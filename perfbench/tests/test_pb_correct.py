"""`correct` on the CPU at a tiny size: the port's runs come out correct,
the control (the reference at the lower precision, in the program's place)
and every planted fault come out not correct."""

import io

import pytest
from conftest import TINY, TINY_PARAMS

import calibrate
import faults
from pbcore import compare, driver, manifest

CELLS = list(TINY_PARAMS)


def limits(cell):
    return manifest.workload(cell)["limits"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_of_the_port_is_correct(cell):
    out, err = io.StringIO(), io.StringIO()
    result = driver.run_cell(cell, 2**31 + 77, 1.0, False, device="cpu", scale=TINY,
                             params=TINY_PARAMS[cell], out=out, err=err).result
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert result["device"]["platform"] == "cpu"
    # the last lines of stderr are the compared numbers beside their limits
    tail = err.getvalue().strip().splitlines()[-len(compare.NUMBERS):]
    assert [line.split(":")[0] for line in tail] == [f"check {n}" for n in compare.NUMBERS]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    r = calibrate.readings(cell, 31, 0.5, True, device="cpu", scale=TINY,
                           params=TINY_PARAMS[cell])
    assert compare.judge(r["program"], limits(cell))[0]
    assert not compare.judge(r["control"], limits(cell))[0], r["control"]


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_is_not_correct(cell, fault):
    r = calibrate.readings(cell, 41, 1.0, False, fault, device="cpu", scale=TINY,
                           params=TINY_PARAMS[cell])
    assert r["fault"] == fault and not r["correct"], r
    assert not compare.judge(r["program"], limits(cell))[0], r
