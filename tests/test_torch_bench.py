"""The port's headline benchmark (similaripy_tpu_torch/benchmarks/bench.py)
on the CPU.

Its control flow with a stubbed cosine and a stubbed load (the model is
tests/test_bench_script.py): the best of the timed rounds, the adaptive
extension, the diagnostic round's laps and the contract line; its kernel
guard (a stale stamp on a card runs the quick sweep, whose failure ends the
bench with exit code 1); and its real call on a 300 x 120 URM, whose
cosine(k=100) equals the JAX package's (nnz, check_sum rtol 1e-4).
"""

import json
import subprocess
import types

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import similaripy_tpu as jsim
from oracles import check_sum
from similaripy_tpu_torch.benchmarks import bench, kernel_check, kernel_stamp
from similaripy_tpu_torch.engine import splus

CONTRACT_KEYS = ["metric", "value", "unit", "vs_baseline", "vs_cpu_measured"]


@pytest.fixture(autouse=True)
def _keep_priority(monkeypatch):
    """bench.main raises its process's priority; not the test worker's."""
    monkeypatch.setattr(bench.os, "nice", lambda inc: 0)


def _urm(seed=0, shape=(300, 120), density=0.08):
    rng = np.random.default_rng(seed)
    urm = sp.random_array(shape, density=density, format="csr", dtype=np.float32,
                          random_state=rng)
    urm.data = rng.choice(np.arange(0.5, 5.5, 0.5), urm.nnz).astype(np.float32)
    return urm


class _FakeResult:
    nnz = 123

    def tocsr(self):
        return sp.csr_array((120, 120), dtype=np.float32)


def _stub(monkeypatch, durations, urm=None):
    """bench.main's load and cosine stubbed: round i 'takes' durations[i]
    seconds (a fake clock); returns the list of cosine calls."""
    urm = _urm() if urm is None else urm
    monkeypatch.setattr(bench, "cached_npz", lambda *a, **kw: (urm, True))
    clock = types.SimpleNamespace(t=0.0)
    calls = []

    def fake_cosine(m, k=100, verbose=False, device=None):
        assert k == 100 and not verbose and device.type == "cpu"
        clock.t += durations[min(len(calls), len(durations) - 1)]
        calls.append(splus.TIMING)
        if splus.TIMING:
            splus.last_laps.clear()
            splus.last_laps.update({"validate": 0.1, "preprocess": 0.2,
                                    "execute (wall)": 0.3, "assembly": 0.4})
        return _FakeResult()

    monkeypatch.setattr(bench.sim, "cosine", fake_cosine)
    monkeypatch.setattr(bench.time, "perf_counter", lambda: clock.t)
    return calls


def _last_line(out):
    line = json.loads(out.strip().splitlines()[-1])
    assert sorted(line) == sorted(CONTRACT_KEYS)
    return line


def test_reports_best_round_and_runs_diag(monkeypatch, capsys):
    # round 0 (untimed) 9 s, then 3, 2, 4 s: best 2 s
    calls = _stub(monkeypatch, [9.0, 3.0, 2.0, 4.0, 4.0])
    assert bench.main(["--device", "cpu", "--rounds", "3", "--max-extra", "0"]) == 0
    out = capsys.readouterr()
    line = _last_line(out.out)
    assert line["metric"] == "ml32m_item_item_cosine_k100" and line["unit"] == "items/s"
    assert line["value"] == round(120 / 2.0, 1)  # items / best round, not the mean
    assert line["vs_baseline"] == round(60.0 / bench.BASELINE_ITEMS_PER_S, 3)
    assert line["vs_cpu_measured"] == round(60.0 / bench.CPU_MEASURED_ITEMS_PER_S, 3)
    # round 0 + 3 timed + 1 diagnostic round; round 0 and the diagnostic
    # round with TIMING on
    assert calls == [True, False, False, False, True]
    assert splus.TIMING is False  # set back after each lapped round
    assert "# timed rounds: [3.0, 2.0, 4.0]; best 2.0s" in out.err
    for which in ("round 0", "diagnostic round"):
        laps = json.loads(out.err.split(f"# {which} laps: ", 1)[1].splitlines()[0])
        assert laps == {"validate": 0.1, "preprocess": 0.2, "execute (wall)": 0.3,
                        "assembly": 0.4}
        assert f"# {which} stages: " in out.err
    assert "# device: cpu; route" in out.err
    # the fake result is empty: no neighbour found
    assert "# recall@100 (120-row sample) vs exact oracle: 0.0000" in out.err


def test_adaptive_extension_runs_while_best_is_recent(monkeypatch, capsys):
    # rounds keep getting faster: extended up to --max-extra rounds
    calls = _stub(monkeypatch, [9.0, 5.0, 4.0, 3.0, 2.0, 1.0, 0.5, 0.25])
    assert bench.main(["--device", "cpu", "--rounds", "2", "--max-extra", "3", "--no-diag"]) == 0
    out = capsys.readouterr()
    assert len(calls) == 1 + 2 + 3 and calls == [True] + [False] * 5
    assert _last_line(out.out)["value"] == round(120 / 1.0, 1)
    assert "diagnostic round" not in out.err


def test_adaptive_extension_stops_at_steady_state(monkeypatch, capsys):
    # the best (1 s) is two rounds old after round 4: stop there
    calls = _stub(monkeypatch, [9.0, 2.0, 1.0, 3.0, 3.0, 0.1])
    assert bench.main(["--device", "cpu", "--rounds", "2", "--max-extra", "4", "--no-diag"]) == 0
    assert len(calls) == 1 + 4
    assert _last_line(capsys.readouterr().out)["value"] == 120.0


def test_profile_round(monkeypatch, capsys):
    _stub(monkeypatch, [1.0])
    assert bench.main(["--device", "cpu", "--rounds", "1", "--max-extra", "0", "--no-diag",
                       "--profile"]) == 0
    assert "cumulative" in capsys.readouterr().err  # cProfile's stats table


def test_bad_rounds_are_refused():
    with pytest.raises(SystemExit):
        bench.main(["--device", "cpu", "--rounds", "0"])


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])


def test_real_call_equals_jax(monkeypatch, capsys):
    """The bench's own cosine call on a 300 x 120 URM (plain versions on the
    CPU) against the JAX package's cosine(k=100); recall 1.0 on all rows."""
    urm = _urm()
    monkeypatch.setattr(bench, "cached_npz", lambda *a, **kw: (urm, True))
    results = []
    real = bench.sim.cosine

    def keep(*a, **kw):
        results.append(real(*a, **kw))
        return results[-1]

    monkeypatch.setattr(bench.sim, "cosine", keep)
    assert bench.main(["--device", "cpu", "--rounds", "1", "--max-extra", "0"]) == 0
    out = capsys.readouterr()
    ref = jsim.cosine(urm.T.tocsr(), k=100, verbose=False)
    assert len(results) == 3  # warm-up, one timed round, the diagnostic round
    for got in results:
        assert got.shape == ref.shape and got.nnz == ref.nnz
        np.testing.assert_allclose(check_sum(got), check_sum(ref), rtol=1e-4)
    assert "# recall@100 (120-row sample) vs exact oracle: 1.0000" in out.err
    assert "route symmetric" in out.err and "native calls 0" in out.err
    assert _last_line(out.out)["value"] > 0


def _patch_stamp(monkeypatch, tmp_path):
    monkeypatch.setattr(kernel_stamp, "STAMP_PATH", tmp_path / "kernel_check.stamp")


def test_guard_passes_off_a_card_without_a_sweep(monkeypatch, tmp_path):
    _patch_stamp(monkeypatch, tmp_path)
    monkeypatch.setattr(bench.subprocess, "run", lambda *a, **kw: pytest.fail("swept"))
    assert bench.ensure_kernel_stamp(torch.device("cpu"))


@pytest.mark.parametrize("sweep_rc", [0, 1])
def test_guard_runs_the_quick_sweep_on_a_stale_stamp(sweep_rc, monkeypatch, tmp_path, capsys):
    _patch_stamp(monkeypatch, tmp_path)
    runs = []

    def fake_run(cmd, **kw):
        runs.append(cmd)
        if sweep_rc == 0:
            kernel_stamp.write_stamp("quick", "cuda")
        return subprocess.CompletedProcess(cmd, sweep_rc, stdout="sweep output\n", stderr="")

    monkeypatch.setattr(bench.subprocess, "run", fake_run)
    ok = bench.ensure_kernel_stamp(torch.device("cuda", 0))
    assert ok == (sweep_rc == 0)
    assert runs[0][1:] == ["-m", "similaripy_tpu_torch.benchmarks.kernel_check", "--quick",
                           "--device", "cuda:0"]
    err = capsys.readouterr().err
    assert "sweep output" in err and ("FAILED" in err) == (sweep_rc != 0)
    # a current stamp: no second sweep
    if ok:
        assert bench.ensure_kernel_stamp(torch.device("cuda", 0)) and len(runs) == 1


def test_failed_sweep_ends_the_bench_with_exit_1(monkeypatch, tmp_path):
    _patch_stamp(monkeypatch, tmp_path)
    monkeypatch.setattr(bench, "resolve_device", lambda d: torch.device("cuda", 0))
    monkeypatch.setattr(bench.subprocess, "run",
                        lambda cmd, **kw: subprocess.CompletedProcess(cmd, 1, "", "boom"))
    monkeypatch.setattr(bench, "cached_npz", lambda *a, **kw: pytest.fail("timed anyway"))
    assert bench.main([]) == 1


@pytest.mark.parametrize("device, stamped", [("cpu", False), ("cuda", True)])
def test_kernel_check_stamps_only_a_card_sweep(device, stamped, monkeypatch, tmp_path):
    """kernel_check.main writes the stamp after a passing sweep on a card,
    never after one on the CPU (the sweep itself stubbed)."""
    _patch_stamp(monkeypatch, tmp_path)
    monkeypatch.setattr(kernel_check, "run_sweep", lambda *a, **kw: ({}, [], True))
    assert kernel_check.main(["--quick", "--device", device]) == 0
    stamp = kernel_stamp.read_stamp()
    assert (stamp is not None) == stamped
    if stamped:
        assert stamp["mode"] == "quick" and stamp["backend"] == "cuda"
        assert kernel_stamp.stamp_is_current()


def test_kernel_check_failure_writes_no_stamp(monkeypatch, tmp_path):
    _patch_stamp(monkeypatch, tmp_path)
    monkeypatch.setattr(kernel_check, "run_sweep",
                        lambda *a, **kw: ({}, [{"label": "x", "ok": False}], False))
    assert kernel_check.main(["--device", "cuda"]) == 1
    assert kernel_stamp.read_stamp() is None
