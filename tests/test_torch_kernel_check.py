"""The port's kernel-check sweep (similaripy_tpu_torch/benchmarks/
kernel_check.py) against the JAX package's, on the CPU.

``row_values_rel`` against ``benchmarks/tpu_kernel_check.py``'s on CSR
pairs (equal rows, ties kept under other ids, changed values, rows of
other lengths, empty rows); every sweep variant at a small C through both
packages (equal nnz, check_sum within rtol 1e-4, as tests/oracles.py
compares the packages everywhere); and the sweep's own run on the CPU.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import similaripy_tpu as jsim
import similaripy_tpu_torch as tsim
from benchmarks import tpu_kernel_check as reference
from oracles import check_sum
from similaripy_tpu_torch.benchmarks import kernel_check

torch.set_num_threads(2)

C, U = 600, 300


def _csr(rows, n_cols=6):
    """CSR from per-row {col: value} dicts."""
    indptr, indices, data = [0], [], []
    for r in rows:
        for c, v in sorted(r.items()):
            indices.append(c)
            data.append(v)
        indptr.append(len(indices))
    return sp.csr_matrix((np.asarray(data, np.float32), indices, indptr),
                         shape=(len(rows), n_cols))


PAIRS = {
    "equal": ([{0: 1.0, 2: 0.5}, {1: 3.0}], [{0: 1.0, 2: 0.5}, {1: 3.0}]),
    "tie_other_ids": ([{0: 2.0, 3: 1.0}, {}], [{0: 2.0, 4: 1.0}, {}]),
    "value_changed": ([{0: 1.0, 1: 2.0}, {5: -4.0}], [{0: 1.0, 1: 2.000002}, {5: -4.0}]),
    "row_length_differs": ([{0: 1.0, 1: 1.0}, {2: 1.0}], [{0: 1.0}, {2: 1.0, 3: 1.0}]),
    "empty": ([{}, {}], [{}, {}]),
    "zero_reference": ([{0: 1e-31}], [{0: 0.0}]),
}


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_row_values_rel_matches_reference(name):
    got, ref = (_csr(rows) for rows in PAIRS[name])
    want = reference.row_values_rel(got, ref)
    assert kernel_check.row_values_rel(got, ref) == want
    if name in ("equal", "tie_other_ids", "empty"):
        assert want == 0.0
    if name == "row_length_differs":
        assert want == float("inf")


def test_repeated_neighbour():
    assert not kernel_check.has_repeated_neighbour(_csr([{0: 1.0, 1: 1.0}] * 3))
    dup = sp.csr_matrix((np.ones(3, np.float32), [1, 1, 2], [0, 2, 3]), shape=(2, 4))
    assert kernel_check.has_repeated_neighbour(dup)
    # only every 97th row is looked at, as in the reference
    late = sp.csr_matrix((np.ones(2, np.float32), [1, 1], [0] * 6 + [2]), shape=(6, 4))
    assert not kernel_check.has_repeated_neighbour(late)


def _variants():
    m, mf, filt, tgt = kernel_check.sweep_inputs(False, C, U)
    port = kernel_check.sweep_variants(tsim, m, mf, filt, tgt, device="cpu")
    jax_side = kernel_check.sweep_variants(jsim, m, mf, filt, tgt)
    return {label: (call, jcall) for (label, call, _), (_, jcall, _) in zip(port, jax_side)}


LABELS = [label for label, _, _ in kernel_check.sweep_variants(
    tsim, *[sp.csr_matrix((2, 2))] * 4)]


def test_sweep_is_the_reference_list():
    """Every entry of the reference's sym_variants + gen_variants, in order
    (20), and the quick subset it takes."""
    assert len(LABELS) == 20
    assert sum(label.startswith("sym ") for label in LABELS) == 13
    quick = [label for label, _, _ in kernel_check.sweep_variants(
        tsim, *[sp.csr_matrix((2, 2))] * 4, quick=True)]
    assert quick == LABELS[:2] + LABELS[13:14] + LABELS[-1:]


@pytest.mark.parametrize("label", LABELS)
def test_sweep_variant_matches_jax(label):
    call, jcall = _variants()[label]
    got, ref = call(), jcall()
    assert got.shape == ref.shape
    assert got.nnz == ref.nnz
    np.testing.assert_allclose(check_sum(got), check_sum(ref), rtol=1e-4)


def test_probe_and_sweep_run_on_cpu(capsys):
    for dtype in kernel_check.PROBE_DTYPES:
        assert kernel_check.probe_transposed_lhs(dtype, "cpu") == ("ok", True)
    probes, results, ok = kernel_check.run_sweep(device="cpu", C=C, U=U, out=lambda s: None)
    assert ok and len(results) == 20 and all(p["ok"] for p in probes.values())
    assert all(r["rel"] == 0.0 and not r["dupes"] for r in results)
    assert kernel_check.main(["--quick", "--device", "cpu"]) == 0
    assert "all kernel variants match" in capsys.readouterr().out


def test_plain_versions_swaps_the_tile_function():
    from similaripy_tpu_torch.engine import splus

    real = splus.execute
    with kernel_check.plain_versions():
        assert splus.execute.func is real and splus.execute.keywords == {"_tile_fn": "plain"}
    assert splus.execute is real


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kernel_check.main(["--quick"])


def test_card_run_must_launch_kernels():
    """On a card a variant whose kernel run launched nothing fails; on the
    CPU both runs are the plain versions and only the values count."""
    m, mf, filt, tgt = kernel_check.sweep_inputs(False, 200, 100)
    label, call, tol = kernel_check.sweep_variants(tsim, m, mf, filt, tgt, device="cpu")[0]
    cpu = kernel_check.check_variant(tsim, label, call, tol, on_card=False)
    assert cpu["ok"] and cpu["launches"] == 0 and cpu["plain_calls_in_kernel_run"] > 0
    assert not kernel_check.check_variant(tsim, label, call, tol, on_card=True)["ok"]
