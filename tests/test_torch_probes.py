"""The hardware probes' plain versions against the JAX package's, on the CPU.

P1 (transposed-lhs product): the plain version against
``jax.lax.dot_general`` contracting both operands on dimension 0, the body
of ``benchmarks/tpu_kernel_check.py::_probe_transposed_lhs``, in int8,
bf16 and f32 (HIGHEST) at the probe's shape and data, on ragged shapes and
on full-range int8. P2 (int8/int4 rate product): the plain version against
``benchmarks/micro_int4.py::_kernel`` through ``pl.pallas_call(...,
grid=(steps,), interpret=True)``. Every comparison is bit-equal: the values
keep every partial sum exact. The microbenchmark scripts' inputs are held
against the reference scripts' formulas, and their CPU runs are smoke-tested.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from similaripy_tpu_torch.benchmarks import (compare_checkouts, micro_int4, micro_tile_kernel,
                                             probes, tlhs_transpose_cost)
from torch_probe_cases import (P1_DTYPES, P1_F32_RANDN_SHAPES, P1_SHAPES, P2_CASES, P2_MODES,
                               f32_scaled_errors, f32_tolerance, p1_inputs, p1_randn, p2_inputs,
                               p2_wrap_inputs, shape_id)

torch.set_num_threads(2)

_TORCH = {"int8": torch.int8, "bfloat16": torch.bfloat16, "float32": torch.float32}
_JNP = {"int8": jnp.int8, "bfloat16": jnp.bfloat16, "float32": jnp.float32}
_DN = (((0,), (0,)), ((), ()))


def _jax_tlhs(a_i, b_i, dtype):
    """The TPU probe's body: dot_general over dimension 0 of both."""
    acc = jnp.int32 if dtype == "int8" else jnp.float32
    a, b = (jnp.asarray(x).astype(_JNP[dtype]) for x in (a_i, b_i))
    precision = jax.lax.Precision.HIGHEST if dtype == "float32" else None
    return np.asarray(jax.lax.dot_general(a, b, _DN, preferred_element_type=acc,
                                          precision=precision))


@pytest.mark.parametrize("dtype", P1_DTYPES)
@pytest.mark.parametrize("shape", P1_SHAPES, ids=[shape_id(s) for s in P1_SHAPES])
def test_p1_plain_matches_dot_general(dtype, shape):
    a_i, b_i = p1_inputs(*shape, seed=sum(shape))
    a, b = (torch.from_numpy(x).to(_TORCH[dtype]) for x in (a_i, b_i))
    probes.reset_counts()
    got = probes.transposed_lhs_product(a, b)
    assert probes.tlhs_counts.plain_calls == 1 and probes.tlhs_counts.kernel_launches == 0
    assert got.dtype == (torch.int32 if dtype == "int8" else torch.float32)
    ref = _jax_tlhs(a_i, b_i, dtype)
    assert got.shape == ref.shape == (shape[1], shape[2])
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy().astype(np.int64), a_i.T @ b_i)


def test_p1_probe_data_matches_dot_general():
    """The probe's own data: default_rng(0), integers(-5, 6), K 512, M 256,
    N 1,024, drawn a then b."""
    from similaripy_tpu_torch.benchmarks import kernel_check

    rng = np.random.default_rng(0)
    K, M, N = kernel_check.PROBE_SHAPE
    a_i, b_i = rng.integers(-5, 6, (K, M)), rng.integers(-5, 6, (K, N))
    for dtype in P1_DTYPES:
        a, b = (torch.from_numpy(x).to(_TORCH[dtype]) for x in (a_i, b_i))
        np.testing.assert_array_equal(probes.transposed_lhs_product(a, b).numpy(),
                                      _jax_tlhs(a_i, b_i, dtype))
        assert kernel_check.probe_transposed_lhs(dtype, "cpu") == ("ok", True)


@pytest.mark.parametrize("shape", [(700, 65, 90), (513, 129, 33)], ids=shape_id)
def test_p1_full_range_int8(shape):
    a_i, b_i = p1_inputs(*shape, seed=3, full_range=True)
    ref = _jax_tlhs(a_i, b_i, "int8")
    a, b = (torch.from_numpy(x).to(torch.int8) for x in (a_i, b_i))
    np.testing.assert_array_equal(probes.transposed_lhs_product(a, b).numpy(), ref)


@pytest.mark.parametrize("shape", P1_F32_RANDN_SHAPES, ids=[shape_id(s) for s in P1_F32_RANDN_SHAPES])
def test_p1_f32_randn_within_tolerance(shape):
    """On non-integer f32 data the plain version and the TPU probe's body
    (HIGHEST) stay within the f32 tolerance the card checks P1 by, and so
    does an emulation of P1's kernel (fmaf, one term after another); a
    product on TF32-rounded operands does not."""
    K, M, N = shape
    a_n, b_n = p1_randn(*shape, seed=sum(shape))
    a, b = torch.from_numpy(a_n), torch.from_numpy(b_n)
    tol = f32_tolerance(K)
    ref = _jax_tlhs(a_n, b_n, "float32")
    acc = torch.zeros((M, N), dtype=torch.float32)
    a64, b64 = a.double(), b.double()
    for k in range(K):
        acc = (a64[k, :, None] * b64[k, None, :] + acc.double()).float()
    for got in (probes.transposed_lhs_product(a, b), torch.from_numpy(ref.copy()), acc):
        mean, worst, tf32_mean = f32_scaled_errors(torch, got, a, b)
        assert mean <= tol and np.isfinite(worst)
        assert tf32_mean > 8 * tol


def _micro_int4_reference(monkeypatch):
    """benchmarks/micro_int4.py, imported with its environment knobs set
    first (it reads MICRO_INT4_* at import; its compile cache follows
    JAX_COMPILATION_CACHE_DIR, which the suite's conftest points at a
    temporary directory)."""
    monkeypatch.setenv("MICRO_INT4_STEPS", "3")
    monkeypatch.setenv("MICRO_INT4_REPS", "1")
    from benchmarks import micro_int4 as reference

    return reference


def _jax_rate(reference, a, b, steps, mode):
    M, K = a.shape
    N = b.shape[1]
    return np.asarray(pl.pallas_call(
        partial(reference._kernel, mode=mode),
        grid=(steps,),
        in_specs=[pl.BlockSpec((M, K), lambda i: (0, 0)), pl.BlockSpec((K, N), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((M, N), lambda i: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((M, N), jnp.int32),
        interpret=True,
    )(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("mode", P2_MODES)
@pytest.mark.parametrize("case", P2_CASES, ids=[shape_id(c) for c in P2_CASES])
def test_p2_plain_matches_pallas_kernel(mode, case, monkeypatch):
    """mode s4: XLA's CPU backend cannot multiply int4 arrays (its HLO
    verifier rejects the upcast of an int4 operand), so the reference runs
    the kernel's int8 mode on the values JAX's int4 cast keeps; the values
    span [-8, 9], so the cast's wrap of 8 and 9 is covered too."""
    reference = _micro_int4_reference(monkeypatch)
    M, K, N, steps = case
    a, b = p2_inputs(M, K, N, seed=M + K)
    if mode == "s4":
        a, b = p2_wrap_inputs(M, K, N, seed=M)
        ja, jb = (np.asarray(jnp.asarray(x).astype(jnp.int4).astype(jnp.int8)) for x in (a, b))
        ref = _jax_rate(reference, ja, jb, steps, "int8")
    else:
        ref = _jax_rate(reference, a, b, steps, "int8")
    probes.reset_counts()
    got = probes.int_rate_product(torch.from_numpy(a), torch.from_numpy(b), steps, mode)
    assert probes.int_mma_counts.plain_calls == 1 and probes.int_mma_counts.kernel_launches == 0
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_p2_int8_in_range_is_s4():
    """On values in [-7, 7] (the probe's) both modes give the same product,
    and the reference's s4 cast changes none of them."""
    a, b = p2_inputs(32, 64, 48, seed=1)
    assert np.array_equal(np.asarray(jnp.asarray(a).astype(jnp.int4).astype(jnp.int8)), a)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert torch.equal(probes.int_rate_product(ta, tb, 3, "s4"),
                       probes.int_rate_product(ta, tb, 3, "int8"))


def test_wrappers_reject_bad_input():
    a = torch.zeros((8, 4), dtype=torch.int8)
    with pytest.raises(ValueError, match="dtypes"):
        probes.transposed_lhs_product(a, a.float())
    with pytest.raises(ValueError, match="chain"):
        probes.transposed_lhs_product(a, torch.zeros((7, 4), dtype=torch.int8))
    with pytest.raises(ValueError, match="dtypes"):
        probes.transposed_lhs_product(a.to(torch.int32), a.to(torch.int32))
    with pytest.raises(ValueError, match="mode"):
        probes.int_rate_product(a, a.T.contiguous(), 2, "int4")
    with pytest.raises(ValueError, match="steps"):
        probes.int_rate_product(a, a.T.contiguous(), -1)
    with pytest.raises(ValueError, match="chain"):
        probes.int_rate_product(a, a, 2)


def test_micro_int4_inputs_match_reference():
    """The reference's operands: arange(...) % 15 - 7 as int8."""
    a, b = micro_int4.inputs("cpu")
    M, K, N = micro_int4.M, micro_int4.K, micro_int4.N
    assert (M, K, N, micro_int4.STEPS) == (512, 2048, 512, 512)
    ja = jnp.asarray(np.arange(M * K).reshape(M, K) % 15 - 7, jnp.int8)
    jb = jnp.asarray(np.arange(K * N).reshape(K, N) % 15 - 7, jnp.int8)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    assert micro_int4.bound_ms(M, K, N, 512) == pytest.approx(0.2778, rel=1e-3)


def test_micro_int4_runs_on_cpu(capsys):
    r = micro_int4.probe("s4", steps=2, device="cpu", shape=(64, 128, 32))
    assert r["exact"] and r["ms"] is None and r["max_abs_diff"] == 0
    assert micro_int4.main(["--device", "cpu", "--steps", "2"]) == 0
    out = capsys.readouterr().out
    assert "int8: exact" in out and "s4: exact" in out


def _reference_tile_inputs(trp, u_pad, tc):
    """benchmarks/micro_tile_kernel.py's make_inputs, its lines as they are
    (the split [hi; lo] tile of 2 * u_pad rows)."""
    ai = jax.lax.broadcasted_iota(jnp.int32, (trp, u_pad), 0) * 7919 + \
        jax.lax.broadcasted_iota(jnp.int32, (trp, u_pad), 1) * 104729
    a = jnp.where((ai % 6) == 0, (ai % 9 + 1).astype(jnp.bfloat16), 0)
    di = jax.lax.broadcasted_iota(jnp.int32, (2 * u_pad, tc), 0) * 31337 + \
        jax.lax.broadcasted_iota(jnp.int32, (2 * u_pad, tc), 1) * 6151
    scale = jnp.where(jax.lax.broadcasted_iota(jnp.int32, (2 * u_pad, tc), 0) < u_pad,
                      1.0, 2.0 ** -9)
    d = jnp.where((di % 845) == 0,
                  ((di % 13 + 1).astype(jnp.float32) * scale / 13.0).astype(jnp.bfloat16), 0)
    return np.asarray(a.astype(jnp.float32)), np.asarray(d.astype(jnp.float32))


def test_micro_tile_kernel_inputs_match_reference():
    """At u_pad 40,000 both formulas overflow int32 (col * 104,729 and
    row * 31,337), and the wrap must agree."""
    trp, u_pad, tc = 4, 40_000, 8
    a, d = micro_tile_kernel.make_inputs(trp, u_pad, tc, "cpu")
    ra, rd = _reference_tile_inputs(trp, u_pad, tc)
    np.testing.assert_array_equal(a.numpy(), ra)
    np.testing.assert_array_equal(d.numpy(), rd[:u_pad] + rd[u_pad:])
    assert (a != 0).any() and (d != 0).any()


def test_micro_tile_kernel_runs_on_cpu(capsys):
    from similaripy_tpu_torch.engine import tile_topk

    tile_topk.reset_counts()
    r = micro_tile_kernel.run(64, 1024, 256, 16, reps=2, device="cpu", rounds=1)
    assert r["round_ms"] is None and tile_topk.plain_calls == 3
    vals, idx = r["carry"]
    assert vals.shape == (16, 64) and torch.isfinite(vals).all()
    assert micro_tile_kernel.main(["--device", "cpu", "--trp", "64", "--upad", "1024",
                                   "--tc", "256", "--reps", "1"]) == 0
    assert "time not measured" in capsys.readouterr().out


def test_micro_tile_kernel_bound():
    assert 1e3 * 2.0 * 2048 * 84480 * 2048 / micro_tile_kernel.PEAK_F32_FLOPS == \
        pytest.approx(10.577, rel=1e-3)


def test_micro_scripts_read_no_environment():
    """The reference scripts' MICRO_* environment knobs are flags here."""
    for mod in (micro_int4, micro_tile_kernel):
        with open(mod.__file__) as f:
            assert "environ" not in f.read(), mod.__name__


def test_tlhs_transpose_cost_needs_a_card(capsys):
    """The transpose-cost control runs only on a card: without one it exits
    1 before it builds anything."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert tlhs_transpose_cost.main([]) == 1
    assert "needs a CUDA card" in capsys.readouterr().err
    assert tlhs_transpose_cost.SHAPE == (200_960, 4096, 4096)


def test_compare_checkouts_needs_a_card(capsys):
    """The two-checkout comparison runs only on a card: without one it
    exits 1 before it starts a turn; its turn and output programs are
    valid Python."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert compare_checkouts.main([".", "."]) == 1
    assert "needs one card" in capsys.readouterr().err
    for code in (compare_checkouts._TURN, compare_checkouts._OUTPUTS):
        compile(code, "<turn>", "exec")
