"""The probes' Hopper pieces on the CPU: P1's int8 path as the K-major pass
and the product on its output (their plain versions) against the JAX
package's transposed-lhs probe (``jax.lax.dot_general`` over dimension 0,
the body of ``benchmarks/tpu_kernel_check.py::_probe_transposed_lhs``),
P2's int8 path as the pass (a padded, b transposed) and the product times
steps against its plain version, the wrappers' counts and product-kernel
names against the C sources' enums, and the card-only scripts' refusal to
run without a card.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from similaripy_tpu_torch.benchmarks import micro_int4, micro_probes, probes
from torch_probe_cases import P1_SHAPES, P2_CASES, p1_inputs, p2_inputs, shape_id

CSRC = Path(probes.__file__).resolve().parent.parent / "csrc"


def _jax_tlhs_int8(a_i, b_i):
    a, b = (jnp.asarray(x).astype(jnp.int8) for x in (a_i, b_i))
    return np.asarray(jax.lax.dot_general(a, b, (((0,), (0,)), ((), ())),
                                          preferred_element_type=jnp.int32))


@pytest.mark.parametrize("shape", P1_SHAPES, ids=shape_id)
def test_p1_int8_pieces_match_dot_general(shape):
    """The K-major pass on both operands, then the product of the padded
    rows, equals the TPU probe's dot_general on full-range int8."""
    K, M, N = shape
    a_i, b_i = p1_inputs(*shape, seed=sum(shape) + 1, full_range=True)
    a, b = (torch.from_numpy(x).to(torch.int8) for x in (a_i, b_i))
    probes.reset_counts()
    at, bt = probes.kmajor_pass(a), probes.kmajor_pass(b)
    assert probes.kmajor_counts.plain_calls == 2 and probes.kmajor_counts.kernel_launches == 0
    k_pad = probes.k_pad(K)
    assert at.shape == (M, k_pad) and bt.shape == (N, k_pad) and k_pad % 128 == 0
    assert not at[:, K:].any() and not bt[:, K:].any()
    got = probes.s8_kmajor_product(at, bt, M, N)
    assert probes.tlhs_counts.plain_calls == 1
    np.testing.assert_array_equal(got.numpy(), _jax_tlhs_int8(a_i, b_i))
    np.testing.assert_array_equal(got.numpy(), probes.transposed_lhs_product(a, b).numpy())


@pytest.mark.parametrize("case", P2_CASES, ids=shape_id)
def test_p2_int8_pieces_match_plain(case):
    """a padded and b transposed by the pass, their product times steps,
    equals P2's plain version and the int64 oracle."""
    M, K, N, steps = case
    a_n, b_n = p2_inputs(M, K, N, seed=M + K)
    a, b = torch.from_numpy(a_n), torch.from_numpy(b_n)
    ap, bt = probes.kmajor_pass(a, transpose=False), probes.kmajor_pass(b)
    assert ap.shape == (M, probes.k_pad(K)) and bt.shape == (N, probes.k_pad(K))
    got = probes.s8_kmajor_product(ap, bt, M, N) * steps
    assert torch.equal(got, probes.int_rate_product_plain(a, b, steps, "int8"))
    np.testing.assert_array_equal(got.numpy(), (a_n.astype(np.int64) @ b_n.astype(np.int64))
                                  * steps)


@pytest.mark.parametrize("K", [0, 1, 127, 128, 129, 200_960])
def test_k_pad_is_the_next_multiple_of_128(K):
    kp = probes.k_pad(K)
    assert kp % 128 == 0 and K <= kp < K + 128


def _enum(source, name):
    """The names of a C enum in a csrc source, in order of their values."""
    body = re.search(r"enum " + name + r" \{([^}]*)\}", (CSRC / source).read_text()).group(1)
    pairs = re.findall(r"(\w+) = (\d+)", body)
    return [n for n, v in sorted(pairs, key=lambda p: int(p[1]))]


def test_product_kernel_names_follow_the_c_enums():
    assert _enum("probe_tlhs.cu", "TlhsKernel") == [
        "TK_SIMT", "TK_SIMT_RING", "TK_MMA_BF16", "TK_WGMMA_BF16", "TK_WGMMA_S8"]
    assert probes.TLHS_KERNELS == ("simt", "simt cp.async ring", "mma.sync bf16", "wgmma bf16",
                                   "wgmma s8")
    assert _enum("probe_int_mma.cu", "RateKernel") == ["IK_WGMMA_S8", "IK_MMA_S4"]
    assert probes.RATE_KERNELS == ("wgmma s8", "mma.sync s4")


def test_counts_reset_and_name_the_product_kernel():
    c = probes.tlhs_counts
    probes.reset_counts()
    assert c.product_launches == dict.fromkeys(probes.TLHS_KERNELS, 0)
    assert c.last_kernel is None and c.kernel_launches == c.pass_launches == 0
    c.count(probes.TLHS_KERNELS.index("wgmma s8"), passes=2)
    assert c.kernel_launches == 1 and c.pass_launches == 2 and c.last_kernel == "wgmma s8"
    assert c.product_launches["wgmma s8"] == 1
    probes.reset_counts()
    assert c.product_launches["wgmma s8"] == 0 and c.last_kernel is None


def test_kmajor_pass_rejects_other_dtypes():
    with pytest.raises(ValueError):
        probes.kmajor_pass(torch.zeros((4, 4), dtype=torch.float32))
    with pytest.raises(ValueError):
        probes.s8_kmajor_product(torch.zeros((4, 128), dtype=torch.int8),
                                 torch.zeros((4, 128), dtype=torch.int16), 4, 4)


def test_micro_int4_names_no_kernel_on_the_cpu():
    r = micro_int4.probe("int8", steps=2, device="cpu", shape=(64, 128, 32))
    assert r["exact"] and r["kernel"] is None and r["ms"] is None


def test_micro_probes_needs_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal without a card")
    assert micro_probes.main([]) == 1
    assert "needs a CUDA card" in capsys.readouterr().err
