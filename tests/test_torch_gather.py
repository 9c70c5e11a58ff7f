"""K4 of the port (similaripy_tpu_torch.engine.gather) against the JAX
kernel it replaces (similaripy_tpu.engine.gather.row_gather_words, run in
interpret mode over its flat int32-word view of the table).

On CPU tensors the port's row_gather runs its plain version,
torch.index_select, so these tests hold that to the TPU kernel bit for bit
in every table dtype (f32, bf16, int8), with repeated and unsorted ids and
the last row among them. The JAX kernel needs rows of a multiple of 4096
bytes (cg 1024 for f32, 2048 for bf16, 4096 for int8); the port has no such
limit (test_odd_widths). The CUDA kernel itself is held against the plain
version on the card (chip_smoke.py and test_torch_kernel_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from similaripy_tpu.engine.gather import row_gather_words, to_flat_words
from similaripy_tpu_torch.engine import gather
from torch_k3_cases import gather_inputs

CG = {"f32": 1024, "bf16": 2048, "int8": 4096}
JNP = {"f32": jnp.float32, "bf16": jnp.bfloat16, "int8": jnp.int8}
TORCH = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}


@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
def test_plain_matches_jax_kernel(mode):
    table, idx = gather_inputs(mode, 96, CG[mode], 150)
    jt = jnp.asarray(table, JNP[mode])
    ref = row_gather_words(to_flat_words(jt), jnp.asarray(idx), CG[mode], JNP[mode],
                           interpret=True)
    gather.reset_counts()
    got = gather.row_gather(torch.from_numpy(table).to(TORCH[mode]), torch.from_numpy(idx))
    assert gather.plain_calls == 1 and gather.kernel_launches == 0
    assert got.dtype == TORCH[mode] and got.shape == (150, CG[mode])
    ref32 = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_array_equal(got.to(torch.float32).numpy(), ref32)


@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
def test_odd_widths(mode):
    """Rows of any width (here 515 values), ids repeated, unsorted and at
    the last row: the rows of the table, in the order asked."""
    table, idx = gather_inputs(mode, 300, 515, 1000)
    t = torch.from_numpy(table).to(TORCH[mode])
    got = gather.row_gather(t, torch.from_numpy(idx))
    assert torch.equal(got, t[torch.from_numpy(idx).long()])
    assert torch.equal(got[0], t[299]) and torch.equal(got[2], t[299])
