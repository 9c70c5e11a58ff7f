"""Values kind ``half_stars``: ratings uniform over the ten half stars
{0.5, 1.0, ..., 5.0}, drawn by the seed over the fixed pattern.

``Values(seed, nnz, device)`` draws once, in set-up: the codes 1..10 of
``nnz + SPAN`` ratings on the run's device from a ``torch.Generator``,
which cross to the host as bytes and become one float32 buffer there
(where the public API takes its matrices). Version v of the ratings is
the slice ``buffer[off(v):off(v) + nnz]``, off(v) = v * STRIDE mod SPAN: a
view, made in no time, so a run has a version of its own for every call
it makes and makes none in the measured window. Two versions give a
rating independent draws (different places of the buffer).
"""

from __future__ import annotations

import numpy as np
import torch

from pbcore import data

SPAN = 1 << 20
STRIDE = 7919  # odd, so the SPAN offsets v * STRIDE mod SPAN are all distinct


class Values:
    def __init__(self, seed: int, nnz: int, device):
        g = data.generator(seed, device, data.VALUES)
        codes = torch.randint(1, 11, (nnz + SPAN,), generator=g, device=device,
                              dtype=torch.int8).cpu()
        self.buffer = np.multiply(codes.numpy(), np.float32(0.5), dtype=np.float32)
        self.nnz = nnz

    def __call__(self, version: int) -> np.ndarray:
        off = (version * STRIDE) % SPAN
        return self.buffer[off:off + self.nnz]
