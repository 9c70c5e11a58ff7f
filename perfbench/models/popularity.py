"""Model kind ``popularity``: an items x items model with exactly
``per_row`` entries a row (the shape of a top-``per_row`` model), the
neighbour ids drawn without replacement in proportion to the item rating
counts of the pattern, the values uniform in (0, 1] (float32), all by the
seed, on the run's device in blocks of rows.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from pbcore import data


def draw(seed: int, counts: np.ndarray, params: dict, device, chunk: int = 2048) -> sp.csr_array:
    """The model of item rating `counts`; `params` is the configuration's
    ``model`` entry (``per_row``)."""
    n, per_row = counts.shape[0], params["per_row"]
    g = data.generator(seed, device, data.MODEL_IDS)
    w = torch.from_numpy(counts.astype(np.float32)).to(device)
    ids = torch.empty((n, per_row), dtype=torch.int64, device=device)
    for r0 in range(0, n, chunk):
        r1 = min(n, r0 + chunk)
        ids[r0:r1] = torch.multinomial(w.expand(r1 - r0, n).contiguous(), per_row,
                                       replacement=False, generator=g)
    vals = 1.0 - torch.rand((n, per_row), generator=g, device=device, dtype=torch.float32)
    indptr = np.arange(0, (n + 1) * per_row, per_row, dtype=np.int32)
    model = sp.csr_array((vals.cpu().numpy().ravel(), ids.cpu().numpy().astype(np.int32).ravel(),
                          indptr), shape=(n, n))
    model.sort_indices()
    return model
