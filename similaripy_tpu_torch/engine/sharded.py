"""Multi-device execution over torch.distributed: the mesh router.

Port of ``similaripy_tpu/engine/sharded.py``'s entry (``execute_sharded``
:764). A mesh from ``parallel.make_mesh`` has two dimensions:

  'rows' — target-row panels are dealt over row shards: each row shard owns
           a disjoint slice of the output (the reference's OpenMP row loop,
           s_plus.h:313-338);
  'cols' — matrix2's column tiles are dealt over column shards: each column
           shard keeps a partial top-k per row over its own tiles.

A mesh call runs the single-device sweeps on this rank's share, with the
same kernels: the symmetric-eligible calls take the pair sweep
(``symmetric.execute_symmetric``, its steps dealt over all ranks by
``sym_sharded.pair_schedule``), the rest the grouped sweep
(``executor.execute_grouped``: K5 densifies this rank's tile groups, K1
carries its panels' top-k over them, with the exclude-seen fold and the
filter and target selectors as on one device; the grouped path of
sharded.py:434). The top-k partials are then all-gathered and re-selected
(``parallel.mesh.merge_topk``), so every rank returns the whole result.
Matrix data never moves between ranks: each stages its own panels and
tiles from the same host inputs. Mesh calls never take the compaction
route, as in the JAX package. Left out: the JAX package's env-gated legacy
scan-over-tiles path (``_execute_sharded_legacy``), which gives the same
results.

Every rank must plan identically (the same tc, groups and collectives, in
the same order), so the device budget is agreed first (the minimum over
ranks) and a mesh call does not replan after an out-of-memory error.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..parallel import mesh as pmesh
from ..utils.device import resolve_device
from . import executor as ex
from .params import SPlusParams
from .preprocess import Preprocessed

NEG_INF = float("-inf")


def local_budget(mesh, device: torch.device, budget_bytes: Optional[int]) -> int:
    """This rank's device bytes: the caller's, else the device's budget, a
    shared card's divided by the ranks on it. The planners then agree on
    the minimum over ranks (``parallel.mesh.agree_min``), so that every
    rank plans the same geometry."""
    share = pmesh.ranks_per_card(mesh)  # on every rank: it may be a collective
    if budget_bytes is None:
        budget_bytes = ex.default_budget(device)
        if device.type == "cuda":
            budget_bytes //= share
    return budget_bytes


def execute_sharded(
    pre: Preprocessed,
    params: SPlusParams,
    *,
    mesh,
    block_size_hint: Optional[int] = 0,
    compute_dtype: str = "float32",
    precision: str = "highest",
    budget_bytes: Optional[int] = None,
    progress=None,
    device="cuda",
):
    """Run the mesh-sharded similarity on this rank (sharded.py:764);
    returns the whole host (T, k) vals f32 and idx int32 on every rank."""
    from .symmetric import execute_symmetric, symmetric_eligible

    device = resolve_device(device)
    pmesh.check_device(mesh, device)
    if precision not in ("highest", "high", "default"):
        raise ValueError(f"precision must be 'highest', 'high' or 'default', got {precision!r}")
    ex.last_route = None
    T, k = pre.targets.shape[0], pre.k
    if T == 0 or k == 0:
        return (
            np.full((T, max(k, 1)), NEG_INF, np.float32),
            np.zeros((T, max(k, 1)), np.int32),
        )
    budget_bytes = local_budget(mesh, device, budget_bytes)
    if symmetric_eligible(pre, params, block_size_hint) and pre.n_output_cols > 0:
        ex.last_route = "sym_sharded"
        return execute_symmetric(
            pre, params, compute_dtype=compute_dtype, precision=precision,
            budget_bytes=budget_bytes, progress=progress, device=device, mesh=mesh,
        )
    ex.last_route = "sharded"
    return ex.execute_grouped(
        pre, params, block_size_hint=block_size_hint, compute_dtype=compute_dtype,
        precision=precision, budget_bytes=budget_bytes, progress=progress, device=device,
        mesh=mesh,
    )
