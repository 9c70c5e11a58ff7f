"""Tiled S-Plus executor: the general grouped branch, on one device or a mesh.

Port of ``similaripy_tpu/engine/executor.py`` (``_execute_impl`` from :1357
on, with ``_run_group_panels``), and with ``mesh=`` of the grouped path of
``similaripy_tpu/engine/sharded.py`` (:434): the same sweep over this
rank's row panels and column tiles (``execute_grouped``). Similarity tiles
are dense products over densified sparse tiles, with the S-Plus epilogue
fused and a per-row top-K carried across column tiles (reference:
s_plus.h:39-64,71-240,265-453):

  - target rows go in row panels (the reference's OpenMP row loop);
  - matrix2's columns are dealt round-robin by popularity into column tiles
    (``balance_columns``), and as many dense (u_pad x tc) tiles as fit the
    device budget are densified (K5, ``scatter.densify_tiles``) once per
    group;
  - every panel streams over the resident group through K1
    (``tile_topk.fused_tile_topk``), whose in-kernel merge carries each
    row's top-k_pad from tile to tile.

Every single-device call that is not a self-similarity over all rows takes
this branch, unless it goes to the symmetric executor (``symmetric.py``) or
to the union-compaction executor (``compact.py``), as in the JAX package.
The recommend idiom ``dot_product(urm, W.T, filter_cols=urm)`` drops its
per-row filter masks through the exclude-seen fold (``_exclude_seen_fold``:
m2 - M*I, exact under its gate; ``FOLD_FILTER = False`` opts out). f32
calls with ``precision='high'`` run K1 in a split-bf16x3 mode
(``_select_f32x3_mode``): the f32 side(s) go to K5 as the COO of their
[hi; lo] bf16 stacks (``split_coo``), a side that bf16 holds exactly as a
plain bf16 tile. Device uploads of all three executors live in the
content-keyed cache at the end of this module (``cache_info``,
``clear_caches``).

Candidate semantics: an output cell is a candidate iff its product xy != 0
(the dense-tile proxy for the reference's structural non-zeros,
s_plus.h:112-117). Non-candidates, thresholded and filtered cells are -inf.
"""

from __future__ import annotations

import gc
import math
import sys
from dataclasses import dataclass
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from ..ops.csr import csc_quantized
from ..parallel import mesh as pmesh
from ..utils.device import hbm_budget_bytes, resolve_device
from . import scatter, spans, tile_topk
from .params import PVEC_LEN, SPlusParams, build_pvec
from .preprocess import (
    Preprocessed, _fingerprint, clear_prep_cache, int8_values, prep_cache_counts,
    prep_cache_len,
)
from .tile_topk import split_bf16x3_parts
from .scatter import densify

NEG_INF = float("-inf")

# widest column tile the kernel path plans: the top-k launch sorts a row's
# survivors in shared memory (8 bytes per column)
KERNEL_MAX_TC = 8192

# tile-width search model of an H100 SXM (relative costs only): the
# published f32 FMA peak (K1's f32 SIMT kernel), the published dense bf16
# tensor-core peak (bf16 and each phase of a split mode), an assumed
# per-tile launch cost and an assumed device scatter rate
_SEARCH_RATE = 67e12
_SEARCH_RATE_BF16 = 989e12
_SEARCH_TILE_OVERHEAD_S = 20e-6
_SEARCH_SCATTER_NNZ_PER_S = 1e9

# calls of the k_pad > MAX_KERNEL_K_PAD branch (plain PyTorch per tile)
wide_k_calls = 0

# the geometry the latest call planned and the executor it took
# ("symmetric", "compact" or "general"; "sharded" or "sym_sharded" for a
# mesh call), for diagnostics and measurements
last_plan: dict = {}
last_route: Optional[str] = None

# the exclude-seen fold (_exclude_seen_fold); False keeps the per-row
# filter masks. The port reads no environment variable: this setting takes
# the place of the JAX package's SIMILARIPY_TPU_FOLD_FILTER.
FOLD_FILTER = True


# ---------------------------------------------------------------------------
# Tiling plan
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TilePlan:
    panel_rows: int  # TRP: target rows per panel
    tile_cols: int  # TC: matrix2 columns per tile
    u_pad: int  # padded inner (common) dimension
    n_panels: int
    n_tiles: int


def plan_tiles(
    n_targets: int,
    n_common: int,
    n_cols: int,
    k: int,
    itemsize: int,
    block_size_hint: Optional[int],
    budget_bytes: int,
) -> TilePlan:
    """Choose panel/tile sizes under the device budget (executor.py:132).

    `block_size_hint` carries the reference block_size semantics
    (reference: s_plus.pyx:217-225): None = single tile (blocking disabled),
    0/auto = planner's choice, int > 0 = explicit tile width.
    """
    budget = budget_bytes
    u_pad = max(_round_up(n_common, 128), 128)

    if block_size_hint is None:
        tc = _round_up(n_cols, 128)
    elif block_size_hint and block_size_hint > 0:
        tc = min(_round_up(int(block_size_hint), 8), _round_up(n_cols, 128))
    else:
        # auto: D tile (u_pad x TC) should use at most ~30% of budget
        tc = int((budget * 0.30) // (u_pad * itemsize))
        tc = max(min(_round_up(tc, 128), _round_up(n_cols, 128)), 128)
        tc = min(tc, 8192)

    # panel: M1 dense (TRP x u_pad) + scores (TRP x TC) within ~50% of budget
    per_row = u_pad * itemsize + tc * 4 * 3  # dense row + score tile + topk slack
    trp = int((budget * 0.50) // per_row)
    trp = max(min(_round_up(trp, 8), _round_up(n_targets, 8)), 8)
    trp = min(trp, 32768)

    n_panels = math.ceil(n_targets / trp)
    n_tiles = math.ceil(n_cols / tc)
    return TilePlan(panel_rows=trp, tile_cols=tc, u_pad=u_pad, n_panels=n_panels, n_tiles=n_tiles)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def plan_fused_groups(
    *,
    C: int,
    tc: int,
    u_pad: int,
    trp: int,
    k_pad: int,
    m1_nnz: int,
    m2_nnz: int,
    sel_nnz: int,
    m1_bytes: int,
    tile_item: int,
    budget: int,
    foreign: int,
    n_panels: int,
    search: bool,
    max_tc: int,
    col_shards: int = 1,
    phases: int = 1,
    rate: float = _SEARCH_RATE,
) -> tuple[int, int, int, int]:
    """Choose (tc, n_tiles_padded, g_tiles, n_groups) for the grouped sweep
    (executor.py:175); on a mesh every one of the `col_shards` column
    shards holds n_groups groups of g_tiles tiles.

    With `search`, the column-tile width minimizes a modeled sweep cost over
    candidate widths: empty padded tiles cost full products (`phases`
    products of a split mode at `rate` each, executor.py:239-240) and every
    extra group re-scatters the whole matrix1 panel set, so how C divides
    into tiles matters more than the width itself. Deterministic host
    logic."""

    def group_plan(tc_cand: int):
        n_t = math.ceil(math.ceil(C / tc_cand) / col_shards)  # one shard's tiles
        tile_b = u_pad * tc_cand * tile_item
        # reserve: panel working set + device COO uploads (~12 B/nnz +
        # padding) + one group's selector slice + whole-run carry planes +
        # one tile's densify transient + 1 GB slack
        res = (
            m1_bytes
            + trp * tc_cand * 16
            + int((m1_nnz + m2_nnz) * 12 * 1.8)
            + int(sel_nnz * 8 * 1.8)
            + 2 * n_panels * k_pad * trp * 4
            + u_pad * tc_cand * tile_item
            + (1 << 30)
        )
        g = max(1, int((budget * 0.85 - res - foreign) // tile_b))
        g = min(g, n_t)
        # pad the tile count so every group has exactly g tiles; shrink g
        # to the minimum for the chosen group count
        ng = math.ceil(n_t / g)
        g = math.ceil(n_t / ng)
        return col_shards * ng * g, g, ng

    if search:
        def cost(tc_cand: int):
            _n_tp, g, ng = group_plan(tc_cand)
            prod = n_panels * ng * g * (2.0 * trp * u_pad * tc_cand * phases / rate)
            ovh = n_panels * ng * g * _SEARCH_TILE_OVERHEAD_S
            scat = ng * (m1_nnz + m2_nnz) / _SEARCH_SCATTER_NNZ_PER_S
            return prod + ovh + scat

        c_pad = _round_up(C, 128)
        lo = min(2048, c_pad)
        cands = range(lo, min(max_tc, c_pad) + 1, 128)
        if cands:
            tc = min(reversed(cands), key=cost)  # ties -> wider tile
    n_tiles, g_tiles, n_groups = group_plan(tc)
    return tc, n_tiles, g_tiles, n_groups


def _pad_bucket(n: int, minimum: int = 1024) -> int:
    """Eighth-octave size buckets (<= 12.5% padding), as in the reference,
    so staged arrays keep a few distinct shapes."""
    n = max(n, minimum)
    step = 1 << max(n.bit_length() - 4, 0)
    return ((n + step - 1) // step) * step


# ---------------------------------------------------------------------------
# Device tiles
# ---------------------------------------------------------------------------


def compute_cast(compute_dtype: str):
    """Tile storage dtype for a compute mode (K1 accumulates f32, or int32
    for int8).

    'int8' is the exact-quantization path: (scaled) small integers
    accumulate exactly in int32 and `inv_scale` (pvec[9]) restores the
    magnitude. 'int4' is stored as int8, as the reference does in effect
    (its int4 branch at executor.py:289 can never run)."""
    if compute_dtype == "bfloat16":
        return torch.bfloat16
    if compute_dtype in ("int8", "int4"):
        return torch.int8
    return torch.float32


def scatter_mask(shape, rows, cols):
    """A uint8 membership mask (1 at each in-range (row, col))."""
    keep = rows < shape[0]
    flat = rows[keep].to(torch.int64) * shape[1] + cols[keep].to(torch.int64)
    out = torch.zeros(shape[0] * shape[1], dtype=torch.uint8, device=rows.device)
    out.index_put_((flat,), torch.ones_like(flat, dtype=torch.uint8))
    return out.view(shape)


# ---------------------------------------------------------------------------
# Host orchestration
# ---------------------------------------------------------------------------


def _expand_ranges(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Concatenate [s, s+c) ranges into one index vector, vectorized."""
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    ends = np.cumsum(counts)
    out = np.repeat(starts - np.concatenate([[0], ends[:-1]]), counts)
    return out + np.arange(total, dtype=np.int64)


def _extract_cols_coo(csc, cols_old: np.ndarray):
    """(row_idx, local_col_idx, data_positions) of csc[:, cols_old]."""
    starts = csc.indptr[cols_old].astype(np.int64)
    counts = (csc.indptr[cols_old + 1] - csc.indptr[cols_old]).astype(np.int64)
    pos = _expand_ranges(starts, counts)
    rows = csc.indices[pos]
    local = np.repeat(np.arange(cols_old.shape[0], dtype=np.int32), counts)
    return rows, local, pos


def balance_columns(col_nnz: np.ndarray, n_tiles: int, tc: int):
    """Round-robin columns over tiles by popularity rank (executor.py:1028;
    reference: s_plus_utils.pyx:493-618), so every tile's padded COO sits
    near the mean nnz.

    Returns (tile_lists, col_map): tile_lists[t] are the original column
    ids of tile t; col_map maps device flat id (t*tc + slot) back to the
    original column (sentinel len(col_nnz) for unused slots)."""
    C = col_nnz.shape[0]
    rank = np.argsort(-col_nnz, kind="stable")
    tile_lists = [rank[t::n_tiles] for t in range(n_tiles)]
    col_map = np.full(n_tiles * tc, C, dtype=np.int64)
    for t, cols in enumerate(tile_lists):
        col_map[t * tc : t * tc + cols.shape[0]] = cols
    return tile_lists, col_map


def _stack_m2_tiles_balanced(m2_csc, tile_lists, tc: int, u_pad: int):
    """Per-tile padded COO of the balanced column layout."""
    n_tiles = len(tile_lists)
    parts = [_extract_cols_coo(m2_csc, cols) for cols in tile_lists]
    p2 = _pad_bucket(max((p[0].shape[0] for p in parts), default=1))
    rows = np.full((n_tiles, p2), u_pad, dtype=np.int32)
    cols = np.zeros((n_tiles, p2), dtype=np.int32)
    vals = np.zeros((n_tiles, p2), dtype=np.float32)
    for t, (r, local, pos) in enumerate(parts):
        n = r.shape[0]
        rows[t, :n] = r
        cols[t, :n] = local
        vals[t, :n] = m2_csc.data[pos]
    return rows, cols, vals


def _stack_selector_tiles_balanced(sel_csc, tile_lists, tc: int, trp: int, pf: int):
    """Per-tile padded COO (mask positions) of a selector's panel rows under
    the balanced column layout; `pf` is the shared pad bucket."""
    n_tiles = len(tile_lists)
    parts = [_extract_cols_coo(sel_csc, cols) for cols in tile_lists]
    rows = np.full((n_tiles, pf), trp, dtype=np.int32)
    cols = np.zeros((n_tiles, pf), dtype=np.int32)
    for t, (r, local, _pos) in enumerate(parts):
        n = r.shape[0]
        rows[t, :n] = r
        cols[t, :n] = local
    return rows, cols


def _selector_pf(sel_t, panel_sels, col_map, tc: int, C: int, n_tiles: int) -> int:
    """Shared selector pad bucket: the max per-(panel, tile) nnz."""
    col_tile = np.zeros(C, np.int32)
    used = col_map < C
    col_tile[col_map[used]] = (np.flatnonzero(used) // tc).astype(np.int32)
    mx = 1
    for sel in panel_sels:
        idx = sel_t[sel].indices
        if idx.shape[0]:
            mx = max(mx, int(np.bincount(col_tile[idx], minlength=n_tiles).max()))
    return _pad_bucket(mx, minimum=256)


def _vec_by_map(v: Optional[np.ndarray], col_map: np.ndarray, n_cols: int,
                fill: float = 1.0) -> np.ndarray:
    """Reindex a per-column vector into the balanced device layout."""
    out = np.full(col_map.shape[0], fill, dtype=np.float32)
    if v is not None:
        used = col_map < n_cols
        out[used] = np.asarray(v, dtype=np.float32)[col_map[used]]
    return out


def _pad_vec(v: Optional[np.ndarray], n: int, fill: float = 1.0) -> np.ndarray:
    out = np.full(n, fill, dtype=np.float32)
    if v is not None:
        out[: v.shape[0]] = v
    return out


def resolve_compute_dtype(requested: str, pre: Preprocessed) -> tuple[str, float]:
    """Resolve 'auto' to the exact int8 path when the data allows it
    (executor.py:1167). Returns (compute_dtype, inv_scale).

    int8 is chosen when both matrices hold small integers after a
    power-of-two scaling and the worst-case dot product fits int32: every
    xy is then accumulated exactly."""
    s1, s2 = pre.qscale1, pre.qscale2
    if requested == "int8":
        if s1 is None or s2 is None:
            raise ValueError(
                "compute_dtype='int8' requires data integerizable to |v|<=127 "
                "after a power-of-two scaling; use 'auto' to fall back safely"
            )
        return "int8", 1.0 / (s1 * s2)
    if requested == "int4":
        if s1 is None or s2 is None:
            raise ValueError(
                "compute_dtype='int4' requires integerizable data with "
                "|v| <= 7 after scaling (binary/small-count matrices)"
            )
        return "int8", 1.0 / (s1 * s2)  # stored and multiplied as int8
    if requested != "auto":
        return requested, 1.0
    if s1 is None or s2 is None:
        return "float32", 1.0
    m1, m2 = pre.m1, pre.m2
    # judged on the densified values: repeated entries sum (int8_values)
    maxv1 = float(np.abs(int8_values(m1)).max()) * s1 if m1.nnz else 0.0
    maxv2 = float(np.abs(int8_values(m2)).max()) * s2 if m2.nnz else 0.0
    max_row_nnz1 = int(np.diff(m1.indptr).max()) if m1.nnz else 0
    if m2.nnz == 0:
        max_col_nnz2 = 0
    elif sp.issparse(m2) and m2.format == "csc":
        max_col_nnz2 = int(np.diff(m2.indptr).max())
    else:
        max_col_nnz2 = int(np.bincount(m2.indices, minlength=m2.shape[1]).max())
    overlap = min(max_row_nnz1, max_col_nnz2)
    if maxv1 * maxv2 * max(overlap, 1) >= 2.0**30:
        return "float32", 1.0
    return "int8", 1.0 / (s1 * s2)


# ---------------------------------------------------------------------------
# precision='high': the split-bf16x3 modes (executor.py:330-395)
# ---------------------------------------------------------------------------

_BF16_EXACT_CACHE: dict = {}

# the products of each mode, for the planner (executor.py:239)
SPLIT_PHASES = {None: 1, "rhs": 2, "lhs": 2, "both": 3}


def _bf16_exact(fp, m) -> bool:
    """True when every value a densify of `m` holds is exactly
    bf16-representable: its entries and the sums of its repeated entries
    (preprocess.int8_values), judged on their f32 values in PyTorch.
    Integer ratings, binary interactions and counts up to 256 qualify.
    Memoised by the content fingerprint `fp`."""
    hit = _BF16_EXACT_CACHE.get(fp)
    if hit is None:
        v = torch.from_numpy(np.ascontiguousarray(int8_values(m), dtype=np.float32))
        hit = bool(torch.equal(v.to(torch.bfloat16).to(torch.float32), v))
        if len(_BF16_EXACT_CACHE) > 64:
            _BF16_EXACT_CACHE.pop(next(iter(_BF16_EXACT_CACHE)))
        _BF16_EXACT_CACHE[fp] = hit
    return hit


def _select_f32x3_mode(pre, m1, m2, compute_dtype: str, precision: str):
    """(compute_dtype, f32x3) of a grouped call (executor.py:355).

    An f32 call with precision='high' runs K1 in a split-bf16x3 mode, the
    product XLA's HIGH computes: 'both' (3 phases, hi.hi + lo.hi + hi.lo)
    when both matrices are float; 'rhs' (2 phases) when matrix1 is exact
    in bf16, so its lo half is zero (a scoring call on integer ratings);
    'lhs' when matrix2 is. When both are exact, one plain bf16 phase is
    already exact in f32: the call rides compute_dtype='bfloat16'. Every
    other call keeps its compute type and f32x3 None. 'default' stays true
    f32 (a minimum, as the JAX package on a CPU gives it). The choice
    reads the whole of both matrices, which every rank of a mesh holds, so
    all ranks agree."""
    if not (compute_dtype == "float32" and precision == "high"):
        return compute_dtype, None
    m1_exact = _bf16_exact(pre.fp1, m1)
    m2_exact = _bf16_exact(pre.fp2, m2)
    if m1_exact and m2_exact:
        return "bfloat16", None
    return compute_dtype, "rhs" if m1_exact else ("lhs" if m2_exact else "both")


def _d_split(f32x3):
    """The tile side (matrix2) of a split mode (executor.py:385): its
    [hi; lo] stack for 'both'/'rhs', a plain bf16 tile for 'lhs' (exact in
    bf16), None otherwise."""
    return "split" if f32x3 in ("both", "rhs") else "cast" if f32x3 == "lhs" else None


def canonical(m):
    """`m` with its repeated entries summed (a copy), or `m` itself when it
    has none: a split densify adds the hi and lo halves of each entry, and
    the split of a sum is not the sum of the splits."""
    if m.has_canonical_format:
        return m
    m = m.copy()
    m.sum_duplicates()
    return m


def split_coo(rows, cols, vals, n: int, axis: int):
    """The COO of the split_bf16x3 stack of a (.., n)-deep f32 COO along
    `axis` (0: rows, 1: columns), without its dense f32 form: each value's
    hi half stays at its place, its lo half moves n further along `axis`,
    both as f32 values that bf16 holds exactly, so a bf16 densify of the
    result over 2n equals split_bf16x3 of the f32 densify, bit for bit,
    when no place repeats. Entries already out of range along `axis` (>= n:
    the tile stacks' padding sentinels) move to 2n, still out of range.
    NumPy arrays of any leading shape; the halves are concatenated along
    the last axis."""
    hi, lo = split_bf16x3_parts(torch.from_numpy(np.ascontiguousarray(vals, dtype=np.float32)))
    hi, lo = hi.to(torch.float32).numpy(), lo.to(torch.float32).numpy()
    if axis == 0:
        real = rows < n
        rows = np.concatenate([np.where(real, rows, 2 * n), np.where(real, rows + n, 2 * n)], -1)
        cols = np.concatenate([cols, cols], -1)
    else:
        real = cols < n
        rows = np.concatenate([rows, rows], -1)
        cols = np.concatenate([np.where(real, cols, 2 * n), np.where(real, cols + n, 2 * n)], -1)
    return rows.astype(np.int32), cols.astype(np.int32), np.concatenate([hi, lo], -1)


# ---------------------------------------------------------------------------
# Exclude-seen fold (executor.py:379-483)
# ---------------------------------------------------------------------------


def _apply_fold(m2_csc, fold_M: float, C: int):
    """m2 - M*I for the exclude-seen fold (see _exclude_seen_fold)."""
    eye = sp.csc_array(sp.identity(C, dtype=np.float32, format="csc"))
    return sp.csc_array(m2_csc - fold_M * eye)


_FOLD_STAT_CACHE: dict = {}


def _exclude_seen_fold(pre, m1, m2, params, compute_dtype, C):
    """Penalty magnitude for the exclude-seen filter fold, or None.

    ``dot_product(urm, W.T, filter_cols=urm)`` (the recommend idiom) drops
    its per-row filter masks by scoring with ``m2' = m2 - M*I``: each seen
    cell picks up an extra ``-M*r(u,j)`` in the contraction (r > 0), which
    pushes it below any threshold >= 0, while an unseen cell adds
    ``0 * (w_jj - M) == 0``, exact in float. No selector tiles are staged
    and K1 runs without a filter mask.

    Exactness gate (every condition is needed):
      - the filter's sparsity pattern equals m1's and m2 is square, so the
        diagonal pairs contraction item i with output item j;
      - the epilogue is ``val = xy`` (no denominator, no pow, no bayes):
        with those terms a huge negative xy need not stay below the
        threshold;
      - threshold >= 0, so the penalized cells (|xy| >= 3/4 * M * r > 0)
        are pruned;
      - m1.data > 0, so the penalty has the right sign;
      - a float compute type (M cannot ride the int8 quantization);
      - M * max(r) * 4 stays finite in f32, and M is a power of two, so
        bf16 carries it exactly.

    ``FOLD_FILTER = False`` turns it off (the masked path is always
    available and exact)."""
    fm = pre.filter_matrix
    if (
        not FOLD_FILTER
        or fm is None
        or compute_dtype not in ("float32", "bfloat16")
        or params.use_denominator
        or params.use_bayes
        or params.use_pow
        or params.threshold < 0.0
        or m1.nnz == 0
        or m2.shape[0] != m2.shape[1]
        or C != m2.shape[1]
        or fm.shape != m1.shape
        or fm.nnz != m1.nnz
    ):
        return None
    # pattern identity, checked on every call (a content memo would need
    # its own fingerprint pass)
    if not (np.array_equal(fm.indptr, m1.indptr) and np.array_equal(fm.indices, m1.indices)):
        return None
    key = (pre.fp1, pre.fp2, "fold_M")
    M = _FOLD_STAT_CACHE.get(key)
    if M is None:
        rmin = float(m1.data.min())
        if rmin <= 0.0:
            M = 0.0
        else:
            max_rowsum = float(np.abs(m1).sum(axis=1).max())
            max_w = float(np.abs(m2.data).max()) if m2.nnz else 0.0
            # 4x the largest possible |score| over the smallest rating,
            # rounded up to a power of two
            bound = 4.0 * max_rowsum * max(max_w, 1.0) / rmin
            if not (bound < 2.0 ** 100):  # catches inf and nan too
                # a pathological dynamic range (a ~1e-35 rating): a safe
                # penalty would overflow f32, and 0 * inf = nan would poison
                # every unseen cell; take the masked path
                M = 0.0
            else:
                M = 2.0 ** math.ceil(math.log2(max(bound, 2.0 ** 20)))
                max_r = float(m1.data.max())
                if not np.isfinite(np.float32(M * max_r * 4.0)):
                    M = 0.0
        if len(_FOLD_STAT_CACHE) > 64:
            _FOLD_STAT_CACHE.pop(next(iter(_FOLD_STAT_CACHE)))
        _FOLD_STAT_CACHE[key] = M
    return M if M > 0.0 else None


def _wide_k_tile(*args, **kwargs):
    """One tile of the k_pad > MAX_KERNEL_K_PAD branch: plain PyTorch, as
    the reference hands k_pad > 1024 from its kernel to XLA
    (executor.py:1416-1425). Counted apart from K1's two routes."""
    global wide_k_calls
    wide_k_calls += 1
    return tile_topk._plain(*args, **kwargs)


def _run_group_panels(panels, d_stack, group, pvec, carries, *, flags, k_pad,
                      trp, panel_k, cdt, int8_mode, tile_fn, f32x3=None):
    """All panels x the group's resident tiles (executor.py:622): densify
    each panel (`panel_k` wide: 2 u_pad for a split stack), then feed every
    tile through `tile_fn` with the panel's carried top-k_pad, which the
    call returns merged."""
    tc = d_stack.shape[2]
    for p, (pr, pc, pv, x_t, x_c, x_d) in enumerate(panels):
        m1_dense = densify((trp, panel_k), pr, pc, pv, cdt)
        for j in range(d_stack.shape[0]):
            fmask = tmask = None
            if "fil_rows" in group:
                fmask = scatter_mask((trp, tc), group["fil_rows"][p, j], group["fil_cols"][p, j])
            if "tgt_rows" in group:
                tmask = scatter_mask((trp, tc), group["tgt_rows"][p, j], group["tgt_cols"][p, j])
            pvec_ext = torch.cat([pvec, group["col_offset"][j], pvec.new_zeros(PVEC_LEN - 11)])
            carries[p] = tile_fn(
                m1_dense, d_stack[j], x_t, x_c, x_d,
                group["y_t"][j], group["y_c"][j], group["y_d"][j], pvec_ext,
                allowed=group["allowed"][j] if "allowed" in group else None,
                fmask=fmask, tmask=tmask, carry=carries[p],
                flags=flags, k_pad=k_pad, int8_mode=int8_mode, split_f32=f32x3 or False,
            )


def execute(
    pre: Preprocessed,
    params: SPlusParams,
    *,
    block_size_hint: Optional[int] = 0,
    compute_dtype: str = "float32",
    precision: str = "highest",
    budget_bytes: Optional[int] = None,
    progress=None,
    device="cuda",
    _tile_fn: str = "kernel",
):
    """Run the tiled similarity; returns host (T, k) vals f32 and idx int32.

    A device out-of-memory error drops the device cache and replans the
    call once from scratch with a 25% smaller budget
    (executor.py:1245-1306). Only ``torch.cuda.OutOfMemoryError`` triggers
    it; ``cache_info()["oom_retries"]`` counts the retries. `_tile_fn="plain"`
    runs the kernels' plain PyTorch versions even on a card (for comparisons
    only)."""
    global _oom_retries
    device = resolve_device(device)
    if budget_bytes is None:
        budget_bytes = default_budget(device)
    kwargs = dict(
        block_size_hint=block_size_hint, compute_dtype=compute_dtype,
        precision=precision, progress=progress, device=device, tile_fn=_tile_fn,
    )
    try:
        return _execute_impl(pre, params, budget_bytes=budget_bytes, **kwargs)
    except torch.cuda.OutOfMemoryError:
        _oom_retries += 1
        retry_budget = int(budget_bytes * 0.75)
        print(
            f"# similaripy_tpu_torch: device OOM — replanning once with a "
            f"smaller device budget ({retry_budget >> 20} MB)",
            file=sys.stderr, flush=True,
        )
    # outside the except block, so the failed attempt's frames (and the
    # device buffers they hold) are released before the retry
    clear_device_cache()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if progress is not None and hasattr(progress, "reset"):
        progress.reset()
    return _execute_impl(pre, params, budget_bytes=retry_budget, **kwargs)


def default_budget(device: torch.device) -> int:
    """The device bytes a call may plan with. On a card the free memory
    does not count what the cache holds, but the planners budget the
    call's own cached uploads in their reserves and subtract the other
    matrices' (``foreign_cache_bytes``), so those bytes are added back."""
    budget = hbm_budget_bytes(device)
    if device.type == "cuda":
        budget += _device_bytes(list(_DEVICE_CACHE.values()))
    return budget


def _execute_impl(
    pre: Preprocessed,
    params: SPlusParams,
    *,
    block_size_hint: Optional[int],
    compute_dtype: str,
    precision: str,
    budget_bytes: int,
    progress,
    device: torch.device,
    tile_fn: str,
):
    """Plan and run one attempt (see execute). `precision` is a minimum
    guarantee: 'high' on f32 runs the split-bf16x3 modes on the grouped and
    the symmetric routes (_select_f32x3_mode), true f32 on the compaction
    route (as compact.py runs HIGH as HIGHEST); 'highest' and 'default'
    run true f32."""
    global last_route
    if precision not in ("highest", "high", "default"):
        raise ValueError(f"precision must be 'highest', 'high' or 'default', got {precision!r}")
    if tile_fn not in ("kernel", "plain"):
        raise ValueError(f"_tile_fn must be 'kernel' or 'plain', got {tile_fn!r}")
    last_route = None
    m1, m2, targets, k = pre.m1, pre.m2, pre.targets, pre.k
    T = targets.shape[0]
    U = m1.shape[1]
    C = pre.n_output_cols

    if T == 0 or k == 0:
        return (
            np.full((T, max(k, 1)), NEG_INF, np.float32),
            np.zeros((T, max(k, 1)), np.int32),
        )

    from .symmetric import execute_symmetric, symmetric_eligible

    if symmetric_eligible(pre, params, block_size_hint):
        # self-similarity: the upper-triangle blocked executor, about half
        # the products and no separate matrix1 staging (symmetric.py)
        last_route = "symmetric"
        return execute_symmetric(
            pre, params, compute_dtype=compute_dtype, precision=precision,
            budget_bytes=budget_bytes, progress=progress, device=device, tile_fn=tile_fn,
        )
    from .compact import compact_eligible, execute_compact

    if compact_eligible(pre, k, device):
        # a union-compacted inner dimension per panel: the hot prefix
        # through a library product, the cold rows gathered (compact.py)
        last_route = "compact"
        return execute_compact(
            pre, params, compute_dtype=compute_dtype, budget_bytes=budget_bytes,
            progress=progress, device=device, tile_fn=tile_fn,
        )
    last_route = "general"
    return execute_grouped(
        pre, params, block_size_hint=block_size_hint, compute_dtype=compute_dtype,
        precision=precision, budget_bytes=budget_bytes, progress=progress, device=device,
        tile_fn=tile_fn,
    )


def execute_grouped(
    pre: Preprocessed,
    params: SPlusParams,
    *,
    block_size_hint: Optional[int],
    compute_dtype: str,
    budget_bytes: int,
    progress,
    device: torch.device,
    precision: str = "highest",
    tile_fn: str = "kernel",
    mesh=None,
):
    """The grouped sweep; returns host (T, k) vals f32 and idx int32.

    An f32 call with precision='high' runs K1 in the split-bf16x3 mode that
    `_select_f32x3_mode` picks (its name in last_plan["f32x3"]).

    With `mesh` (``parallel.make_mesh``; sharded.py:434 of the JAX package)
    target-row panels are dealt over the 'rows' dimension and matrix2's
    column tiles over 'cols': this rank stages its panels and its own tile
    range and runs the same sweep over them, on the budget agreed over
    ranks. The top-k partials are then all-gathered over 'cols' and
    re-selected, then gathered over 'rows', and every rank returns the
    whole result. With no mesh the one device holds every panel and tile."""
    m1, m2, targets, k = pre.m1, pre.m2, pre.targets, pre.k
    T = targets.shape[0]
    U = m1.shape[1]
    C = pre.n_output_cols
    R_sh, C_sh = pmesh.axis_sizes(mesh)
    r_me, c_me = pmesh.coordinate(mesh)
    T_sh = math.ceil(T / R_sh)  # one row shard's target rows

    compute_dtype, inv_scale = resolve_compute_dtype(compute_dtype, pre)
    # the first plan sizes the f32 call, as the reference's (executor.py:1358)
    plan_item = torch.empty(0, dtype=compute_cast(compute_dtype)).element_size()
    compute_dtype, f32x3 = _select_f32x3_mode(pre, m1, m2, compute_dtype, precision)
    cdt = compute_cast(compute_dtype)
    # exclude-seen fold: the recommend idiom's per-row filter becomes
    # matmul algebra (m2 - M*I): no selector tiles and no filter masks
    fold_M = _exclude_seen_fold(pre, m1, m2, params, compute_dtype, C)
    # every rank plans with the smallest budget and the largest foreign
    # cache, so all plan the same geometry and join the same collectives
    budget, neg_foreign = pmesh.agree_min(
        (budget_bytes, -foreign_cache_bytes((pre.fp1, pre.fp2))), mesh
    )
    plan = plan_tiles(T_sh, U, C, k, plan_item, block_size_hint, budget)
    trp, tc, u_pad = plan.panel_rows, plan.tile_cols, plan.u_pad

    # carry planes accumulate across ALL tiles, so their depth is k
    # (clamped to the catalog), not one tile's width
    k_pad = _round_up(min(k, C), 8)
    wide = k_pad > tile_topk.MAX_KERNEL_K_PAD
    if wide:
        f32x3 = None  # the plain branch multiplies in true f32 (executor.py:1423)
        k_pad = k
        step = _wide_k_tile
    elif tile_fn == "plain":
        step = tile_topk.fused_tile_topk_plain
    else:
        step = tile_topk.fused_tile_topk
    densify_group = (
        scatter.densify_tiles_plain if tile_fn == "plain" else scatter.densify_tiles
    )
    # smaller panels leave more memory for resident tile groups (each extra
    # group re-scatters matrix1), so cap the panel height
    trp = min(trp, 2048)
    tc = _round_up(min(tc, KERNEL_MAX_TC, _round_up(C, 128)), 128)

    # bytes an element of a panel and of a tile (executor.py:1431-1438): a
    # split stack is two bf16 halves, the exact side of 'rhs' / 'lhs' one
    dense_item = torch.empty(0, dtype=cdt).element_size()
    panel_item = 2 if f32x3 == "rhs" else dense_item
    tile_item = 2 if f32x3 == "lhs" else dense_item
    split_cdt = torch.bfloat16 if f32x3 else cdt  # what K5 and the panel densify store
    m1_bytes = trp * u_pad * panel_item
    # the filter's nnz stays in the reserve when the fold drops its masks,
    # so a folded call plans the masked call's geometry
    sel_nnz = (
        (pre.filter_matrix.nnz if pre.filter_matrix is not None else 0)
        + (pre.target_matrix.nnz if pre.target_matrix is not None else 0)
    )
    n_panels = math.ceil(T_sh / trp)  # panels of one row shard
    tc, n_tiles, g_tiles, n_groups = plan_fused_groups(
        C=C, tc=tc, u_pad=u_pad, trp=trp, k_pad=k_pad,
        m1_nnz=m1.nnz, m2_nnz=m2.nnz, sel_nnz=sel_nnz,
        m1_bytes=m1_bytes, tile_item=tile_item, budget=budget,
        foreign=-neg_foreign, n_panels=n_panels,
        search=compute_dtype in ("bfloat16", "float32") and block_size_hint == 0,
        max_tc=KERNEL_MAX_TC, col_shards=C_sh, phases=SPLIT_PHASES[f32x3],
        rate=_SEARCH_RATE if compute_dtype == "float32" and not f32x3 else _SEARCH_RATE_BF16,
    )
    n_own = n_groups * g_tiles
    base = c_me * n_own  # this column shard's tiles: [base, base + n_own)

    last_plan.clear()
    last_plan.update(
        compute_dtype=compute_dtype, trp=trp, tc=tc, u_pad=u_pad, k_pad=k_pad,
        n_panels=n_panels, n_tiles=n_tiles, g_tiles=g_tiles, n_groups=n_groups,
        fold=fold_M, f32x3=f32x3, mesh=(R_sh, C_sh), coordinate=(r_me, c_me), budget=budget,
        # this rank's launches: K1 once per (panel, own tile), K5 per group
        k1_launches=n_panels * n_own, k5_launches=n_groups,
    )

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    # ---- matrix2 tiles: balanced round-robin column layout, cached ----
    int8_mode = compute_dtype in ("int8", "int4")
    d_split = _d_split(f32x3)
    m2_key = (
        "m2", pre.fp2, _fingerprint(pre.Yt, pre.Yc, pre.Yd, pre.col_allowed),
        compute_dtype, d_split, tc, n_tiles, u_pad, fold_M, base, n_own, str(device),
    )
    cached = _cache_get(m2_key)
    if cached is None:
        with spans.span("stage") as stage:
            _evict_stale("m2", pre.fp2, m2_key)
            m2_csc = csc_quantized(m2, pre.qscale2 if int8_mode else None)
            if fold_M is not None:
                m2_csc = _apply_fold(m2_csc, fold_M, C)
            if f32x3:
                m2_csc = canonical(m2_csc)
            tile_lists, col_map = balance_columns(np.diff(m2_csc.indptr), n_tiles, tc)
            own_lists = tile_lists[base:base + n_own]
            coo = _stack_m2_tiles_balanced(m2_csc, own_lists, tc, u_pad)
            if d_split == "split":  # the [hi; lo] stacks, 2 u_pad deep
                coo = split_coo(*coo, u_pad, axis=0)
            m2_coo = tuple(dev(a) for a in coo)

            def own_tiles(v):
                return dev(v.reshape(n_tiles, -1)[base:base + n_own])

            tiles_common = {
                name: own_tiles(_vec_by_map(v, col_map, C))
                for name, v in (("y_t", pre.Yt), ("y_c", pre.Yc), ("y_d", pre.Yd))
            }
            tiles_common["col_offset"] = own_tiles(np.arange(n_tiles, dtype=np.float32) * tc)
            if pre.col_allowed is not None:
                allowed = np.zeros(col_map.shape[0], dtype=np.uint8)
                used = col_map < C
                allowed[used] = pre.col_allowed[col_map[used]]
                tiles_common["allowed"] = own_tiles(allowed)
            cached = (m2_coo, tiles_common, col_map, own_lists)
            _stage_put(stage, m2_key, cached)
    m2_coo, tiles_common, col_map, own_lists = cached
    t_rows, t_cols, t_vals = m2_coo

    # ---- matrix1 panels: target rows dealt round-robin by nnz rank over
    # (panel, row shard) slots; this rank stages its row shard's panels ----
    a_split = f32x3 in ("both", "lhs")  # the panel side is a [hi; lo] stack
    m1_key = (
        "m1", pre.fp1, _fingerprint(targets, pre.Xt, pre.Xc, pre.Xd),
        compute_dtype, f32x3, u_pad if a_split else None, trp, n_panels, R_sh, r_me,
        str(device),
    )
    cached = _cache_get(m1_key)
    if cached is None:
        with spans.span("stage") as stage:
            _evict_stale("m1", pre.fp1, m1_key)
            m1_t = m1[targets]
            if int8_mode:
                m1_t.data = np.rint(m1_t.data * pre.qscale1).astype(np.float32)
            if f32x3:
                m1_t = canonical(m1_t)
            n_slots = n_panels * R_sh
            order = np.argsort(-np.diff(m1_t.indptr), kind="stable")
            slot_sel = [order[s::n_slots] for s in range(n_slots)]
            panels = []
            for p in range(n_panels):
                sel = slot_sel[p * R_sh + r_me]
                panel = m1_t[sel]
                tgt = targets[sel]
                pr = np.repeat(np.arange(sel.shape[0], dtype=np.int32), np.diff(panel.indptr))
                coo = (pr, panel.indices.astype(np.int32), panel.data)
                if a_split:  # the [hi; lo] stack, 2 u_pad wide
                    coo = split_coo(*coo, u_pad, axis=1)
                vecs = [
                    _pad_vec(v[tgt] if v is not None else None, trp)
                    for v in (pre.Xt, pre.Xc, pre.Xd)
                ]
                panels.append((*map(dev, coo), *map(dev, vecs)))
            cached = (panels, slot_sel)
            _stage_put(stage, m1_key, cached)
    panels, slot_sel = cached
    panel_sel = [slot_sel[p * R_sh + r_me] for p in range(n_panels)]

    # ---- per-panel selector tiles (host-resident, uploaded per group) ----
    # a folded filter stages nothing
    fil_matrix = pre.filter_matrix if fold_M is None else None
    sel_stacked = {}
    if fil_matrix is not None or pre.target_matrix is not None:
        def mat_fp(mat):
            return None if mat is None else _fingerprint(mat.data, mat.indices, mat.indptr)

        sel_key = (
            "sel", pre.fp1, pre.fp2, _fingerprint(targets),
            mat_fp(fil_matrix), mat_fp(pre.target_matrix),
            compute_dtype, trp, tc, n_tiles, u_pad, n_panels, R_sh, r_me, base, n_own,
        )
        cached = _cache_get(sel_key)
        if cached is None:
            with spans.span("stage") as stage:
                _evict_stale("sel", pre.fp1, sel_key)
                for name, mat in (("fil", fil_matrix), ("tgt", pre.target_matrix)):
                    if mat is None:
                        continue
                    sel_t = mat[targets]
                    pf = _selector_pf(sel_t, panel_sel, col_map, tc, C, n_tiles)
                    stacks = [
                        _stack_selector_tiles_balanced(sel_t[sel].tocsc(), own_lists, tc, trp, pf)
                        for sel in panel_sel
                    ]
                    sel_stacked[f"{name}_rows"] = np.stack([s[0] for s in stacks])
                    sel_stacked[f"{name}_cols"] = np.stack([s[1] for s in stacks])
                _stage_put(stage, sel_key, sel_stacked)
        else:
            sel_stacked = cached

    pvec = dev(build_pvec(params, inv_scale))
    carries = [
        (
            torch.full((k_pad, trp), NEG_INF, dtype=torch.float32, device=device),
            torch.zeros((k_pad, trp), dtype=torch.int32, device=device),
        )
        for _ in range(n_panels)
    ]
    for g in range(n_groups):
        t0, t1 = g * g_tiles, (g + 1) * g_tiles
        d_stack = None  # release the previous group before the next lands
        d_stack = densify_group(
            t_rows[t0:t1], t_cols[t0:t1], t_vals[t0:t1],
            u_pad=2 * u_pad if d_split == "split" else u_pad, tc=tc, cdt=split_cdt,
        )
        group = {name: arr[t0:t1] for name, arr in tiles_common.items()}
        for name, arr in sel_stacked.items():
            group[name] = dev(arr[:, t0:t1])
        _run_group_panels(
            panels, d_stack, group, pvec, carries,
            flags=params.static_flags(), k_pad=k_pad, trp=trp,
            panel_k=2 * u_pad if a_split else u_pad, cdt=split_cdt, int8_mode=int8_mode,
            tile_fn=step, f32x3=f32x3,
        )
        if progress is not None:
            done = T if g == n_groups - 1 else (T * (g + 1)) // n_groups
            progress.update(done - (T * g) // n_groups)
    del d_stack

    # ---- on a mesh: merge over 'cols', then gather every row shard ----
    k_out = min(k, k_pad)
    vals = torch.stack([c[0] for c in carries]).transpose(1, 2)[:, :, :k_out]
    idx = torch.stack([c[1] for c in carries]).transpose(1, 2)[:, :, :k_out]
    vals, idx = pmesh.merge_topk(vals, idx, mesh, k_out, "cols")
    out_vals = np.full((T, k), NEG_INF, np.float32)
    out_idx = np.zeros((T, k), np.int32)
    for r, (v, i) in enumerate(pmesh.gather_rows(vals, idx, mesh)):
        v, i = v.cpu().numpy(), i.cpu().numpy()
        for p in range(n_panels):
            sel = slot_sel[p * R_sh + r]
            out_vals[sel, :k_out] = v[p, : sel.shape[0]]
            out_idx[sel, :k_out] = i[p, : sel.shape[0]]

    # device column ids are balanced-layout slots; map back to originals.
    # -inf slots carry arbitrary ids (incl. unused-slot sentinels) and are
    # dropped downstream in assembly, so a blanket map is safe.
    out_idx = col_map[out_idx].astype(np.int32)
    return out_vals, out_idx


# ---------------------------------------------------------------------------
# Device-resident input cache (executor.py:760-941)
# ---------------------------------------------------------------------------
#
# Production retrieval calls the engine again and again on the same
# matrices (every scoring batch reuses the item matrix). Both executors
# keep their device uploads here under full-content fingerprints, so a
# repeated call skips the host staging and the upload, and an in-place
# mutation of an input is always seen. Keys are tuples whose first entry
# is the kind: "m2" tile stacks, "m1" panel uploads and "sel" host-resident
# selector stacks of the general executor, "sym_coo" stackings of the
# symmetric executor, "compact_m1" panel stacks and "compact_m2" tile COOs
# of the compaction executor.

_DEVICE_CACHE: dict = {}
# m1 panels + m2 tiles + selector stacks of a scoring call take 3 slots
# next to a model build's COO entry; 8 keeps a two-model pipeline from
# thrashing. Device bytes are handled by the planners through
# foreign_cache_bytes, not by this count.
_DEVICE_CACHE_CAP = 8

# host-resident entries (the "sel" stacks are NumPy arrays) are bounded by
# bytes, not count: foreign_cache_bytes ignores host memory, so nothing
# else prunes them
_HOST_CACHE_MAX_BYTES = 2048 << 20

_MISS = object()

# lookups by kind since the last clear_caches(), and the OOM retries of
# execute(), for cache_info()
_CACHE_COUNTS: dict = {}
_oom_retries = 0


def _kind(key) -> str:
    return key[0] if isinstance(key, tuple) and key else "?"


def _cache_get(key):
    value = _DEVICE_CACHE.pop(key, _MISS)
    counts = _CACHE_COUNTS.setdefault(_kind(key), {"hits": 0, "misses": 0})
    if value is _MISS:
        counts["misses"] += 1
        return None
    counts["hits"] += 1
    _DEVICE_CACHE[key] = value  # reinsert at the end: eviction is LRU
    return value


def _leaves(value):
    stack = [value]
    while stack:
        v = stack.pop()
        if isinstance(v, dict):
            stack.extend(v.values())
        elif isinstance(v, (list, tuple)):
            stack.extend(v)
        else:
            yield v


def _host_bytes(value) -> int:
    return sum(v.nbytes for v in _leaves(value) if isinstance(v, np.ndarray))


def _device_bytes(value) -> int:
    """Bytes of the tensors in `value` (on whatever device they live: the
    tests' CPU tensors count as the device's, as JAX's CPU arrays do)."""
    return sum(
        v.numel() * v.element_size() for v in _leaves(value) if isinstance(v, torch.Tensor)
    )


def _cache_put(key, value):
    if len(_DEVICE_CACHE) >= _DEVICE_CACHE_CAP:
        _DEVICE_CACHE.pop(next(iter(_DEVICE_CACHE)))
    _DEVICE_CACHE[key] = value
    # the host-byte budget over NumPy-holding entries, oldest first, never
    # the one just inserted
    host_keys = [k for k, v in _DEVICE_CACHE.items() if _host_bytes(v) > 0]
    while len(host_keys) > 1 and sum(
        _host_bytes(_DEVICE_CACHE[k]) for k in host_keys
    ) > _HOST_CACHE_MAX_BYTES:
        _DEVICE_CACHE.pop(host_keys.pop(0), None)


def _stage_put(stage, key, value) -> None:
    """_cache_put at the end of a miss's ``stage`` span, which records the
    key's tag and the bytes the entry holds."""
    _cache_put(key, value)
    if spans.ACTIVE:
        stage.attrs.update(kind=_kind(key), bytes=_device_bytes(value),
                           host_bytes=_host_bytes(value))


def _evict_stale(tag: str, fp, keep_key) -> None:
    """Drop `tag` entries of the same matrix fingerprint under another key
    (stale geometry or dtype variants): foreign_cache_bytes does not count
    same-fingerprint entries, so a stale one would hold unbudgeted device
    memory right when the fresh stack uploads."""
    stale = [
        k for k in _DEVICE_CACHE
        if isinstance(k, tuple) and k and k[0] == tag and fp in k and k != keep_key
    ]
    for k in stale:
        _DEVICE_CACHE.pop(k, None)


def clear_device_cache():
    _DEVICE_CACHE.clear()


def foreign_cache_bytes(keep_fps: tuple) -> int:
    """Device bytes held by cache entries of OTHER matrices.

    A pipeline that builds an item-item model and then scores with it
    leaves the build's uploads cached while the scoring call plans; the
    planners leave room for them. Entries whose key holds one of
    `keep_fps` (this call's input fingerprints) are the call's own and are
    not counted. A same-fingerprint entry of another geometry is not
    counted either: every cache miss evicts it (_evict_stale) before its
    fresh upload lands."""
    total = 0
    for key, value in _DEVICE_CACHE.items():
        if any(fp in key for fp in keep_fps if fp is not None):
            continue
        total += _device_bytes(value)
    return total


def clear_caches():
    """Drop every engine cache: the device uploads, the fold statistics and
    the host preprocess cache, and reset the counts of ``cache_info``.
    Safe at any time; the next call re-stages. The caches key on
    full-content fingerprints, so this is never needed for correctness,
    only to release memory."""
    global _oom_retries
    _DEVICE_CACHE.clear()
    _CACHE_COUNTS.clear()
    _oom_retries = 0
    _FOLD_STAT_CACHE.clear()
    _BF16_EXACT_CACHE.clear()
    clear_prep_cache()


def cache_info() -> dict:
    """Resident footprint of the engine caches, for memory monitoring
    (pairs with :func:`clear_caches`), and their lookups since the last
    :func:`clear_caches`.

    Returns ``{"entries", "device_bytes", "host_bytes", "by_kind": {kind:
    {"entries", "device_bytes", "host_bytes"}}, "prep_entries", "hits":
    {kind: n}, "misses": {kind: n}, "prep_hits", "prep_misses",
    "oom_retries"}`` where ``kind`` is the key's tag ("m2", "m1", "sel",
    "sym_coo", "compact_m1", "compact_m2"), ``prep_entries`` counts the
    host preprocess cache, ``hits`` and ``misses`` the device cache's
    lookups, ``prep_hits`` and ``prep_misses`` the preprocess cache's, and
    ``oom_retries`` the calls that ran out of device memory and were
    replanned."""
    device_bytes = host_bytes = 0
    by_kind: dict = {}
    for key, value in _DEVICE_CACHE.items():
        kind = _kind(key)
        d, h = _device_bytes(value), _host_bytes(value)
        device_bytes += d
        host_bytes += h
        e = by_kind.setdefault(kind, {"entries": 0, "device_bytes": 0, "host_bytes": 0})
        e["entries"] += 1
        e["device_bytes"] += d
        e["host_bytes"] += h
    prep = prep_cache_counts()
    return {
        "entries": len(_DEVICE_CACHE),
        "device_bytes": device_bytes,
        "host_bytes": host_bytes,
        "by_kind": by_kind,
        "prep_entries": prep_cache_len(),
        "hits": {kind: c["hits"] for kind, c in _CACHE_COUNTS.items()},
        "misses": {kind: c["misses"] for kind, c in _CACHE_COUNTS.items()},
        "prep_hits": prep.get("hits", 0),
        "prep_misses": prep.get("misses", 0),
        "oom_retries": _oom_retries,
    }
