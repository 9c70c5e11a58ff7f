"""Host staging that more than one executor uses: the compute type, the
balanced column layout, the split-bf16x3 COO, the upload of a host array,
and ``last_plan``, the geometry the latest call planned.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from . import spans
from .preprocess import Preprocessed, int8_values
from .tile_topk import split_bf16x3_parts

# the geometry the latest call planned, for diagnostics and measurements;
# the executors clear and fill this one dict, never rebind it
last_plan: dict = {}


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def upload(a, device) -> torch.Tensor:
    """A host array as a tensor on `device`."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


# ---------------------------------------------------------------------------
# Compute type
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
    maxv1 = _max_value(m1, pre.qmax1) * s1
    maxv2 = _max_value(m2, pre.qmax2) * s2
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


def _max_value(m, known: Optional[float]) -> float:
    """The largest magnitude among the densified values of `m` (repeated
    entries sum: int8_values): `known`, the gate's, when given."""
    if known is not None:
        return known
    return float(np.abs(int8_values(m)).max()) if m.nnz else 0.0


_BF16_EXACT_CACHE: dict = {}


def bf16_exact(fp, m) -> bool:
    """True when every value a densify of `m` holds is exactly
    bf16-representable: its entries and the sums of its repeated entries
    (preprocess.int8_values), judged on their f32 values in PyTorch.
    Integer ratings, binary interactions and counts up to 256 qualify.
    Memoised by the content fingerprint `fp`; a miss is a ``bf16_exact``
    span of a traced call."""
    hit = _BF16_EXACT_CACHE.get(fp)
    if hit is None:
        with spans.span("bf16_exact"):
            v = torch.from_numpy(np.ascontiguousarray(int8_values(m), dtype=np.float32))
            hit = bool(torch.equal(v.to(torch.bfloat16).to(torch.float32), v))
        if len(_BF16_EXACT_CACHE) > 64:
            _BF16_EXACT_CACHE.pop(next(iter(_BF16_EXACT_CACHE)))
        _BF16_EXACT_CACHE[fp] = hit
    return hit


def clear_memo() -> None:
    """Drop bf16_exact's memo."""
    _BF16_EXACT_CACHE.clear()


# ---------------------------------------------------------------------------
# The balanced column layout
# ---------------------------------------------------------------------------


def pad_bucket(n: int, minimum: int = 1024) -> int:
    """Eighth-octave size buckets (<= 12.5% padding), as in the reference,
    so staged arrays keep a few distinct shapes."""
    n = max(n, minimum)
    step = 1 << max(n.bit_length() - 4, 0)
    return ((n + step - 1) // step) * step


def _expand_ranges(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Concatenate [s, s+c) ranges into one index vector, vectorized."""
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    ends = np.cumsum(counts)
    out = np.repeat(starts - np.concatenate([[0], ends[:-1]]), counts)
    return out + np.arange(total, dtype=np.int64)


def extract_cols_coo(csc, cols_old: np.ndarray):
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


def stack_m2_tiles_balanced(m2_csc, tile_lists, tc: int, u_pad: int):
    """Per-tile padded COO of the balanced column layout."""
    n_tiles = len(tile_lists)
    parts = [extract_cols_coo(m2_csc, cols) for cols in tile_lists]
    p2 = pad_bucket(max((p[0].shape[0] for p in parts), default=1))
    rows = np.full((n_tiles, p2), u_pad, dtype=np.int32)
    cols = np.zeros((n_tiles, p2), dtype=np.int32)
    vals = np.zeros((n_tiles, p2), dtype=np.float32)
    for t, (r, local, pos) in enumerate(parts):
        n = r.shape[0]
        rows[t, :n] = r
        cols[t, :n] = local
        vals[t, :n] = m2_csc.data[pos]
    return rows, cols, vals


def stack_m2_tiles_device(m2_csc, tile_lists, u_pad: int, device, qscale=None):
    """stack_m2_tiles_balanced's stacks, built on `device` from the CSC's
    own index and value arrays, element for element equal to the host
    stacks uploaded. `tile_lists` partition the columns, as the symmetric
    layout's do; `qscale` snaps the values to rint(v * qscale), as
    ``csc_quantized`` does. The host computes, per column, its slot and
    where its first entry lands in the flat (n_tiles, p2) stacks
    (O(columns)); the device expands those to every entry and writes the
    users, slots and values in, each column's entries in CSC order.
    Returns ((rows, cols, vals), the bytes uploaded)."""
    n_tiles, C = len(tile_lists), m2_csc.shape[1]
    indptr = m2_csc.indptr.astype(np.int64)
    col_nnz = np.diff(indptr)
    order = np.concatenate(tile_lists).astype(np.int64)
    if order.shape[0] != C:
        raise ValueError("tile_lists must partition the columns")
    sizes = np.array([lst.shape[0] for lst in tile_lists], dtype=np.int64)
    tile_of = np.repeat(np.arange(n_tiles, dtype=np.int64), sizes)
    counts = col_nnz[order]
    tile_nnz = np.bincount(tile_of, weights=counts, minlength=n_tiles).astype(np.int64)
    p2 = pad_bucket(int(tile_nnz.max()))
    # exclusive running sums in tile-major order, less the tile's own start
    first = np.cumsum(counts) - counts
    tile_first = np.cumsum(tile_nnz) - tile_nnz
    item_first = np.cumsum(sizes) - sizes
    # entry pos (a CSC position less indptr[0]) of column c lands at pos + shift[c]
    shift = np.empty(C, dtype=np.int64)
    shift[order] = tile_of * p2 + first - tile_first[tile_of] - (indptr[order] - indptr[0])
    slot = np.empty(C, dtype=np.int32)
    slot[order] = np.arange(C, dtype=np.int64) - item_first[tile_of]
    lo, hi = int(indptr[0]), int(indptr[-1])
    host = (col_nnz.astype(np.int32), shift, slot,
            m2_csc.indices[lo:hi].astype(np.int32, copy=False),
            m2_csc.data[lo:hi].astype(np.float32, copy=False))
    col_nnz_d, shift_d, slot_d, users_d, vals_d = (upload(a, device) for a in host)
    nnz = hi - lo
    col = torch.repeat_interleave(col_nnz_d, output_size=nnz)  # each entry's column
    dest = shift_d.index_select(0, col)
    dest += torch.arange(nnz, dtype=torch.int64, device=device)
    rows = torch.full((n_tiles * p2,), u_pad, dtype=torch.int32, device=device)
    cols = torch.zeros(n_tiles * p2, dtype=torch.int32, device=device)
    vals = torch.zeros(n_tiles * p2, dtype=torch.float32, device=device)
    rows.index_copy_(0, dest, users_d)
    cols.index_copy_(0, dest, slot_d.index_select(0, col))
    vals.index_copy_(0, dest, vals_d if qscale is None else torch.round(vals_d * qscale))
    settle(vals)
    stacks = tuple(a.view(n_tiles, p2) for a in (rows, cols, vals))
    return stacks, sum(a.nbytes for a in host)


def settle(t: torch.Tensor) -> None:
    """While a call is traced, waits for the card's work queued so far, so
    that the open span ends after it rather than at its launch."""
    if spans.ACTIVE and t.is_cuda:
        torch.cuda.synchronize(t.device)


def vec_by_map(v: Optional[np.ndarray], col_map: np.ndarray, n_cols: int,
               fill: float = 1.0) -> np.ndarray:
    """Reindex a per-column vector into the balanced device layout."""
    out = np.full(col_map.shape[0], fill, dtype=np.float32)
    if v is not None:
        used = col_map < n_cols
        out[used] = np.asarray(v, dtype=np.float32)[col_map[used]]
    return out


def column_vectors(pre: Preprocessed, col_map: np.ndarray) -> dict:
    """matrix2's column vectors, and the allowed mask of a column selector,
    in the balanced device layout of `col_map`."""
    C = pre.n_output_cols
    out = {name: vec_by_map(v, col_map, C)
           for name, v in (("y_t", pre.Yt), ("y_c", pre.Yc), ("y_d", pre.Yd))}
    if pre.col_allowed is not None:
        out["allowed"] = vec_by_map(pre.col_allowed, col_map, C, fill=0).astype(np.uint8)
    return out


# ---------------------------------------------------------------------------
# precision='high': the split COO (executor.py:330-395)
# ---------------------------------------------------------------------------


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
    NumPy arrays (the result is NumPy) or tensors (the result stays on
    their device), of any leading shape; the halves are concatenated along
    the last axis. A traced call's span ``split`` (``attrs["entries"]``:
    the entries given out)."""
    with spans.span("split") as span:
        host = isinstance(vals, np.ndarray)
        if host:
            rows, cols = torch.from_numpy(rows), torch.from_numpy(cols)
            vals = torch.from_numpy(np.ascontiguousarray(vals, dtype=np.float32))
        hi, lo = (h.to(torch.float32) for h in split_bf16x3_parts(vals))
        far = 2 * n
        if axis == 0:
            real = rows < n
            rows = torch.cat([torch.where(real, rows, far), torch.where(real, rows + n, far)], -1)
            cols = torch.cat([cols, cols], -1)
        else:
            real = cols < n
            rows = torch.cat([rows, rows], -1)
            cols = torch.cat([torch.where(real, cols, far), torch.where(real, cols + n, far)], -1)
        out = rows.to(torch.int32), cols.to(torch.int32), torch.cat([hi, lo], -1)
        if spans.ACTIVE:
            span.attrs["entries"] = out[2].numel()
        if host:
            return tuple(a.numpy() for a in out)
        settle(out[2])
    return out
