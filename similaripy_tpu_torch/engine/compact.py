"""Union-compaction executor: targeted and scoring calls with fewer products.

Port of ``similaripy_tpu/engine/compact.py``. The general executor
(executor.py) multiplies every panel against the full padded inner (user)
dimension. This one shrinks the inner dimension per panel of TM = 256 target
rows to

    K_panel = H (hot prefix) + the panel's cold union, padded to a bucket

  - users (the inner axis) are ranked by how many target rows touch them;
    the top-H "hot" rows of the densified matrix2 are shared by every panel
    and multiplied densely (``torch.matmul``, or ``torch._int_mm`` in int8),
    and the product starts K3's accumulator as its bias;
  - each panel's remaining "cold" union rows are copied out of the
    densified column group by K4 (``gather.row_gather``) into a compact
    buffer;
  - K3 (``panel_topk.fused_panel_topk``) computes cold product + hot bias +
    S-Plus epilogue + a top-k_pad per (row, tile); ``torch.topk`` merges the
    tiles' candidates into the running top-k of each row.

Panels are target rows dealt round-robin within degree classes
(``plan_compact_device``) so per-panel unions stay balanced; panels whose cold
union exceeds the largest bucket run through K3 with the full inner
dimension (no gather, no bias). Dense tiles are densified by K5
(``scatter.densify_tiles``). int8 stays exact end to end: the hot partial
scores stay int32 and join the cold int32 accumulator inside K3 before the
single inverse-scale multiply.

Both sides stay in the device cache (cache.py). The "compact_src" entry
(matrix1's CSR column ids and values) keys on matrix1 alone. The
"compact_m1" entry (the plan's panels and the user ranks as a device table)
keys on the targets; a miss is built on the device from "compact_src"
(``plan_compact_device``: the targets' entries gathered there, the users
ranked, the panels' cold unions sized and the COO stacks written there,
with the host making the plan's O(targets) decisions), and counts in
``cache_info()``'s ``card_builds``. ``plan_compact`` is the same plan in
NumPy, which the tests hold it to. The "compact_m2" entry (matrix2's
balanced per-tile COO with the user axis in user order, the column map and
the column vectors) keys on matrix2 and its column vectors alone, so calls
on fixed ratings that change only their targets stage matrix2 once; each
column group's rows are put in the call's rank order on the device
(``rank_rows``) just before K5.

The JAX package turns this route off on its TPU, whose per-row DMA gather
ran at ~6 GB/s; on a card a row gather is a plain coalesced copy (K4 moves
~2.9 TB/s). The route is chosen by ``MODE`` (no environment variable is
read): "on" forces it for every eligible call, "off" never takes it, and
"auto" takes it on a card (the JAX package's off-TPU rule, whose size
test always holds once the hot prefix is at least KB high), never on the
CPU, where the other routes' tests keep their routes. On an H100 the three
calls of chip_smoke.py took 1.16-2.7x less wall time on this route than on
the general one (PERF.md). ``HOT`` is the JAX package's
``SIMILARIPY_TPU_HOT``.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..ops.csr import csc_quantized
from . import cache, gather, panel_topk, scatter, spans
from .params import PVEC_LEN, build_pvec
from .preprocess import Preprocessed, _fingerprint
from .staging import (
    balance_columns, column_vectors, compute_cast, last_plan, resolve_compute_dtype, round_up,
    settle, stack_m2_tiles_balanced, upload,
)
from .tile_topk import NEG_INF, full_f32_matmul

# "auto" | "on" | "off" (see the module docstring)
MODE = "auto"
# hot-prefix height, at most a quarter of the inner dimension
HOT = 16384

TM = 256  # target rows per panel (pallas_kernels.TM)
KB = 768  # inner-dimension granule (pallas_kernels.KB)
DEFAULT_TC = 4096  # column-tile width (pallas_kernels.DEFAULT_TC); f32 halves it

# int8 hot products on the CPU run as float64 (exact below 2**53), in
# column chunks so the f64 copy stays small
_CPU_INT8_COLS = 2048


# ---------------------------------------------------------------------------
# Host planning: panel assignment, buckets, unions, compact column remapping
# ---------------------------------------------------------------------------


@dataclass
class BucketPlan:
    """Panels whose cold unions fit one K bucket. The arrays are NumPy
    (plan_compact) or tensors on the call's device (plan_compact_device)."""

    B: int  # cold-union bucket width (0 for the dense bucket)
    K: int  # lhs width = H + B, or u_pad for the dense bucket
    panel_rows: list  # per panel: np.ndarray of panel-local target positions
    pr: np.ndarray  # (n_p, p1) int32 stacked lhs COO rows
    pc: np.ndarray  # (n_p, p1) int32 compact cols
    pv: np.ndarray  # (n_p, p1) f32 values
    gather_idx: Optional[np.ndarray]  # (n_p, B) int32 device ranks, pad 0
    sx_t: np.ndarray = None  # (n_p, TM) f32
    sx_c: np.ndarray = None
    sx_d: np.ndarray = None


@dataclass
class CompactPlan:
    H: int
    u_pad: int
    TM: int
    rank_of: np.ndarray  # (U,) int64: user id -> device row (a tensor on the device's plan)
    buckets: list = field(default_factory=list)  # [BucketPlan...]


def plan_compact(
    m1_t,  # target-sliced CSR (T x U), values already quantized if int8
    targets: np.ndarray,
    xt_full,
    xc_full,
    xd_full,
    *,
    u_pad: int,
    TM: int,
    H: int,
    uc_buckets: tuple,
) -> CompactPlan:
    """Partition target rows into TM-row panels with bucketed cold unions
    (compact.py:95).

    Items are degree-sorted and dealt round-robin within each bucket class
    so panel nnz stays balanced without inflating unions (similar-degree
    items have statistically similar user sets). A panel overflowing its
    class after dealing is promoted to the next class.
    """
    T, U = m1_t.shape
    deg = np.diff(m1_t.indptr)

    # rank users by how many panel rows touch them: the most-touched rows
    # are the ones every panel would otherwise gather
    touch = np.bincount(m1_t.indices, minlength=U)
    order = np.argsort(-touch, kind="stable").astype(np.int64)
    rank_of = np.empty(U, dtype=np.int64)
    rank_of[order] = np.arange(U)

    plan = CompactPlan(H=H, u_pad=u_pad, TM=TM, rank_of=rank_of)

    # --- provisional contiguous panels in degree order -> class sizing ---
    item_order = np.argsort(-deg, kind="stable")
    ranked = rank_of[m1_t.indices]  # per-nnz device row

    def panel_cold_union(rows: np.ndarray) -> np.ndarray:
        parts = [ranked[m1_t.indptr[i]: m1_t.indptr[i + 1]] for i in rows]
        r = np.concatenate(parts) if parts else np.empty(0, np.int64)
        return np.unique(r[r >= H])

    classes = list(uc_buckets) + [None]  # None = dense class
    n_prov = math.ceil(T / TM)
    class_items: dict = {c: [] for c in classes}
    for p in range(n_prov):
        rows = item_order[p * TM: (p + 1) * TM]
        uc = panel_cold_union(rows).shape[0]
        for c in uc_buckets:
            if uc <= c:
                class_items[c].append(rows)
                break
        else:
            class_items[None].append(rows)

    # --- deal within class, verify, promote overflows ---
    carry_over: list = []
    for c in classes:
        items = class_items[c]
        pool = np.concatenate(items + carry_over) if (items or carry_over) else np.empty(0, np.int64)
        carry_over = []
        if pool.shape[0] == 0:
            continue
        n_p = math.ceil(pool.shape[0] / TM)
        panels = [pool[i::n_p] for i in range(n_p)]
        if c is not None:
            kept = []
            for rows in panels:
                if panel_cold_union(rows).shape[0] > c:
                    carry_over.append(rows)
                else:
                    kept.append(rows)
            panels = kept
        if not panels:
            continue

        B = int(c) if c is not None else 0
        K = H + B if c is not None else u_pad
        n_p = len(panels)

        # stacked lhs COO with compact column remapping + gather indices
        nnzs = [int(deg[rows].sum()) for rows in panels]
        p1 = 1 << max(int(np.ceil(np.log2(max(max(nnzs), 1)))), 8)
        pr = np.full((n_p, p1), TM, dtype=np.int32)  # TM = dropped sentinel
        pc = np.zeros((n_p, p1), dtype=np.int32)
        pv = np.zeros((n_p, p1), dtype=np.float32)
        gi = np.zeros((n_p, B), dtype=np.int32) if c is not None else None
        sx_t = np.ones((n_p, TM), dtype=np.float32)
        sx_c = np.ones((n_p, TM), dtype=np.float32)
        sx_d = np.ones((n_p, TM), dtype=np.float32)
        for pi, rows in enumerate(panels):
            parts = [ranked[m1_t.indptr[i]: m1_t.indptr[i + 1]] for i in rows]
            r_all = np.concatenate(parts) if parts else np.empty(0, np.int64)
            vals = np.concatenate(
                [m1_t.data[m1_t.indptr[i]: m1_t.indptr[i + 1]] for i in rows]
            ) if parts else np.empty(0, np.float32)
            row_ids = np.repeat(np.arange(len(rows), dtype=np.int32), deg[rows])
            if c is not None:
                cold = np.unique(r_all[r_all >= H])
                gi[pi, : cold.shape[0]] = cold.astype(np.int32)
                # compact col: rank if hot else H + position in union
                cols = np.where(
                    r_all < H, r_all, H + np.searchsorted(cold, r_all),
                ).astype(np.int32)
            else:
                cols = r_all.astype(np.int32)
            n = cols.shape[0]
            pr[pi, :n] = row_ids
            pc[pi, :n] = cols
            pv[pi, :n] = vals

            tgt_ids = targets[rows]
            if xt_full is not None:
                sx_t[pi, : rows.shape[0]] = xt_full[tgt_ids]
            if xc_full is not None:
                sx_c[pi, : rows.shape[0]] = xc_full[tgt_ids]
            if xd_full is not None:
                sx_d[pi, : rows.shape[0]] = xd_full[tgt_ids]

        plan.buckets.append(
            BucketPlan(
                B=B, K=K, panel_rows=[np.asarray(r) for r in panels],
                pr=pr, pc=pc, pv=pv, gather_idx=gi,
                sx_t=sx_t, sx_c=sx_c, sx_d=sx_d,
            )
        )
    return plan


# ---------------------------------------------------------------------------
# Eligibility
# ---------------------------------------------------------------------------


def _hot_height(u_pad: int) -> int:
    """Hot-prefix height: HOT, at most a quarter of the inner dim."""
    return max(min(HOT, (u_pad // 4 // KB) * KB), 0)


def cold_buckets(H: int, u_pad: int) -> tuple:
    """The cold-union bucket widths a call plans with: (H // 2, 2 * H),
    rounded up to KB, each leaving K = H + B below u_pad."""
    return tuple(round_up(b, KB) for b in (H // 2, 2 * H) if H + round_up(b, KB) < u_pad)


def compact_eligible(pre: Preprocessed, k: int, device: torch.device) -> bool:
    """Whether the union-compaction route applies (compact.py:416).

    Requires no per-row (MATRIX-mode) selectors, a hot prefix at least KB
    high and k within K3's extraction cap (1024). ``MODE`` then decides:
    "on" takes it, "off" does not, "auto" takes it on a card, never on the
    CPU."""
    if MODE not in ("auto", "on", "off"):
        raise ValueError(f"compact.MODE must be 'auto', 'on' or 'off', got {MODE!r}")
    if MODE == "off":
        return False
    if pre.filter_matrix is not None or pre.target_matrix is not None:
        return False
    u_pad = max(round_up(pre.m1.shape[1], KB), KB)
    if _hot_height(u_pad) < KB:
        return False
    if min(k, pre.n_output_cols) > 1024:
        return False
    # "auto": the reference's off-TPU size rule (u_pad >= 4 * H or u_pad >=
    # 32768, compact.py:453) always holds here, since H <= u_pad / 4
    return MODE == "on" or device.type == "cuda"


# ---------------------------------------------------------------------------
# Device-side execution
# ---------------------------------------------------------------------------


def _scatter_lhs(pr, pc, pv, *, K: int, H: int, dense: bool, cdt, densify):
    """(n_p, p1) COO stacks -> the (n_p, TM, K) dense panels, split into the
    hot (n_p, TM, H) and cold (n_p, TM, K - H) parts (the whole panel is
    cold in the dense bucket)."""
    lhs = densify(pr, pc, pv, u_pad=TM, tc=K, cdt=cdt)
    if dense:
        return None, lhs
    return lhs[:, :, :H].contiguous(), lhs[:, :, H:].contiguous()


def _build_d_group(rows, cols, vals, *, u_pad: int, tc: int, cdt, densify):
    """A group's per-tile COOs (G, p2) -> one (u_pad, G*tc) dense table: the
    tiles side by side, so a gathered row spans the whole group."""
    g = rows.shape[0]
    offs = torch.arange(g, dtype=torch.int32, device=rows.device)[:, None] * tc
    return densify(rows.reshape(1, -1), (cols + offs).reshape(1, -1), vals.reshape(1, -1),
                   u_pad=u_pad, tc=g * tc, cdt=cdt)[0]


def _hot_bias(a_hot, d_hot, int8_mode: bool):
    """The hot-prefix partial scores a_hot @ d_hot: exact int32 for int8
    (torch._int_mm on a card, float64 on the CPU), true f32 otherwise."""
    if not int8_mode:
        with full_f32_matmul():
            return a_hot.to(torch.float32) @ d_hot
    if a_hot.device.type == "cuda":
        return torch._int_mm(a_hot, d_hot)
    a64 = a_hot.to(torch.float64)
    return torch.cat([
        (a64 @ d_hot[:, c0:c0 + _CPU_INT8_COLS].to(torch.float64)).to(torch.int32)
        for c0 in range(0, d_hot.shape[1], _CPU_INT8_COLS)
    ], dim=1)


def _run_bucket_panels(b, d_group, d_hot, yv, pvec_ext, carry, *, flags, k, k_pad,
                       tc, int8_mode, panel_fn, gather_fn):
    """Every panel of a bucket against the group (compact.py:282): gather
    its cold rows, the hot-prefix bias, K3, and the merge of the tiles'
    candidates into the running top-k (updated in place)."""
    cv_all, ci_all = carry  # (n_p, TM, k)
    dense = b["B"] == 0
    for p in range(len(b["panel_rows"])):
        if dense:
            d_cold, bias = d_group, None
        else:
            d_cold = gather_fn(d_group, b["gi"][p])
            bias = _hot_bias(b["hot"][p], d_hot, int8_mode)
        vals, idx = panel_fn(
            b["cold"][p], d_cold, b["sx_t"][p], b["sx_c"][p], b["sx_d"][p],
            yv["y_t"], yv["y_c"], yv["y_d"], pvec_ext,
            bias=bias, allowed=yv.get("allowed"),
            flags=flags, k_pad=k_pad, tc=tc, int8_mode=int8_mode,
        )
        del d_cold, bias
        all_v = torch.cat([cv_all[p], vals.permute(2, 0, 1).reshape(TM, -1)], dim=1)
        all_i = torch.cat([ci_all[p], idx.permute(2, 0, 1).reshape(TM, -1)], dim=1)
        new_v, pos = torch.topk(all_v, k, dim=1)
        cv_all[p] = new_v
        ci_all[p] = torch.gather(all_i, 1, pos)


def stage_source(pre: Preprocessed, device):
    """matrix1's entries on `device`, the "compact_src" entry: its CSR
    column ids (int32) and float32 values, which every "compact_m1" miss on
    this matrix gathers its target rows from. The row pointers stay on the
    host (``pre.m1.indptr``), where the plan's O(T) decisions read them."""
    m1 = pre.m1
    return dict(indices=upload(m1.indices.astype(np.int32, copy=False), device),
                data=upload(m1.data.astype(np.float32, copy=False), device))


def plan_compact_device(src, m1, targets, xt_full, xc_full, xd_full, *, qscale, u_pad: int,
                        TM: int, H: int, uc_buckets: tuple, device):
    """plan_compact's plan, built on `device` from matrix1's entries there
    (`src`, stage_source's; `m1` the host CSR they came from): equal to
    plan_compact's on the target slice of `m1`, its values snapped to
    rint(v * qscale) when `qscale` is given, element for element, with the
    stacks, gather ids, target vectors and ranks as tensors on `device`.

    The device gathers the target rows' entries, ranks the users and sizes
    the panels' cold unions by one unique of (panel, rank) keys a pass; the
    host gets those sizes alone and makes plan_compact's O(T) decisions
    (degree order, classes, round-robin dealing, promotion). The device
    then writes every panel's entries where plan_compact puts them, in
    compact columns from the panel's sorted cold union. Only O(T) vectors
    go up. Returns (plan, the bytes uploaded)."""
    sent = 0

    def dev(a):
        nonlocal sent
        sent += a.nbytes
        return upload(a, device)

    T, U = targets.shape[0], m1.shape[1]
    indptr = m1.indptr.astype(np.int64, copy=False)
    starts = indptr[targets]
    deg = indptr[targets.astype(np.int64) + 1] - starts
    first = np.cumsum(deg) - deg
    n = int(deg.sum())
    at = torch.arange(n, device=device)
    owner = torch.repeat_interleave(dev(deg), output_size=n)  # each entry's target position
    src_pos = dev(starts - first).index_select(0, owner) + at
    users = src["indices"].index_select(0, src_pos).to(torch.int64)
    vals = src["data"].index_select(0, src_pos)
    if qscale is not None:
        vals = torch.round(vals * qscale)
    del src_pos

    # users ranked by how many target rows touch them, ties in id order
    # (np.argsort(-touch, kind="stable"))
    order = torch.sort(-torch.bincount(users, minlength=U), stable=True).indices
    rank_of = torch.empty(U, dtype=torch.int64, device=device)
    rank_of[order] = torch.arange(U, device=device)
    ranked = rank_of.index_select(0, users)
    del users, order
    cold = ranked >= H
    cold_owner, cold_rank = owner[cold], ranked[cold]

    def union_sizes(panels):
        """The cold-union size of each panel (rows: target positions)."""
        label = np.full(T, -1, dtype=np.int64)
        for i, rows in enumerate(panels):
            label[rows] = i
        lab = dev(label).index_select(0, cold_owner)
        keep = lab >= 0
        keys = torch.unique(lab[keep] * u_pad + cold_rank[keep])
        return torch.bincount(keys // u_pad, minlength=len(panels)).cpu().numpy()

    # --- provisional contiguous panels in degree order -> class sizing ---
    item_order = np.argsort(-deg, kind="stable")
    prov = [item_order[p * TM: (p + 1) * TM] for p in range(math.ceil(T / TM))]
    classes = list(uc_buckets) + [None]  # None = dense class
    class_items: dict = {c: [] for c in classes}
    for rows, uc in zip(prov, union_sizes(prov)):
        class_items[next((c for c in uc_buckets if uc <= c), None)].append(rows)

    # --- deal within class, verify, promote overflows ---
    kept: list = []
    carry_over: list = []
    for c in classes:
        items = class_items[c] + carry_over
        carry_over = []
        if not items:
            continue
        pool = np.concatenate(items)
        n_p = math.ceil(pool.shape[0] / TM)
        panels = [pool[i::n_p] for i in range(n_p)]
        if c is not None:
            sizes = union_sizes(panels)
            carry_over = [rows for rows, s in zip(panels, sizes) if s > c]
            panels = [rows for rows, s in zip(panels, sizes) if s <= c]
        if panels:
            kept.append((c, panels))

    # --- where each target position's entries land in the flat stacks of
    # all buckets, and where each gathering panel's gather ids start ---
    n_panels = sum(len(panels) for _, panels in kept)
    dest = np.zeros(T, dtype=np.int64)
    row_in = np.zeros(T, dtype=np.int32)
    panel_of = np.full(T, -1, dtype=np.int64)  # -1: a dense panel's row
    gi_first = np.zeros(n_panels, dtype=np.int64)
    geometry = []
    stack_end = gi_end = g = 0
    for c, panels in kept:
        B = int(c) if c is not None else 0
        p1 = 1 << max(int(np.ceil(np.log2(max(max(int(deg[r].sum()) for r in panels), 1)))), 8)
        for pi, rows in enumerate(panels):
            d = deg[rows]
            dest[rows] = stack_end + pi * p1 + np.cumsum(d) - d
            row_in[rows] = np.arange(rows.shape[0])
            if c is not None:
                panel_of[rows] = g
                gi_first[g] = gi_end + pi * B
            g += 1
        geometry.append((B, p1, stack_end, gi_end))
        stack_end += len(panels) * p1
        gi_end += len(panels) * B

    put = dev(dest - first).index_select(0, owner) + at
    pr = torch.full((stack_end,), TM, dtype=torch.int32, device=device)  # TM = dropped
    pr.index_copy_(0, put, dev(row_in).index_select(0, owner))
    pv = torch.zeros(stack_end, dtype=torch.float32, device=device)
    pv.index_copy_(0, put, vals)
    # compact col: the rank if hot, else H + its place in the panel's union
    gp = dev(panel_of).index_select(0, owner)
    sel = cold & (gp >= 0)
    gp = gp[sel]
    keys, inv = torch.unique(gp * u_pad + ranked[sel], return_inverse=True)
    key_panel = keys // u_pad
    size = torch.bincount(key_panel, minlength=n_panels)
    union_first = torch.cumsum(size, 0) - size
    ranked[sel] = H + inv - union_first.index_select(0, gp)
    pc = torch.zeros(stack_end, dtype=torch.int32, device=device)
    pc.index_copy_(0, put, ranked.to(torch.int32))
    gi = torch.zeros(gi_end, dtype=torch.int32, device=device)
    slot = (dev(gi_first) - union_first).index_select(0, key_panel)
    slot += torch.arange(keys.shape[0], device=device)
    gi.index_copy_(0, slot, (keys % u_pad).to(torch.int32))

    plan = CompactPlan(H=H, u_pad=u_pad, TM=TM, rank_of=rank_of)
    for (c, panels), (B, p1, s0, g0) in zip(kept, geometry):
        n_p = len(panels)
        sx = np.ones((3, n_p, TM), dtype=np.float32)
        for pi, rows in enumerate(panels):
            for v, full in zip(sx, (xt_full, xc_full, xd_full)):
                if full is not None:
                    v[pi, : rows.shape[0]] = full[targets[rows]]
        sx_t, sx_c, sx_d = dev(sx)
        pr_b, pc_b, pv_b = (a[s0: s0 + n_p * p1].view(n_p, p1) for a in (pr, pc, pv))
        plan.buckets.append(BucketPlan(
            B=B, K=H + B if c is not None else u_pad, panel_rows=[np.asarray(r) for r in panels],
            pr=pr_b, pc=pc_b, pv=pv_b,
            gather_idx=gi[g0: g0 + n_p * B].view(n_p, B) if c is not None else None,
            sx_t=sx_t, sx_c=sx_c, sx_d=sx_d,
        ))
    return plan, sent


def stage_panels(pre: Preprocessed, compute_dtype: str, *, u_pad: int, device, densify, src):
    """The m1 side of a call on the device: plan_compact_device's buckets
    with their dense (n_p, TM, H) hot and (n_p, TM, K - H) cold lhs, gather
    ids and target vectors, and the user ranks as an int32 table of U + 1
    entries whose last is the sentinel u_pad (``rank_rows``), from `src`,
    matrix1's entries on the device (stage_source's). A traced call's open
    ``stage`` span records the bytes uploaded (``attrs["upload_bytes"]``).
    Returns (buckets, rank_table)."""
    stage = spans.current()
    int8_mode = compute_dtype in ("int8", "int4")
    H = _hot_height(u_pad)
    plan, sent = plan_compact_device(
        src, pre.m1, pre.targets, pre.Xt, pre.Xc, pre.Xd,
        qscale=pre.qscale1 if int8_mode else None, u_pad=u_pad, TM=TM, H=H,
        uc_buckets=cold_buckets(H, u_pad), device=device)
    buckets = []
    for b in plan.buckets:
        hot, cold = _scatter_lhs(b.pr, b.pc, b.pv, K=b.K, H=H, dense=b.B == 0,
                                 cdt=compute_cast(compute_dtype), densify=densify)
        buckets.append(dict(
            B=b.B, K=b.K, panel_rows=b.panel_rows, hot=hot, cold=cold, gi=b.gather_idx,
            sx_t=b.sx_t, sx_c=b.sx_c, sx_d=b.sx_d,
        ))
    rank_table = torch.cat([plan.rank_of, plan.rank_of.new_tensor([u_pad])]).to(torch.int32)
    if stage is not None:
        stage.attrs["upload_bytes"] = sent
    settle(rank_table)
    return buckets, rank_table


def rank_rows(rows, rank_table):
    """A group's per-tile COO rows (user ids, padding u_pad) in the call's
    rank order, by one device index through ``rank_table`` (U + 1 entries,
    the last u_pad), so padding stays u_pad."""
    u = rank_table.shape[0] - 1
    return torch.index_select(rank_table, 0, rows.clamp_max(u).reshape(-1)).reshape(rows.shape)


def stage_tiles(pre: Preprocessed, compute_dtype: str, *, tc: int, n_tiles: int,
                u_pad: int, device):
    """The m2 side on the device, which depends on matrix2 and its column
    vectors alone: its columns dealt over n_tiles balanced tiles, each
    tile's COO with the user axis in user order (padding u_pad), and the
    column vectors (and the allowed mask) in that layout. A call ranks the
    rows of each group with ``rank_rows``. Returns ((rows, cols, vals,
    yvecs), col_map)."""
    dev = functools.partial(upload, device=device)
    int8_mode = compute_dtype in ("int8", "int4")
    m2_csc = csc_quantized(pre.m2, pre.qscale2 if int8_mode else None)
    tile_lists, col_map = balance_columns(np.diff(m2_csc.indptr), n_tiles, tc)
    rows, cols, vals = stack_m2_tiles_balanced(m2_csc, tile_lists, tc, u_pad)
    yvecs = {name: dev(v) for name, v in column_vectors(pre, col_map).items()}
    return (dev(rows), dev(cols), dev(vals), yvecs), col_map


def execute_compact(
    pre: Preprocessed,
    params,
    *,
    compute_dtype: str,
    budget_bytes: int,
    progress,
    device: torch.device,
    tile_fn: str = "kernel",
):
    """Union-compacted execution (compact.py:456); same contract as
    executor.execute(): host (T, k) vals f32 and idx int32.
    `tile_fn="plain"` runs the kernels' plain versions even on a card."""
    m1, m2, targets, k = pre.m1, pre.m2, pre.targets, pre.k
    T, U = targets.shape[0], m1.shape[1]
    C = pre.n_output_cols

    compute_dtype, inv_scale = resolve_compute_dtype(compute_dtype, pre)
    int8_mode = compute_dtype in ("int8", "int4")
    cdt = compute_cast(compute_dtype)
    dense_item = torch.empty(0, dtype=cdt).element_size()
    if tile_fn == "plain":
        panel_fn = panel_topk.fused_panel_topk_plain
        gather_fn = gather.row_gather_plain
        densify = scatter.densify_tiles_plain
    else:
        panel_fn = panel_topk.fused_panel_topk
        gather_fn = gather.row_gather
        densify = scatter.densify_tiles

    u_pad = max(round_up(U, KB), KB)
    H = _hot_height(u_pad)
    tc = DEFAULT_TC if compute_dtype != "float32" else DEFAULT_TC // 2
    tc = min(tc, round_up(C, 128))
    k_pad = round_up(min(k, tc), 8)

    # ---- m1 side: matrix1's entries (cached across calls on it), then
    # the plan and the device lhs stacks built from them (cached on the
    # targets) ----
    src = cache.staged(("compact_src", pre.fp1, str(device)), pre.fp1,
                       lambda: stage_source(pre, device))
    m1_key = (
        "compact_m1", pre.fp1, _fingerprint(targets, pre.Xt, pre.Xc, pre.Xd),
        compute_dtype, TM, H, cold_buckets(H, u_pad), str(device),
    )

    def stage_m1():
        cache.count_card_build("compact_m1")
        return stage_panels(pre, compute_dtype, u_pad=u_pad, device=device, densify=densify,
                            src=src)

    dev_buckets, rank_table = cache.staged(m1_key, pre.fp1, stage_m1)

    # ---- group sizing under the device budget (compact.py:541) ----
    b2 = max((b["B"] for b in dev_buckets), default=0)
    misc = (
        cache.device_bytes((src, dev_buckets, rank_table))
        + int(m2.nnz * 12 * 1.8)  # staged COO uploads
        + int(m2.nnz * 4 * 1.8)  # a group's ranked rows (G x p2 x 4), at most the whole stack
        + cache.foreign_cache_bytes((pre.fp1, pre.fp2))
        + (1 << 30)
    )
    avail = int(budget_bytes * 0.88) - misc
    bytes_per_col = (
        u_pad * dense_item  # the group's dense table
        + 2 * b2 * dense_item  # gathered cold rows, two alive at a time
        + 3 * TM * 4  # the bias (two alive) and K3's score scratch
        + (H * 4 if compute_dtype == "bfloat16" else 0)  # f32 copy of the hot rows
    )
    cg_max = max(avail // max(bytes_per_col, 1), tc)
    n_total_tiles = math.ceil(C / tc)
    n_groups = max(1, math.ceil(n_total_tiles / max(cg_max // tc, 1)))
    G = math.ceil(n_total_tiles / n_groups)
    n_tiles = n_groups * G
    cg = G * tc

    # ---- m2 side: balanced columns, per-tile COO in user order (cached
    # across calls on the same matrix2, whatever their targets) ----
    m2_key = (
        "compact_m2", pre.fp2, _fingerprint(pre.Yt, pre.Yc, pre.Yd, pre.col_allowed),
        compute_dtype, tc, n_tiles, u_pad, str(device),
    )
    (t_rows, t_cols, t_vals, yvecs), col_map = cache.staged(
        m2_key, pre.fp2,
        lambda: stage_tiles(pre, compute_dtype, tc=tc, n_tiles=n_tiles, u_pad=u_pad,
                            device=device),
    )

    last_plan.clear()
    last_plan.update(
        compute_dtype=compute_dtype, TM=TM, H=H, u_pad=u_pad, tc=tc, cg=cg,
        k_pad=k_pad, n_groups=n_groups, n_tiles=n_tiles,
        buckets=[(b["B"], len(b["panel_rows"])) for b in dev_buckets],
    )

    pvec = upload(build_pvec(params, inv_scale), device)
    flags = params.static_flags()
    carries = [
        (torch.full((len(b["panel_rows"]), TM, k), NEG_INF, dtype=torch.float32, device=device),
         torch.zeros((len(b["panel_rows"]), TM, k), dtype=torch.int32, device=device))
        for b in dev_buckets
    ]
    done_items = 0
    for g in range(n_groups):
        t0, t1 = g * G, (g + 1) * G
        d_group = d_hot = None  # release the previous group before the next lands
        with spans.span("group") as group:
            d_group = _build_d_group(rank_rows(t_rows[t0:t1], rank_table), t_cols[t0:t1],
                                     t_vals[t0:t1], u_pad=u_pad, tc=tc, cdt=cdt,
                                     densify=densify)
            if any(b["B"] != 0 for b in dev_buckets):
                d_hot = d_group[:H]
                if compute_dtype == "bfloat16":
                    d_hot = d_hot.to(torch.float32)  # the bias is an f32 product
            yv = {name: v[t0 * tc:t1 * tc] for name, v in yvecs.items()}
            pvec_ext = torch.cat([pvec, pvec.new_tensor([t0 * tc]),
                                  pvec.new_zeros(PVEC_LEN - 11)])
            for bi, b in enumerate(dev_buckets):
                _run_bucket_panels(
                    b, d_group, d_hot, yv, pvec_ext, carries[bi], flags=flags, k=k,
                    k_pad=k_pad, tc=tc, int8_mode=int8_mode, panel_fn=panel_fn,
                    gather_fn=gather_fn,
                )
            if spans.ACTIVE:
                group.attrs.update(index=g, cols=cg, table_bytes=d_group.nbytes,
                                   panels=sum(len(b["panel_rows"]) for b in dev_buckets))
                settle(d_group)
        if progress is not None:
            step = T - done_items if g == n_groups - 1 else T // n_groups
            done_items += step
            progress.update(step)
    del d_group, d_hot

    with spans.span("pack"):
        out_vals = np.empty((T, k), np.float32)
        out_idx = np.empty((T, k), np.int32)
        for bi, b in enumerate(dev_buckets):
            vals_np = carries[bi][0].cpu().numpy()
            idx_np = carries[bi][1].cpu().numpy()
            for pi, rows in enumerate(b["panel_rows"]):
                out_vals[rows] = vals_np[pi, : rows.shape[0]]
                out_idx[rows] = idx_np[pi, : rows.shape[0]]
        # device column ids are balanced-layout slots; -inf slots carry
        # arbitrary ids and are dropped in assembly
        out_idx = col_map[out_idx].astype(np.int32)
    return out_vals, out_idx
