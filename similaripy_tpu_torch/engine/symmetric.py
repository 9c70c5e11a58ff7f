"""Symmetric (self-similarity) executor: upper-triangle blocked top-k.

Port of ``similaripy_tpu/engine/symmetric.py``. Self-similarity, the
top-k of ``m @ m.T`` (every ``matrix2=None`` call), gives a score matrix
whose values are symmetric, and this executor computes each block of the
upper block triangle once:

  - ONE item permutation (nnz-rank round-robin over the column tiles, with
    a seeded shuffle inside each tile) serves rows and columns, so every
    tile's COO densifies (K5, ``scatter.densify_tiles``) into the same
    (users x slots) dense tile, whether it is an inner tile or part of an
    anchor group; int8 (and int4) tiles are densified K-major (slots x
    users), the layout that K2's 8-bit ``wgmma`` reads: K2 takes the
    anchors as the (sw, u_pad) stack and a tile as its transposed view;
  - anchor groups of ``gt`` tiles are densified once and stay resident
    while the inner tiles t >= the anchor's first tile sweep past them;
    inner tiles that belong to a resident anchor are sliced from it
    instead of densified again;
  - each block feeds TWO top-k merges through K2 (``sym_topk``): the anchor
    rows' carry (row side, row tile <= t) and the inner tile columns' carry
    (col side, row tile < t), so every ordered pair is delivered once, the
    diagonal included; with an asymmetric epilogue (t1 != t2 or different
    X and Y vectors: tversky, asymmetric_cosine, p3alpha and rp3beta after
    their value-symmetric refactor) the col side re-runs it with X and Y
    swapped;
  - anchors go in PAIRS that share one inner sweep, and a finished pair's
    rows are final: they are merged (``_pack_rows_dual``) and copied to
    the host before the next pair starts;
  - on a mesh (``mesh=``) every step of the sweep runs on one rank
    (``sym_sharded.pair_schedule``) and a finished pair's rows are
    all-gathered over the ranks and re-selected before they are copied;
  - an f32 call with ``precision='high'`` runs K2 in its split-bf16x3 mode
    (symmetric.py:877-896 of the JAX package): the tiles are [hi; lo] bf16
    stacks 2 u_pad deep, anchors and inner tiles alike, densified by K5
    from the split COO (``staging.split_coo``); data that bf16 holds
    exactly rides compute_dtype='bfloat16' instead.

The result equals the general executor's: the same epilogue, the same
candidate rule (xy != 0), exact top-k. Left out of the port, as TPU
scheduling only: the anchor prefill, the single-anchor mode and the
``SIMILARIPY_TPU_SYM_*`` knobs, the MXU binning of the densify, the
timing laps and the asynchronous readback.
"""

from __future__ import annotations

import math
import time
import warnings
from typing import Optional

import numpy as np
import torch

from ..parallel import mesh as pmesh
from . import cache, scatter, spans, sym_topk
from .params import SPlusParams, build_pvec
from .preprocess import Preprocessed, _fingerprint
from .staging import (
    bf16_exact, canonical, compute_cast, last_plan, resolve_compute_dtype, round_up, split_coo,
    stack_m2_tiles_device, upload, vec_by_map,
)
from .sym_sharded import pair_schedule, rank_work, schedule_anatomy
from .tile_topk import NEG_INF

# calls of the k_pad > MAX_KERNEL_K_PAD branch (plain PyTorch per block)
wide_k_calls = 0


# ---------------------------------------------------------------------------
# Eligibility
# ---------------------------------------------------------------------------


def _vec_pair_equal(a: Optional[np.ndarray], b: Optional[np.ndarray]) -> bool:
    if a is None and b is None:
        return True
    if a is None or b is None:
        return False
    return a.shape == b.shape and np.array_equal(a, b)


def symmetric_eligible(pre: Preprocessed, params: SPlusParams, block_size_hint) -> bool:
    """True when the score matrix is provably symmetric and not subset.

    Requires: the call came from ``matrix2=None`` (pre.self_similar), all
    rows targeted in natural order, no column selectors, equal quantization
    of both sides, and the planner-managed block size (an explicit
    block_size keeps the reference's semantics on the general path). An
    asymmetric epilogue is fine: xy stays value-symmetric and the col side
    re-runs the epilogue with X and Y swapped."""
    if not pre.self_similar:
        return False
    if block_size_hint != 0:
        return False
    if pre.filter_matrix is not None or pre.target_matrix is not None:
        return False
    if pre.col_allowed is not None:
        return False
    C = pre.n_output_cols
    if pre.n_output_rows != C or pre.m1.shape[0] != C:
        return False
    t = pre.targets
    if t.shape[0] != C or t[0] != 0 or t[-1] != C - 1:
        return False
    if not np.array_equal(t, np.arange(C, dtype=t.dtype)):
        return False
    return pre.qscale1 == pre.qscale2


def epilogue_is_symmetric(pre: Preprocessed, params: SPlusParams) -> bool:
    """True when one epilogue value serves both delivery directions."""
    if params.l1 != 0.0 and params.t1 != params.t2:
        return False
    for a, b in ((pre.Xt, pre.Yt), (pre.Xc, pre.Yc), (pre.Xd, pre.Yd)):
        if not _vec_pair_equal(a, b):
            return False
    return True


# ---------------------------------------------------------------------------
# Planning
# ---------------------------------------------------------------------------

# The planner's cost model; only the ratio of the two rates matters. A
# block runs at K2's rates, product and both merges, measured on an NVIDIA
# H100 80GB HBM3 at 700.00 W (PERF.md) by chip_smoke.py (phase times, live
# blocks at u_pad 200,960): f32 (tc 2,048) 47.2 TFLOP/s, bf16 (tc 2,048)
# 238, the split-bf16x3 mode ("split", tc 2,048) 121 in f32 operations (364
# in bf16 ones, three phases); and int8 (tc 4,096, wgmma s8) 1,440 TOP/s,
# its 231 live blocks a call in a traced run of the benchmark's cell
# ml32m-raw-int8.full-build (k2_roofline.build 72.74% of 1,979), where the
# carries are warm: the smoke's block, whose cold carries make its two
# merges 2.4 ms, reads 974. int4 runs as int8. K5 densified an f32 inner
# tile of 0.69 M entries, its zero fill included, in 0.65 ms there: about
# 1e9 entries/s; an int8 tile, a quarter of the bytes, 1.50 M entries in
# 0.30-0.34 ms in traced runs of that cell: 4.4e9-4.9e9.
_PRODUCT_RATE = {"int8": 1440e12, "int4": 1440e12, "bfloat16": 238e12, "float32": 47.2e12,
                 "split": 121e12}
_DENSIFY_NNZ_RATE = {"int8": 4.5e9, "int4": 4.5e9, "bfloat16": 1e9, "float32": 1e9,
                     "split": 1e9}


def _triangle_counts(n_tiles_dev: int, gt: int) -> tuple[int, int]:
    """(K2 block products, K5 tile densifies) of execute_symmetric's pair
    schedule: a pair sweeps its first anchor's band with that anchor alone
    and the tiles right of it with both; anchors are densified once each,
    and inner tiles that belong to a resident anchor are sliced from it."""
    n_groups = n_tiles_dev // gt
    products = 0
    densifies = n_tiles_dev  # the anchors
    a = 0
    while a < n_groups:
        if a + 1 < n_groups:
            rest = n_tiles_dev - (a + 1) * gt
            products += gt + 2 * rest
            densifies += rest - gt  # the second anchor's own tiles are sliced
            a += 2
        else:
            products += n_tiles_dev - a * gt
            densifies += n_tiles_dev - (a + 1) * gt  # its own tiles are sliced
            a += 1
    return products, densifies


def _plan(C: int, U: int, nnz: int, compute_dtype: str, budget: int,
          k_pad: int) -> tuple[int, int, int]:
    """Choose (tc, gt, u_pad) by modeled time under the device budget.

    Larger anchor groups (gt) cut the inner re-densifies but pad the tile
    grid to a multiple of gt (padding costs whole products) and hold more
    memory: a pair's two anchor stacks plus K2's two f32 score planes
    (sw x tc each). Every gt that fits is costed and the cheapest wins.
    `compute_dtype` "split" plans the split-bf16x3 mode: a tile of two bf16
    halves, the f32 call's 4 bytes an element (its COO, twice the
    entries, comes in `nnz`)."""
    u_pad = max(round_up(U, 128), 128)
    isize = {"bfloat16": 2, "int8": 1, "int4": 1}.get(compute_dtype, 4)
    tc = min(4096 if isize <= 2 else 2048, round_up(C, 128))
    n_tiles = math.ceil(C / tc)

    tile = tc * u_pad * isize
    reserve = (
        int(nnz * 12 * 1.8)  # device COO uploads + pad slack
        + tile  # the inner tile K5 densifies
        + 16 * k_pad * n_tiles * tc  # the four carry planes
        + (1 << 30)
    )
    per_anchor_tile = 2 * tile + 8 * tc * tc
    gt_max = max(1, min((int(budget * 0.85) - reserve) // per_anchor_tile, n_tiles))

    rate = _PRODUCT_RATE.get(compute_dtype, _PRODUCT_RATE["float32"])
    densify_rate = _DENSIFY_NNZ_RATE.get(compute_dtype, _DENSIFY_NNZ_RATE["float32"])
    nnz_tile = nnz / max(n_tiles, 1)
    best_gt, best_t = 1, float("inf")
    for gt in range(1, gt_max + 1):
        products, densifies = _triangle_counts(math.ceil(n_tiles / gt) * gt, gt)
        t = (products * (gt * tc) * tc * u_pad * 2 / rate
             + densifies * nnz_tile / densify_rate)
        if t < best_t - 1e-9:
            best_gt, best_t = gt, t
    return tc, best_gt, u_pad


# ---------------------------------------------------------------------------
# Prep: the item layout on the host, the tile COO stacks on the device
# ---------------------------------------------------------------------------


def item_layout(col_nnz: np.ndarray, n_tiles_dev: int, tc: int):
    """The one item permutation: (tile_lists, item_map). Items go
    round-robin by nnz rank over ALL device tiles (the product cost is set
    by the padded catalog alone, so spreading items into the padding tiles
    is free and keeps every tile's COO near the mean), then are shuffled
    within each tile (any bijection is valid), seeded as the JAX package
    seeds it. `item_map` maps a device slot to its item (C for padding)."""
    C = col_nnz.shape[0]
    rank = np.argsort(-col_nnz, kind="stable")
    rng = np.random.default_rng(0x51A7)
    tile_lists = [lst[rng.permutation(lst.shape[0])]
                  for lst in (rank[t::n_tiles_dev] for t in range(n_tiles_dev))]
    item_map = np.full(n_tiles_dev * tc, C, dtype=np.int64)
    for t, items in enumerate(tile_lists):
        item_map[t * tc : t * tc + items.shape[0]] = items
    return tile_lists, item_map


def prep_coo_symmetric(pre: Preprocessed, compute_dtype: str, tc: int,
                       n_tiles_dev: int, u_pad: int, device: torch.device,
                       split: bool = False):
    """The O(nnz) prep: the item permutation and the per-tile COO stacks.

    Depends only on matrix2, its quantization and the tile geometry, not
    on the epilogue vectors, so it is cached apart from them. The host
    makes the O(items) layout (``item_layout``); the device builds the
    stacks from matrix2's uploaded CSC arrays
    (``staging.stack_m2_tiles_device``), int8 values snapped there, and,
    with `split`, their split COO. Returns (coo, item_map, bytes uploaded):
    `coo` holds the per-tile users `ru` (sentinel u_pad), slots `sl` and
    values `vv` on `device`, each (n_tiles_dev, p2); with `split` the COO
    of the tiles' [hi; lo] stacks (users below 2 u_pad, sentinel 2 u_pad,
    each (n_tiles_dev, 2 p2))."""
    int_mode = compute_dtype in ("int8", "int4")
    m2_csc = pre.m2.tocsc()
    if split:
        m2_csc = canonical(m2_csc)
    tile_lists, item_map = item_layout(np.diff(m2_csc.indptr), n_tiles_dev, tc)
    coo, sent = stack_m2_tiles_device(m2_csc, tile_lists, u_pad, device,
                                      pre.qscale2 if int_mode else None)
    if split:
        coo = split_coo(*coo, u_pad, axis=0)
    return dict(zip(("ru", "sl", "vv"), coo)), item_map, sent


def prep_vecs_symmetric(pre: Preprocessed, item_map: np.ndarray, tc: int,
                        n_tiles_dev: int) -> dict:
    """The cheap per-call prep: X/Y epilogue vectors in the slot layout."""
    C = pre.n_output_cols
    return {
        name: vec_by_map(v, item_map, C).reshape(n_tiles_dev, tc)
        for name, v in (("y_t", pre.Yt), ("y_c", pre.Yc), ("y_d", pre.Yd),
                        ("x_t", pre.Xt), ("x_c", pre.Xc), ("x_d", pre.Xd))
    }


def cached_prep_symmetric(pre: Preprocessed, compute_dtype: str, tc: int,
                          n_tiles_dev: int, u_pad: int, device: torch.device,
                          split: bool = False):
    """Two-level prep cache: the COO stacks under a (matrix2, quantization,
    geometry, device) key in the device cache, the per-similarity vector
    layouts nested in that entry under their fingerprints, so a sweep of
    different similarities over one matrix re-stacks nothing. Returns
    (device COO, device vectors, item_map). A miss of either level is a
    ``stage`` span of a traced call (kind "sym_coo" or "sym_vecs"); a
    "sym_coo" miss, whose stacks the device builds, records the bytes it
    uploaded (``attrs["upload_bytes"]``) and counts in ``cache_info()``'s
    ``card_builds``."""

    def upload_all(arrays):
        return {name: upload(a, device) for name, a in arrays.items()}

    def stage_coo():
        stage = spans.current()
        coo, item_map, sent = prep_coo_symmetric(pre, compute_dtype, tc, n_tiles_dev, u_pad,
                                                 device, split)
        if stage is not None:
            stage.attrs["upload_bytes"] = sent
        cache.count_card_build("sym_coo")
        return coo, item_map, {}

    int_mode = compute_dtype in ("int8", "int4")
    coo_key = (
        "sym_coo", pre.fp2, pre.qscale2 if int_mode else None, int_mode, split,
        tc, n_tiles_dev, u_pad, str(device),
    )
    dev_coo, item_map, vec_cache = cache.staged(coo_key, pre.fp2, stage_coo)
    vec_key = (_fingerprint(pre.Yt, pre.Yc, pre.Yd), _fingerprint(pre.Xt, pre.Xc, pre.Xd))
    vecs = vec_cache.get(vec_key)
    if vecs is None:
        with spans.span("stage") as stage:
            vecs = upload_all(prep_vecs_symmetric(pre, item_map, tc, n_tiles_dev))
            if len(vec_cache) >= 16:
                vec_cache.pop(next(iter(vec_cache)))
            vec_cache[vec_key] = vecs
            cache.record(stage, "sym_vecs", vecs)
    return dev_coo, vecs, item_map


# ---------------------------------------------------------------------------
# Orchestration
# ---------------------------------------------------------------------------


def _wide_k_block(*args, **kwargs):
    """One block of the k_pad > MAX_KERNEL_K_PAD branch: plain PyTorch, as
    the reference hands k_pad > 1024 from its kernel to XLA
    (symmetric.py:913-920). Counted apart from K2's two routes."""
    global wide_k_calls
    wide_k_calls += 1
    return sym_topk._plain(*args, **kwargs)


def _pack_rows_dual(crv, cri, ccv_tiles, cci_tiles, k: int):
    """The final (sw, k) top-k of one finished anchor group: its row-side
    plane (k_pad_r, sw) and its tiles' col-side planes, whose lists are
    disjoint by the delivery masks, merged by one stable sort (row-side
    entries first among ties, as lax.top_k over the concatenation)."""
    all_v = torch.cat([crv, torch.cat(ccv_tiles, dim=1)]).T
    all_i = torch.cat([cri, torch.cat(cci_tiles, dim=1)]).T
    vals, pos = torch.sort(all_v, dim=1, descending=True, stable=True)
    return vals[:, :k], torch.gather(all_i, 1, pos[:, :k])


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def execute_symmetric(
    pre: Preprocessed,
    params: SPlusParams,
    *,
    compute_dtype: str = "auto",
    precision: str = "highest",
    budget_bytes: int,
    progress=None,
    device: torch.device,
    tile_fn: str = "kernel",
    mesh=None,
):
    """Self-similarity top-k; returns host (C, k) vals f32 and idx int32.

    An f32 call with precision='high' runs K2's split-bf16x3 mode, or rides
    bf16 when the data is exact in it (last_plan["f32x3"] is 'both' or
    None); every other call runs its compute type as it is.
    `tile_fn` "plain" runs K2's and K5's plain versions even on a card
    (for comparisons only). With `mesh` (``parallel.make_mesh``) this rank
    runs its share of the pair schedule (``sym_sharded.pair_schedule``) on
    the budget agreed over ranks, and every rank returns the whole result."""
    t_enter = time.perf_counter()
    C = pre.n_output_cols
    U = pre.m1.shape[1]
    k = pre.k
    R_sh, C_sh = pmesh.axis_sizes(mesh)
    r_me, c_me = pmesh.coordinate(mesh)
    N, me = R_sh * C_sh, r_me * C_sh + c_me
    compute_dtype, inv_scale = resolve_compute_dtype(compute_dtype, pre)
    # precision='high' (symmetric.py:877-896): both sides are the one
    # matrix, so 'both', or one exact bf16 phase when bf16 holds its values
    f32x3 = None
    if compute_dtype == "float32" and precision == "high":
        if bf16_exact(pre.fp2, pre.m2):
            compute_dtype = "bfloat16"
        else:
            f32x3 = "both"
    int8_mode = compute_dtype in ("int8", "int4")
    cdt = compute_cast(compute_dtype)

    # cached uploads of OTHER matrices occupy real device memory: plan
    # around them, floored at a quarter of the budget; every rank plans
    # with the smallest such budget
    budget = budget_bytes
    foreign = cache.foreign_cache_bytes((pre.fp1, pre.fp2))
    if foreign > (budget * 3) // 4:
        warnings.warn(
            f"device cache holds {foreign / 2**30:.1f} GiB of other matrices' "
            f"uploads (> 75% of the {budget / 2**30:.1f} GiB device budget); "
            "planning with a floored 25% budget — call "
            "similaripy_tpu_torch.clear_caches() if this call runs out of memory",
            RuntimeWarning,
            stacklevel=2,
        )
    budget = pmesh.agree_min(max(budget // 4, budget - foreign), mesh)

    # carry depth: no row has more than C candidates
    k_kern = min(k, C)
    k_pad = round_up(k_kern, 8)
    if k_pad > sym_topk.MAX_KERNEL_K_PAD:
        f32x3 = None  # the plain branch multiplies in true f32 (symmetric.py:913-920)
    split = f32x3 is not None
    # a split call plans as "split": 4 bytes an element, twice the COO entries
    tc, gt, u_pad = _plan(C, U, pre.m2.nnz * (2 if split else 1),
                          "split" if split else compute_dtype, budget, k_pad)
    if k_pad > sym_topk.MAX_KERNEL_K_PAD:
        step = _wide_k_block
    elif tile_fn == "plain":
        step = sym_topk.fused_sym_topk_plain
    else:
        step = sym_topk.fused_sym_topk
    densify = scatter.densify_tiles_plain if tile_fn == "plain" else scatter.densify_tiles

    n_tiles = math.ceil(C / tc)
    n_groups = math.ceil(n_tiles / gt)
    n_tiles_dev = n_groups * gt
    Cdev = n_tiles_dev * tc
    sw = gt * tc
    schedule = pair_schedule(n_tiles_dev, gt, N)

    dev_coo, vecs, item_map = cached_prep_symmetric(
        pre, compute_dtype, tc, n_tiles_dev, u_pad, device, split
    )
    # what K5 densifies: the [hi; lo] bf16 stacks of a split call; int8
    # tiles K-major, (tc, u_pad), since 8-bit wgmma reads no other layout
    tile_k, tile_cdt = (2 * u_pad, torch.bfloat16) if split else (u_pad, cdt)
    layout = "kmajor" if int8_mode else "mn"
    pvec_host = build_pvec(params, inv_scale)
    flags = params.static_flags()
    asym = not epilogue_is_symmetric(pre, params)
    k_pad_r, k_pad_c = sym_topk.sym_k_pads(k_kern, tc, sw)
    anatomy = schedule_anatomy(n_tiles=n_tiles_dev, gt=gt, N=N)

    last_plan.clear()
    last_plan.update(
        compute_dtype=compute_dtype, f32x3=f32x3, tc=tc, gt=gt, u_pad=u_pad, k_pad=k_pad,
        n_tiles=n_tiles_dev, n_groups=n_groups, sw=sw, pairs=len(schedule),
        asym=asym, mesh=(R_sh, C_sh), rank=me, budget=budget,
        # this rank's share of the schedule (all of it on one device)
        blocks=anatomy["k2_blocks"][me], scatters=anatomy["k5_scatters"][me],
    )

    # carries, full width on every rank: one row-side plane per anchor
    # group, one col-side plane per tile, so every K2 call reads and
    # replaces whole contiguous planes
    def planes(depth, width, count):
        return (
            [torch.full((depth, width), NEG_INF, device=device) for _ in range(count)],
            [torch.zeros((depth, width), dtype=torch.int32, device=device)
             for _ in range(count)],
        )

    with spans.span("alloc"):
        crv, cri = planes(k_pad_r, sw, n_groups)
        ccv, cci = planes(k_pad_c, tc, n_tiles_dev)
        # the host's (C, k) outputs; device slots -> items, where -inf
        # slots carry arbitrary ids, dropped in assembly
        item_ids = item_map.astype(np.int32)
        out_vals = np.full((C, k), NEG_INF, np.float32)
        out_idx = np.zeros((C, k), np.int32)

    def coo(t0, t1):
        return dev_coo["ru"][t0:t1], dev_coo["sl"][t0:t1], dev_coo["vv"][t0:t1]

    def vec3(prefix, t0, t1):
        return tuple(vecs[f"{prefix}_{n}"][t0:t1].reshape(-1) for n in "tcd")

    def densify_range(t0, t1):
        return densify(*coo(t0, t1), u_pad=tile_k, tc=tc, cdt=tile_cdt, layout=layout)

    def k2_tile(tile):
        """One densified tile as K2 takes it, (tile_k, tc): int8 the
        transposed view of its K-major (tc, u_pad) tile (no copy)."""
        return tile.T if int8_mode else tile

    def make_anchor(a: int) -> dict:
        t0, t1 = a * gt, (a + 1) * gt
        tiles = densify_range(t0, t1)  # (gt, tile_k, tc); int8 (gt, tc, u_pad)
        return {
            "a": a,
            "tiles": tiles,
            # what K2 takes: int8 the (sw, u_pad) stack, a view of the tiles
            "lhs": tiles.view(sw, tile_k) if int8_mode else tiles,
            "x": vec3("x", t0, t1),  # X at the anchor's items
            "y2": vec3("y", t0, t1) if asym else None,  # Y at the anchor's items
        }

    def run_step(anchors: dict, sweepers: tuple, t: int):
        """Tile t against the anchors `sweepers` (K2 once for each)."""
        own = anchors.get(t // gt)
        if own is not None:  # the tile is resident in an anchor: slice, no densify
            d = k2_tile(own["tiles"][t - own["a"] * gt])
        else:
            d = k2_tile(densify_range(t, t + 1)[0])
        y = vec3("y", t, t + 1)
        x2 = vec3("x", t, t + 1) if asym else None
        for a in sweepers:
            an = anchors[a]
            pv = np.zeros(16, np.float32)
            pv[:10] = pvec_host
            pv[10:14] = (t * tc, a * gt * tc, t, a * gt)
            rkth = crv[a][k_pad_r - 1].view(sw, 1)
            crv[a], cri[a], ccv[t], cci[t] = step(
                an["lhs"], d, *an["x"], *y, crv[a], cri[a], rkth, ccv[t], cci[t],
                torch.from_numpy(pv).to(device),
                flags=flags, k=k_kern, tc=tc, int8_mode=int8_mode, x2=x2, y2=an["y2"],
                split_f32=split,
            )

    t_prep = time.perf_counter()
    sweep_s = pack_s = 0.0
    done_rows = 0
    for pair, steps in schedule:
        t0 = time.perf_counter()
        with spans.span("sweep"):
            # a pair sweeps its first anchor's band with that anchor alone,
            # then the tiles right of it with both; this rank runs its own steps
            mine, need, _inner = rank_work(pair, steps, gt, me)
            anchors = {a: make_anchor(a) for a in need}
            for t, n in mine:
                run_step(anchors, pair[:n], t)
            del anchors
            _sync(device)
            t1 = time.perf_counter()
        with spans.span("pack"):
            # the pair's rows are final: merge both sides, then (on a mesh)
            # every rank's partials, and copy them out
            parts = [
                _pack_rows_dual(crv[a], cri[a], ccv[a * gt:(a + 1) * gt],
                                cci[a * gt:(a + 1) * gt], k)
                for a in pair
            ]
            vals, idx = pmesh.merge_topk(torch.cat([p[0] for p in parts]),
                                         torch.cat([p[1] for p in parts]), mesh, k)
            vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
            seg = item_map[pair[0] * sw:(pair[-1] + 1) * sw]
            real = seg < C
            out_vals[seg[real]] = vals[real]
            out_idx[seg[real]] = item_ids[idx[real]]
            for a in pair:
                crv[a] = cri[a] = None
                ccv[a * gt:(a + 1) * gt] = cci[a * gt:(a + 1) * gt] = [None] * gt
            t2 = time.perf_counter()
        sweep_s += t1 - t0
        pack_s += t2 - t1
        if progress is not None:
            done = min(C, ((pair[-1] + 1) * sw * C) // Cdev)
            progress.update(done - done_rows)
            done_rows = done
    if progress is not None and done_rows < C:
        progress.update(C - done_rows)
    last_plan["stages"] = {
        "prep_s": t_prep - t_enter, "sweep_s": sweep_s, "pack_s": pack_s,
    }
    return out_vals, out_idx
