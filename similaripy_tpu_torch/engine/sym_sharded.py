"""The pair sweep's schedule over the ranks of a mesh.

The counterpart of ``similaripy_tpu/engine/sym_sharded.py``, designed on
the port's own pair sweep (``symmetric.py::execute_symmetric``) rather than
on the JAX package's anchor-prefill schedule, which the port never took.
``execute_symmetric`` is the one sweep, on one device or on a mesh
(``mesh=``):

  - every rank plans the same geometry (tc, gt, u_pad from
    ``symmetric._plan`` on the budget agreed over ranks) and walks the same
    pair schedule (``pair_schedule``);
  - each step of a pair's sweep, one inner tile t against the pair's
    anchors that sweep it, belongs to exactly one rank, dealt round-robin
    by a counter that runs on across pairs (so the remainders spread);
    that rank densifies the tile (K5, unless it is one of its resident
    anchors' own tiles) and runs the K2 blocks of the step;
  - a rank densifies an anchor only if it owns a step that sweeps it;
  - every rank keeps full-width row-side and column-side carry planes;
  - when a pair is finished, each rank merges the pair's rows from its own
    planes (``_pack_rows_dual``), the (rows x k) partials are all-gathered
    over all ranks and re-selected (as JAX ``_pack_rows_sharded`` :439), and
    every rank places them in the whole result.

Each (anchor, tile) block runs on one rank, so the ranks' candidate
streams are disjoint and their union is the single-device candidate set:
the merge is exact. With one rank every step is its own, and the schedule
is the single-device sweep. ``schedule_anatomy`` replays the schedule and
counts, per rank, the K2 blocks, K5 scatters and collectives of a plan.
"""

from __future__ import annotations


def pair_schedule(n_tiles_dev: int, gt: int, N: int) -> list:
    """[(pair, [(t, n_anchors, rank), ...]), ...]: the pair sweep of
    ``execute_symmetric`` with every step dealt to a rank. A dual pair
    sweeps its first anchor's band with that anchor alone, then the tiles
    right of it with both; steps go round-robin by a counter that runs on
    across pairs."""
    n_groups = n_tiles_dev // gt
    out = []
    counter = 0
    for a in range(0, n_groups, 2):
        pair = (a, a + 1) if a + 1 < n_groups else (a,)
        if len(pair) == 2:
            windows = [(1, a * gt, pair[1] * gt), (2, pair[1] * gt, n_tiles_dev)]
        else:
            windows = [(1, a * gt, n_tiles_dev)]
        steps = []
        for n_anchors, c0, c1 in windows:
            for t in range(c0, c1):
                steps.append((t, n_anchors, counter % N))
                counter += 1
        out.append((pair, steps))
    return out


def rank_work(pair: tuple, steps: list, gt: int, rank: int):
    """(this rank's steps, the anchors it densifies, its inner densifies)."""
    mine = [(t, n) for t, n, r in steps if r == rank]
    anchors = sorted({a for _t, n in mine for a in pair[:n]})
    inner = sum(1 for t, n in mine if t // gt not in pair[:n])
    return mine, anchors, inner


def schedule_anatomy(*, n_tiles: int, gt: int, N: int) -> dict:
    """Per-rank work of the sharded symmetric schedule for a plan of
    ``n_tiles`` device tiles in anchor groups of ``gt`` over ``N`` ranks
    (the counterpart of JAX ``sym_sharded.py:83``): the K2 blocks, the K5
    scatters (one per densify call: an anchor group or an inner tile) and
    the collectives (the budget agreement and one all-gather a pair, when
    N > 1) each rank issues."""
    sched = pair_schedule(n_tiles, gt, N)
    k2 = [0] * N
    k5 = [0] * N
    for pair, steps in sched:
        for rank in range(N):
            mine, anchors, inner = rank_work(pair, steps, gt, rank)
            k2[rank] += sum(n for _t, n in mine)
            k5[rank] += len(anchors) + inner
    coll = 1 + len(sched) if N > 1 else 0
    return {
        "N": N, "n_tiles": n_tiles, "gt": gt, "pairs": len(sched),
        "k2_blocks": k2, "k5_scatters": k5, "collectives": [coll] * N,
    }
