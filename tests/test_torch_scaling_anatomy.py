"""The port's scaling anatomy (``similaripy_tpu_torch/benchmarks/
scaling_anatomy.py``): per-rank work of the sharded symmetric schedule at
N cards, with modeled seconds from the planner's own cost model.

The ranks' K2 blocks partition the single device's, their inner K5
densifies too (an anchor group is densified by every rank that sweeps
it); the busiest rank holds at most its 1/N share plus one step per
sweep window; the N=1 rows at ML-32M geometry are the plans and launch
counts the card ran (chip_smoke.py, PERF.md section 5), and the N=2 int8
row the launches of its two gloo ranks; the modeled seconds follow the
stated formula, and the table and the planner count the same work. The
JAX package's anatomy replays another schedule (its anchor prefill) at
TPU rates, so only the geometry is shared with it.
"""

import json
import math
import os
import sys

import pytest

from similaripy_tpu_torch.benchmarks import scaling_anatomy as sa
from similaripy_tpu_torch.engine import symmetric
from similaripy_tpu_torch.engine.sym_sharded import pair_schedule, rank_work, schedule_anatomy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ML32M = sa.ML32M
GEOMETRIES = [(21, 1), (42, 1), (42, 2), (18, 3), (7, 1), (10, 2)]


def _windows(n_tiles, gt):
    return sum(2 if len(pair) == 2 else 1 for pair, _ in pair_schedule(n_tiles, gt, 1))


@pytest.mark.parametrize("n_tiles,gt", GEOMETRIES)
def test_ranks_partition_the_single_device_work(n_tiles, gt):
    a1 = schedule_anatomy(n_tiles=n_tiles, gt=gt, N=1)
    inner1 = sum(rank_work(p, s, gt, 0)[2] for p, s in pair_schedule(n_tiles, gt, 1))
    for n in (2, 4, 8):
        a = schedule_anatomy(n_tiles=n_tiles, gt=gt, N=n)
        assert sum(a["k2_blocks"]) == sum(a1["k2_blocks"])
        sched = pair_schedule(n_tiles, gt, n)
        inner = anchors = 0
        for pair, steps in sched:
            # every step on exactly one rank
            assert sorted(t for t, _n, _r in steps) == [t for t, _n, _r in steps]
            for rank in range(n):
                _mine, own, ins = rank_work(pair, steps, gt, rank)
                assert set(own) <= set(pair)
                inner += ins
                anchors += len(own)
        assert inner == inner1
        assert sum(a["k5_scatters"]) == inner + anchors
        assert sum(a["k5_scatters"]) >= sum(a1["k5_scatters"])


@pytest.mark.parametrize("n_tiles,gt", GEOMETRIES)
def test_busiest_rank_within_one_step_a_window_of_its_share(n_tiles, gt):
    total = sum(schedule_anatomy(n_tiles=n_tiles, gt=gt, N=1)["k2_blocks"])
    windows = _windows(n_tiles, gt)
    prev = math.inf
    for n in (2, 4, 8):
        busiest = max(schedule_anatomy(n_tiles=n_tiles, gt=gt, N=n)["k2_blocks"])
        assert busiest <= math.ceil(total / n) + windows, (n, busiest, total)
        assert busiest <= prev
        prev = busiest


@pytest.mark.parametrize("n_tiles,gt", GEOMETRIES)
def test_table_counts_the_planners_work(n_tiles, gt):
    """Summed over the ranks, K2 blocks and K5 tiles equal the planner's
    _triangle_counts at every N, so model and planner cannot disagree."""
    products, densifies = symmetric._triangle_counts(n_tiles, gt)
    assert sum(schedule_anatomy(n_tiles=n_tiles, gt=gt, N=1)["k2_blocks"]) == products
    assert sa.k5_tiles(n_tiles, gt, 1) == [densifies]
    if gt == 1:
        assert sa.k5_tiles(n_tiles, gt, 1) == schedule_anatomy(
            n_tiles=n_tiles, gt=gt, N=1)["k5_scatters"]


@pytest.mark.parametrize("dtype,plan,k2,k5", [
    ("int8", (4096, 1, 21), 231, 121),
    ("float32", (2048, 1, 42), 903, 462),
    ("split", (2048, 2, 42), 462, 221),
])
def test_single_card_rows_equal_the_smokes_plans(dtype, plan, k2, k5):
    table = sa.anatomy_table(**ML32M, n_list=(1,), compute_dtype=dtype)
    pl, row = table["plan"], table["mesh_sizes"][0]
    assert (pl["tc"], pl["gt"], pl["n_tiles"], pl["u_pad"]) == (*plan, 200_960)
    assert row["k2_blocks"] == [k2] and row["k5_scatters"] == [k5]
    assert row["collectives"] == [0]
    assert row["collective_bytes_per_rank"] == {"sent": 0, "received": 0}


def test_two_rank_int8_row_equals_the_gloo_ranks():
    row = sa.anatomy_table(**ML32M, n_list=(1, 2))["mesh_sizes"][1]
    assert row["k2_blocks"] == [116, 115]
    assert row["k5_scatters"] == [71, 70]
    # the budget agreement and one all-gather a pair (11 pairs)
    assert row["collectives"] == [12, 12]
    # each rank contributes every slot's k entries (value and id) once
    sent = 21 * 4096 * 100 * 8 + 8
    assert row["collective_bytes_per_rank"] == {"sent": sent, "received": sent}


@pytest.mark.parametrize("dtype", ["int8", "float32", "split", "bfloat16"])
def test_modeled_seconds_follow_the_formula(dtype):
    table = sa.anatomy_table(**ML32M, compute_dtype=dtype)
    pl = table["plan"]
    nnz = ML32M["nnz"] * (2 if dtype == "split" else 1)
    t_block = pl["gt"] * pl["tc"] * pl["tc"] * pl["u_pad"] * 2 / symmetric._PRODUCT_RATE[dtype]
    t_tile = nnz / math.ceil(ML32M["C"] / pl["tc"]) / symmetric._DENSIFY_NNZ_RATE[dtype]
    base = None
    for row in table["mesh_sizes"]:
        sums = [(b * t_block, s * t_tile) for b, s in zip(row["k2_blocks"], row["k5_tiles"])]
        k2_s, k5_s = max(sums, key=sum)
        m = row["modeled_seconds"]
        assert m["k2"] == pytest.approx(k2_s, rel=1e-12)
        assert m["k5"] == pytest.approx(k5_s, rel=1e-12)
        assert m["total"] == pytest.approx(k2_s + k5_s, rel=1e-12)
        base = base or m["total"]
        assert row["modeled_speedup_vs_1"] == pytest.approx(base / m["total"])
        assert row["modeled_efficiency"] == pytest.approx(base / m["total"] / row["N"])
    # the planner's rate for this geometry: f32 and int8 rows model the sweep
    # the card measured within a third (32.4 s, and 1.18 s on wgmma s8,
    # PERF.md section 5)
    if dtype in ("float32", "int8"):
        want = {"float32": 32.363, "int8": 1.182}[dtype]
        assert abs(table["mesh_sizes"][0]["modeled_seconds"]["total"] / want - 1) < 1 / 3


def test_main_writes_the_table(tmp_path, capsys):
    out = tmp_path / "reports" / "anatomy.json"
    assert sa.main(["--out", str(out)]) == 0
    table = json.loads(out.read_text())
    assert [r["N"] for r in table["mesh_sizes"]] == [1, 2, 4, 8]
    assert table["geometry"] == ML32M
    assert table["plan"]["compute_dtype"] == "int8"
    text = capsys.readouterr().out
    assert "K2/rank" in text and "K5/rank" in text and f"written to {out}" in text


def test_default_report_path_leaves_the_jax_report_alone(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert sa.main([]) == 0
    assert os.listdir(tmp_path / "reports") == ["scaling_anatomy_torch.json"]


def test_no_tpu_constant_and_the_jax_geometry():
    src = open(sa.__file__).read()
    for word in ("MXU", "ICI", "v5e", "296e12", "SCATTER_NNZ_RATE", "GBPS"):
        assert word not in src, word
    sys.path.insert(0, REPO)
    try:
        from benchmarks.scaling_anatomy import ML32M as jax_ml32m
    finally:
        sys.path.remove(REPO)
    assert ML32M == jax_ml32m


def test_new_modules_import_with_jax_blocked():
    """The example, its notebook generator, the anatomy and bench_n2 import,
    and the table is built, where importing jax, similaripy_tpu or the
    top-level benchmarks fails."""
    import subprocess
    import textwrap

    script = textwrap.dedent("""
        import sys
        for name in ("jax", "similaripy_tpu", "benchmarks", "nbformat"):
            sys.modules[name] = None
        import similaripy_tpu_torch.examples.item_item_recommender
        import similaripy_tpu_torch.examples.make_notebook
        import similaripy_tpu_torch.benchmarks.bench_n2
        from similaripy_tpu_torch.benchmarks import scaling_anatomy as sa
        assert sa.anatomy_table(**sa.ML32M, n_list=(2,))["mesh_sizes"][0]["k2_blocks"] == [116, 115]
        leaked = [n for n in sys.modules if n == "jax" and sys.modules[n] is not None
                  or n.startswith(("jax.", "jaxlib", "similaripy_tpu.", "benchmarks."))]
        assert not leaked, leaked
        print("isolated ok")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "isolated ok" in proc.stdout
