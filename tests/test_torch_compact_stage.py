"""The compaction executor's "compact_m1" staging on the call's device
(compact.stage_panels through compact.plan_compact_device) against the
NumPy plan it stands in for (compact.plan_compact on the quantized target
slice, its stacks uploaded and densified): the buckets, the panels' rows,
the COO stacks, the dense hot and cold lhs, the gather ids, the target
vectors and the rank table, element for element. Runs on the CPU; the
last test repeats the comparison on a card and skips without one. No JAX
is needed:
    python -m pytest tests/test_torch_compact_stage.py --noconftest -q
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from similaripy_tpu_torch.engine import compact, scatter, staging
from similaripy_tpu_torch.engine.preprocess import preprocess

torch.set_num_threads(2)

CPU = torch.device("cpu")


def _int_matrix(rows, cols, density, seed):
    rng = np.random.default_rng(seed)
    m = sp.random_array((rows, cols), density=density, format="csr",
                        dtype=np.float32, random_state=rng)
    m.data[:] = np.round(m.data * 4) + 1.0  # small ints: every mode runs
    return m


def _power_law(n_rows, n_cols, max_deg, seed, alpha=1.1):
    """Rows of 1 to max_deg - 1 users drawn by a power law over the users,
    values small integers: most entries fall in a hot prefix, so panels'
    cold unions fit the buckets."""
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, n_cols + 1) ** alpha
    w /= w.sum()
    rows, cols = [], []
    for r in range(n_rows):
        c = rng.choice(n_cols, size=int(rng.integers(1, max_deg)), replace=False, p=w)
        rows.extend([r] * len(c))
        cols.extend(c.tolist())
    vals = rng.integers(1, 6, len(rows)).astype(np.float32)
    return sp.csr_array((vals, (rows, cols)), shape=(n_rows, n_cols))


def _skewed():
    """test_compact_skewed_degrees_promotion's matrix: 11 head rows of 2,000
    uniform users, the rest 1-59 users drawn by a power law."""
    n_rows, n_cols = 400, 4096
    rng = np.random.default_rng(11)
    w = 1.0 / np.arange(1, n_cols + 1) ** 1.1
    w /= w.sum()
    rows, cols = [], []
    for r in range(n_rows):
        c = (rng.choice(n_cols, size=2000, replace=False) if r <= 10
             else rng.choice(n_cols, size=int(rng.integers(1, 60)), replace=False, p=w))
        rows.extend([r] * len(c))
        cols.extend(c.tolist())
    return sp.csr_array((np.ones(len(rows), np.float32), (rows, cols)), shape=(n_rows, n_cols))


def _mixed():
    """Light rows above heavy ones: cold buckets and a dense one in one
    plan."""
    light = _power_law(1200, 8192, 20, 5)
    heavy = _int_matrix(300, 8192, 0.3, 6)
    return sp.csr_array(sp.vstack([light, heavy]).tocsr())


def _promoted():
    """Two provisional panels whose cold unions (about 680 users each, in
    disjoint blocks) fit the 768 bucket; dealt round-robin, each panel
    gets rows of both blocks (about 990 users), overflows 768 and is
    promoted to 1,536. Every row has 40 users of the hot prefix and 6 of
    its block, so the degree order is the row order."""
    rng = np.random.default_rng(41)
    rows, cols = [], []
    for r in range(512):
        block = 1000 if r < 256 else 2000
        c = np.concatenate([rng.choice(768, 40, replace=False),
                            block + rng.choice(800, 6, replace=False)])
        rows.extend([r] * len(c))
        cols.extend(c.tolist())
    vals = rng.integers(1, 6, len(rows)).astype(np.float32)
    return sp.csr_array((vals, (rows, cols)), shape=(512, 4096))


def _with_empty_rows(m, rows):
    m = m.tolil()
    for r in rows:
        m[r, :] = 0
    return sp.csr_array(m.tocsr())


# name -> (matrix, its targets, the hot-prefix height HOT or None, the
# bucket widths B of the plan, 0 the dense bucket)
CASES = {
    "buckets": (lambda: _power_law(1500, 8192, 20, 21), lambda n: np.arange(0, n, 2), None,
                [768]),
    "dense": (_mixed, lambda n: np.arange(n), None, [768, 3072, 0]),
    "skewed": (_skewed, lambda n: np.arange(n), None, [768, 0]),
    "promotion": (_promoted, lambda n: np.arange(n), None, [1536]),
    "tiny_hot": (lambda: _int_matrix(300, 20000, 0.002, 10), lambda n: np.arange(n), 768,
                 [1536, 0]),
    "empty_rows": (lambda: _with_empty_rows(_power_law(1500, 8192, 20, 22), range(0, 1500, 7)),
                   lambda n: np.arange(n), None, [768]),
    "repeated": (lambda: _power_law(1500, 8192, 20, 23),
                 lambda n: np.concatenate([np.arange(0, n, 2), np.arange(0, n, 3), [5, 5, 5]]),
                 None, [768]),
}


def _host_stage(pre, dtype, u_pad, H):
    """The m1 side as the host staged it before the device did: the
    quantized target slice, plan_compact, its stacks uploaded and
    densified (the plain densify)."""
    m1_t = pre.m1[pre.targets]
    if dtype == "int8":
        m1_t.data = np.rint(m1_t.data * pre.qscale1).astype(np.float32)
    plan = compact.plan_compact(m1_t, pre.targets, pre.Xt, pre.Xc, pre.Xd, u_pad=u_pad,
                                TM=compact.TM, H=H, uc_buckets=compact.cold_buckets(H, u_pad))
    out = []
    for b in plan.buckets:
        hot, cold = compact._scatter_lhs(
            *(torch.from_numpy(a) for a in (b.pr, b.pc, b.pv)), K=b.K, H=H, dense=b.B == 0,
            cdt=staging.compute_cast(dtype), densify=scatter.densify_tiles_plain)
        out.append((b, hot, cold))
    return plan, out


def _assert_stage_equal(pre, dtype, device):
    """stage_panels on `device` against the host's plan, element for
    element; returns the plan's bucket widths."""
    U = pre.m1.shape[1]
    u_pad = max(staging.round_up(U, compact.KB), compact.KB)
    H = compact._hot_height(u_pad)
    src = compact.stage_source(pre, device)
    buckets, table = compact.stage_panels(pre, dtype, u_pad=u_pad, device=device,
                                          densify=scatter.densify_tiles_plain, src=src)
    plan, want = _host_stage(pre, dtype, u_pad, H)
    assert table.dtype == torch.int32 and table.device == device
    np.testing.assert_array_equal(table.cpu().numpy(), np.append(plan.rank_of, u_pad))
    qscale = pre.qscale1 if dtype == "int8" else None
    dplan, _sent = compact.plan_compact_device(
        src, pre.m1, pre.targets, pre.Xt, pre.Xc, pre.Xd,
        qscale=qscale, u_pad=u_pad, TM=compact.TM, H=H,
        uc_buckets=compact.cold_buckets(H, u_pad), device=device)
    assert len(buckets) == len(want) == len(dplan.buckets)
    for got, d, (b, hot, cold) in zip(buckets, dplan.buckets, want):
        assert (got["B"], got["K"]) == (b.B, b.K)
        assert len(got["panel_rows"]) == len(b.panel_rows)
        for r_got, r_want in zip(got["panel_rows"], b.panel_rows):
            np.testing.assert_array_equal(r_got, r_want)
        # the COO stacks themselves: every entry where the host put it
        for name in ("pr", "pc", "pv"):
            np.testing.assert_array_equal(getattr(d, name).cpu().numpy(), getattr(b, name),
                                          err_msg=name)
        for name, want_t in (("hot", hot), ("cold", cold)):
            if want_t is None:
                assert got[name] is None
            else:
                assert got[name].dtype == want_t.dtype
                assert torch.equal(got[name].cpu(), want_t), name
        if b.gather_idx is None:
            assert got["gi"] is None
        else:
            assert got["gi"].dtype == torch.int32
            np.testing.assert_array_equal(got["gi"].cpu().numpy(), b.gather_idx)
        for name in ("sx_t", "sx_c", "sx_d"):
            np.testing.assert_array_equal(got[name].cpu().numpy(), getattr(b, name))
    return [b.B for b in plan.buckets]


@pytest.mark.parametrize("dtype", ["int8", "float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_device_stage_equals_the_numpy_plan(monkeypatch, case, dtype):
    make, targets_of, hot, widths = CASES[case]
    if hot is not None:
        monkeypatch.setattr(compact, "HOT", hot)
    m = make()
    targets = targets_of(m.shape[0])
    pre = preprocess(m, m.T, k=20, l2=1.0, l3=1.0, p1=0.5, p2=0.5,
                     weight_depop_matrix1="sum", target_rows=targets)
    assert pre.Xc is not None and pre.Xd is not None
    assert _assert_stage_equal(pre, dtype, CPU) == widths


@pytest.mark.cuda
def test_card_stage_equals_the_cpu_stage():
    """At about a million entries on a card: the card's stage against the
    NumPy plan (and so against the CPU's), in int8 and float32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    card = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(31)
    m = _int_matrix(4_000, 50_000, 0.005, 31)
    m.data[:] = rng.integers(1, 11, m.nnz) * np.float32(0.5)
    assert 900_000 < m.nnz < 1_100_000
    targets = rng.choice(m.shape[0], 1_500, replace=False)
    pre = preprocess(m, m.T, k=20, l2=1.0, target_rows=targets)
    for dtype in ("int8", "float32"):
        assert any(_assert_stage_equal(pre, dtype, card))  # a bucket gathers
