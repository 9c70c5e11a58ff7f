"""Two checkouts of the repository on one CUDA card, in turns.

    python -m similaripy_tpu_torch.benchmarks.compare_checkouts A_ROOT B_ROOT [--rounds 2]

Each turn is a process of its own that imports one checkout's package and
its ``chip_smoke.py``, so it builds and runs that checkout's kernels, and
runs the smoke's phase ``main`` (the main path at ML-32M width on the
tracked ``.bench_data_1.0.npz``, read from the first checkout that holds
it). The turns go A, B, B, A for two rounds (A, B, B, A, A, B, B, A for
four), so that both checkouts see the card and the host alike. Before the
turns, each checkout's K1 and K3 run on the same seeded operands in f32,
bf16 and int8 (raw products; K3 with a bias), and the script reports
whether their values and ids are bitwise equal.

Prints one JSON line for the outputs and one per turn: the label ("a" or
"b"), the route and wall of every call of phase ``main`` in its order,
and its compaction-against-general table. Needs a card; exits 1 without
one. Use it to compare a change with its parent: unpack the parent with
``git archive`` into a git-ignored directory and pass both roots.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import torch

DATA_NAME = ".bench_data_1.0.npz"

# one turn: phase main of the checkout at argv[1], the data at argv[3]
_TURN = """
import json, sys, time
import numpy as np, scipy.sparse as sp, torch
root, label, data = sys.argv[1:4]
sys.path.insert(0, root)
import chip_smoke as cs
import similaripy_tpu_torch as sim
from similaripy_tpu_torch.engine import build, executor as ex, gather, panel_topk
from similaripy_tpu_torch.engine import scatter, sym_topk, tile_topk
torch.backends.cuda.matmul.allow_tf32 = False
build.build()
build.load()
urm = sp.load_npz(data).tocsr().astype(np.float32)
counters = {"tile_topk": tile_topk, "sym_topk": sym_topk, "scatter": scatter,
            "panel_topk": panel_topk, "gather": gather}
t = time.perf_counter()
main_path, _ = cs.phase_main(torch, sim, counters, ex, urm, torch.device("cuda"))
print(json.dumps({"label": label, "main_s": time.perf_counter() - t,
                  "calls": [[c["route"], c["seconds"]] for c in main_path["calls"]],
                  "compaction": {k: {n: v[n] for n in ("compact_s", "general_s", "faster")}
                                 for k, v in main_path["compaction"].items()}}))
"""

# K1 and K3 of the checkout at argv[1] on seeded operands, saved to argv[2]
_OUTPUTS = """
import sys
import numpy as np, torch
root, out = sys.argv[1:3]
sys.path.insert(0, root)
from similaripy_tpu_torch.engine import panel_topk, tile_topk
dev = torch.device("cuda")
res = {}
for mode, dt in (("f32", torch.float32), ("bf16", torch.bfloat16), ("int8", torch.int8)):
    rng = np.random.default_rng(5)
    for name, (m, k, n) in (("k1", (384, 20000, 1536)), ("k3", (256, 6144, 4096))):
        if mode == "int8":
            a = rng.integers(-128, 128, (m, k)) * (rng.random((m, k)) < 0.2)
            d = rng.integers(-128, 128, (k, n)) * (rng.random((k, n)) < 0.2)
        else:
            a = rng.standard_normal((m, k)) * (rng.random((m, k)) < 0.2)
            d = rng.standard_normal((k, n)) * (rng.random((k, n)) < 0.2)
        a, d = torch.from_numpy(a).to(dev).to(dt), torch.from_numpy(d).to(dev).to(dt)
        ones_m, ones_n = torch.ones(m, device=dev), torch.ones(n, device=dev)
        pv = torch.zeros(16, device=dev)
        pv[9] = 1.0
        vecs = (ones_m, ones_m, ones_m, ones_n, ones_n, ones_n, pv)
        kw = dict(flags=(False,) * 6, k_pad=64, int8_mode=mode == "int8")
        if name == "k1":
            v, i = tile_topk.fused_tile_topk(a, d, *vecs, **kw)
        else:
            bias = (rng.integers(-1000, 1000, (m, n)).astype(np.int32) if mode == "int8"
                    else rng.standard_normal((m, n)).astype(np.float32))
            v, i = panel_topk.fused_panel_topk(a, d, *vecs, bias=torch.from_numpy(bias).to(dev),
                                               tc=1024, **kw)
        res[f"{name}_{mode}_values"], res[f"{name}_{mode}_ids"] = v.cpu().numpy(), i.cpu().numpy()
np.savez(out, **res)
"""


def _run(code: str, root: str, *args: str) -> str:
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", code, root, *args], cwd=root, env=env,
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"a turn in {root} failed:\n{proc.stderr[-4000:]}")
    return proc.stdout


def compare_outputs(roots) -> dict:
    """Whether each K1 / K3 output of the two checkouts is bitwise equal."""
    import numpy as np

    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, f"{x}.npz") for x in "ab"]
        for root, path in zip(roots, paths):
            _run(_OUTPUTS, root, path)
        a, b = (np.load(p) for p in paths)
        return {k: bool(np.array_equal(a[k], b[k])) for k in a.files}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs=2, metavar="ROOT", help="the two checkouts, A and B")
    ap.add_argument("--rounds", type=int, default=2, help="A, B, B, A counts two rounds")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_checkouts: no CUDA device; this script needs one card", file=sys.stderr)
        return 1
    roots = [os.path.abspath(r) for r in args.roots]
    data = next((os.path.join(r, DATA_NAME) for r in roots
                 if os.path.exists(os.path.join(r, DATA_NAME))), None)
    if data is None:
        print(f"compare_checkouts: neither checkout holds {DATA_NAME}", file=sys.stderr)
        return 1
    print(json.dumps({"outputs_bitwise_equal": compare_outputs(roots)}), flush=True)
    order = [0, 1, 1, 0] * ((args.rounds + 1) // 2)
    for side in order[:2 * args.rounds]:
        print(_run(_TURN, roots[side], "ab"[side], data).strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
