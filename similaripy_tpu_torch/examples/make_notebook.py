"""Generate similaripy_tpu_torch/examples/item_item_recommender.ipynb.

The counterpart of ``examples/make_notebook.py``: the notebook form of the
port's end-to-end pipeline. The script
``similaripy_tpu_torch/examples/item_item_recommender.py`` is the single
source of the pipeline code; the notebook imports its helpers, so the two
forms cannot drift. Re-run this after editing the example to refresh the
checked-in notebook:

    python -m similaripy_tpu_torch.examples.make_notebook

``nbformat`` is imported only when the notebook is built, so this module
imports on a machine without it.
"""

from __future__ import annotations

import os

HERE = os.path.dirname(os.path.abspath(__file__))
NOTEBOOK = os.path.join(HERE, "item_item_recommender.ipynb")

MD = [
    # (position, markdown)
    """# Item-item recommender with similaripy_tpu_torch

End-to-end pipeline, notebook form, on the PyTorch/CUDA port (script twin:
`similaripy_tpu_torch/examples/item_item_recommender.py`; reference
analogue: `notebooks/movielens32m_item_item_recommender.ipynb`):

1. load interactions (synthetic MovieLens-shaped by default — set
   `DATA_PATH` to a real `ratings.csv` / `.npz`),
2. leave-n-out split,
3. BM25-weight the URM,
4. train an item-item similarity model,
5. score users with seen-item filtering,
6. evaluate NDCG@10 / recall@10,
7. (optional) tune rp3beta and draw the 2-D item-space map.

Every call runs on `DEVICE`: `"cuda"` (one card; it raises without one) or
`"cpu"` (the kernels' plain PyTorch versions).""",
    """## 1. Data

`DATA_PATH = None` builds a synthetic power-law URM so the notebook runs
without network egress; point it at a MovieLens-format ratings file to
use real data.""",
    """## 2. Split and BM25 preprocessing

Leave-2-out per user (the reference notebook splits temporally; synthetic
data has no timestamps). BM25 weighting sharpens informative
interactions, exactly as in the reference pipeline.""",
    """## 3. Train the similarity model

`rp3beta` on the transposed URM — the random-walk similarity the
reference notebook tunes. Swap in `sim.cosine`, `sim.asymmetric_cosine`,
`sim.s_plus`, ... freely; all nine similarities share the same engine.""",
    """## 4. Score and evaluate

Recommendations are `URM @ W.T` with the user's seen items masked
*before* top-K (`filter_cols=train`) — the reference's two-stage
retrieval pattern.""",
    """## 5. Hyperparameter tuning (optional)

Optuna when installed, seeded random search otherwise. A handful of
trials is enough to see the (alpha, beta) response surface move.""",
    """## 6. Item-space visualization (optional)

Truncated-SVD projection of the BM25-weighted item vectors with the
strongest learned similarity edges drawn on top (the reference notebook
uses UMAP; SVD ships with SciPy).""",
]

DEVICE_CELL = 'DEVICE = "cuda"  # or "cpu"'

CODE = [
    """import os, sys, time
# the notebook lives in similaripy_tpu_torch/examples/: put the checkout's
# root on the path
sys.path.insert(0, os.path.abspath(os.path.join(os.getcwd(), "..", "..")))

import numpy as np
import scipy.sparse as sp

import similaripy_tpu_torch as sim
from similaripy_tpu_torch.utils.synth import synthetic_urm
from similaripy_tpu_torch.examples.item_item_recommender import (
    holdout_split, ndcg_and_recall_at)

DATA_PATH = None  # e.g. "data/movielens_32m/ratings.csv"
K = 100  # similarity neighbors

if DATA_PATH:
    from similaripy_tpu_torch.benchmarks.dataset_loaders import load_file
    urm = load_file(DATA_PATH)
else:
    urm = synthetic_urm(n_users=20_000, n_items=4_000, nnz=400_000)
urm = sp.csr_array(urm[np.diff(urm.indptr) >= 5])  # drop sparse users
print(f"URM: {urm.shape[0]:,} x {urm.shape[1]:,}, nnz={urm.nnz:,}")""",
    """train, test = holdout_split(urm)
train_w = sim.normalization.bm25(train, axis=1, k1=1.2, b=0.75, device=DEVICE)
print(f"train nnz={train.nnz:,}, held-out nnz={test.nnz:,}")""",
    """t0 = time.perf_counter()
W = sim.rp3beta(train.T, alpha=1.0, beta=0.6, k=K, verbose=False, device=DEVICE)
print(f"rp3beta similarity: {time.perf_counter() - t0:.2f}s, nnz={W.nnz:,}")""",
    """recs = sim.dot_product(train_w, W.T, k=10, filter_cols=train,
                       verbose=False, format_output="csr", device=DEVICE)
ndcg, recall = ndcg_and_recall_at(recs, test, n=10)
print(f"NDCG@10 = {ndcg:.4f}   recall@10 = {recall:.4f}")""",
    """N_TRIALS = 0  # set to e.g. 10 to tune
if N_TRIALS:
    from similaripy_tpu_torch.examples.item_item_recommender import tune_hyperparams
    best = tune_hyperparams(train, train_w, test, K, N_TRIALS, device=DEVICE)
    W = sim.rp3beta(train.T, k=K, verbose=False, device=DEVICE, **best)
    recs = sim.dot_product(train_w, W.T, k=10, filter_cols=train,
                           verbose=False, format_output="csr", device=DEVICE)
    ndcg, recall = ndcg_and_recall_at(recs, test, n=10)
    print(f"tuned: NDCG@10 = {ndcg:.4f}   recall@10 = {recall:.4f}")""",
    """DRAW = False  # set True to render the item-space map
if DRAW:
    from similaripy_tpu_torch.examples.item_item_recommender import visualize_item_space
    visualize_item_space(train_w, W, "item_space.png")""",
]


def build():
    """The notebook: the title, the DEVICE cell, then each section's
    markdown and code."""
    import nbformat as nbf

    nb = nbf.v4.new_notebook()
    nb.metadata["kernelspec"] = {
        "display_name": "Python 3", "language": "python", "name": "python3",
    }
    cells = [nbf.v4.new_markdown_cell(MD[0]), nbf.v4.new_code_cell(DEVICE_CELL)]
    for md, code in zip(MD[1:], CODE):
        cells.append(nbf.v4.new_markdown_cell(md))
        cells.append(nbf.v4.new_code_cell(code))
    nb.cells = cells
    return nb


def main() -> int:
    import nbformat as nbf

    nbf.write(build(), NOTEBOOK)
    print(f"wrote {NOTEBOOK}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
