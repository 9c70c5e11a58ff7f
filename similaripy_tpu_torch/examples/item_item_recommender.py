"""End-to-end item-item recommender pipeline, on the port.

The counterpart of ``examples/item_item_recommender.py`` (itself the script
form of the reference's MovieLens-32M notebook,
notebooks/movielens32m_item_item_recommender.ipynb): split interactions
into train/test, BM25-normalize the URM, train an item-item similarity
model, score users with seen-item filtering, and evaluate NDCG@10 /
recall@10. Runs on a synthetic MovieLens-shaped dataset by default; pass
--data-path with a ratings CSV or a sparse .npz to use other data. Every
public call runs on ``--device`` (default ``cuda``, which raises without a
card; ``cpu`` runs the kernels' plain versions). It prints the same lines
as the JAX script, so the two outputs can be read side by side.

Usage: python -m similaripy_tpu_torch.examples.item_item_recommender
           [--data-path FILE] [--model rp3beta] [--device cuda]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import scipy.sparse as sp

import similaripy_tpu_torch as sim
from similaripy_tpu_torch.utils.device import resolve_device
from similaripy_tpu_torch.utils.synth import synthetic_urm

# main's latest run: the seconds of each stage ("load", "split", "bm25",
# "model", "scoring", "evaluation"), the matrices it built (urm, train,
# train_w, test, W, recs) and its scores ("ndcg", "recall"; "tuned" after
# --tune), for callers that check a run
last_run: dict = {}


def holdout_split(urm: sp.csr_array, n_holdout: int = 2, seed: int = 7):
    """Leave-n-out per user, vectorized (the notebook uses a temporal
    split; synthetic data has no timestamps, so hold out n random items
    per user with more than n+1 interactions). `urm` is left as it was."""
    rng = np.random.default_rng(seed)
    urm = urm.tocsr()
    counts = np.diff(urm.indptr)
    nnz = urm.nnz
    row_ids = np.repeat(np.arange(urm.shape[0]), counts)

    # rank every nnz within its row by a random key; the n smallest ranks
    # of each eligible row are held out
    keys = rng.random(nnz)
    perm = np.lexsort((keys, row_ids))
    ranks = np.empty(nnz, np.int64)
    ranks[perm] = np.arange(nnz) - np.repeat(urm.indptr[:-1], counts)
    eligible = (counts > n_holdout + 1)[row_ids]
    drop = (ranks < n_holdout) & eligible

    # train takes copies of the index arrays: eliminate_zeros works in
    # place, and on arrays shared with `urm` it would corrupt the caller's
    # matrix (the JAX script shares them)
    train = sp.csr_array(
        (np.where(drop, 0.0, urm.data), urm.indices.copy(), urm.indptr.copy()),
        shape=urm.shape,
    )
    train.eliminate_zeros()
    test = sp.csr_array(
        (np.ones(int(drop.sum()), np.float32), (row_ids[drop], urm.indices[drop])),
        shape=urm.shape,
    )
    return train, test


def ndcg_and_recall_at(recs: sp.csr_array, test: sp.csr_array, n: int = 10):
    """Rank-aware evaluation over held-out items (notebook's NDCG@10)."""
    recs = recs.tocsr()
    test = test.tocsr()
    ndcgs, recalls = [], []
    for u in range(test.shape[0]):
        rel = set(test.indices[test.indptr[u] : test.indptr[u + 1]])
        if not rel:
            continue
        s, e = recs.indptr[u], recs.indptr[u + 1]
        order = np.argsort(-recs.data[s:e])[:n]
        ranked = recs.indices[s:e][order]
        dcg = sum(1.0 / np.log2(r + 2) for r, i in enumerate(ranked) if i in rel)
        idcg = sum(1.0 / np.log2(r + 2) for r in range(min(len(rel), n)))
        ndcgs.append(dcg / idcg if idcg else 0.0)
        recalls.append(len(rel & set(ranked)) / len(rel))
    return float(np.mean(ndcgs)), float(np.mean(recalls))


def tune_hyperparams(train, train_w, test, k: int, n_trials: int, seed: int = 3,
                     device="cuda"):
    """Hyperparameter search for rp3beta (notebook cells 30-36).

    Uses Optuna when installed (the notebook's tuner); otherwise an
    equivalent seeded random search over the same space. Objective is
    NDCG@10 on the held-out split.
    """
    def objective_params(alpha, beta):
        W = sim.rp3beta(train.T, alpha=alpha, beta=beta, k=k, verbose=False,
                        device=device)
        recs = sim.dot_product(
            train_w, W.T, k=10, filter_cols=train, verbose=False,
            format_output="csr", device=device,
        )
        ndcg, _ = ndcg_and_recall_at(recs, test, n=10)
        return ndcg

    try:
        import optuna

        optuna.logging.set_verbosity(optuna.logging.WARNING)

        def objective(trial):
            return objective_params(
                trial.suggest_float("alpha", 0.3, 1.5),
                trial.suggest_float("beta", 0.0, 1.0),
            )

        study = optuna.create_study(
            direction="maximize",
            sampler=optuna.samplers.TPESampler(seed=seed),
        )
        study.optimize(objective, n_trials=n_trials)
        best, best_ndcg = study.best_params, study.best_value
        tuner = "optuna"
    except ImportError:
        rng = np.random.default_rng(seed)
        best, best_ndcg = None, -1.0
        for t in range(n_trials):
            params = {
                "alpha": float(rng.uniform(0.3, 1.5)),
                "beta": float(rng.uniform(0.0, 1.0)),
            }
            ndcg = objective_params(**params)
            print(f"  trial {t}: alpha={params['alpha']:.3f} "
                  f"beta={params['beta']:.3f} -> NDCG@10 {ndcg:.4f}")
            if ndcg > best_ndcg:
                best, best_ndcg = params, ndcg
        tuner = "random-search (optuna not installed)"
    print(f"tuning [{tuner}]: best NDCG@10 {best_ndcg:.4f} with {best}")
    return best


def visualize_item_space(train_w, W, out_path: str, seed: int = 5):
    """2-D item-embedding map (notebook cells 38-42).

    The notebook projects item vectors with UMAP; here the embedding is a
    truncated SVD of the BM25-weighted item x user matrix (available in
    every SciPy install), colored by item popularity, with the learned
    similarity's strongest edges drawn on top.
    """
    from scipy.sparse.linalg import svds

    item_user = train_w.T.tocsr().astype(np.float64)
    u, s, _ = svds(item_user, k=2, random_state=np.random.default_rng(seed))
    xy = u * s  # (n_items, 2)
    pop = np.asarray((train_w != 0).sum(axis=0)).ravel()

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 6))
    sc = ax.scatter(xy[:, 0], xy[:, 1], c=np.log1p(pop), s=4, cmap="viridis")
    Wc = W.tocoo()
    if Wc.nnz:
        strongest = np.argsort(-Wc.data)[:300]
        for e in strongest:
            a, b = Wc.coords[0][e], Wc.coords[1][e]
            ax.plot(xy[[a, b], 0], xy[[a, b], 1], lw=0.2, c="gray", alpha=0.3)
    fig.colorbar(sc, label="log(1+popularity)")
    ax.set_title("item space (truncated-SVD projection, top similarity edges)")
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    print(f"item-space map written to {out_path}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data-path", default=None, metavar="FILE",
                   help="ratings file (MovieLens-format .csv or .npz sparse "
                        "matrix) instead of synthetic data")
    p.add_argument("--users", type=int, default=20_000)
    p.add_argument("--items", type=int, default=4_000)
    p.add_argument("--nnz", type=int, default=400_000)
    p.add_argument("--k", type=int, default=100, help="similarity neighbors")
    p.add_argument("--model", default="rp3beta",
                   choices=["cosine", "asymmetric_cosine", "rp3beta", "s_plus"])
    p.add_argument("--tune", type=int, default=0, metavar="N",
                   help="run N hyperparameter-tuning trials (rp3beta)")
    p.add_argument("--viz", default=None, metavar="PNG",
                   help="write a 2-D item-space visualization here")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where every call runs (cuda raises without a card)")
    args = p.parse_args(argv)
    dev = args.device
    resolve_device(dev)  # no card for 'cuda': raise before the data is read
    last_run.clear()
    seconds = last_run["seconds"] = {}

    t0 = time.perf_counter()
    if args.data_path:
        from similaripy_tpu_torch.benchmarks.dataset_loaders import load_file

        print(f"loading ratings from {args.data_path}...")
        urm = load_file(args.data_path)
    else:
        print(f"building synthetic URM ({args.users}x{args.items}, "
              f"nnz={args.nnz})...")
        urm = synthetic_urm(n_users=args.users, n_items=args.items,
                            nnz=args.nnz)
    # drop empty users/items for a denser eval
    keep_u = np.diff(urm.indptr) >= 5
    urm = sp.csr_array(urm[keep_u])
    seconds["load"] = time.perf_counter() - t0
    print(f"URM: {urm.shape[0]:,} x {urm.shape[1]:,}, nnz={urm.nnz:,}")

    t0 = time.perf_counter()
    train, test = holdout_split(urm)
    seconds["split"] = time.perf_counter() - t0
    print(f"train nnz={train.nnz:,}, held-out nnz={test.nnz:,}")

    # --- preprocessing: BM25 weighting (notebook cell: bm25 on URM) ---
    t0 = time.perf_counter()
    train_w = sim.normalization.bm25(train, axis=1, k1=1.2, b=0.75, device=dev)
    seconds["bm25"] = time.perf_counter() - t0

    # --- model: item-item similarity on the transposed URM ---
    t0 = time.perf_counter()
    models = {
        "cosine": lambda: sim.cosine(train_w.T, k=args.k, verbose=False, device=dev),
        "asymmetric_cosine": lambda: sim.asymmetric_cosine(
            train_w.T, alpha=0.3, k=args.k, verbose=False, device=dev
        ),
        "rp3beta": lambda: sim.rp3beta(
            train.T, alpha=1.0, beta=0.6, k=args.k, verbose=False, device=dev
        ),
        "s_plus": lambda: sim.s_plus(
            train_w.T, l1=0.5, l2=0.5, t1=1, t2=1, c1=0.5, c2=0.5,
            k=args.k, verbose=False, device=dev,
        ),
    }
    W = models[args.model]()
    seconds["model"] = time.perf_counter() - t0
    print(f"{args.model} similarity: {seconds['model']:.2f}s, nnz={W.nnz:,}")

    # --- scoring: URM . W^T with seen-item masking (notebook cell 37) ---
    t0 = time.perf_counter()
    recs = sim.dot_product(
        train_w, W.T, k=10, filter_cols=train, verbose=False, format_output="csr",
        device=dev,
    )
    seconds["scoring"] = time.perf_counter() - t0
    print(f"scoring: {seconds['scoring']:.2f}s")

    t0 = time.perf_counter()
    ndcg, recall = ndcg_and_recall_at(recs, test, n=10)
    seconds["evaluation"] = time.perf_counter() - t0
    print(f"NDCG@10 = {ndcg:.4f}   recall@10 = {recall:.4f}")
    last_run.update(urm=urm, train=train, train_w=train_w, test=test, W=W, recs=recs,
                    ndcg=ndcg, recall=recall)

    if args.tune:
        print(f"tuning rp3beta ({args.tune} trials)...")
        best = tune_hyperparams(train, train_w, test, args.k, args.tune, device=dev)
        W = sim.rp3beta(train.T, k=args.k, verbose=False, device=dev, **best)
        recs = sim.dot_product(
            train_w, W.T, k=10, filter_cols=train, verbose=False,
            format_output="csr", device=dev,
        )
        ndcg, recall = ndcg_and_recall_at(recs, test, n=10)
        print(f"tuned:  NDCG@10 = {ndcg:.4f}   recall@10 = {recall:.4f}")
        last_run["tuned"] = {"params": best, "ndcg": ndcg, "recall": recall}

    if args.viz:
        visualize_item_space(train_w, W, args.viz)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
