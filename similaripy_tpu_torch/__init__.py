"""similaripy_tpu_torch — the PyTorch and CUDA port of similaripy_tpu.

Nine KNN similarity functions over sparse matrices (dot, cosine, asymmetric
cosine, Jaccard, Dice, Tversky, P3alpha, RP3beta, S-Plus) as one
generalized fused kernel, plus the CSR normalization suite (L1/L2/max,
TF-IDF, BM25, BM25+), with the public surface of ``similaripy_tpu``.

The hot paths are hand-written CUDA kernels for Hopper (``csrc/*.cu``,
built with ``nvcc`` at first use): the tile product with the fused S-Plus
epilogue and the exact per-row top-k (K1, ``engine/tile_topk.py``) behind
the general executor, and, behind the symmetric executor that every
``matrix2=None`` call over all rows takes, the two-sided self-similarity
block (K2, ``engine/sym_topk.py``) and the tile densify (K5,
``engine/scatter.py``). Device uploads are cached across calls
(``cache_info``, ``clear_caches``). Every entry point takes ``device``
(default ``"cuda"``); ``device="cpu"`` runs the same code on the kernels'
plain PyTorch versions. This package imports neither JAX nor
``similaripy_tpu``.
"""

from .version import __version__

from .normalization import normalize, bm25, bm25plus, tfidf
from .similarity import (
    dot_product,
    cosine,
    asymmetric_cosine,
    jaccard,
    dice,
    tversky,
    p3alpha,
    rp3beta,
    s_plus,
    recommend,
)
from .engine.executor import cache_info, clear_caches
from . import normalization

__all__ = [
    "__version__",
    "normalize",
    "bm25",
    "bm25plus",
    "tfidf",
    "dot_product",
    "cosine",
    "asymmetric_cosine",
    "jaccard",
    "dice",
    "tversky",
    "p3alpha",
    "rp3beta",
    "s_plus",
    "recommend",
    "cache_info",
    "clear_caches",
]
