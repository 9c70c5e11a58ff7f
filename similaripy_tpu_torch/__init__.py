"""similaripy_tpu_torch — the PyTorch and CUDA port of similaripy_tpu.

Nine KNN similarity functions over sparse matrices (dot, cosine, asymmetric
cosine, Jaccard, Dice, Tversky, P3alpha, RP3beta, S-Plus) as one
generalized fused kernel, plus the CSR normalization suite (L1/L2/max,
TF-IDF, BM25, BM25+), with the public surface of ``similaripy_tpu``.

The hot path is one hand-written CUDA kernel for Hopper
(``csrc/tile_topk.cu``, built with ``nvcc`` at first use): the tile product
with the fused S-Plus epilogue and the exact per-row top-k
(``engine/tile_topk.py``). Every entry point takes ``device`` (default
``"cuda"``); ``device="cpu"`` runs the same code on the kernel's plain
PyTorch version. This package imports neither JAX nor ``similaripy_tpu``.
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
]
