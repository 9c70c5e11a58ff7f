"""Carry the JAX package's preprocessed state across to the port.

This system has no weights: its state is the preprocessed operands. These
functions take the fields of ``similaripy_tpu``'s ``Preprocessed`` (and its
parameter vector) as NumPy / SciPy objects and build the port's
counterparts, so both executors can be fed exactly the same state. They
never import the JAX package: the caller hands plain objects over.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from .engine.params import PVEC_LEN
from .engine.preprocess import Preprocessed, _fingerprint

_VECTORS = ("Xt", "Yt", "Xc", "Yc", "Xd", "Yd")


def _f32_or_none(v):
    return None if v is None else np.ascontiguousarray(np.asarray(v, dtype=np.float32))


def preprocessed_from_reference(fields: dict) -> Preprocessed:
    """The port's ``Preprocessed`` from the reference's fields: ``m1``,
    ``m2``, ``targets``, ``k``, the six normalization vectors,
    ``col_allowed``, ``filter_matrix``, ``target_matrix``, ``qscale1``,
    ``qscale2``, ``n_output_rows``, ``n_output_cols`` and ``self_similar``.
    ``m2`` may be a CSC transpose view of ``m1`` (self-similarity)."""
    m1 = sp.csr_array(fields["m1"])
    m2 = fields["m2"]
    m2 = sp.csc_array(m2) if m2.format == "csc" else sp.csr_array(m2)
    self_similar = bool(fields.get("self_similar", False))
    fp1 = _fingerprint(m1.indptr, m1.indices, m1.data)
    out = Preprocessed(
        m1=m1,
        m2=m2,
        targets=np.ascontiguousarray(np.asarray(fields["targets"], dtype=np.int32)),
        k=int(fields["k"]),
        fp1=fp1,
        # a self-similarity's m2 is m1's transpose, keyed as preprocess keys it
        fp2=fp1 + ":T" if self_similar else _fingerprint(m2.indptr, m2.indices, m2.data),
        n_output_rows=int(fields["n_output_rows"]),
        n_output_cols=int(fields["n_output_cols"]),
        qscale1=fields.get("qscale1"),
        qscale2=fields.get("qscale2"),
        self_similar=self_similar,
    )
    for name in _VECTORS:
        setattr(out, name, _f32_or_none(fields.get(name)))
    allowed = fields.get("col_allowed")
    out.col_allowed = None if allowed is None else np.asarray(allowed, dtype=bool)
    for name in ("filter_matrix", "target_matrix"):
        mat = fields.get(name)
        setattr(out, name, None if mat is None else sp.csr_array(mat))
    return out


def pvec_from_reference(pvec, device="cpu") -> torch.Tensor:
    """The reference's parameter vector (build_pvec's 10 entries, or the
    16-entry per-tile form with col_base at [10]) as the port's (16,) f32
    tensor on `device`."""
    v = np.asarray(pvec, dtype=np.float32).ravel()
    if v.shape[0] > PVEC_LEN:
        raise ValueError(f"pvec has {v.shape[0]} entries, at most {PVEC_LEN} expected")
    out = np.zeros(PVEC_LEN, dtype=np.float32)
    out[: v.shape[0]] = v
    return torch.from_numpy(out).to(device)
