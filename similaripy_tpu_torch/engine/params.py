"""S-Plus kernel parameterization (port of ``similaripy_tpu/engine/params.py``).

One generalized similarity kernel covers all nine public similarity
functions (reference: similaripy/cython_code/s_plus.h:129-156):

    T(x,y)  = t1*(Xt[r] - xy) + t2*(Yt[c] - xy) + xy        (raw xy!)
    C(x,y)  = Xc[r] * Yc[c]
    D(x,y)  = Xd[r] * Yd[c]
    xy_p    = xy**a1 if a1 != 1 else xy
    denom   = l1*T + l2*C + l3*D + stabilized_shrink
    val     = xy_p / denom      if any of {l1,l2,l3,stab,bayes} nonzero
              (0 when denom == 0)
            = xy (raw)          otherwise
    if bayesian_shrink: val *= xy_p / (xy_p + bayesian_shrink)
    keep if val >= threshold
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# pvec layout shared by the executor, the plain tile function and the CUDA
# kernel: a1 l1 l2 l3 t1 t2 stab bayes threshold inv_scale, then col_base
# at PVEC_COL_BASE once extended to PVEC_LEN entries per tile.
PVEC_COL_BASE = 10
PVEC_LEN = 16


@dataclass(frozen=True)
class SPlusParams:
    a1: float = 1.0
    l1: float = 0.0
    l2: float = 0.0
    l3: float = 0.0
    t1: float = 1.0
    t2: float = 1.0
    stabilized_shrink: float = 0.0
    bayesian_shrink: float = 0.0
    threshold: float = 0.0

    @property
    def use_l1(self) -> bool:
        return self.l1 != 0.0

    @property
    def use_l2(self) -> bool:
        return self.l2 != 0.0

    @property
    def use_l3(self) -> bool:
        return self.l3 != 0.0

    @property
    def use_pow(self) -> bool:
        return self.a1 != 1.0

    @property
    def use_bayes(self) -> bool:
        return self.bayesian_shrink != 0.0

    @property
    def use_denominator(self) -> bool:
        return (
            self.use_l1
            or self.use_l2
            or self.use_l3
            or self.stabilized_shrink != 0.0
            or self.use_bayes
        )

    def static_flags(self) -> tuple:
        """(use_l1, use_l2, use_l3, use_pow, use_bayes, use_denominator)."""
        return (
            self.use_l1,
            self.use_l2,
            self.use_l3,
            self.use_pow,
            self.use_bayes,
            self.use_denominator,
        )


def build_pvec(params: SPlusParams, inv_scale: float = 1.0) -> np.ndarray:
    """(10,) f32 parameter vector (reference executor.py:1222)."""
    return np.array(
        [
            params.a1,
            params.l1,
            params.l2,
            params.l3,
            params.t1,
            params.t2,
            params.stabilized_shrink,
            params.bayesian_shrink,
            params.threshold,
            inv_scale,
        ],
        dtype=np.float32,
    )
