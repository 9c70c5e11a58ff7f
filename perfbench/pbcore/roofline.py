"""Each kernel launch's least time on the card, from its operands.

A frozen copy of the per-launch operation and byte counts of the port's
smoke (``chip_smoke.py``: ``_time_k1``, ``_time_k2``, ``_time_k3_k4``,
``_bound``), extended by the masks a launch reads. Operations are the dense
products of the operands the kernel receives (K2: of its live anchor rows,
the rows it computes; a split-bf16x3 launch: each phase); bytes count the
operands as stored and every other input read once, and every output and
carry written once. The least time is the larger of operations over the
peak rate of the launch's type and bytes over the memory bandwidth.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAKS = {
    "float32": 67e12,  # FLOP/s outside the tensor cores
    "bfloat16": 989e12,
    "int8": 1979e12,  # OP/s
    "bytes": 3.35e12,  # B/s of HBM3
}
PHASES = {None: 1, False: 1, True: 3, "both": 3, "rhs": 2, "lhs": 2}


def least_seconds(ops: float, nbytes: float, dtype: str) -> float:
    return max(ops / PEAKS[dtype], nbytes / PEAKS["bytes"])


def k2_launch(sw: int, u_pad: int, tc: int, k_pad: int, n_live: int, phases: int,
              operand_bytes: float) -> tuple[float, float]:
    """K2: an anchor group of sw rows, n_live of them live, against one tile
    of tc columns over a u_pad-deep user axis; both carries in and out."""
    ops = 2.0 * n_live * tc * u_pad * phases
    nbytes = operand_bytes + 4.0 * (6 * sw + 6 * tc + 16) + 2 * 8.0 * k_pad * (sw + tc)
    return ops, nbytes


def k1_launch(trp: int, u_pad: int, tc: int, k_pad: int, phases: int, operand_bytes: float,
              mask_bytes: float = 0.0) -> tuple[float, float]:
    """K1: a panel of trp rows against one tile of tc columns over u_pad;
    the carry in and out."""
    ops = 2.0 * trp * u_pad * tc * phases
    nbytes = operand_bytes + 4.0 * (3 * trp + 3 * tc + 16 + 4 * k_pad * trp) + mask_bytes
    return ops, nbytes


def k3_launch(tm: int, K: int, cg: int, tc: int, k_pad: int, operand_bytes: float,
              bias_bytes: float, mask_bytes: float = 0.0) -> tuple[float, float]:
    """K3: a panel of tm rows against a group of cg columns over its K
    gathered cold rows, the hot prefix's partial scores as a bias; each
    tile's top-k written once."""
    ops = 2.0 * tm * K * cg
    nbytes = (operand_bytes + bias_bytes + 4.0 * (3 * tm + 3 * cg + 16)
              + 8.0 * (cg // tc) * k_pad * tm + mask_bytes)
    return ops, nbytes
