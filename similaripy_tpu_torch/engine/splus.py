"""The S-Plus mega-entry point (port of ``similaripy_tpu/engine/splus.py``).

Drop-in behavioral equivalent of the reference's Cython entry point
(reference: similaripy/cython_code/s_plus.pyx:95-433): validation, CSR
coercion + zero elimination, binary mode, normalization-vector precompute,
column-selector classification, the fused similarity + top-K computation,
and COO/CSR output assembly (on a card by the native C++ kernels of
``native/``, on the CPU by their NumPy version).

Extensions (keyword-only, defaulted so reference call sites work unchanged):
  compute_dtype : 'auto' (default; picks the exact int8 path for integral
                  data, else float32) | 'float32' | 'bfloat16' | 'int8'
  precision     : 'highest' (default) | 'high' | 'default' — a minimum
                  guarantee. 'highest' and 'default' run float32 products in
                  true f32; 'high' runs them as XLA's HIGH does, split-bf16x3
                  products on the tensor cores (engine/executor.py:
                  _select_f32x3_mode), except on the compaction route, which
                  runs true f32 as the JAX package's does
  device        : 'cuda' (default) or 'cpu'; 'cuda' without a card raises.
                  On a mesh it is this rank's compute device
  mesh          : a ('rows', 'cols') DeviceMesh from
                  ``parallel.make_mesh``: every rank of the process group
                  makes the same call and gets the whole result
                  (the router engine/executor.py::execute,
                  engine/sym_sharded.py)

`num_threads` is accepted for API compatibility and ignored. `block_size`
keeps the reference's tri-state semantics (None = single tile, 0 = auto,
int = explicit width) as a column-tile-width hint.
"""

from __future__ import annotations

from typing import Optional

from ..utils.device import resolve_device
from ..utils.progress import ProgressBar
from . import executor, panel_topk, spans, sym_topk
from .assembly import assemble
from .executor import execute
from .params import SPlusParams
from .preprocess import Preprocessed, preprocess, validate_s_plus_inputs

# host timing laps of each call (splus.py:78-183 of the JAX package, there
# behind SIMILARIPY_TPU_TIMING): with TIMING on, each call records its spans
# (engine/spans.py) and last_laps holds the seconds of the lap spans
# "validate", "preprocess", "execute (wall)" and "assembly" of the latest
# call. The port reads no environment variable.
TIMING = False
last_laps: dict = {}


# the epilogue terms of SPlusParams.static_flags() a root span names
_EPILOGUE_TERMS = ("l1", "l2", "l3", "pow", "bayes")


def _launch_counts() -> tuple:
    """K2's launches by product kernel and its asymmetric ones, K3's by
    product kernel with its plain calls under "plain"."""
    k3 = dict(panel_topk.product_launches, plain=panel_topk.plain_calls)
    return dict(sym_topk.product_launches), sym_topk.asym_launches, k3


def _ran(counts: dict, before: dict) -> dict:
    return {name: n - before[name] for name, n in counts.items() if n > before[name]}


def _call_attrs(before: tuple, params: SPlusParams) -> dict:
    """The root span's attrs after execute: K2's launches by product kernel
    (those it ran) and those that carried the asymmetric column side, K3's
    launches likewise, the column groups of a compaction call (0 on another
    route) and the epilogue terms the call ran."""
    (k2, asym, k3), (k2_0, asym0, k3_0) = _launch_counts(), before
    compact = executor.last_route == "compact"
    return {"k2": _ran(k2, k2_0), "k2_asym": asym - asym0, "k3": _ran(k3, k3_0),
            "groups": executor.last_plan["n_groups"] if compact else 0,
            "epilogue": [t for t, on in zip(_EPILOGUE_TERMS, params.static_flags()) if on]}


def _lap(name) -> None:
    """Ends the running lap span and starts lap `name` (None: none)."""
    done = spans.lap(name)
    if done is not None:
        last_laps[done.name] = done.seconds


def s_plus(
    matrix1,
    matrix2=None,
    weight_depop_matrix1="none",
    weight_depop_matrix2="none",
    p1: float = 0,
    p2: float = 0,
    a1: float = 1,
    l1: float = 0,
    l2: float = 0,
    l3: float = 0,
    t1: float = 1,
    t2: float = 1,
    c1: float = 0.5,
    c2: float = 0.5,
    k: int = 100,
    stabilized_shrink: float = 0,
    bayesian_shrink: float = 0,
    additive_shrink: float = 0,
    threshold: float = 0,
    binary: bool = False,
    target_rows=None,
    filter_cols=None,
    target_cols=None,
    verbose: bool = True,
    format_output: str = "csr",
    num_threads: int = 0,
    block_size: Optional[int] = 0,
    # --- extensions ---
    compute_dtype: str = "auto",
    precision: str = "highest",
    mesh=None,
    device="cuda",
):
    """Compute top-K similarity between rows of two sparse matrices.

    Reference semantics: similaripy/cython_code/s_plus.pyx:95-433.
    """
    device = resolve_device(device)
    self_similar = matrix2 is None
    if matrix2 is None:
        matrix2 = matrix1.T

    timing = TIMING
    if timing:
        last_laps.clear()
        counts_before = _launch_counts()
    # a public function that transformed the inputs has opened the root
    with spans.call(timing):
        _lap("validate")
        validate_s_plus_inputs(
            matrix1=matrix1,
            matrix2=matrix2,
            weight_depop_matrix1=weight_depop_matrix1,
            weight_depop_matrix2=weight_depop_matrix2,
            k=k,
            target_rows=target_rows,
            filter_cols=filter_cols,
            target_cols=target_cols,
            verbose=verbose,
            format_output=format_output,
        )

        n_targets = (
            len(target_rows) if target_rows is not None else matrix1.shape[0]
        )
        progress = ProgressBar(n_targets, disabled=not verbose)
        progress.set_description("Preprocessing")

        _lap("preprocess")
        pre: Preprocessed = preprocess(
            matrix1,
            matrix2,
            weight_depop_matrix1=weight_depop_matrix1,
            weight_depop_matrix2=weight_depop_matrix2,
            p1=p1,
            p2=p2,
            c1=c1,
            c2=c2,
            l1=l1,
            l2=l2,
            l3=l3,
            k=k,
            additive_shrink=additive_shrink,
            binary=binary,
            target_rows=target_rows,
            filter_cols=filter_cols,
            target_cols=target_cols,
            self_similar=self_similar,
            device=device,
        )

        _lap("execute (wall)")
        params = SPlusParams(
            a1=a1,
            l1=l1,
            l2=l2,
            l3=l3,
            t1=t1,
            t2=t2,
            stabilized_shrink=stabilized_shrink,
            bayesian_shrink=bayesian_shrink,
            threshold=threshold,
        )

        progress.set_description("Computing")
        vals, idx = execute(
            pre,
            params,
            block_size_hint=block_size,
            compute_dtype=compute_dtype,
            precision=precision,
            progress=progress,
            device=device,
            mesh=mesh,
        )
        if timing:
            spans.root().attrs.update(route=executor.last_route, targets=n_targets,
                                      **_call_attrs(counts_before, params))

        progress.set_description(f"Building {format_output} matrix")
        _lap("assembly")
        res = assemble(
            vals,
            idx,
            pre.targets,
            pre.n_output_rows,
            pre.n_output_cols,
            format_output,
            native=device.type == "cuda",
        )
        _lap(None)
    progress.close("Done")
    return res
