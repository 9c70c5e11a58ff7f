"""Call-scoped span log of the port's host path, switched by ``splus.TIMING``.

With ``splus.TIMING`` on, every call opens a root span ``call`` whose call
id rises by one each call. Its ``attrs`` hold the route
(``executor.last_route``), the number of target rows (``targets``), and
the call's launches: ``k2``, K2's by product kernel, and ``k2_asym``,
those that carry the asymmetric column side; ``k3``, K3's by product
kernel, its plain calls under ``"plain"``; ``groups``, the column groups
of a compaction call (0 on another route); and ``epilogue``, the terms of
the S-Plus epilogue the call ran, of ``l1``, ``l2``, ``l3``, ``pow`` and
``bayes``. ``s_plus`` opens it, or, for a public function
that works on the host before it calls ``s_plus`` (p3alpha, rp3beta), that
function does, and ``s_plus`` then opens no second root. Under it run the
four laps ``validate``, ``preprocess``, ``execute (wall)`` and ``assembly``
(``splus.last_laps`` is filled from them), and inside those the spans of
the work itself:

  - ``transform``: the public function's work before ``s_plus`` (ahead
    of the ``validate`` lap, directly under the root), on the call's
    device for the value-symmetric P3 transform when the device takes the
    input (``ops/card_p3.py``), else on the host; ``attrs`` hold the
    ``nnz`` and the ``bytes`` (values, indices, pointers) of the matrices
    it read, ``where`` ("card" or "host") and ``upload_bytes``, what went
    up to the device (0 on the host path);
  - ``coerce``: each CSR coercion of ``preprocess``, on the call's device
    for a non-CSR input (``ops/card_prep.py``), else on the host
    (``ops/csr.py``); ``attrs`` hold ``where`` ("card" or "host") and the
    ``bytes`` of the caller's arrays it read;
  - ``norms`` and ``gate``: a miss of the preprocess cache, its norm and
    depop vectors and its int8 gate (once a call: a self-similar call's
    m1.T takes m1's scale);
  - ``selectors``: the column selectors of ``preprocess`` (a sparse
    filter or target checked for zeros and sorted indices, copied and
    cleaned where it needs it; an array's global mask);
  - ``hash``: each content fingerprint (``preprocess._fingerprint``), in
    ``preprocess`` or in an executor's cache key; ``attrs["bytes"]`` is
    what it hashed;
  - ``stage``: the work of one device-cache miss in an executor (host
    stacking and upload); ``attrs`` hold the cache kind (the key's tag,
    or ``"sym_vecs"`` for the symmetric route's nested vector layouts) and
    the ``bytes`` (device) and ``host_bytes`` the entry holds, and for
    the symmetric route's "sym_coo", whose stacks the card builds from
    matrix2's uploaded CSC arrays, ``upload_bytes``, what crossed to the
    card. Key computation stays outside, so no ``hash`` lies inside a
    ``stage``;
  - ``split``: the split-bf16x3 COO of a ``precision='high'`` call
    (``staging.split_coo``), inside the ``stage`` that makes it;
    ``attrs["entries"]`` is the entries it gives out;
  - ``bf16_exact``: a miss of ``staging.bf16_exact``, the check of
    every value of a matrix for bf16 exactness that picks a
    ``precision='high'`` call's product mode, in ``execute (wall)``;
  - ``fold``: the gate of the general executor's exclude-seen fold
    (``executor._exclude_seen_fold``: the filter's pattern against
    matrix1's, and the penalty's statistics on a miss of their memo);
  - ``alloc``: the symmetric executor's allocations before its sweep:
    the carry planes on the device and the (C, k) outputs on the host;
  - ``group``: one column group of a compaction call (``compact.py``), in
    ``execute (wall)``: its dense table (K5), and each panel's gather
    (K4), hot-prefix product and K3 launch; it ends once the card has
    done the group's work. ``attrs`` hold the group's ``index``, its
    ``cols``, the ``table_bytes`` of its dense table and the ``panels``
    (K3 launches) it ran;
  - ``tile_group``: one column group of the general executor
    (``executor.py::execute_grouped``), in ``execute (wall)``: its tile
    stack (K5), its selector uploads and its panels' K1 launches; it
    ends once the host has enqueued that work, with no wait for the card;
  - ``sweep``: one anchor pair of the symmetric executor
    (``symmetric.py``), in ``execute (wall)``: the pair's anchors (K5),
    its steps (K5 and K2) and the wait for the card that ends them; the
    spans of a call sum to ``last_plan["stages"]["sweep_s"]`` to within
    a few microseconds a pair;
  - ``pack``: the copy-out of results: in the symmetric executor one a
    pair (after its ``sweep``; they sum to ``last_plan["stages"]
    ["pack_s"]`` likewise), the merge of both sides, the copy to the host
    and the scatter into the call's output; in the general and the
    compaction executors one a call, the copy to the host, the scatter by
    panel or bucket and the map of device columns to items.

A span's ``start`` and ``end`` are ``time.perf_counter()`` readings, the
clock the benchmark puts device intervals on. While ``torch.profiler`` is
recording, each span also opens a profiler range of its name on the CPU
side (``_RecordFunctionFast``, a ``cpu_op``; no GPU-side range).
``log()`` gives the spans of the last ``CALLS_KEPT`` calls, oldest first.

With tracing off a span site costs one check of the module flag
``ACTIVE`` and returns the shared no-op ``OFF``: nothing is recorded or
allocated and no profiler range is opened. The log is module state used
from one thread at a time, as ``splus.last_laps`` is; calls do not nest.
"""

from __future__ import annotations

import time
from collections import deque

import torch

CALLS_KEPT = 1024

# true while a traced s_plus call is open: span sites record only then
ACTIVE = False

_calls: deque = deque(maxlen=CALLS_KEPT)  # each call's spans, root first
_stack: list = []  # the open spans of the current call, root first
_lap = None  # the running lap span
_last_id = 0


class Span:
    """One timed interval: `call` is its root's id, `id` its index among
    the call's spans and `parent` its parent's (None for the root)."""

    __slots__ = ("name", "call", "id", "parent", "start", "end", "attrs", "_range")

    def __init__(self, name: str, call: int, id: int, parent, start: float):
        self.name, self.call, self.id, self.parent = name, call, id, parent
        self.start, self.end = start, None
        self.attrs: dict = {}
        self._range = None
        if torch.autograd._profiler_enabled():
            # a CPU-side range ("cpu_op"): record_function's user annotation
            # would also lay a GPU-side range over the kernels launched in it,
            # which a reader of the profiler's device activity counts as busy
            self._range = torch._C._profiler._RecordFunctionFast(name)
            self._range.__enter__()

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def _close(self, now: float) -> None:
        self.end = now
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if self is _stack[0]:
            _close_call()
        else:
            _stack.pop()._close(time.perf_counter())
        return False


class _Off:
    """The span of every site while tracing is off: records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


OFF = _Off()


def _open(name: str, now: float) -> Span:
    tree = _calls[-1]
    s = Span(name, _stack[0].call, len(tree), _stack[-1].id, now)
    tree.append(s)
    _stack.append(s)
    return s


def call(on: bool):
    """The root span of one call when `on` (use it in a ``with`` statement,
    which closes every span of the call), else ``OFF``; ``OFF`` too while a
    root is open (the public function's), whose ``with`` closes the call."""
    global ACTIVE, _last_id
    if not on or ACTIVE:
        return OFF
    _last_id += 1
    root = Span("call", _last_id, 0, None, time.perf_counter())
    _calls.append([root])
    _stack[:] = [root]
    ACTIVE = True
    return root


def _close_call() -> None:
    global ACTIVE, _lap
    now = time.perf_counter()
    while _stack:
        _stack.pop()._close(now)
    _lap = None
    ACTIVE = False


def root():
    """The open call's root span, or None."""
    return _stack[0] if ACTIVE else None


def current():
    """The innermost open span of the open call, or None."""
    return _stack[-1] if ACTIVE else None


def span(name: str):
    """A child of the innermost open span, for a ``with`` statement."""
    if not ACTIVE:
        return OFF
    return _open(name, time.perf_counter())


def lap(name):
    """Ends the running lap and starts lap `name` (None: none) at one clock
    reading; returns the lap it ended, or None."""
    global _lap
    if not ACTIVE:
        return None
    now = time.perf_counter()
    done = _lap
    if done is not None:
        _stack.pop()._close(now)
    _lap = _open(name, now) if name is not None else None
    return done


def log() -> list:
    """The spans of the kept calls, oldest call first, each call's root
    first and the rest in the order they opened."""
    return [s for tree in _calls for s in tree]


def clear() -> None:
    """Empties the log (the call ids keep rising)."""
    _calls.clear()
