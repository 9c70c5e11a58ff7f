"""Call-scoped span log of the port's host path, switched by ``splus.TIMING``.

With ``splus.TIMING`` on, every ``s_plus`` call opens a root span ``call``
(its ``attrs`` hold the route, ``executor.last_route``, and the number of
target rows) whose call id rises by one each call. Under it run the four
laps ``validate``, ``preprocess``, ``execute (wall)`` and ``assembly``
(``splus.last_laps`` is filled from them), and inside those the spans of
the work itself:

  - ``coerce``: each CSR coercion of ``preprocess`` (``ops/csr.py``);
  - ``hash``: each content fingerprint (``preprocess._fingerprint``), in
    ``preprocess`` or in an executor's cache key; ``attrs["bytes"]`` is
    what it hashed;
  - ``stage``: the work of one device-cache miss in an executor (host
    stacking and upload); ``attrs`` hold the cache kind (the key's tag,
    or ``"sym_vecs"`` for the symmetric route's nested vector layouts) and
    the ``bytes`` (device) and ``host_bytes`` the entry holds. Key
    computation stays outside, so no ``hash`` lies inside a ``stage``.

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
    """The root span of one s_plus call when `on` (use it in a ``with``
    statement, which closes every span of the call), else ``OFF``."""
    global ACTIVE, _last_id
    if not on:
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
