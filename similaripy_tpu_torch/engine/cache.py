"""The content-keyed device cache of the three executors (executor.py:760-941
of the JAX package).

Production retrieval calls the engine again and again on the same
matrices (every scoring batch reuses the item matrix), so the executors
keep their uploads here under full-content fingerprints: a repeated call
skips the host staging and the upload, and an in-place mutation of an input
is always seen. A key is a tuple: its kind first ("m2", "m1", "sel" of the
grouped executor, "sym_coo" of the symmetric one, "compact_src",
"compact_m1", "compact_m2" of the compaction one), the fingerprint of the
matrix it stages inside. Every executor goes through ``staged``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import spans

_DEVICE_CACHE: dict = {}
# m1 panels + m2 tiles + selector stacks of a scoring call take 3 slots
# next to a model build's COO entry; 8 keeps a two-model pipeline from
# thrashing. Device bytes are handled by the planners through
# foreign_cache_bytes, not by this count.
_DEVICE_CACHE_CAP = 8

# host-resident entries (the "sel" stacks are NumPy arrays) are bounded by
# bytes, not count: foreign_cache_bytes ignores host memory, so nothing
# else prunes them
_HOST_CACHE_MAX_BYTES = 2048 << 20

_MISS = object()

# lookups by kind since the last clear()
_CACHE_COUNTS: dict = {}
# misses by kind whose entry the device built from uploaded source arrays
_CARD_BUILDS: dict = {}


def _kind(key) -> str:
    return key[0] if isinstance(key, tuple) and key else "?"


def _cache_get(key):
    value = _DEVICE_CACHE.pop(key, _MISS)
    counts = _CACHE_COUNTS.setdefault(_kind(key), {"hits": 0, "misses": 0})
    if value is _MISS:
        counts["misses"] += 1
        return None
    counts["hits"] += 1
    _DEVICE_CACHE[key] = value  # reinsert at the end: eviction is LRU
    return value


def _leaves(value):
    stack = [value]
    while stack:
        v = stack.pop()
        if isinstance(v, dict):
            stack.extend(v.values())
        elif isinstance(v, (list, tuple)):
            stack.extend(v)
        else:
            yield v


def host_bytes(value) -> int:
    return sum(v.nbytes for v in _leaves(value) if isinstance(v, np.ndarray))


def device_bytes(value) -> int:
    """Bytes of the tensors in `value` (on whatever device they live: the
    tests' CPU tensors count as the device's, as JAX's CPU arrays do)."""
    return sum(
        v.numel() * v.element_size() for v in _leaves(value) if isinstance(v, torch.Tensor)
    )


def _cache_put(key, value):
    if len(_DEVICE_CACHE) >= _DEVICE_CACHE_CAP:
        _DEVICE_CACHE.pop(next(iter(_DEVICE_CACHE)))
    _DEVICE_CACHE[key] = value
    # the host-byte budget over NumPy-holding entries, oldest first, never
    # the one just inserted
    host_keys = [k for k, v in _DEVICE_CACHE.items() if host_bytes(v) > 0]
    while len(host_keys) > 1 and sum(
        host_bytes(_DEVICE_CACHE[k]) for k in host_keys
    ) > _HOST_CACHE_MAX_BYTES:
        _DEVICE_CACHE.pop(host_keys.pop(0), None)


def _evict_stale(tag: str, fp, keep_key) -> None:
    """Drop `tag` entries of the same matrix fingerprint under another key
    (stale geometry or dtype variants): foreign_cache_bytes does not count
    same-fingerprint entries, so a stale one would hold unbudgeted device
    memory right when the fresh stack uploads."""
    stale = [
        k for k in _DEVICE_CACHE
        if isinstance(k, tuple) and k and k[0] == tag and fp in k and k != keep_key
    ]
    for k in stale:
        _DEVICE_CACHE.pop(k, None)


def record(stage, kind: str, value) -> None:
    """Records on a traced call's ``stage`` span the kind it staged and the
    device and host bytes of what it made."""
    if spans.ACTIVE:
        stage.attrs.update(kind=kind, bytes=device_bytes(value), host_bytes=host_bytes(value))


def staged(key, fp, build):
    """The entry under `key`, whose first entry is its kind and which holds
    the fingerprint `fp` of the matrix it stages. A miss evicts the stale
    entries of that kind and matrix, runs `build()` inside a ``stage`` span
    and stores what it returns. The caller builds `key` first, so the
    ``hash`` spans of its fingerprints stay outside the ``stage`` span."""
    value = _cache_get(key)
    if value is None:
        with spans.span("stage") as stage:
            _evict_stale(key[0], fp, key)
            value = build()
            _cache_put(key, value)
            record(stage, key[0], value)
    return value


def count_card_build(kind: str) -> None:
    """Counts a miss of `kind` whose entry the device built."""
    _CARD_BUILDS[kind] = _CARD_BUILDS.get(kind, 0) + 1


def foreign_cache_bytes(keep_fps: tuple) -> int:
    """Device bytes held by cache entries of OTHER matrices.

    A pipeline that builds an item-item model and then scores with it
    leaves the build's uploads cached while the scoring call plans; the
    planners leave room for them. Entries whose key holds one of
    `keep_fps` (this call's input fingerprints) are the call's own and are
    not counted. A same-fingerprint entry of another geometry is not
    counted either: every cache miss evicts it (_evict_stale) before its
    fresh upload lands."""
    total = 0
    for key, value in _DEVICE_CACHE.items():
        if any(fp in key for fp in keep_fps if fp is not None):
            continue
        total += device_bytes(value)
    return total


def clear_device_cache() -> None:
    """Drop every entry; the lookup counts stay."""
    _DEVICE_CACHE.clear()


def clear() -> None:
    """Drop every entry, the lookup counts and the card builds."""
    _DEVICE_CACHE.clear()
    _CACHE_COUNTS.clear()
    _CARD_BUILDS.clear()


def info() -> dict:
    """The device cache's part of ``executor.cache_info()``."""
    total_device = total_host = 0
    by_kind: dict = {}
    for key, value in _DEVICE_CACHE.items():
        d, h = device_bytes(value), host_bytes(value)
        total_device += d
        total_host += h
        e = by_kind.setdefault(_kind(key), {"entries": 0, "device_bytes": 0, "host_bytes": 0})
        e["entries"] += 1
        e["device_bytes"] += d
        e["host_bytes"] += h
    return {
        "entries": len(_DEVICE_CACHE),
        "device_bytes": total_device,
        "host_bytes": total_host,
        "by_kind": by_kind,
        "hits": {kind: c["hits"] for kind, c in _CACHE_COUNTS.items()},
        "misses": {kind: c["misses"] for kind, c in _CACHE_COUNTS.items()},
        "card_builds": dict(_CARD_BUILDS),
    }
