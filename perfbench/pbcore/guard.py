"""The import guard: nothing a run loads may be JAX or the JAX package.

Module names are compared by their top-level name, the part before the
first dot, as a whole string: ``similaripy_tpu_torch`` (the port) begins
with ``similaripy_tpu`` (the JAX package) and is not it.
"""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "similaripy_tpu"})


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_loaded(modules=None, forbidden=FORBIDDEN) -> list[str]:
    """The loaded modules whose top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if top_level(n) in forbidden)


class Blocker:
    """A meta-path finder that refuses to import the forbidden top-level
    names (the tests load the harness and the reference under it)."""

    def __init__(self, forbidden):
        self.forbidden = frozenset(forbidden)

    def find_spec(self, fullname, path=None, target=None):
        if top_level(fullname) in self.forbidden:
            raise ImportError(f"{fullname} may not be imported here")
        return None
