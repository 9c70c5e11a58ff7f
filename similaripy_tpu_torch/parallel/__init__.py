"""Multi-device execution over torch.distributed (``make_mesh``)."""

from .mesh import make_mesh

__all__ = ["make_mesh"]
