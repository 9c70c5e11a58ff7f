"""The device mesh over torch.distributed.

Port of ``similaripy_tpu/parallel/mesh.py``. The engine scales out over a
``torch.distributed.device_mesh.DeviceMesh`` with two named dimensions:

  'rows' — data parallelism over target rows (the reference's OpenMP row
           loop, s_plus.h:337-338);
  'cols' — parallelism over matrix2 columns, with an all-gather top-k
           merge.

A mesh call is SPMD: every rank of the default process group calls the
public function with the same inputs and gets back the whole result (the
JAX package's multi-process form, ``replicate = jax.process_count() > 1``).
Start one process per rank, e.g. ``torchrun --nproc-per-node N``, call
``torch.distributed.init_process_group`` (NCCL on cards, one card a rank;
gloo on the CPU, or when several ranks share one card), then
``make_mesh(rows, cols)`` and pass ``mesh=`` to any similarity.

The collectives move only the small (rows x k) top-k partials. They run on
the group's device type: a gloo group takes CPU copies of partials computed
on a card, so ranks may compute on a card and talk over gloo. The engine's
sweeps take ``mesh=None`` for one device, and every helper here treats
None as a (1, 1) mesh whose collectives are identities.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# collectives issued by engine calls on a mesh (not those of make_mesh)
collectives = 0

_AXES = ("rows", "cols")


def make_mesh(rows: int = 1, cols: int | None = None):
    """A ('rows', 'cols') DeviceMesh over every rank of the initialized
    default process group; ``cols`` defaults to world size // rows.

    Raises if no process group is initialized: there is no quiet
    single-process fallback. Also counts, once, how many ranks share each
    rank's card: such ranks plan with that card's budget divided by their
    count (``ranks_per_card``)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh needs an initialized default process group: call "
            "torch.distributed.init_process_group on every rank first "
            "(backend 'nccl' on cards, 'gloo' on the CPU)"
        )
    from torch.distributed.device_mesh import DeviceMesh

    world = dist.get_world_size()
    rows = int(rows)
    cols = world // max(rows, 1) if cols is None else int(cols)
    if rows < 1 or cols < 1 or rows * cols != world:
        raise ValueError(
            f"mesh {rows}x{cols} needs {rows * cols} ranks; the process group "
            f"has {world}"
        )
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    mesh = DeviceMesh(
        device_type, torch.arange(world).reshape(rows, cols), mesh_dim_names=_AXES
    )
    mesh.ranks_per_card = _count_ranks_per_card()
    return mesh


def _count_ranks_per_card() -> int:
    """How many ranks of the group have this rank's current card (1 when
    this process sees no card)."""
    ident = ""
    if torch.cuda.is_available():
        ident = str(torch.cuda.get_device_properties(torch.cuda.current_device()).uuid)
    idents = [None] * dist.get_world_size()
    dist.all_gather_object(idents, ident)
    return idents.count(ident) if ident else 1


def ranks_per_card(mesh) -> int:
    """The count ``make_mesh`` took; a mesh built by hand is counted at its
    first call (every rank calls, so the collective matches)."""
    n = getattr(mesh, "ranks_per_card", None)
    if n is None:
        n = mesh.ranks_per_card = _count_ranks_per_card()
    return n


def axis_sizes(mesh) -> tuple[int, int]:
    """(rows, cols) sizes; an absent dimension counts as 1 (sharded.py:73).
    The mesh must span every rank of the default group. No mesh (None) is
    one device: (1, 1)."""
    if mesh is None:
        return 1, 1
    names = tuple(mesh.mesh_dim_names or ())
    if not names or not set(names) <= set(_AXES):
        raise ValueError(
            f"the sharded executors expect mesh dimensions named 'rows'/'cols', got {names}"
        )
    if mesh.size() != dist.get_world_size():
        raise ValueError(
            f"the mesh holds {mesh.size()} ranks; it must span all "
            f"{dist.get_world_size()} ranks of the default process group"
        )
    shape = dict(zip(names, mesh.shape))
    return shape.get("rows", 1), shape.get("cols", 1)


def coordinate(mesh) -> tuple[int, int]:
    """This rank's (row, col) position in the mesh; (0, 0) with no mesh."""
    if mesh is None:
        return 0, 0
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    return coord.get("rows", 0), coord.get("cols", 0)


def comm_device(mesh) -> torch.device:
    """Where the group's collectives take their tensors."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def check_device(mesh, device: torch.device) -> None:
    """A mesh call needs the initialized process group, and ``device`` is
    the rank's compute device: under NCCL the card the group uses, under
    gloo a card or the CPU."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "mesh= needs the initialized default process group the mesh was "
            "made over (parallel.make_mesh)"
        )
    if mesh.device_type == "cuda" and device != comm_device(mesh):
        raise ValueError(
            f"this rank's NCCL group uses {comm_device(mesh)}, but the call asks "
            f"for device={device}; pass that card (or build the group over gloo)"
        )


def all_gather(t: torch.Tensor, mesh, axis: str | None = None) -> list:
    """Every member's ``t`` (same shape and dtype on all ranks), in rank
    order, on ``t``'s device: over the mesh dimension ``axis``, or over all
    ranks when ``axis`` is None. The list form of ``dist.all_gather``. With
    no mesh (None) it is ``[t]``."""
    global collectives
    if mesh is None or (axis is not None and axis not in (mesh.mesh_dim_names or ())):
        return [t]
    group = None if axis is None else mesh.get_group(axis)
    size = dist.get_world_size(group)
    if size == 1:
        return [t]
    src = t.contiguous().to(comm_device(mesh))
    out = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(out, src, group=group)
    collectives += 1
    return [o.to(t.device) for o in out]


def agree_min(values, mesh):
    """The smallest of ``values`` (an int, or a tuple of ints taken
    elementwise) over all ranks, in one collective: every rank then plans
    the same geometry and so joins the same collectives. With no mesh
    (None) or one rank it returns ``values``."""
    global collectives
    if mesh is None or dist.get_world_size() == 1:
        return values
    one = isinstance(values, int)
    t = torch.tensor([values] if one else list(values), dtype=torch.int64,
                     device=comm_device(mesh))
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    collectives += 1
    out = [int(v) for v in t.tolist()]
    return out[0] if one else tuple(out)


def _pack(vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(..., k) f32 values and int32 ids as one (..., k, 2) int32 tensor, so
    one collective moves both."""
    return torch.stack([vals.contiguous().view(torch.int32), idx.contiguous()], dim=-1)


def _unpack(packed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return packed[..., 0].contiguous().view(torch.float32), packed[..., 1].contiguous()


def merge_topk(vals: torch.Tensor, idx: torch.Tensor, mesh, k: int,
               axis: str | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The top-k of every member's (..., k) partials along their last axis
    (sharded.py:393, sym_sharded.py:439): all-gathered over ``axis`` (all
    ranks when None) and re-selected by a stable sort, so ties keep the
    lower rank's entries first, as lax.top_k over the concatenation does.
    With no mesh, or one member, the partials come back as they are."""
    parts = all_gather(_pack(vals, idx), mesh, axis)
    if len(parts) == 1:
        return vals, idx
    v, i = _unpack(torch.cat(parts, dim=-2))
    v, pos = torch.sort(v, dim=-1, descending=True, stable=True)
    return v[..., :k], torch.gather(i, -1, pos[..., :k])


def gather_rows(vals: torch.Tensor, idx: torch.Tensor, mesh) -> list:
    """[(vals, idx) of row shard 0, 1, ...]: every row shard's partials,
    gathered over 'rows' in one collective (with no mesh, ``[(vals, idx)]``)."""
    return [_unpack(p) for p in all_gather(_pack(vals, idx), mesh, "rows")]


def reset_counts() -> None:
    global collectives
    collectives = 0
