"""Process groups, meshes and replication.

Counterpart of the JAX package's ``parallel/mesh.py``. JAX runs one process
over every visible device and shards arrays over a ``Mesh``; PyTorch's idiom
is one process per card. So here:

- :func:`init_from_env` joins the process group that ``torchrun`` (or a
  spawning test) describes with ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``MASTER_ADDR`` and ``MASTER_PORT``: NCCL for a CUDA device, gloo for the
  CPU. A failed join raises; nothing drops to fewer ranks or to the CPU.
- :func:`make_mesh` lays out the group's ranks, or a list of devices (the
  slide fleet's threads, ``infer/fleet.py``), with the JAX function's shape
  rules (one ``-1``, divisibility, the same errors: :func:`mesh_shape`).
- :func:`group_submeshes` splits a (group, data) mesh into its rows; over
  ranks each row gets its own ``dist.new_group``.
- :func:`replicate` broadcasts parameters, buffers and optimizer state from
  the group's first rank; :func:`shard_batch` takes this rank's rows of a
  global batch.

``torch.distributed`` is imported inside the functions that use it, so a
single card's paths never load it.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Sequence

import numpy as np
import torch

from ss25_hierarchical_multiscale_image_classification_tpu_torch.parallel.feed import (
    process_batch_slice,
)

DATA_AXIS = "data"
#: How long a collective may wait for the other ranks before the run fails.
TIMEOUT = datetime.timedelta(minutes=10)


def init_from_env(device: str | torch.device = "cuda",
                  timeout: datetime.timedelta = TIMEOUT):
    """Join the process group described by ``torchrun``'s environment and
    return it (``dist.group.WORLD``), with NCCL when ``device`` is CUDA and
    gloo for the CPU. Raises when a variable is missing or the join fails;
    a group that is already initialized is returned as it is."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.group.WORLD
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
               if k not in os.environ]
    if missing:
        raise RuntimeError(f"no process group: {', '.join(missing)} not set "
                           "(launch with torchrun --nproc_per_node=N)")
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if backend == "nccl":
        from ss25_hierarchical_multiscale_image_classification_tpu_torch.device import (
            local_device,
        )

        torch.cuda.set_device(local_device("cuda"))
    dist.init_process_group(backend, init_method="env://", timeout=timeout,
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return dist.group.WORLD


def rank_and_size(group=None) -> tuple[int, int]:
    """This process's rank in ``group`` and the group's size; (0, 1) when
    ``group`` is None (one process, no collective)."""
    if group is None:
        return 0, 1
    import torch.distributed as dist

    return dist.get_rank(group), dist.get_world_size(group)


def is_main(group=None) -> bool:
    """Whether this process writes the artifacts: rank 0, or no group."""
    return rank_and_size(group)[0] == 0


def barrier(group=None) -> None:
    """Wait for every rank of ``group`` (nothing without one)."""
    if group is not None:
        import torch.distributed as dist

        dist.barrier(group)


def broadcast_object(obj: Any, group=None) -> Any:
    """The group's first rank's ``obj`` (picklable) on every rank; ``obj``
    itself without a group. Every rank must call it."""
    if group is None:
        return obj
    import torch.distributed as dist

    shared = [obj]
    dist.broadcast_object_list(shared, src=dist.get_global_rank(group, 0),
                               group=group)
    return shared[0]


def mesh_shape(n: int, axis_names: Sequence[str],
               shape: Sequence[int] | None = None) -> tuple[int, ...]:
    """The extents of a mesh of ``n`` members: one per axis name, a single
    -1 inferred from ``n``; the JAX function's rules and errors."""
    if shape is None:
        if len(axis_names) != 1:
            raise ValueError(
                f"a {len(axis_names)}-axis mesh needs an explicit shape "
                f"(one extent per axis, a single -1 allowed)"
            )
        shape = (n,)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(
            f"shape {shape} must have one extent per axis name {axis_names}"
        )
    if sum(s == -1 for s in shape) > 1:
        raise ValueError(f"at most one -1 extent allowed, got {shape}")
    if -1 in shape:
        known = int(np.prod([s for s in shape if s != -1]))
        if known == 0 or n % known:
            raise ValueError(
                f"cannot infer -1 in {shape}: {n} devices not divisible "
                f"by {known}"
            )
        shape = tuple(n // known if s == -1 else s for s in shape)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} needs {np.prod(shape)} devices, "
                         f"have {n}")
    return shape


@dataclasses.dataclass
class Mesh:
    """Members laid out on named axes: ranks (ints) of the process group or
    devices. ``group`` is the process group of a 1-D mesh of ranks, for its
    collectives (None for devices, or for ranks without a process group)."""

    devices: np.ndarray
    axis_names: tuple[str, ...]
    group: Any = None

    @property
    def size(self) -> int:
        return int(self.devices.size)


def _members(devices) -> list:
    if devices is not None:
        return list(devices)
    import torch.distributed as dist

    return list(range(dist.get_world_size() if dist.is_initialized() else 1))


def make_mesh(num_devices: int | None = None,
              axis_names: Sequence[str] = (DATA_AXIS,),
              devices: Sequence | None = None,
              shape: Sequence[int] | None = None) -> Mesh:
    """A 1-D or N-D mesh over ``devices``, by default the ranks of the
    process group (one rank without one). ``shape`` gives one extent per
    axis name and may hold a single -1 (the fleet's ``("group", "data")``
    layout with ``shape=(-1, G)``); 1-D meshes need none. Members are laid
    out row-major, so the last axis varies fastest."""
    members = _members(devices)
    if num_devices is not None:
        members = members[:num_devices]
    shp = mesh_shape(len(members), axis_names, shape)
    grid = np.empty(len(members), dtype=object)
    grid[:] = members
    group = None
    if devices is None and len(shp) == 1:
        import torch.distributed as dist

        group = dist.group.WORLD if dist.is_initialized() else None
    return Mesh(grid.reshape(shp), tuple(axis_names), group)


def group_submeshes(mesh: Mesh, data_axis: str = DATA_AXIS) -> list[Mesh]:
    """Split a 2-D (group, data) mesh into its rows, one 1-D data mesh each.
    A mesh of ranks under a process group gets a ``dist.new_group`` per row,
    which every rank must create, in the same order (so every rank calls
    this)."""
    if mesh.devices.ndim != 2:
        raise ValueError(
            f"group_submeshes expects a 2-D (group, data) mesh, got shape "
            f"{mesh.devices.shape}"
        )
    ranks = all(isinstance(m, (int, np.integer)) for m in mesh.devices.flat)
    out = []
    for row in mesh.devices:
        group = None
        if ranks:
            import torch.distributed as dist

            if dist.is_initialized():
                group = dist.new_group([int(r) for r in row])
        out.append(Mesh(row.copy(), (data_axis,), group))
    return out


def shard_batch(tree: Any, group=None) -> Any:
    """This rank's rows of every array of a global batch (a tuple, list,
    dict or one array): the contiguous slice of
    :func:`..parallel.feed.process_batch_slice`."""
    rank, world = rank_and_size(group)

    def rows(x):
        return x[process_batch_slice(len(x), rank, world)]

    if isinstance(tree, dict):
        return {k: rows(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(rows(x) for x in tree)
    return rows(tree)


def _tensors(obj) -> list[torch.Tensor]:
    if isinstance(obj, torch.nn.Module):
        return [*obj.parameters(), *obj.buffers()]
    if isinstance(obj, torch.optim.Optimizer):
        return [v for state in obj.state.values() for v in state.values()
                if isinstance(v, torch.Tensor)]
    return list(obj)


@torch.no_grad()
def replicate(obj, group=None) -> None:
    """Overwrite, in place, every tensor of ``obj`` with the group's first
    rank's: a module's parameters and buffers, an optimizer's state, or a
    list of tensors. Nothing happens without a group. Every rank must hold
    the same tensors (an optimizer after the same number of steps)."""
    if group is None:
        return
    import torch.distributed as dist

    src = dist.get_global_rank(group, 0)
    for t in _tensors(obj):
        dist.broadcast(t, src=src, group=group)
