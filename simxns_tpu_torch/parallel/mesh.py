"""The mesh over ``torch.distributed`` (port of
``simxns_tpu/parallel/mesh.py``).

The JAX package runs one SPMD program over a ``(data, model)`` mesh of
every device, or a ``(replica, data, model)`` mesh across slices; the
reference runs NCCL DDP over 8 GPUs (SURVEY.md §2.2, §2.8). The port runs
one process per GPU, launched by ``torchrun`` (``python -m
torch.distributed.run``), and a :class:`Mesh` names the process's place:

- ranks take the row-major layout of ``np.reshape(devices, (n_slices,
  n_data, n_model))``: rank = (r * n_data + d) * n_model + m;
- the per-step batch is split over the data-parallel ranks (replica x
  data, in that order) into contiguous row blocks (:func:`shard_batch`:
  the row order of ``P(("replica", "data"))``); the ``n_model`` ranks of
  one data coordinate hold the same rows;
- the MIPS index is split into row shards over the data axis of a slice
  and replicated across slices and model ranks (``index.engine``);
- the model axis carries tensor parallelism (``parallel.tp``).

A :class:`Mesh` is the data-parallel group seen from one rank (its
``rank``, ``world_size`` and ``group``), and holds the groups of the other
axis uses: :attr:`Mesh.slice_mesh` (the data axis within this rank's
slice) and :attr:`Mesh.model_mesh` (the model axis). Every rank creates
every subgroup, in one order, also those it is not in
(``torch.distributed.new_group`` waits for all ranks otherwise).

A :class:`Mesh` without a group (``group=None``) is a world of one that
skips every collective: the single-device path, the counterpart of JAX's
1x1 mesh. A group of size 1 still runs the collectives.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from simxns_tpu_torch.device import resolve_device

__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "REPLICA_AXIS", "create_mesh",
           "create_multislice_mesh", "dp_axes", "dp_size",
           "local_batch_size", "mesh_device", "pad_to_multiple",
           "shard_batch"]

DATA_AXIS = "data"
MODEL_AXIS = "model"
REPLICA_AXIS = "replica"     # the multislice outer axis; absent on 1 slice


@dataclasses.dataclass
class Mesh:
    """One process's place in the mesh: its data-parallel group.

    ``group`` is a ``torch.distributed`` process group, or None for a world
    of one without collectives. ``rank`` and ``world_size`` are the
    process's rank in ``group`` and the group's size (the data-parallel
    size: replica x data); ``n_slices`` is the replica axis's size
    (``axis_names`` holds ``"replica"`` on a multislice mesh, as JAX's);
    ``slice_mesh`` is the data axis within this rank's slice (None: the
    mesh itself) and ``model_mesh`` the model axis (None: no tensor
    parallelism).
    """
    device: torch.device
    rank: int = 0
    world_size: int = 1
    group: Any = None
    n_slices: int = 1
    slice_mesh: Optional["Mesh"] = None
    model_mesh: Optional["Mesh"] = None
    axis_names: Tuple[str, ...] = (DATA_AXIS, MODEL_AXIS)

    @property
    def distributed(self) -> bool:
        """True when collectives run (a group, of any size)."""
        return self.group is not None

    @property
    def multislice(self) -> bool:
        return REPLICA_AXIS in self.axis_names

    @property
    def n_model(self) -> int:
        return 1 if self.model_mesh is None else self.model_mesh.world_size

    @property
    def n_data(self) -> int:
        """Data-parallel ranks within one slice."""
        return self.world_size // self.n_slices

    @property
    def shape(self) -> Dict[str, int]:
        """Axis sizes, as ``jax.sharding.Mesh.shape``."""
        sizes = {REPLICA_AXIS: self.n_slices, DATA_AXIS: self.n_data,
                 MODEL_AXIS: self.n_model}
        return {a: sizes[a] for a in self.axis_names}

    @property
    def replica_index(self) -> int:
        """This rank's slice."""
        return self.rank // self.n_data

    @property
    def within_slice(self) -> "Mesh":
        """The data axis of this rank's slice (the mesh itself on one
        slice): what the index shards and slice-scoped negatives span."""
        return self if self.slice_mesh is None else self.slice_mesh

    @classmethod
    def of_group(cls, group, device) -> "Mesh":
        """The mesh of an initialized process group (``None``: the default
        group) on ``device``."""
        import torch.distributed as dist

        group = dist.group.WORLD if group is None else group
        return cls(device=torch.device(device),
                   rank=dist.get_rank(group),
                   world_size=dist.get_world_size(group), group=group)


def _rank_device(device: Optional[Union[str, torch.device]],
                 local_rank: int) -> torch.device:
    """``cuda`` (or None) means ``cuda:LOCAL_RANK`` under ``torchrun``; an
    explicit index (``cuda:0``) or ``cpu`` is kept."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank)
    return resolve_device(dev)


def _axis_sizes(world: int, n_slices: Optional[int], n_data: Optional[int],
                n_model: int) -> int:
    """``n_data`` from the world, with the JAX package's checks and errors
    (``n_slices`` None: a ``(data, model)`` mesh)."""
    if n_slices is not None:
        if world % n_slices != 0:
            raise ValueError(f"{world} devices not divisible by "
                             f"n_slices={n_slices}")
        per_slice = world // n_slices
        if n_data is None:
            if per_slice % n_model != 0:
                raise ValueError(f"{per_slice} per-slice devices not "
                                 f"divisible by n_model={n_model}")
            n_data = per_slice // n_model
        if n_data * n_model != per_slice:
            raise ValueError(f"per-slice mesh {n_data}x{n_model} != "
                             f"{per_slice} devices per slice")
        return n_data
    if n_data is None:
        if world % n_model != 0:
            raise ValueError(f"{world} devices not divisible by "
                             f"n_model={n_model}")
        n_data = world // n_model
    needed = n_data * n_model
    if needed > world:
        raise ValueError(f"mesh {n_data}x{n_model} needs {needed} devices, "
                         f"have {world}")
    if needed < world:
        raise ValueError(f"mesh {n_data}x{n_model} uses {needed} of the "
                         f"{world} ranks: every rank of the group must "
                         "have a place")
    return n_data


def _subgroups(dev: torch.device, n_slices: int, n_data: int, n_model: int,
               axes) -> Mesh:
    """This rank's mesh over the default group: every rank creates every
    subgroup in the same order (data-parallel groups, then the data axis
    within each slice, then the model groups)."""
    import torch.distributed as dist

    world = dist.get_world_size()
    me = dist.get_rank()
    grid = np.arange(world).reshape(n_slices, n_data, n_model)
    r0, d0, m0 = (int(i) for i in np.argwhere(grid == me)[0])

    def groups(lists):
        """One new group per list (all ranks, same order); -> this rank's
        (group, ranks) or None."""
        mine = None
        for ranks in lists:
            ranks = sorted(int(x) for x in ranks)
            if len(ranks) == world:
                g = dist.group.WORLD
            else:
                g = dist.new_group(ranks)
            if me in ranks:
                mine = (g, ranks)
        return mine

    def sub(found) -> Mesh:
        g, ranks = found
        return Mesh(device=dev, rank=ranks.index(me), world_size=len(ranks),
                    group=g)

    dp = sub(groups([grid[:, :, m].reshape(-1) for m in range(n_model)]))
    slice_mesh = None
    if REPLICA_AXIS in axes:
        slice_mesh = sub(groups([grid[r, :, m] for r in range(n_slices)
                                 for m in range(n_model)]))
    model_mesh = None
    if n_model > 1:
        model_mesh = sub(groups([grid[r, d, :] for r in range(n_slices)
                                 for d in range(n_data)]))
    dp.n_slices = n_slices
    dp.slice_mesh = slice_mesh
    dp.model_mesh = model_mesh
    dp.axis_names = axes
    assert dp.rank == r0 * n_data + d0 and (
        model_mesh is None or model_mesh.rank == m0)
    return dp


def _init_group(device, backend, timeout_s) -> Optional[torch.device]:
    """Join (or find) the default group; None when this process runs
    alone (no ``torchrun``, no group)."""
    import torch.distributed as dist

    initialized = dist.is_available() and dist.is_initialized()
    if not initialized and "WORLD_SIZE" not in os.environ:
        return None
    dev = _rank_device(device, int(os.environ.get("LOCAL_RANK", 0)))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not initialized:
        if backend is None:
            backend = "nccl" if dev.type == "cuda" else "gloo"
        kw = {}
        if timeout_s is not None:
            kw["timeout"] = datetime.timedelta(seconds=timeout_s)
        dist.init_process_group(backend, **kw)
    return dev


def create_mesh(device: Optional[Union[str, torch.device]] = None,
                backend: Optional[str] = None,
                timeout_s: Optional[float] = None, *,
                n_data: Optional[int] = None, n_model: int = 1) -> Mesh:
    """The ``(data, model)`` mesh of this process.

    Under ``torchrun`` (``WORLD_SIZE`` in the environment) or in a process
    whose default group is already initialized: the default group's ranks
    as ``n_data x n_model`` (``n_data=None``: every rank not taken by
    ``n_model``), on ``cuda:LOCAL_RANK`` unless ``device`` names an index
    or the CPU. The group is initialized here if it is not yet, with
    ``backend`` (default ``nccl`` on a card, ``gloo`` on the CPU) and
    ``timeout_s`` as the group's timeout, so that a stalled rank raises in
    its peers instead of hanging them. Otherwise a world of one without a
    group on ``device`` (default: the card); ``n_data`` and ``n_model``
    must then be 1 or None.
    """
    dev = _init_group(device, backend, timeout_s)
    if dev is None:
        _axis_sizes(1, None, n_data, n_model)
        return Mesh(device=resolve_device(device))
    import torch.distributed as dist

    world = dist.get_world_size()
    n_data = _axis_sizes(world, None, n_data, n_model)
    if n_model == 1:
        return Mesh.of_group(None, dev)         # the data-parallel world
    return _subgroups(dev, 1, n_data, n_model, (DATA_AXIS, MODEL_AXIS))


def create_multislice_mesh(n_slices: int, n_data: Optional[int] = None,
                           n_model: int = 1,
                           device: Optional[Union[str, torch.device]] = None,
                           backend: Optional[str] = None,
                           timeout_s: Optional[float] = None) -> Mesh:
    """The ``(replica, data, model)`` mesh of this process (multislice).

    ``replica`` spans slices: the gradient all-reduce crosses it once a
    step, while the index shards, the search merges, slice-scoped
    in-batch negatives and the tensor-parallel collectives stay within a
    slice. The default group's ranks are split evenly: rank r * per_slice
    .. (r + 1) * per_slice - 1 form slice r. Without a group: a world of
    one (``n_slices`` must be 1).
    """
    dev = _init_group(device, backend, timeout_s)
    if dev is None:
        _axis_sizes(1, n_slices, n_data, n_model)
        return Mesh(device=resolve_device(device),
                    axis_names=(REPLICA_AXIS, DATA_AXIS, MODEL_AXIS))
    import torch.distributed as dist

    world = dist.get_world_size()
    n_data = _axis_sizes(world, n_slices, n_data, n_model)
    return _subgroups(dev, n_slices, n_data, n_model,
                      (REPLICA_AXIS, DATA_AXIS, MODEL_AXIS))


def mesh_device(mesh: Optional[Mesh], device=None) -> torch.device:
    """The device of an entry point: ``device`` if given, else the mesh's,
    else the card."""
    if device is not None or mesh is None:
        return resolve_device(device)
    return mesh.device


def dp_axes(mesh: Optional[Mesh]):
    """The axis name(s) the per-step batch is split over:
    ``("replica", "data")`` on a multislice mesh, ``"data"`` otherwise."""
    if mesh is not None and REPLICA_AXIS in mesh.axis_names:
        return (REPLICA_AXIS, DATA_AXIS)
    return DATA_AXIS


def dp_size(mesh: Optional[Mesh]) -> int:
    """The data-parallel world size, replica x data (1 without a mesh)."""
    return 1 if mesh is None else mesh.world_size


def local_batch_size(global_batch: int, mesh: Optional[Mesh]) -> int:
    n = dp_size(mesh)
    if global_batch % n != 0:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"dp={n}")
    return global_batch // n


def shard_batch(batch: Any, mesh: Optional[Mesh]) -> Any:
    """This rank's rows ``[r * B / W, (r + 1) * B / W)`` of every leaf of a
    host batch (r the data-parallel rank, replica-major; W = ``dp_size``;
    dicts of numpy arrays or tensors; every leaf shares the leading
    dimension B, which W divides). Scalars are kept whole. Without
    a group the batch is returned as it is."""
    if mesh is None or not mesh.distributed:
        return batch

    def take(x):
        if isinstance(x, dict):
            return {k: take(v) for k, v in x.items()}
        if not isinstance(x, (np.ndarray, torch.Tensor)) or x.ndim == 0:
            return x
        per = local_batch_size(x.shape[0], mesh)
        return x[mesh.rank * per:(mesh.rank + 1) * per]

    return take(batch)


def pad_to_multiple(n: int, m: int) -> int:
    return int(math.ceil(n / m) * m)
