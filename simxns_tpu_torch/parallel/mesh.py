"""Data parallelism over ``torch.distributed`` (port of
``simxns_tpu/parallel/mesh.py``).

The JAX package runs one SPMD program over a ``(data, model)`` mesh of
every device; the reference runs NCCL DDP over 8 GPUs (SURVEY.md §2.2,
§2.8). The port runs one process per GPU, launched by ``torchrun``
(``python -m torch.distributed.run``), and a :class:`Mesh` names the
process's place in the group: its rank, the world size, its device and
the process group. ``torch.distributed`` replaces the ``data`` axis:

- the per-step batch is split into W contiguous row blocks, rank 0's
  first (:func:`shard_batch`: the row order of ``P("data")``);
- the MIPS index is split into W row shards (``index.engine.MIPSIndex``).

Tensor parallelism (the ``model`` axis) is not ported.

A :class:`Mesh` without a group (``group=None``) is a world of one that
skips every collective: the single-device path, the counterpart of JAX's
1x1 mesh. A group of size 1 still runs the collectives.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
from typing import Any, Optional, Union

import numpy as np
import torch

from simxns_tpu_torch.device import resolve_device

__all__ = ["Mesh", "create_mesh", "dp_size", "local_batch_size",
           "mesh_device", "pad_to_multiple", "shard_batch"]


@dataclasses.dataclass
class Mesh:
    """One process's place in a data-parallel group.

    ``group`` is a ``torch.distributed`` process group, or None for a world
    of one without collectives. ``rank`` and ``world_size`` are the
    process's rank in ``group`` and the group's size.
    """
    device: torch.device
    rank: int = 0
    world_size: int = 1
    group: Any = None

    @property
    def distributed(self) -> bool:
        """True when collectives run (a group, of any size)."""
        return self.group is not None

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


def create_mesh(device: Optional[Union[str, torch.device]] = None,
                backend: Optional[str] = None,
                timeout_s: Optional[float] = None) -> Mesh:
    """The mesh of this process.

    Under ``torchrun`` (``WORLD_SIZE`` in the environment) or in a process
    whose default group is already initialized: the default group, on
    ``cuda:LOCAL_RANK`` unless ``device`` names an index or the CPU. The
    group is initialized here if it is not yet, with ``backend`` (default
    ``nccl`` on a card, ``gloo`` on the CPU) and ``timeout_s`` as the
    group's timeout, so that a stalled rank raises in its peers instead of
    hanging them. Otherwise a world of one without a group on ``device``
    (default: the card).
    """
    import torch.distributed as dist

    initialized = dist.is_available() and dist.is_initialized()
    if not initialized and "WORLD_SIZE" not in os.environ:
        return Mesh(device=resolve_device(device))
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
    return Mesh.of_group(None, dev)


def mesh_device(mesh: Optional[Mesh], device=None) -> torch.device:
    """The device of an entry point: ``device`` if given, else the mesh's,
    else the card."""
    if device is not None or mesh is None:
        return resolve_device(device)
    return mesh.device


def dp_size(mesh: Optional[Mesh]) -> int:
    """The data-parallel world size (1 without a mesh)."""
    return 1 if mesh is None else mesh.world_size


def local_batch_size(global_batch: int, mesh: Optional[Mesh]) -> int:
    n = dp_size(mesh)
    if global_batch % n != 0:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"dp={n}")
    return global_batch // n


def shard_batch(batch: Any, mesh: Optional[Mesh]) -> Any:
    """This rank's rows ``[r * B / W, (r + 1) * B / W)`` of every leaf of a
    host batch (dicts of numpy arrays or tensors; every leaf shares the
    leading dimension B, which W divides). Scalars are kept whole. Without
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
