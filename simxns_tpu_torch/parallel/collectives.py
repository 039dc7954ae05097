"""Cross-rank gathers and reductions of data-parallel training (port of
``simxns_tpu/parallel/collectives.py``).

The reference shares embeddings across ranks so the contrastive softmax
sees ``world_size x`` negatives, with a gradient contract: remote shards
are detached and the local slot is the live local tensor
(``MASTER/pretrain/modeling.py:402-410``, SURVEY.md §2.8). Two modes:

- :func:`all_gather_full_grad` — gradients flow into every shard: the
  forward gathers, the backward reduce-scatters (sums) the gradient back
  to each rank's slot;
- :func:`all_gather_local_grad` — the reference contract: the gathered
  copy is detached and the caller's live ``x`` spliced into its own slot.

Every function takes a :class:`~simxns_tpu_torch.parallel.mesh.Mesh`; a
mesh without a group (a world of one) returns its input. Only collectives
that NCCL and gloo both take on CUDA tensors are used (``all_gather``,
``reduce_scatter``, ``all_reduce``), with no branch on the backend.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from simxns_tpu_torch.parallel.mesh import Mesh

__all__ = ["all_gather_full_grad", "all_gather_local_grad",
           "all_gather_rows", "all_reduce_grads", "all_reduce_sum",
           "barrier", "broadcast_int", "gather_in_batch_negatives",
           "gather_positive_offsets"]

# gradients are all-reduced in flat buffers of at most this many elements
BUCKET_ELEMENTS = 1 << 26


def _active(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and mesh.distributed


def all_gather_rows(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """[B, ...] on each rank -> [W * B, ...], rank-major (rank 0's rows
    first), the same on every rank; no gradient. Every rank's B must be
    equal."""
    import torch.distributed as dist

    if not _active(mesh):
        return x
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.world_size)]
    dist.all_gather(parts, x, group=mesh.group)
    return torch.cat(parts)


class _GatherFullGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return all_gather_rows(x, mesh)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        mesh = ctx.mesh
        parts = [p.contiguous() for p in grad.chunk(mesh.world_size)]
        out = torch.empty_like(parts[mesh.rank])
        dist.reduce_scatter(out, parts, group=mesh.group)
        return out, None


def all_gather_full_grad(x: torch.Tensor, mesh: Optional[Mesh]
                         ) -> torch.Tensor:
    """All-gather with gradients to every shard: [B, ...] -> [W * B, ...]
    rank-major; the backward sums every rank's gradient of this rank's
    slot."""
    if not _active(mesh):
        return x
    return _GatherFullGrad.apply(x, mesh)


def all_gather_local_grad(x: torch.Tensor, mesh: Optional[Mesh]
                          ) -> torch.Tensor:
    """All-gather; gradients flow only into the local shard (the live
    ``x`` spliced into its own slot of the detached gathered copy)."""
    if not _active(mesh):
        return x
    parts = list(all_gather_rows(x, mesh).chunk(mesh.world_size))
    parts[mesh.rank] = x
    return torch.cat(parts)


def gather_in_batch_negatives(x: torch.Tensor, mesh: Optional[Mesh],
                              grad_mode: str = "full") -> torch.Tensor:
    if grad_mode == "full":
        return all_gather_full_grad(x, mesh)
    if grad_mode == "local":
        return all_gather_local_grad(x, mesh)
    raise ValueError(f"grad_mode must be 'full' or 'local', got {grad_mode!r}")


def gather_positive_offsets(local_positions: torch.Tensor, local_batch: int,
                            mesh: Optional[Mesh]) -> torch.Tensor:
    """Shift rank-local positive indices into the gathered index space:
    ``+ rank * local_batch``."""
    rank = mesh.rank if mesh is not None else 0
    return local_positions + rank * local_batch


def all_reduce_sum(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Sum of ``x`` over the group (a new tensor; ``x`` itself without a
    group)."""
    import torch.distributed as dist

    if not _active(mesh):
        return x
    out = x.detach().clone()
    dist.all_reduce(out, group=mesh.group)
    return out


def all_reduce_grads(grads: Dict[str, Optional[torch.Tensor]],
                     mesh: Optional[Mesh]
                     ) -> Dict[str, Optional[torch.Tensor]]:
    """Sum every gradient over the group, in place, through flat buffers of
    at most :data:`BUCKET_ELEMENTS` elements per dtype (a few collectives a
    step). A ``None`` gradient (the loss does not reach the parameter)
    stays None: every rank runs the same model, so the same ones are None.
    Every rank ends with the same bits."""
    import torch.distributed as dist

    if not _active(mesh):
        return grads
    buckets: Dict[tuple, List[List[torch.Tensor]]] = {}
    for g in grads.values():
        if g is None:
            continue
        runs = buckets.setdefault((g.dtype, g.device), [[]])
        if runs[-1] and (sum(t.numel() for t in runs[-1]) + g.numel()
                         > BUCKET_ELEMENTS):
            runs.append([])
        runs[-1].append(g)
    for runs in buckets.values():
        for run in runs:
            flat = torch.cat([g.reshape(-1) for g in run])
            dist.all_reduce(flat, group=mesh.group)
            offset = 0
            for g in run:
                g.copy_(flat[offset:offset + g.numel()].view_as(g))
                offset += g.numel()
    return grads


def broadcast_int(value: int, mesh: Optional[Mesh], src: int = 0) -> int:
    """Rank ``src``'s ``value`` on every rank (``value`` without a group)."""
    if not _active(mesh):
        return value
    mine = value if mesh.rank == src else 0
    return int(all_reduce_sum(torch.tensor(
        [mine], dtype=torch.int64, device=mesh.device), mesh).item())


def barrier(mesh: Optional[Mesh], failed: bool = False,
            what: str = "a rank") -> None:
    """Wait for every rank; raise on every rank if any passed
    ``failed=True`` (an all-reduce of the flags on the mesh's device, so it
    orders with the other collectives of the group)."""
    if not _active(mesh):
        if failed:
            raise RuntimeError(f"{what} failed")
        return
    flags = all_reduce_sum(torch.tensor([int(failed)], dtype=torch.int64,
                                        device=mesh.device), mesh)
    if int(flags.item()):
        raise RuntimeError(f"{what} failed on {int(flags.item())} rank(s)")


def sum_metrics(metrics: Dict[str, torch.Tensor], mesh: Optional[Mesh],
                divide: Sequence[str] = ()) -> Dict[str, torch.Tensor]:
    """Each scalar metric summed over the group in one all-reduce (as f64,
    exact for counts), each back in its dtype; the names in ``divide`` are
    then divided by the world size. Without a group: ``metrics``."""
    if not _active(mesh):
        return metrics
    names = list(metrics)
    packed = torch.stack([metrics[n].detach().reshape(()).double()
                          for n in names])
    packed = all_reduce_sum(packed, mesh)
    out = {}
    for i, n in enumerate(names):
        v = packed[i]
        if n in divide:
            v = v / mesh.world_size
        out[n] = v.to(metrics[n].dtype)
    return out
