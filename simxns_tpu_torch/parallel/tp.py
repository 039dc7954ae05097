"""Megatron tensor parallelism over the mesh's ``model`` axis (port of
``simxns_tpu/parallel/tp.py``).

The JAX package assigns a ``PartitionSpec`` to each parameter by its path
and lets GSPMD insert the collectives. The port has no GSPMD, so it splits
the layers itself, with the same decisions (:func:`tp_param_shardings`):

- attention ``query``/``key``/``value`` and FFN ``intermediate`` weights
  are column-split (their output features), their biases with them;
- attention ``output`` and FFN ``output`` weights are row-split (their
  input features); their biases stay whole and are added once, after the
  all-reduce;
- the MLM ``decoder`` is split over the vocabulary, with its bias;
- embeddings, LayerNorms and every other layer stay whole.

``nn.Linear`` keeps its weight as [out, in], the transpose of flax's
kernel, so a column split is dim 0 of the weight and a row split dim 1.

:func:`shard_params` keeps each model rank's slice and gives the model's
layers a :class:`TensorParallel` context, which wires Megatron's two
autograd functions around the split layers: identity forward / all-reduce
backward at a column input (:meth:`TensorParallel.copy_in`), all-reduce
forward / identity backward after a row output
(:meth:`TensorParallel.reduce_out`). The column split of q, k and v falls
on whole heads when the heads divide by the model size, and the attention
kernels run at heads / T; where only the width divides (GSPMD computes
there too), q, k and v are gathered over the model group before the
attention. Where the JAX package runs a Pallas kernel on split operands
(the FFN and int8 knobs, the fused-int8 layer), GSPMD feeds the kernel
whole arrays: the port runs that layer on its weights gathered over the
model group, and an untied MLM head gathers its logits.

The optimizer sees the split: the global gradient norm and LAMB's
per-parameter norms add the split parameters' squares over the model
group. A checkpoint holds full tensors (:func:`full_state_dict`), so it
loads on one device; :func:`load_full_state` re-splits a full state.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator, Optional

import torch
from torch import nn

from simxns_tpu_torch.parallel.mesh import Mesh

__all__ = ["TensorParallel", "full_state_dict", "load_full_state",
           "shard_params", "tensor_parallel_of", "tp_param_shardings"]

_COLUMN = ("query", "key", "value", "intermediate")
_ROW = ("output",)              # attention output + FFN output


def _split_dim(name: str, ndim: int) -> Optional[int]:
    """``_spec_for`` on a state_dict name of the port: 0 (column, or the
    vocabulary), 1 (row) or None (whole)."""
    parts = name.split(".")
    last = parts[-1]
    parent = parts[-2] if len(parts) >= 2 else ""
    if ndim < 1:
        return None
    if "embedding" in parent or "layer_norm" in parent:
        return None
    if last == "weight" and ndim == 2:
        if parent in _COLUMN or parent == "decoder":
            return 0
        if parent in _ROW:
            return 1
        return None
    if last == "bias" and ndim == 1 and (parent in _COLUMN
                                         or parent == "decoder"):
        return 0
    return None


def tp_param_shardings(module: nn.Module, mesh: Optional[Mesh] = None
                       ) -> Dict[str, Optional[int]]:
    """{state_dict name: the dimension split over the model axis, or None
    for a whole parameter}; with a mesh, every split dimension must divide
    by its model size (else ``ValueError``, as placing the JAX tree
    fails)."""
    out = {}
    n = 1 if mesh is None else mesh.n_model
    for name, p in module.named_parameters():
        dim = _split_dim(name, p.ndim)
        if dim is not None and p.shape[dim] % n:
            raise ValueError(
                f"{name}: dimension {dim} of {tuple(p.shape)} does not "
                f"divide by the model axis n_model={n}")
        out[name] = dim
    return out


# --- the collectives of the model axis, under autograd -----------------------

def _all_reduce(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    import torch.distributed as dist

    out = x.contiguous().clone()
    dist.all_reduce(out, group=mesh.group)
    return out


def _all_gather(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    import torch.distributed as dist

    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.world_size)]
    dist.all_gather(parts, x, group=mesh.group)
    return torch.cat(parts, dim=dim)


def _reduce_scatter(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    import torch.distributed as dist

    parts = [p.contiguous() for p in x.chunk(mesh.world_size, dim=dim)]
    out = torch.empty_like(parts[mesh.rank])
    dist.reduce_scatter(out, parts, group=mesh.group)
    return out


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.mesh), None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _all_reduce(x, mesh)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim``; the backward takes this rank's slice of
    the gradient (``summed=False``: every rank computes the same thing
    downstream) or the sum of every rank's (``summed=True``: each holds a
    partial gradient)."""

    @staticmethod
    def forward(ctx, x, mesh, dim, summed):
        ctx.mesh, ctx.dim, ctx.summed = mesh, dim, summed
        return _all_gather(x, mesh, dim)

    @staticmethod
    def backward(ctx, grad):
        mesh, dim = ctx.mesh, ctx.dim
        if ctx.summed:
            return _reduce_scatter(grad, mesh, dim), None, None, None
        return (grad.chunk(mesh.world_size, dim=dim)[mesh.rank].contiguous(),
                None, None, None)


@dataclasses.dataclass(eq=False)
class TensorParallel:
    """A layer's view of the model axis: its group (``mesh``, the mesh's
    ``model_mesh``) and the collectives around the split layers."""
    mesh: Mesh

    @property
    def rank(self) -> int:
        return self.mesh.rank

    @property
    def size(self) -> int:
        return self.mesh.world_size

    def __deepcopy__(self, memo):
        return self          # a copied module shares the group

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        """A column-split layer's input: identity forward, the gradient
        all-reduced over the model group."""
        return _CopyIn.apply(x, self.mesh)

    def reduce_out(self, x: torch.Tensor) -> torch.Tensor:
        """A row-split layer's partial output summed over the model group
        (the gradient passes as it is)."""
        return _ReduceOut.apply(x, self.mesh)

    def gather(self, x: torch.Tensor, dim: int = -1,
               summed: bool = False) -> torch.Tensor:
        """The model ranks' slices along ``dim`` as one tensor (see
        :class:`_Gather` for ``summed``)."""
        return _Gather.apply(x, self.mesh, dim % x.ndim, summed)

    def row_dense(self, layer: nn.Linear, x: torch.Tensor,
                  dt: torch.dtype) -> torch.Tensor:
        """flax ``Dense(dtype=dt)`` of a row-split layer: the ``dt``
        operands' products accumulated in f32 on each rank, summed over
        the model group in f32, rounded to ``dt``, then the whole ``dt``
        bias added once."""
        part = torch.matmul(x.to(dt).float(), layer.weight.to(dt).float().T)
        return self.reduce_out(part).to(dt) + layer.bias.to(dt)

    def gathered(self, module: nn.Module) -> Dict[str, torch.Tensor]:
        """``module``'s parameters with every split one gathered over the
        model group (the gradient goes to this rank's slice), by name."""
        out = {}
        for name, p in module.named_parameters():
            dim = _split_dim(name, p.ndim)
            out[name] = p if dim is None else self.gather(p, dim)
        return out

    @contextlib.contextmanager
    def suspended(self, module: nn.Module) -> Iterator[None]:
        """``module``'s layers without their context for the duration."""
        layers = [m for m in module.modules() if getattr(m, "tp", None)]
        for m in layers:
            m.tp = None
        try:
            yield
        finally:
            for m in layers:
                m.tp = self

    def whole(self, module: nn.Module, *args, **kwargs):
        """``module(*args, **kwargs)`` on its gathered weights, computed
        the same on every model rank (GSPMD's whole operands)."""
        full = self.gathered(module)
        with self.suspended(module):
            return torch.func.functional_call(module, full, args, kwargs)


def tensor_parallel_of(module: nn.Module):
    """``(model mesh, names of the split parameters)`` of a module that
    :func:`shard_params` split, else None."""
    return getattr(module, "_tp_split", None)


def _tp_layers(module: nn.Module):
    from simxns_tpu_torch.models.bert import (BertLayer, BertSelfAttention,
                                              MLMHead)

    return [m for m in module.modules()
            if isinstance(m, (BertLayer, BertSelfAttention, MLMHead))]


@torch.no_grad()
def shard_params(module: nn.Module, mesh: Mesh) -> nn.Module:
    """Split ``module``'s parameters over ``mesh``'s model axis, in place:
    each parameter that :func:`tp_param_shardings` splits keeps this
    model rank's contiguous block (a new ``Parameter``), and the layers
    run Megatron's collectives. Returns ``module``. A mesh without a
    model axis (``n_model`` 1) leaves it as it is."""
    if mesh.model_mesh is None or mesh.n_model == 1:
        return module
    if tensor_parallel_of(module) is not None:
        raise ValueError("the module is split already")
    model = mesh.model_mesh
    split = {}
    for name, dim in tp_param_shardings(module, mesh).items():
        if dim is None:
            continue
        owner, _, leaf = name.rpartition(".")
        sub = module.get_submodule(owner)
        full = getattr(sub, leaf)
        part = full.chunk(model.world_size, dim=dim)[model.rank].clone()
        setattr(sub, leaf, nn.Parameter(part,
                                        requires_grad=full.requires_grad))
        split[name] = dim
    ctx = TensorParallel(model)
    for layer in _tp_layers(module):
        layer.tp = ctx
    module._tp_split = (model, frozenset(split))
    return module


@torch.no_grad()
def full_state_dict(state) -> dict:
    """A ``TrainState``'s :meth:`state_dict` with every split tensor (the
    parameter and its AdamW moments) gathered over the model group: the
    tree of one device, which a checkpoint holds. Every model rank calls
    it (a collective); a state that is not split is returned as it is."""
    tree = state.state_dict()
    info = tensor_parallel_of(state.module)
    if info is None:
        return tree
    model, names = info

    def full(part):
        return {n: (_all_gather(t, model, _split_dim(n, t.ndim))
                    if n in names else t) for n, t in part.items()}

    opt = dict(tree["opt_state"])
    for key in ("mu", "nu"):
        if key in opt:
            opt[key] = full(opt[key])
    return {**tree, "params": full(tree["params"]), "opt_state": opt}


@torch.no_grad()
def load_full_state(state, tree: dict):
    """Copy a full (one-device) ``state_dict`` tree into a split
    ``TrainState``: each split tensor's block of this model rank. Returns
    ``state``."""
    info = tensor_parallel_of(state.module)
    if info is None:
        return state.load_state_dict(tree)
    model, names = info

    def local(part):
        return {n: (t.chunk(model.world_size, dim=_split_dim(n, t.ndim))
                    [model.rank] if n in names else t)
                for n, t in part.items()}

    opt = dict(tree["opt_state"])
    for key in ("mu", "nu"):
        if key in opt:
            opt[key] = local(opt[key])
    return state.load_state_dict({**tree, "params": local(tree["params"]),
                                  "opt_state": opt})
