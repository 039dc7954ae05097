"""Training steps of AR2 co-training (port of ``simxns_tpu/train/steps.py``).

Each factory returns ``step(state, batch) -> (state, metrics)`` with the JAX
metric names; the retriever step takes ``(de_state, teacher, batch)``.
A step runs the loss forward, the backward, and the AdamW update in place
(``device=None`` is the mesh's device, else the card). Batches are dicts of
numpy arrays or tensors:

- :func:`make_biencoder_step`: ``q_ids``/``q_mask`` [N, Lq],
  ``ctx_ids``/``ctx_mask`` [C, Lc], ``positive_idx`` [N] — in-batch
  negatives, the global softmax (the JAX ``grad_mode="full"``);
- :func:`make_reranker_step`: ``joint_ids``/``joint_mask`` [N, M, Lj],
  positive at column 0;
- :func:`make_ar2_retriever_step`: both, with M passages per query in
  ``ctx_*``; the teacher (the live reranker or its ``int8_view``) runs
  under ``no_grad``;
- :func:`make_colbert_step`: ``q_*`` and ``ctx_*`` of a ``ColBERT`` state,
  MaxSim scores of every query against every document, the positive of
  query i at ``i * group_size`` (LEAD's single-model trainer).

``dropout=True`` trains the model in train mode (the JAX factories'
``dropout``; ``run_ar2`` never turns it on): the step's generator is
:func:`dropout_generator` of ``(dropout_seed, state.step)``, the
counterpart of ``dropout_rngs``' ``fold_in``, so a run is reproducible
and every step draws fresh masks; under a group of W > 1 the rank is
folded in too (the JAX steps fold ``axis_index``), so ranks draw
different masks. The retriever step's teacher stays in eval mode.

Data parallelism (``mesh``, a :class:`~simxns_tpu_torch.parallel.mesh.Mesh`
with a group; one process per GPU): every rank passes its rows of the
global batch (``parallel.shard_batch``, rank-major) and the group computes
what the JAX step computes on a mesh of W devices over the whole batch.
The convention: **each rank's loss is its share of the global objective,
and the gradients are summed** over the group (one all-reduce of flat
buffers after the backward, then the same AdamW update on every rank, so
every rank holds the same parameter bits). A rank's share of a mean over
the global batch is its local mean over W (every rank holds B / W rows);
the AR2 adversarial term, a global sum divided by ``adv_world_size``, is
the local sum over ``adv_world_size``. The reported ``loss`` is the
global loss (the shares summed), ``correct`` the global count (JAX's
``psum``), ``normal_loss`` the global mean and ``adv_loss`` the global
sum. The bi-encoder step gathers the context embeddings over the group
(``grad_mode="full"``: gradients to every shard; ``"local"``: the
reference's detach-remote contract) and ``positive_idx`` stays a global
flat index. Without a group (``mesh=None`` or ``Mesh(group=None)``) every
step is the single-device step, the counterpart of JAX's 1x1 mesh.

On a multislice mesh (``create_multislice_mesh``) the gradients are
summed over every slice, and ``negatives_scope="slice"`` gathers the
in-batch negatives over the data axis of the rank's slice only (the
global ``positive_idx`` shifted into the slice's rows). Tensor
parallelism (a mesh with a ``model`` axis): the state's module is split
by ``parallel.tp.shard_params`` and the step factory takes
``auto_state=True`` (JAX's name: the step keeps the state's layout); the
update runs on each rank's slice. The gradients are summed over the
data-parallel group only: a split parameter's slices are never summed
across model ranks, and a whole one gets the same gradient on every model
rank by construction. A split state without ``auto_state`` raises (the
reranker step, which has no ``auto_state`` in JAX, runs replicated).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from simxns_tpu_torch.losses.contrastive import grouped_nll, in_batch_nll
from simxns_tpu_torch.losses.distill import ar2_retriever_loss
from simxns_tpu_torch.parallel.collectives import (all_gather_full_grad,
                                                   all_reduce_grads,
                                                   gather_in_batch_negatives,
                                                   sum_metrics)
from simxns_tpu_torch.parallel.mesh import Mesh, dp_size, mesh_device
from simxns_tpu_torch.parallel.tp import tensor_parallel_of
from simxns_tpu_torch.train.optim import AdamW
from simxns_tpu_torch.train.state import TrainState

Metrics = Dict[str, torch.Tensor]


def to_device(batch: dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """Every array of ``batch`` as a tensor on ``device`` (integers as
    int64, the index type of ``nn.Embedding``)."""
    out = {}
    for key, val in batch.items():
        t = torch.as_tensor(val)
        if not t.is_floating_point():
            t = t.long()
        out[key] = t.to(device, non_blocking=True)
    return out


def _check_on(module: nn.Module, device: torch.device,
              auto_state: bool = False) -> None:
    p = next(module.parameters())
    if p.device.type != device.type:
        raise ValueError(f"the model's parameters are on {p.device}, the step "
                         f"runs on {device}: move the model first")
    if tensor_parallel_of(module) is not None and not auto_state:
        raise ValueError("the state holds tensor-parallel parameters "
                         "(parallel.tp.shard_params): build the step with "
                         "auto_state=True")


_MASK64 = 0xFFFFFFFFFFFFFFFF


def _mix64(x: int) -> int:
    """splitmix64's finalizer: every input bit reaches every output bit."""
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def dropout_generator(dropout: bool, seed: int, step: int, rank: int = 0
                      ) -> Optional[torch.Generator]:
    """The step's dropout generator: None in eval mode, else a CPU
    generator that is a function of ``(seed, step, rank)`` alone (the models
    draw one seed per layer from it); rank 0's is the single-device one.

    The CPU generator keeps only the low 32 bits of its seed, so seed, step
    and rank are mixed into all 64 bits and the halves folded together:
    each of the three changes the masks (JAX: ``fold_in(PRNGKey(seed),
    step)``, then ``fold_in(key, axis_index)``)."""
    if not dropout:
        return None
    base = _mix64((_mix64(seed & _MASK64) + step) & _MASK64)
    if rank:
        base = _mix64(base ^ ((rank * 0x9E3779B97F4A7C15) & _MASK64))
    return torch.Generator().manual_seed((base ^ (base >> 32)) & 0xFFFFFFFF)


def _share(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """A rank's share of a global mean, x / W (x itself in a world of
    one)."""
    w = dp_size(mesh)
    return x if w == 1 else x / w


def biencoder_loss(model: nn.Module, batch: Dict[str, torch.Tensor],
                   score_scale: float = 1.0,
                   generator: Optional[torch.Generator] = None,
                   mesh: Optional[Mesh] = None, grad_mode: str = "full",
                   negatives_scope: str = "global"
                   ) -> Tuple[torch.Tensor, Metrics]:
    """``generator``: train mode (dropout), None for eval mode. Under a
    group: this rank's share of the global loss over the gathered contexts
    (``grad_mode``; over its slice's under ``negatives_scope="slice"`` on
    a multislice mesh) and its local ``correct``."""
    q_emb, ctx_emb = model(batch["q_ids"], batch["q_mask"], batch["ctx_ids"],
                           batch["ctx_mask"], generator=generator)
    pos = batch["positive_idx"]
    over = mesh
    if negatives_scope == "slice" and mesh is not None and mesh.multislice:
        # the gathered rows span this slice only: the global index shifts
        # down by the slice's first row (rows are replica-major)
        over = mesh.within_slice
        pos = pos - mesh.replica_index * ctx_emb.shape[0] * mesh.n_data
    ctx_emb = gather_in_batch_negatives(ctx_emb, over, grad_mode)
    loss, correct = in_batch_nll(q_emb, ctx_emb, pos,
                                 score_scale=score_scale)
    return _share(loss, mesh), {"correct": correct}


def reranker_loss(model: nn.Module, batch: Dict[str, torch.Tensor],
                  generator: Optional[torch.Generator] = None,
                  mesh: Optional[Mesh] = None
                  ) -> Tuple[torch.Tensor, Metrics]:
    """Under a group: this rank's share of the global mean."""
    n, m, lj = batch["joint_ids"].shape
    logits = model(batch["joint_ids"].reshape(n * m, lj),
                   batch["joint_mask"].reshape(n * m, lj),
                   group_size=m, generator=generator)["logits"]
    correct = (logits.argmax(dim=1) == 0).sum().to(torch.int32)
    return _share(grouped_nll(logits), mesh), {"correct": correct}


def retriever_loss(model: nn.Module, teacher: nn.Module,
                   batch: Dict[str, torch.Tensor], temperature: float = 1.0,
                   adv_lambda: float = 0.5,
                   scale_scores: Optional[float] = None,
                   adv_world_size: int = 1,
                   generator: Optional[torch.Generator] = None,
                   mesh: Optional[Mesh] = None
                   ) -> Tuple[torch.Tensor, Metrics]:
    """The AR2 retriever objective. The adversarial term is a per-device
    sum that the reference's DDP averages over its world, so it is divided
    by ``adv_world_size`` (1 on one device). ``generator`` puts the
    retriever in train mode; the teacher always runs in eval mode. Under a
    group: this rank's share, ``adv_lambda * adv_r / adv_world_size +
    (1 - adv_lambda) * normal_r / W`` (``adv_r`` the local sum,
    ``normal_r`` the local mean), and the local aux terms."""
    n, m, lj = batch["joint_ids"].shape
    with torch.no_grad():
        logits = teacher(batch["joint_ids"].reshape(n * m, lj),
                         batch["joint_mask"].reshape(n * m, lj),
                         group_size=m)["logits"]
    q_emb, ctx_emb = model(batch["q_ids"], batch["q_mask"], batch["ctx_ids"],
                           batch["ctx_mask"], generator=generator)
    groups = ctx_emb.reshape(n, m, -1)
    scores = torch.einsum("bh,bmh->bm", q_emb.float(), groups.float())
    loss, aux = ar2_retriever_loss(scores, logits, temperature=temperature,
                                   adv_lambda=adv_lambda,
                                   scale_scores=scale_scores)
    if adv_lambda != 0.0:
        return (adv_lambda * aux["adv_loss"] / adv_world_size
                + (1.0 - adv_lambda) * _share(aux["normal_loss"], mesh)), aux
    return _share(loss, mesh), aux


def gradients(module: nn.Module, loss: torch.Tensor
              ) -> Dict[str, Optional[torch.Tensor]]:
    """d loss / d parameters by name (None where the loss does not reach
    a parameter)."""
    for p in module.parameters():
        p.grad = None
    loss.backward()
    return {n: p.grad for n, p in module.named_parameters()}


def _apply(state: TrainState, loss: torch.Tensor, aux: Metrics,
           tx: AdamW, mesh: Optional[Mesh] = None,
           mean_metrics: Tuple[str, ...] = ()) -> Tuple[TrainState, Metrics]:
    """Backward, the gradients summed over the group, AdamW; the metrics
    summed over the group (``mean_metrics``: then divided by W)."""
    grads = all_reduce_grads(gradients(state.module, loss), mesh)
    state = state.apply_gradients(grads, tx)
    for p in state.module.parameters():
        p.grad = None
    metrics = {"loss": loss.detach(),
               **{k: v.detach() for k, v in aux.items()}}
    return state, sum_metrics(metrics, mesh, divide=mean_metrics)


def with_grad_accum(loss_fn: Callable, micro_steps: int) -> Callable:
    """Wrap ``loss_fn(module, batch) -> (loss, aux)`` to average the
    gradients over ``micro_steps`` equal slices of the batch's leading dim
    (the JAX ``with_grad_accum``; the reference's
    ``--gradient_accumulation_steps``). Returns ``vg(module, batch) ->
    ((loss, aux), grads)``: the loss and float aux averaged, integer aux
    summed, the gradients (by name) summed over the slices in order and
    scaled by ``1 / micro_steps``; the ``.grad`` fields are cleared.

    For an in-batch loss the negative pool shrinks to the slice and
    ``positive_idx`` must be slice-local: a full-batch index raises
    ``ValueError`` (the JAX guard on concrete batches). Under a group,
    ``loss_fn`` returns the rank's share and the caller sums the gradients
    (``parallel.all_reduce_grads``).
    """
    def vg(module: nn.Module, batch: dict):
        if micro_steps <= 1:
            loss, aux = loss_fn(module, batch)
            return (loss, aux), gradients(module, loss)
        pos = batch.get("positive_idx")
        if pos is not None and "ctx_ids" in batch:
            rows = batch["ctx_ids"].shape[0] // micro_steps
            top = int(torch.as_tensor(pos).max())
            if top >= rows:
                raise ValueError(
                    f"with_grad_accum(micro_steps={micro_steps}): "
                    f"positive_idx max {top} >= {rows} ctx rows per "
                    "microbatch — positive_idx must be microbatch-LOCAL "
                    "under accumulation (see docstring)")
        for p in module.parameters():
            p.grad = None
        loss_sum, aux_sum = None, None
        for i in range(micro_steps):
            micro = {k: v.reshape((micro_steps, v.shape[0] // micro_steps)
                                  + tuple(v.shape[1:]))[i]
                     for k, v in batch.items()}
            loss, aux = loss_fn(module, micro)
            loss.backward()
            loss = loss.detach()
            aux = {k: v.detach() for k, v in aux.items()}
            if loss_sum is None:
                loss_sum, aux_sum = loss, aux
            else:
                loss_sum = loss_sum + loss
                aux_sum = {k: aux_sum[k] + v for k, v in aux.items()}
        scale = 1.0 / micro_steps
        aux = {k: v * scale if v.is_floating_point() else v
               for k, v in aux_sum.items()}
        grads = {n: None if p.grad is None else p.grad * scale
                 for n, p in module.named_parameters()}
        for p in module.parameters():
            p.grad = None
        return (loss_sum * scale, aux), grads

    return vg


def make_biencoder_step(tx: AdamW, device=None, score_scale: float = 1.0,
                        dropout: bool = False,
                        dropout_seed: int = 0, mesh: Optional[Mesh] = None,
                        grad_mode: str = "full", auto_state: bool = False,
                        negatives_scope: str = "global") -> Callable:
    """In-batch contrastive step of a ``BiEncoder`` state; the scores are
    multiplied by ``score_scale`` before the softmax. Under a group the
    contexts are gathered (``grad_mode`` ``"full"`` or ``"local"``), over
    every data-parallel rank (``negatives_scope="global"``: the math of
    one big slice) or, on a multislice mesh, over the rank's slice
    (``"slice"``). ``auto_state``: the state is tensor-parallel."""
    if negatives_scope not in ("global", "slice"):
        raise ValueError(f"bad negatives_scope {negatives_scope!r}")
    if grad_mode not in ("full", "local"):
        raise ValueError(f"bad grad_mode {grad_mode!r}")
    dev = mesh_device(mesh, device)

    def step(state: TrainState, batch: dict):
        _check_on(state.module, dev, auto_state)
        gen = dropout_generator(dropout, dropout_seed, state.step,
                                0 if mesh is None else mesh.rank)
        loss, aux = biencoder_loss(state.module, to_device(batch, dev),
                                   score_scale, gen, mesh, grad_mode,
                                   negatives_scope)
        return _apply(state, loss, aux, tx, mesh)

    return step


def make_reranker_step(tx: AdamW, device=None, dropout: bool = False,
                       dropout_seed: int = 1,
                       mesh: Optional[Mesh] = None) -> Callable:
    """Grouped CE step of a ``CrossEncoder`` state."""
    dev = mesh_device(mesh, device)

    def step(state: TrainState, batch: dict):
        _check_on(state.module, dev)
        gen = dropout_generator(dropout, dropout_seed, state.step,
                                0 if mesh is None else mesh.rank)
        loss, aux = reranker_loss(state.module, to_device(batch, dev), gen,
                                  mesh)
        return _apply(state, loss, aux, tx, mesh)

    return step


def make_ar2_retriever_step(tx: AdamW, temperature: float = 1.0,
                            adv_lambda: float = 0.5,
                            scale_scores: Optional[float] = None,
                            adv_world_size: Optional[int] = None,
                            device=None, dropout: bool = False,
                            dropout_seed: int = 2,
                            mesh: Optional[Mesh] = None,
                            auto_state: bool = False) -> Callable:
    """AR2 retriever step: KL to a frozen reranker plus the adversarial
    reward. ``step(de_state, teacher, batch)``; ``teacher`` is the live
    ``CrossEncoder`` or its ``int8_view``. With ``dropout`` the retriever
    trains in train mode and the teacher stays in eval mode, as the
    reference's ``model.train(); reranker_model.eval()``.
    ``adv_world_size`` defaults to the group's world size (JAX's
    ``dp_size(mesh)``; 1 without a group); pass 8 to pin the reference's
    8-GPU scale on another world. ``auto_state``: the retriever state is
    tensor-parallel (the teacher may be split or whole)."""
    dev = mesh_device(mesh, device)
    world = dp_size(mesh) if adv_world_size is None else adv_world_size

    def step(de_state: TrainState, teacher: nn.Module, batch: dict):
        _check_on(de_state.module, dev, auto_state)
        gen = dropout_generator(dropout, dropout_seed, de_state.step,
                                0 if mesh is None else mesh.rank)
        loss, aux = retriever_loss(de_state.module, teacher,
                                   to_device(batch, dev), temperature,
                                   adv_lambda, scale_scores, world, gen,
                                   mesh)
        return _apply(de_state, loss, aux, tx, mesh,
                      mean_metrics=("normal_loss",))

    return step


def colbert_loss(model: nn.Module, batch: Dict[str, torch.Tensor],
                 group_size: int = 1, mesh: Optional[Mesh] = None
                 ) -> Tuple[torch.Tensor, Metrics]:
    """In-batch MaxSim NLL (``get_loss_dual``, ``LEAD/util.py:416-451``).
    Under a group the document tokens are gathered (gradients to every
    shard) and the targets shifted into the gathered rows: this rank's
    share of the global mean and its local ``correct``."""
    from simxns_tpu_torch.models.colbert import maxsim_score

    q_tok, d_tok = model(batch["q_ids"], batch["q_mask"], batch["ctx_ids"],
                         batch["ctx_mask"])
    scores = maxsim_score(q_tok, all_gather_full_grad(d_tok, mesh))  # [Q, D]
    n = scores.shape[0]
    rank = 0 if mesh is None or not mesh.distributed else mesh.rank
    target = (torch.arange(n, device=scores.device) + rank * n) * group_size
    logp = torch.log_softmax(scores.float(), dim=1)
    loss = -logp.gather(1, target[:, None]).mean()
    correct = (scores.argmax(dim=1) == target).sum().to(torch.int32)
    return _share(loss, mesh), {"correct": correct}


def make_colbert_step(tx: AdamW, device=None, group_size: int = 1,
                      mesh: Optional[Mesh] = None) -> Callable:
    """ColBERT in-batch contrastive step (the JAX ``make_colbert_step``):
    ``step(state, batch) -> (state, metrics)``. Masked document tokens are
    zero vectors (cosine mode), the effect of the reference's -1e4 fill."""
    dev = mesh_device(mesh, device)

    def step(state: TrainState, batch: dict):
        _check_on(state.module, dev)
        loss, aux = colbert_loss(state.module, to_device(batch, dev),
                                 group_size, mesh)
        return _apply(state, loss, aux, tx, mesh)

    return step
