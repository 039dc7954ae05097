"""Training steps of AR2 co-training (port of ``simxns_tpu/train/steps.py``).

Each factory returns ``step(state, batch) -> (state, metrics)`` with the JAX
metric names; the retriever step takes ``(de_state, teacher, batch)``.
A step runs the loss forward, the backward, and the AdamW update in place
on one device (``device=None`` is the card). Batches are dicts of numpy
arrays or tensors:

- :func:`make_biencoder_step`: ``q_ids``/``q_mask`` [N, Lq],
  ``ctx_ids``/``ctx_mask`` [C, Lc], ``positive_idx`` [N] — in-batch
  negatives, the global softmax (the JAX ``grad_mode="full"``);
- :func:`make_reranker_step`: ``joint_ids``/``joint_mask`` [N, M, Lj],
  positive at column 0;
- :func:`make_ar2_retriever_step`: both, with M passages per query in
  ``ctx_*``; the teacher (the live reranker or its ``int8_view``) runs
  under ``no_grad``.

``dropout=True`` trains the model in train mode (the JAX factories'
``dropout``; ``run_ar2`` never turns it on): the step's generator is
:func:`dropout_generator` of ``(dropout_seed, state.step)``, the
counterpart of ``dropout_rngs``' ``fold_in``, so a run is reproducible
and every step draws fresh masks. The retriever step's teacher stays in
eval mode. Not ported yet (multi-GPU): ``grad_mode="local"``, slice
scope, ``with_grad_accum``, meshes.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from simxns_tpu_torch.device import resolve_device
from simxns_tpu_torch.losses.contrastive import grouped_nll, in_batch_nll
from simxns_tpu_torch.losses.distill import ar2_retriever_loss
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


def _check_on(module: nn.Module, device: torch.device) -> None:
    p = next(module.parameters())
    if p.device.type != device.type:
        raise ValueError(f"the model's parameters are on {p.device}, the step "
                         f"runs on {device}: move the model first")


def dropout_generator(dropout: bool, seed: int, step: int
                      ) -> Optional[torch.Generator]:
    """The step's dropout generator: None in eval mode, else a CPU
    generator that is a function of ``(seed, step)`` alone (the models
    draw one seed per layer from it)."""
    if not dropout:
        return None
    return torch.Generator().manual_seed((seed << 32) + step)


def biencoder_loss(model: nn.Module, batch: Dict[str, torch.Tensor],
                   score_scale: float = 1.0,
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[torch.Tensor, Metrics]:
    """``generator``: train mode (dropout), None for eval mode."""
    q_emb, ctx_emb = model(batch["q_ids"], batch["q_mask"], batch["ctx_ids"],
                           batch["ctx_mask"], generator=generator)
    loss, correct = in_batch_nll(q_emb, ctx_emb, batch["positive_idx"],
                                 score_scale=score_scale)
    return loss, {"correct": correct}


def reranker_loss(model: nn.Module, batch: Dict[str, torch.Tensor],
                  generator: Optional[torch.Generator] = None
                  ) -> Tuple[torch.Tensor, Metrics]:
    n, m, lj = batch["joint_ids"].shape
    logits = model(batch["joint_ids"].reshape(n * m, lj),
                   batch["joint_mask"].reshape(n * m, lj),
                   group_size=m, generator=generator)["logits"]
    correct = (logits.argmax(dim=1) == 0).sum().to(torch.int32)
    return grouped_nll(logits), {"correct": correct}


def retriever_loss(model: nn.Module, teacher: nn.Module,
                   batch: Dict[str, torch.Tensor], temperature: float = 1.0,
                   adv_lambda: float = 0.5,
                   scale_scores: Optional[float] = None,
                   adv_world_size: int = 1,
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[torch.Tensor, Metrics]:
    """The AR2 retriever objective. The adversarial term is a per-device
    sum that the reference's DDP averages over its world, so it is divided
    by ``adv_world_size`` (1 on one device). ``generator`` puts the
    retriever in train mode; the teacher always runs in eval mode."""
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
        loss = (adv_lambda * aux["adv_loss"] / adv_world_size
                + (1.0 - adv_lambda) * aux["normal_loss"])
    return loss, aux


def gradients(module: nn.Module, loss: torch.Tensor
              ) -> Dict[str, Optional[torch.Tensor]]:
    """d loss / d parameters by name (None where the loss does not reach
    a parameter)."""
    for p in module.parameters():
        p.grad = None
    loss.backward()
    return {n: p.grad for n, p in module.named_parameters()}


def _apply(state: TrainState, loss: torch.Tensor, aux: Metrics,
           tx: AdamW) -> Tuple[TrainState, Metrics]:
    grads = gradients(state.module, loss)
    state = state.apply_gradients(grads, tx)
    for p in state.module.parameters():
        p.grad = None
    return state, {"loss": loss.detach(),
                   **{k: v.detach() for k, v in aux.items()}}


def make_biencoder_step(tx: AdamW, device=None, score_scale: float = 1.0,
                        dropout: bool = False,
                        dropout_seed: int = 0) -> Callable:
    """In-batch contrastive step of a ``BiEncoder`` state; the scores are
    multiplied by ``score_scale`` before the softmax."""
    dev = resolve_device(device)

    def step(state: TrainState, batch: dict):
        _check_on(state.module, dev)
        gen = dropout_generator(dropout, dropout_seed, state.step)
        loss, aux = biencoder_loss(state.module, to_device(batch, dev),
                                   score_scale, gen)
        return _apply(state, loss, aux, tx)

    return step


def make_reranker_step(tx: AdamW, device=None, dropout: bool = False,
                       dropout_seed: int = 1) -> Callable:
    """Grouped CE step of a ``CrossEncoder`` state."""
    dev = resolve_device(device)

    def step(state: TrainState, batch: dict):
        _check_on(state.module, dev)
        gen = dropout_generator(dropout, dropout_seed, state.step)
        loss, aux = reranker_loss(state.module, to_device(batch, dev), gen)
        return _apply(state, loss, aux, tx)

    return step


def make_ar2_retriever_step(tx: AdamW, temperature: float = 1.0,
                            adv_lambda: float = 0.5,
                            scale_scores: Optional[float] = None,
                            adv_world_size: Optional[int] = None,
                            device=None, dropout: bool = False,
                            dropout_seed: int = 2) -> Callable:
    """AR2 retriever step: KL to a frozen reranker plus the adversarial
    reward. ``step(de_state, teacher, batch)``; ``teacher`` is the live
    ``CrossEncoder`` or its ``int8_view``. With ``dropout`` the retriever
    trains in train mode and the teacher stays in eval mode, as the
    reference's ``model.train(); reranker_model.eval()``."""
    dev = resolve_device(device)
    world = 1 if adv_world_size is None else adv_world_size

    def step(de_state: TrainState, teacher: nn.Module, batch: dict):
        _check_on(de_state.module, dev)
        gen = dropout_generator(dropout, dropout_seed, de_state.step)
        loss, aux = retriever_loss(de_state.module, teacher,
                                   to_device(batch, dev), temperature,
                                   adv_lambda, scale_scores, world, gen)
        return _apply(de_state, loss, aux, tx)

    return step
