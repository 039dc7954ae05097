"""PROD progressive knowledge-distillation steps (port of
``simxns_tpu/train/kd.py``).

One step factory covers the teacher modes of
``PROD/ProD_KD/run_progressive_distill_marco.py:204-318``:

- ``dual_encoder``: a DE teacher; student and teacher both score the
  global in-batch [Q, C] matrix (``BiEncoderKDLoss``);
- ``cross_encoder``: a frozen CE teacher over (1 + n) groups
  (``CrossBERTKDLoss``), with the LwF term against a frozen copy of the
  student at init when ``"student_init"`` is among the teachers
  (``:84-86, 294-306``);
- ``double``: the DE and the CE teachers; the larger loss wins
  (``:227-234``), and the picked teacher's metrics are reported;
- ``colbert``: a ColBERT teacher's full-cross MaxSim [Q, C] scores
  (``ColBERTKDLoss``), the student on the global in-batch matrix.

:func:`make_ce_kd_step` is the CE -> CE stage (``Cross2CrossKDLoss``).
A step is ``step(state, teachers, batch) -> (state, metrics)``: the
teachers are modules (``{"de", "ce", "colbert", "student_init"}``; the CE
one may be an ``int8_view``), run under ``no_grad`` in eval mode. The batch is the
``MinedDataset`` layout (``q_*``, ``ctx_*``, ``positive_idx`` a global
flat index, ``joint_*`` [N, M, Lj]).

Data parallelism (``mesh``): as the other step factories, each rank's loss
is its share of the global objective (every loss here is a mean over
rows: the local mean over W) and the gradients are summed over the
data-parallel group; the in-batch branches gather the student's contexts
(gradients to every shard) and the teacher's, so each rank scores its
queries against the global [Q, C] matrix, as the JAX step does over the
whole batch. ``double`` picks its teacher by the global losses.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from simxns_tpu_torch.losses.contrastive import in_batch_nll
from simxns_tpu_torch.losses.distill import (bi_logit_loss,
                                             colbert_teacher_scores, dkd_loss,
                                             kd_logit_mse_loss,
                                             kd_softmax_loss, prob_loss)
from simxns_tpu_torch.parallel.collectives import (all_gather_full_grad,
                                                   all_gather_rows,
                                                   all_reduce_sum)
from simxns_tpu_torch.parallel.mesh import Mesh, dp_size, mesh_device
from simxns_tpu_torch.train.steps import _apply, _check_on, _share, to_device
from simxns_tpu_torch.train.state import TrainState

Metrics = Dict[str, torch.Tensor]
TEACHER_TYPES = ("dual_encoder", "cross_encoder", "colbert", "double")
_MEANS = ("hard_loss", "soft_loss", "lwf_loss", "teacher_pick")


def soft_kd_loss(kd_type: str, student_scores: torch.Tensor,
                 teacher_scores: torch.Tensor, target_idx: torch.Tensor,
                 temperature: float, dkd_alpha: float = 1.0,
                 dkd_beta: float = 1.0) -> torch.Tensor:
    """Dispatch on the reference's ``KD_type`` flag."""
    if kd_type == "KD_softmax":
        return kd_softmax_loss(student_scores, teacher_scores, temperature)
    if kd_type == "KD_logit":
        return kd_logit_mse_loss(student_scores, teacher_scores)
    if kd_type == "DKD":
        return dkd_loss(student_scores, teacher_scores, target_idx,
                        dkd_alpha, dkd_beta, temperature)
    if kd_type == "prob_loss":
        return prob_loss(student_scores, teacher_scores, temperature)
    raise ValueError(f"unknown KD_type {kd_type!r}")


def _grouped_scores(q: torch.Tensor, ctx: torch.Tensor) -> torch.Tensor:
    groups = ctx.reshape(q.shape[0], -1, q.shape[1])
    return torch.einsum("bh,bmh->bm", q.float(), groups.float())


def _joint_logits(model: nn.Module, batch: Dict[str, torch.Tensor]
                  ) -> torch.Tensor:
    n, m, lj = batch["joint_ids"].shape
    return model(batch["joint_ids"].reshape(n * m, lj),
                 batch["joint_mask"].reshape(n * m, lj),
                 group_size=m)["logits"]


def _global_mean(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The global mean of a per-rank mean (x itself in a world of one)."""
    w = dp_size(mesh)
    return x.detach() if w == 1 else all_reduce_sum(x, mesh) / w


def make_kd_step(tx, teacher_type: str, kd_type: str = "KD_softmax",
                 temperature: float = 1.0, ce_weight: float = 0.0,
                 kd_weight: float = 1.0, lwf_weight: float = 0.0,
                 dkd_alpha: float = 1.0, dkd_beta: float = 1.0,
                 device=None, mesh: Optional[Mesh] = None) -> Callable:
    """``step(student_state, teachers, batch) -> (student_state,
    metrics)`` for a ``BiEncoder`` student; ``teachers`` holds frozen
    modules among ``"de"``, ``"ce"``, ``"colbert"`` and
    ``"student_init"``."""
    if teacher_type not in TEACHER_TYPES:
        raise ValueError(f"unknown teacher_type {teacher_type!r}")
    dev = mesh_device(mesh, device)

    def soft(s, t, target):
        return soft_kd_loss(kd_type, s, t, target, temperature, dkd_alpha,
                            dkd_beta)

    def de_branch(q, ctx, teachers, batch):
        g_ctx = all_gather_full_grad(ctx, mesh)
        s_scores = q.float() @ g_ctx.float().T
        hard, correct = in_batch_nll(q, g_ctx, batch["positive_idx"])
        with torch.no_grad():
            t_q, t_ctx = teachers["de"](batch["q_ids"], batch["q_mask"],
                                        batch["ctx_ids"], batch["ctx_mask"])
            t_scores = t_q.float() @ all_gather_rows(t_ctx, mesh).float().T
        if kd_type == "Bi_logit":
            loss = bi_logit_loss(q, ctx, t_q, t_ctx)
        else:
            loss = soft(s_scores, t_scores, batch["positive_idx"])
        return hard, loss, correct

    def ce_branch(q, ctx, teachers, batch):
        s_scores = _grouped_scores(q, ctx)
        zeros = torch.zeros(s_scores.shape[0], dtype=torch.long,
                            device=s_scores.device)
        hard = -torch.log_softmax(s_scores, dim=1)[:, 0].mean()
        correct = (s_scores.argmax(dim=1) == 0).sum().to(torch.int32)
        with torch.no_grad():
            t_scores = _joint_logits(teachers["ce"], batch)
        # LwF is a term of its own in the reference (CrossBERTKDLoss:
        # CE_WEIGHT*hard + KD_WEIGHT*soft + LwF_WEIGHT*lwf)
        lwf = torch.zeros((), dtype=torch.float32, device=s_scores.device)
        if lwf_weight and "student_init" in teachers:
            with torch.no_grad():
                o_q, o_ctx = teachers["student_init"](
                    batch["q_ids"], batch["q_mask"], batch["ctx_ids"],
                    batch["ctx_mask"])
                o_scores = _grouped_scores(o_q, o_ctx)
            lwf = soft(s_scores, o_scores, zeros)
        return hard, soft(s_scores, t_scores, zeros), lwf, correct

    def colbert_branch(q, ctx, teachers, batch):
        g_ctx = all_gather_full_grad(ctx, mesh)
        s_scores = q.float() @ g_ctx.float().T
        hard, correct = in_batch_nll(q, g_ctx, batch["positive_idx"])
        with torch.no_grad():
            t = teachers["colbert"]
            t_q = t.encode_query(batch["q_ids"], batch["q_mask"])
            t_ctx = t.encode_doc(batch["ctx_ids"], batch["ctx_mask"])
            t_scores = colbert_teacher_scores(
                t_q, all_gather_rows(t_ctx, mesh),
                all_gather_rows(batch["ctx_mask"], mesh))
        return hard, soft(s_scores, t_scores, batch["positive_idx"]), correct

    def loss_fn(module, teachers, batch) -> Tuple[torch.Tensor, Metrics]:
        q, ctx = module(batch["q_ids"], batch["q_mask"], batch["ctx_ids"],
                        batch["ctx_mask"])
        if teacher_type in ("dual_encoder", "colbert"):
            branch = de_branch if teacher_type == "dual_encoder" else (
                colbert_branch)
            hard, soft_l, correct = branch(q, ctx, teachers, batch)
            loss = ce_weight * hard + kd_weight * soft_l
            return loss, {"hard_loss": hard, "soft_loss": soft_l,
                          "correct": correct}
        if teacher_type == "cross_encoder":
            hard, soft_l, lwf, correct = ce_branch(q, ctx, teachers, batch)
            loss = ce_weight * hard + kd_weight * soft_l + lwf_weight * lwf
            return loss, {"hard_loss": hard, "soft_loss": soft_l,
                          "lwf_loss": lwf, "correct": correct}
        h1, s1, c1 = de_branch(q, ctx, teachers, batch)
        h2, s2, lwf2, c2 = ce_branch(q, ctx, teachers, batch)
        l1 = ce_weight * h1 + kd_weight * s1
        l2 = ce_weight * h2 + kd_weight * s2 + lwf_weight * lwf2
        # the larger global loss wins (:227-234), with its metrics
        pick_ce = bool(_global_mean(l2, mesh) > _global_mean(l1, mesh))
        h, s, c, loss = (h2, s2, c2, l2) if pick_ce else (h1, s1, c1, l1)
        return loss, {"hard_loss": h, "soft_loss": s, "correct": c,
                      "teacher_pick": torch.tensor(int(pick_ce),
                                                   dtype=torch.int32,
                                                   device=loss.device)}

    def step(state: TrainState, teachers: Dict[str, nn.Module],
             batch: dict):
        _check_on(state.module, dev)
        loss, aux = loss_fn(state.module, teachers, to_device(batch, dev))
        return _apply(state, _share(loss, mesh), aux, tx, mesh,
                      mean_metrics=_MEANS)

    return step


def make_ce_kd_step(tx, kd_type: str = "KD_softmax",
                    temperature: float = 1.0, ce_weight: float = 1.0,
                    kd_weight: float = 1.0, device=None,
                    mesh: Optional[Mesh] = None) -> Callable:
    """CE -> CE distillation (``Cross2CrossKDLoss``, PROD's 24L -> 12L
    reranker stage): the grouped hard CE at column 0 plus the soft KD
    between the two rerankers' group logits.
    ``step(student_state, teacher, batch) -> (state, metrics)``, the
    teacher a ``CrossEncoder`` (or its ``int8_view``)."""
    dev = mesh_device(mesh, device)

    def step(state: TrainState, teacher: nn.Module, batch: dict):
        _check_on(state.module, dev)
        batch = to_device(batch, dev)
        s_logits = _joint_logits(state.module, batch)
        with torch.no_grad():
            t_logits = _joint_logits(teacher, batch)
        hard = -torch.log_softmax(s_logits.float(), dim=1)[:, 0].mean()
        zeros = torch.zeros(s_logits.shape[0], dtype=torch.long,
                            device=s_logits.device)
        soft_l = soft_kd_loss(kd_type, s_logits, t_logits, zeros,
                              temperature)
        correct = (s_logits.argmax(dim=1) == 0).sum().to(torch.int32)
        loss = ce_weight * hard + kd_weight * soft_l
        return _apply(state, _share(loss, mesh),
                      {"hard_loss": hard, "soft_loss": soft_l,
                       "correct": correct}, tx, mesh, mean_metrics=_MEANS)

    return step
