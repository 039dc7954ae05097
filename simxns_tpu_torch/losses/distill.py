"""Distillation losses: AR2 co-training and the PROD KD family (port of
``simxns_tpu/losses/distill.py``).

AR2: the retriever's softmax over its (1 + n)-passage group is pulled
toward the frozen reranker's, plus an adversarial reward term, with the
reference's quirks (``co_training_wiki_train.py:194-235``):

- ``normal = -sum(p_CE * log p_DE) / B``: summed over the group, averaged
  over the batch;
- ``reward[b, d] = log softmax([logit_pos, logit_d])[0]``;
- ``adv = sum(reward * log p_DE)``: summed and unscaled;
- ``loss = adv_lambda * adv + (1 - adv_lambda) * normal``;
- the reranker logits carry no gradient.

PROD (``PROD/ProD_KD/model/models.py:970-1105``): soft targets from a
teacher over in-batch scores or grouped CE logits, ``KD_softmax`` (KL at
T, times T^2), ``KD_logit`` (0.5 MSE on logits), ``DKD`` (decoupled
target / non-target KD), ``Bi_logit`` (0.5 MSE on both embeddings) and
``prob_loss`` (the student not tempered); mixed with the hard NLL by
``CE_WEIGHT/KD_WEIGHT``. Every teacher input is detached. Scores are taken
in f32; ``EPS = 1e-7`` as the reference.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

EPS = 1e-7


def ar2_retriever_loss(retriever_scores: torch.Tensor,
                       reranker_logits: torch.Tensor,
                       temperature: float = 1.0, adv_lambda: float = 0.0,
                       scale_scores: Optional[float] = None
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Scores and logits [B, M]. -> ``(loss, {"normal_loss", "adv_loss"})``.
    ``scale_scores`` is 1/sqrt(H) when the recipe sets ``scale_simmila``."""
    s = retriever_scores.float()
    if scale_scores is not None:
        s = s * scale_scores
    p_de = torch.softmax(s, dim=1)
    logits = reranker_logits.detach().float()
    p_ce = torch.softmax(logits / temperature, dim=1)
    log_de = torch.log(p_de + EPS)
    normal = -(p_ce * log_de).sum() / s.shape[0]
    pair = torch.stack([logits[:, :1].expand_as(logits), logits], dim=-1)
    reward = torch.log(torch.softmax(pair, dim=-1)[..., 0] + EPS)
    adv = (reward * log_de).sum()
    loss = adv_lambda * adv + (1.0 - adv_lambda) * normal
    return loss, {"normal_loss": normal, "adv_loss": adv}


def kd_softmax_loss(student_logits: torch.Tensor,
                    teacher_logits: torch.Tensor,
                    temperature: float = 1.0) -> torch.Tensor:
    """KL(teacher || student) at temperature T over the last axis, the
    mean over rows, times T^2."""
    t = teacher_logits.detach().float() / temperature
    s = student_logits.float() / temperature
    log_t = torch.log_softmax(t, dim=-1)
    kl = (torch.softmax(t, dim=-1) * (log_t - torch.log_softmax(s, dim=-1))
          ).sum(-1)
    return kl.mean() * temperature ** 2


def kd_logit_mse_loss(student_logits: torch.Tensor,
                      teacher_logits: torch.Tensor) -> torch.Tensor:
    """``KD_logit``: 0.5 * MSE on logits (models.py:1056-1058)."""
    t = teacher_logits.detach().float()
    return 0.5 * ((student_logits.float() - t) ** 2).mean()


def embedding_mse_loss(student_emb: torch.Tensor,
                       teacher_emb: torch.Tensor) -> torch.Tensor:
    """0.5 * MSE on pooled embeddings (one side of ``Bi_logit``)."""
    t = teacher_emb.detach().float()
    return 0.5 * ((student_emb.float() - t) ** 2).mean()


def bi_logit_loss(student_q: torch.Tensor, student_ctx: torch.Tensor,
                  teacher_q: torch.Tensor, teacher_ctx: torch.Tensor
                  ) -> torch.Tensor:
    """``Bi_logit``: 0.5 MSE(q) + 0.5 MSE(ctx) on embeddings
    (models.py:1061-1067)."""
    return (embedding_mse_loss(student_q, teacher_q)
            + embedding_mse_loss(student_ctx, teacher_ctx))


def prob_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
              temperature: float = 1.0) -> torch.Tensor:
    """``prob_loss``: -softmax(teacher / T) . log(softmax(student) + eps),
    summed over the group, averaged over the batch; the student is NOT
    tempered (``CrossBERTKDLoss`` models.py:739-745)."""
    p_t = torch.softmax(teacher_logits.detach().float() / temperature, dim=1)
    p_s = torch.softmax(student_logits.float(), dim=1)
    return -(p_t * torch.log(p_s + EPS)).sum() / student_logits.shape[0]


def colbert_teacher_scores(teacher_q_tokens: torch.Tensor,
                           teacher_ctx_tokens: torch.Tensor,
                           ctx_mask: torch.Tensor) -> torch.Tensor:
    """The ColBERT teacher's [Q, P] score matrix: full-cross MaxSim (each
    query token's best passage token, summed over query tokens) with the
    masked passage tokens at -9999 (``ColBERTKDLoss`` models.py:342-348);
    tokens [Q, Sq, D] and [P, Sd, D], mask [P, Sd]; no gradient."""
    s = torch.einsum("qin,pjn->qipj", teacher_q_tokens.detach().float(),
                     teacher_ctx_tokens.detach().float())
    s = torch.where(ctx_mask[None, None] > 0, s,
                    torch.tensor(-9999.0, device=s.device))
    return s.max(dim=-1).values.sum(dim=1)


def dkd_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
             target_idx: torch.Tensor, alpha: float = 1.0, beta: float = 1.0,
             temperature: float = 1.0) -> torch.Tensor:
    """Decoupled KD (models.py:1069-1105): target-class binary KD (TCKD)
    plus non-target distribution KD (NCKD), times T^2."""
    t = teacher_logits.detach().float() / temperature
    s = student_logits.float() / temperature
    onehot = torch.nn.functional.one_hot(target_idx.long(),
                                         s.shape[1]).float()

    def binary_probs(logits):
        p = torch.softmax(logits, dim=1)
        p_t = (p * onehot).sum(1, keepdim=True)
        return torch.cat([p_t, 1.0 - p_t], dim=1)

    b_t, b_s = binary_probs(t), binary_probs(s)
    tckd = (b_t * (torch.log(b_t + EPS) - torch.log(b_s + EPS))
            ).sum(1).mean()
    neg_inf = torch.tensor(-1e9, device=t.device)
    t_masked = torch.where(onehot > 0, neg_inf, t)
    s_masked = torch.where(onehot > 0, neg_inf, s)
    nckd = (torch.softmax(t_masked, dim=1)
            * (torch.log_softmax(t_masked, dim=1)
               - torch.log_softmax(s_masked, dim=1))).sum(1).mean()
    return (alpha * tckd + beta * nckd) * temperature ** 2


def mixed_kd_loss(hard_loss: torch.Tensor, soft_loss: torch.Tensor,
                  ce_weight: float = 0.0, kd_weight: float = 1.0
                  ) -> torch.Tensor:
    """``CE_WEIGHT * hard + KD_WEIGHT * soft`` (models.py:1031)."""
    return ce_weight * hard_loss + kd_weight * soft_loss


def multi_teacher_kd_loss(student_scores: torch.Tensor,
                          de_scores: torch.Tensor,
                          ce12_scores: torch.Tensor,
                          ce24_scores: torch.Tensor,
                          temperature: float = 1.0
                          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """PROD ``UniKDLoss``'s three-teacher ensemble
    (``PROD/ProD_KD/model/models.py:473-560``) with its quirks: a
    teacher's "loss" is ``F.nll_loss`` of its softmax *probabilities*,
    ``-p[:, 0].mean()`` (negative); the ensemble weights are the teachers'
    shares of the sum of those (a worse teacher weighs more), and the soft
    term is scaled by ``1 / (0.1 + mean teacher loss)`` (:552-554).
    Scores [B, M]; the teachers carry no gradient."""
    s = student_scores.float()
    hard = -torch.log_softmax(s, dim=1)[:, 0].mean()

    def quirk_loss(t):
        return -torch.softmax(t.detach().float(), dim=1)[:, 0].mean()

    de_l, c12_l, c24_l = (quirk_loss(t) for t in (de_scores, ce12_scores,
                                                  ce24_scores))
    total = de_l + c12_l + c24_l
    mixed = (de_l / total * de_scores.detach()
             + c12_l / total * ce12_scores.detach()
             + c24_l / total * ce24_scores.detach())
    soft = kd_softmax_loss(s, mixed, temperature)
    loss = hard + (1.0 / (0.1 + total / 3.0)) * soft
    return loss, {"hard_loss": hard, "soft_loss": soft,
                  "teacher_losses": torch.stack([de_l, c12_l, c24_l])}
