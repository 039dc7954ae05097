"""LEAD layer-reweighted distillation losses (port of
``simxns_tpu/losses/lead.py``).

- :func:`layer_score_distill_loss`: per-layer CLS-score distributions
  aligned by KL, with layer weights ``softmax(-teacher_layer_NLL /
  layer_temperature)`` (``LEAD/util.py:539-559``);
- :func:`pair_kl`: the model-level mutual KL terms (``:750-753``);
- :func:`query_doc_attention_maps` + :func:`virt_loss`: the VIRT
  attention-map MSE (``:504-537``); the valid region is two broadcast
  comparisons (fully masked rows softmax to uniform on both sides and add
  0 to the MSE);
- :func:`attention_map_kl`: the CE -> student attention-map KL
  (``:467-502``);
- :func:`select_layers`: the random / last / skip layer draws, re-drawn
  every ``save_steps`` (``select_layer`` :206-254). It takes a **numpy**
  ``Generator``, so a run's draws are the JAX run's draws;
- :func:`grouped_slice`: the "remove cross-batch negatives" reshape when a
  CE is in the mix (``:704-706``): row i keeps columns ``[i*M, (i+1)*M)``.

KL convention: torch ``F.kl_div(log_p_student, p_teacher,
reduction='batchmean')``, the sum over every element over the first
dimension; teacher probabilities are ``softmax(scores / T)`` clipped at
1e-30 inside the log and carry no gradient; student log-probabilities are
not temperature-scaled (``:607-609``). Everything is computed in f32.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

NEG = -1e9


def batchmean_kl(student_log_probs: torch.Tensor,
                 teacher_probs: torch.Tensor) -> torch.Tensor:
    """torch ``F.kl_div(log_s, p_t, reduction='batchmean')``, the teacher
    side clipped at 1e-30 in the log and detached."""
    t = teacher_probs.detach().float()
    s = student_log_probs.float()
    kl = t * (torch.log(torch.clamp(t, min=1e-30)) - s)
    return kl.sum() / student_log_probs.shape[0]


def pair_kl(student_scores: torch.Tensor, teacher_scores: torch.Tensor,
            temperature: float = 1.0) -> torch.Tensor:
    """KL(softmax(teacher / T) || softmax(student)), batchmean."""
    return batchmean_kl(
        torch.log_softmax(student_scores.float(), dim=-1),
        torch.softmax(teacher_scores.detach().float() / temperature, dim=-1))


def grouped_slice(scores: torch.Tensor, sample_num: int) -> torch.Tensor:
    """[..., Q, Q*M] in-batch scores -> [..., Q, M] own-group scores."""
    q = scores.shape[-2]
    cols = (torch.arange(q, device=scores.device)[:, None] * sample_num
            + torch.arange(sample_num, device=scores.device)[None, :])
    return torch.gather(scores, -1, cols.expand(*scores.shape[:-1],
                                                sample_num))


def layer_scores_from_cls(q_layer_cls: torch.Tensor,
                          d_layer_cls: torch.Tensor) -> torch.Tensor:
    """[L, Q, H] x [L, D, H] layer CLS hiddens -> [L, Q, D] f32 in-batch
    score matrices."""
    return torch.einsum("lqh,ldh->lqd", q_layer_cls.float(),
                        d_layer_cls.float())


def layer_score_distill_loss(
        teacher_layer_scores: torch.Tensor,    # [L, Q, C]
        student_layer_scores: torch.Tensor,    # [L, Q, C]
        target: torch.Tensor,                  # [Q] positive column
        temperature: float = 1.0, layer_temperature: float = 1.0,
        reweight: bool = True, distill_para: float = 1.0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> ``(loss, per_layer_kl [L])``: ``sum_l w_l KL(softmax(teacher_l
    / T) || softmax(student_l))`` with ``w = softmax(-NLL(teacher_l,
    target) / layer_temperature)`` when ``reweight`` (LEAD's
    contribution), else ``distill_para`` per layer."""
    t = teacher_layer_scores.detach().float()
    s = student_layer_scores.float()
    t_probs = torch.softmax(t / temperature, dim=-1)
    s_logp = torch.log_softmax(s, dim=-1)
    kl = (t_probs * (torch.log(torch.clamp(t_probs, min=1e-30)) - s_logp)
          ).sum(-1).sum(-1) / s.shape[1]                      # [L]
    t_logp = torch.log_softmax(t, dim=-1)
    idx = target.long()[None, :, None].expand(t.shape[0], -1, 1)
    nll = -torch.gather(t_logp, 2, idx)[..., 0].mean(-1)      # [L]
    if reweight:
        weights = torch.softmax(-nll / layer_temperature, dim=0)
    else:
        weights = torch.full_like(kl, distill_para)
    return (weights * kl).sum(), kl


def query_doc_attention_maps(q_layer_hidden: torch.Tensor,  # [L, Q, Sq, H]
                             d_layer_hidden: torch.Tensor,  # [L, D, Sd, H]
                             q_len: torch.Tensor,           # [Q]
                             d_len: torch.Tensor            # [D]
                             ) -> torch.Tensor:
    """Per-layer query-token x doc-token maps softmaxed over doc tokens,
    positions past a length at -1e9: [L, Q, D, Sq, Sd]."""
    att = torch.einsum("lqsh,ldth->lqdst", q_layer_hidden.float(),
                       d_layer_hidden.float())
    sq, sd = att.shape[-2], att.shape[-1]
    dev = att.device
    q_valid = torch.arange(sq, device=dev)[None, :] < q_len[:, None]
    d_valid = torch.arange(sd, device=dev)[None, :] < d_len[:, None]
    mask = q_valid[:, None, :, None] & d_valid[None, :, None, :]
    att = torch.where(mask[None], att, torch.tensor(NEG, device=dev))
    return torch.softmax(att, dim=-1)


def virt_loss(teacher_maps: torch.Tensor, student_maps: torch.Tensor,
              distill_para: float = 1.0) -> torch.Tensor:
    """MSE (sum) / L / Q / D x para (``virt_loss`` util.py:531-537)."""
    t = teacher_maps.detach().float()
    s = student_maps.float()
    l, q, d = s.shape[0], s.shape[1], s.shape[2]
    return ((s - t) ** 2).sum() / l / q / d * distill_para


def attention_map_kl(student_scores: torch.Tensor,   # [..., Sq, Sd]
                     teacher_scores: torch.Tensor,   # [..., Sq, Sd]
                     q_valid: torch.Tensor,          # [..., Sq]
                     d_valid: torch.Tensor           # [..., Sd]
                     ) -> torch.Tensor:
    """The CE -> student attention-map KL: both sides at -1e9 outside the
    valid region and softmaxed over doc tokens (fully masked rows are equal
    uniform rows, KL 0), averaged over the valid query rows."""
    mask = (q_valid[..., :, None] > 0) & (d_valid[..., None, :] > 0)
    neg = torch.tensor(NEG, device=student_scores.device)
    s = torch.where(mask, student_scores.float(), neg)
    t = torch.where(mask, teacher_scores.detach().float(), neg)
    p_t = torch.softmax(t, dim=-1)
    log_s = torch.log_softmax(s, dim=-1)
    kl = (p_t * (torch.log(torch.clamp(p_t, min=1e-30)) - log_s)).sum(-1)
    row_valid = (q_valid > 0).float()
    return (kl * row_valid).sum() / torch.clamp(row_valid.sum(), min=1.0)


def select_layers(rng: np.random.Generator, num_student_layers: int,
                  num_teacher_layers: int, num_distill_layers: int,
                  mode: str = "random") -> Tuple[List[int], List[int]]:
    """Student and teacher layer indices (``run_LEAD.py:152,260``); ``last``
    and ``skip`` are the reference's fixed lists at any depth. ``rng`` is
    a numpy ``Generator``: the same seed draws the JAX run's layers."""
    if mode == "random":
        s = sorted(rng.choice(num_student_layers, size=num_distill_layers,
                              replace=False).tolist())
        t = sorted(rng.choice(num_teacher_layers, size=num_distill_layers,
                              replace=False).tolist())
        return s, t
    if mode == "last":
        return (list(range(num_student_layers - num_distill_layers,
                           num_student_layers)),
                list(range(num_teacher_layers - num_distill_layers,
                           num_teacher_layers)))
    if mode == "skip":
        s = list(range(num_student_layers - num_distill_layers,
                       num_student_layers))
        stride = max(1, num_teacher_layers // num_distill_layers)
        return s, [i * stride for i in range(num_distill_layers)]
    raise ValueError(f"unknown layer selection mode {mode!r}")
