"""Contrastive retrieval losses (port of ``simxns_tpu/losses/contrastive.py``).

- :func:`in_batch_nll`: NLL over (questions x all contexts), the
  reference's ``BiEncoderNllLoss`` (``score_scale`` covers its ``* 20``
  variant);
- :func:`grouped_nll`: cross-entropy over (N, M) groups with the positive
  at a fixed column, the reranker CE loss.

All softmax math is f32 whatever the activation dtype.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch


def similarity_scores(q_emb: torch.Tensor, ctx_emb: torch.Tensor,
                      score_scale: float = 1.0) -> torch.Tensor:
    """Dot-product score matrix [Q, C] in f32 (bf16 products are exact in
    f32, so upcasting first is the JAX ``preferred_element_type``)."""
    return score_scale * (q_emb.float() @ ctx_emb.float().T)


def _reduce(nll: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return nll.mean()
    if reduction == "sum":
        return nll.sum()
    return nll


def in_batch_nll(q_emb: torch.Tensor, ctx_emb: torch.Tensor,
                 positive_idx: torch.Tensor, score_scale: float = 1.0,
                 reduction: str = "mean"
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """In-batch negative NLL of q [Q, H] against ctx [C, H], each question's
    positive at ``positive_idx`` [Q]. -> ``(loss, correct)``, ``correct``
    the number of questions whose positive scores first."""
    scores = similarity_scores(q_emb, ctx_emb, score_scale)
    logp = torch.log_softmax(scores, dim=1)
    pos = positive_idx.long()
    nll = -logp.gather(1, pos[:, None])[:, 0]
    correct = (scores.argmax(dim=1) == pos).sum().to(torch.int32)
    return _reduce(nll, reduction), correct


def grouped_nll(logits: torch.Tensor,
                positive_col: Union[int, torch.Tensor] = 0,
                reduction: str = "mean") -> torch.Tensor:
    """CE over each row of [N, M] logits with the positive at column
    ``positive_col`` (an int, or an index tensor [N])."""
    logp = torch.log_softmax(logits.float(), dim=1)
    if isinstance(positive_col, int):
        nll = -logp[:, positive_col]
    else:
        nll = -logp.gather(1, positive_col.long()[:, None])[:, 0]
    return _reduce(nll, reduction)
