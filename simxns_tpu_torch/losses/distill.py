"""The AR2 retriever loss (port of ``simxns_tpu/losses/distill.py:30-59``).

The retriever's softmax over its (1 + n)-passage group is pulled toward the
frozen reranker's, plus an adversarial reward term, with the reference's
quirks (``co_training_wiki_train.py:194-235``):

- ``normal = -sum(p_CE * log p_DE) / B``: summed over the group, averaged
  over the batch;
- ``reward[b, d] = log softmax([logit_pos, logit_d])[0]``;
- ``adv = sum(reward * log p_DE)``: summed and unscaled;
- ``loss = adv_lambda * adv + (1 - adv_lambda) * normal``;
- the reranker logits carry no gradient.

The PROD KD losses of the JAX module are not ported yet.
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
