"""DPR span reader (port of ``simxns_tpu/models/reader.py``).

``Reader`` and its loss (``SimANS/model/models.py:575-603, 662-703``): an
encoder over N questions x M passages of joint rows, per-token start and
end logits (``qa_outputs``), a relevance logit per passage
(``qa_classifier`` on the CLS vector), trained with

- the switch loss: cross-entropy over the M passages of a question, the
  positive at column 0, summed over questions (not averaged);
- the span loss: a cross-entropy per answer occurrence for start and end
  with ``ignore_index = L`` (positions clamped into [0, L]; an ignored one
  adds 0), the max over passages (only the positive carries live spans),
  then the marginal max-likelihood over the occurrences (``-log sum
  exp(-loss)`` with the zero-loss slots masked).

On the card the encoder's attention runs K7/K8 for rows of 256 to 1024
tokens (``ops/flash_attention.py``), in bf16 or f32 after the config.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from simxns_tpu_torch.models.bert import (BertConfig, BertEncoder, dense,
                                          init_weights, skip_init)


@dataclasses.dataclass(frozen=True)
class ReaderConfig:
    bert: BertConfig


class Reader(nn.Module):
    """``generator`` seeds the JAX package's initializers; pass a converted
    state_dict (``params_from_jax``) to ``load_state_dict`` instead."""

    def __init__(self, cfg: ReaderConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        bert = cfg.bert
        with skip_init(generator is not None):
            self.encoder = BertEncoder(bert)
            self.qa_outputs = nn.Linear(bert.hidden_size, 2,
                                        dtype=bert.param_dtype)
            self.qa_classifier = nn.Linear(bert.hidden_size, 1,
                                           dtype=bert.param_dtype)
        if generator is not None:
            init_weights(self, bert.initializer_range, generator)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                *, generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """input_ids [N, M, L] -> (start [N, M, L], end [N, M, L], rank
        [N, M]), all f32. A ``generator`` trains with dropout."""
        n, m, l = input_ids.shape
        dt = self.cfg.bert.dtype
        out = self.encoder(input_ids.reshape(n * m, l),
                           attention_mask.reshape(n * m, l),
                           generator=generator)
        span = dense(self.qa_outputs, out.last_hidden_state, dt)
        start = span[..., 0].float().reshape(n, m, l)
        end = span[..., 1].float().reshape(n, m, l)
        rank = dense(self.qa_classifier, out.pooled, dt)
        return start, end, rank[..., 0].float().reshape(n, m)


def reader_loss(start_logits: torch.Tensor,       # [N, M, L]
                end_logits: torch.Tensor,         # [N, M, L]
                relevance_logits: torch.Tensor,   # [N, M]
                start_positions: torch.Tensor,    # [N, M, A]; pad >= L
                end_positions: torch.Tensor,      # [N, M, A]
                answer_mask: torch.Tensor,        # [N, M, A] 1 = live
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """-> (span loss + switch loss, ``{"span_loss", "switch_loss"}``)."""
    n, m, l = start_logits.shape
    a = start_positions.shape[-1]
    ignored = l

    logp = torch.log_softmax(relevance_logits.float(), dim=1)
    switch_loss = -logp[:, 0].sum()

    def ce(logits, positions):
        """[R, L] x [R, A] -> [R, A]: -log p at each live position."""
        positions = positions.reshape(n * m, a).long().clamp(0, ignored)
        valid = positions != ignored
        lp = torch.log_softmax(logits.reshape(n * m, l).float(), dim=-1)
        nll = -torch.gather(lp, 1, torch.where(valid, positions, 0))
        return torch.where(valid, nll, 0.0)

    am = answer_mask.reshape(n * m, a).float()
    losses = (ce(start_logits, start_positions) * am
              + ce(end_logits, end_positions) * am)
    loss_tensor = losses.reshape(n, m, a).amax(dim=1)
    marginal = torch.exp(-loss_tensor - 1e10 * (loss_tensor == 0)).sum(dim=1)
    span_loss = -torch.log(marginal + (marginal == 0)).sum()
    return span_loss + switch_loss, {"span_loss": span_loss,
                                     "switch_loss": switch_loss}
