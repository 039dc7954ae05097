"""ColBERT late interaction (port of ``simxns_tpu/models/colbert.py``).

A BERT tower with a ``dim``-wide linear head (no bias) over every token;
queries and documents are scored by MaxSim (``PROD/ProD_KD/model/
models.py:141-196``, ``LEAD/models.py:79-143``). The reference always keeps
two heads, ``linear`` for queries and ``doc_linear`` for documents;
``share_weight`` shares only the BERT tower (``doc_encoder`` exists only
when it is False). Token vectors are L2-normalised in cosine mode (the
norm taken in f32, clamped at 1e-9). Document padding, and the tokens an
optional ``doc_token_mask`` drops (LEAD's punctuation), are zero vectors.

Reference quirk, kept: the query side is not masked (``models.py:
169-173``), so a query's padding positions add live MaxSim terms.

:func:`maxsim_score` scores every query against every document [Q, N];
:func:`maxsim_score_paired` row against row [B]. The L2 metric uses the
expanded form ``2 q.d - |q|^2 - |d|^2`` (the difference tensor would be
[Q, N, Sq, Sd, D]). Products accumulate in f32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from simxns_tpu_torch.models.bert import (BertConfig, BertEncoder, dense,
                                          init_weights, skip_init)


@dataclasses.dataclass(frozen=True)
class ColBERTConfig:
    bert: BertConfig
    dim: int = 128
    similarity: str = "cosine"        # "cosine" | "l2"
    share_weight: bool = True         # one tower for queries and documents


class ColBERT(nn.Module):
    """``forward(q_ids, q_mask, d_ids, d_mask) -> (q tokens [Q, Sq, dim],
    d tokens [N, Sd, dim])`` in the config's dtype. ``generator`` seeds the
    JAX package's initializers."""

    def __init__(self, cfg: ColBERTConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        bert = cfg.bert
        with skip_init(generator is not None):
            self.encoder = BertEncoder(bert)
            self.linear = nn.Linear(bert.hidden_size, cfg.dim, bias=False,
                                    dtype=bert.param_dtype)
            self.doc_linear = nn.Linear(bert.hidden_size, cfg.dim, bias=False,
                                        dtype=bert.param_dtype)
            if not cfg.share_weight:
                self.doc_encoder = BertEncoder(bert)
        if generator is not None:
            init_weights(self, bert.initializer_range, generator)

    def _embed(self, encoder, proj, input_ids, attention_mask,
               token_type_ids, generator, token_mask):
        dt = self.cfg.bert.dtype
        out = encoder(input_ids, attention_mask, token_type_ids,
                      generator=generator)
        tok = dense(proj, out.last_hidden_state, dt)          # [B, S, dim]
        if token_mask is not None:
            tok = tok * token_mask[..., None].to(tok.dtype)
        if self.cfg.similarity == "cosine":
            norm = torch.linalg.vector_norm(tok.float(), dim=-1, keepdim=True)
            tok = tok / torch.clamp(norm, min=1e-9).to(tok.dtype)
        return tok

    def encode_query(self, input_ids, attention_mask, token_type_ids=None, *,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
        """Query token vectors; the padding is NOT masked (the reference's
        ``query_emb``)."""
        return self._embed(self.encoder, self.linear, input_ids,
                           attention_mask, token_type_ids, generator, None)

    def encode_doc(self, input_ids, attention_mask, token_type_ids=None,
                   doc_token_mask=None, *,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
        """Document token vectors, zero where ``attention_mask`` (times
        ``doc_token_mask``) is 0."""
        enc = self.encoder if self.cfg.share_weight else self.doc_encoder
        mask = (attention_mask if doc_token_mask is None
                else attention_mask * doc_token_mask)
        return self._embed(enc, self.doc_linear, input_ids, attention_mask,
                           token_type_ids, generator, mask)

    def forward(self, q_ids, q_mask, d_ids, d_mask, q_type_ids=None,
                d_type_ids=None, doc_token_mask=None, *,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        return (self.encode_query(q_ids, q_mask, q_type_ids,
                                  generator=generator),
                self.encode_doc(d_ids, d_mask, d_type_ids, doc_token_mask,
                                generator=generator))


def _sims(q: torch.Tensor, d: torch.Tensor, similarity: str, spec: str,
          qn_shape, dn_shape) -> torch.Tensor:
    qd = torch.einsum(spec, q.float(), d.float())
    if similarity == "cosine":
        return qd
    if similarity == "l2":
        qn = (q.float() ** 2).sum(-1)
        dn = (d.float() ** 2).sum(-1)
        return 2.0 * qd - qn.reshape(qn_shape) - dn.reshape(dn_shape)
    raise ValueError(similarity)


def maxsim_score(q_tokens: torch.Tensor, d_tokens: torch.Tensor,
                 similarity: str = "cosine") -> torch.Tensor:
    """[Q, Sq, D] x [N, Sd, D] -> [Q, N]: per query token the best document
    token's similarity, summed over query tokens."""
    qn, sq = q_tokens.shape[:2]
    n, sd = d_tokens.shape[:2]
    sims = _sims(q_tokens, d_tokens, similarity, "qsd,ntd->qnst",
                 (qn, 1, sq, 1), (1, n, 1, sd))
    return sims.amax(dim=-1).sum(dim=-1)


def maxsim_score_paired(q_tokens: torch.Tensor, d_tokens: torch.Tensor,
                        similarity: str = "cosine") -> torch.Tensor:
    """[B, Sq, D] x [B, Sd, D] -> [B] (the grouped reranking path)."""
    b, sq = q_tokens.shape[:2]
    sd = d_tokens.shape[1]
    sims = _sims(q_tokens, d_tokens, similarity, "bsd,btd->bst",
                 (b, sq, 1), (b, 1, sd))
    return sims.amax(dim=-1).sum(dim=-1)
