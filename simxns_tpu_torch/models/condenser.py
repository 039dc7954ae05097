"""MASTER bottlenecked masked-autoencoder pre-training (port of
``simxns_tpu/models/condenser.py``).

``CondenserForPretraining`` (``MASTER/pretrain/modeling.py:21-207``): a
deep BERT MLM encoder and five shallow decoder heads that see a passage
only through the encoder's CLS vector:

- ``c_head``: corrupted-passage recovery (keyword-weighted masks);
- ``query_head``: docT5 query recovery;
- ``gpt_head``: GPT-2 continuation recovery;
- ``next_head``: second-half recovery from the first half's CLS;
- ``overlap_head``: complement-mask recovery.

A decoder's input is ``[encoder CLS || fresh embeddings of its tokens[1:]]``
(``modeling.py:64-65``); each head is ``n_head_layers`` BERT layers; every
head shares the encoder's MLM classifier (``MLMHead``, tied to the word
embeddings). The loss is the sum of 5 decoder MLMs and 3 encoder MLMs
(``modeling.py:158``); :meth:`Condenser.electra_forward` is the 4-loss
ELECTRA variant. A call with a ``torch.Generator`` trains with dropout.

:func:`generate_replaced_ids` is the ELECTRA corruption (``trainer.py:
35-93``), :func:`in_batch_nearest` its partner choice (the diagonal zeroed,
not -inf: a reference quirk, kept), :func:`cocondenser_span_loss` the
CoCondenser span contrastive loss. The encoder-only export is
``io.checkpoint.export_encoder_only``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from simxns_tpu_torch.models.bert import (BertConfig, BertEncoder, BertLayer,
                                          MLMHead, init_weights, skip_init)
from simxns_tpu_torch.ops import dropout as drop

HEAD_NAMES = ("c_head", "query_head", "gpt_head", "next_head",
              "overlap_head")
IGNORE_INDEX = -100


@dataclasses.dataclass(frozen=True)
class CondenserConfig:
    bert: BertConfig
    n_head_layers: int = 2
    tie_embeddings: bool = True


def mlm_loss_from_logits(logits: torch.Tensor,
                         labels: torch.Tensor) -> torch.Tensor:
    """The mean CE over positions whose label is not -100 (torch
    ``CrossEntropyLoss(ignore_index=-100)``); 0 when every one is."""
    valid = labels != IGNORE_INDEX
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return nll.sum() / torch.clamp(valid.sum(), min=1)


class Condenser(nn.Module):
    """The encoder, the shared MLM head and the five heads' layers
    (``c_head.{i}`` ... ``overlap_head.{i}``). ``generator`` seeds the JAX
    package's initializers."""

    def __init__(self, cfg: CondenserConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        with skip_init(generator is not None):
            self.encoder = BertEncoder(cfg.bert)
            self.mlm = MLMHead(cfg.bert, tied=cfg.tie_embeddings)
            for name in HEAD_NAMES:
                setattr(self, name, nn.ModuleList(
                    BertLayer(cfg.bert) for _ in range(cfg.n_head_layers)))
        if generator is not None:
            init_weights(self, cfg.bert.initializer_range, generator)

    def _table(self) -> Optional[torch.Tensor]:
        return (self.encoder.embeddings.word_embeddings.weight
                if self.cfg.tie_embeddings else None)

    def _encode_mlm(self, input_ids, attention_mask, labels, generator):
        """The encoder pass: (MLM loss, CLS hiddens [B, 1, H])."""
        out = self.encoder(input_ids, attention_mask, generator=generator)
        logits = self.mlm(out.last_hidden_state, self._table())
        return (mlm_loss_from_logits(logits, labels),
                out.last_hidden_state[:, :1])

    def decode_logits(self, head_name: str, cls_hiddens: torch.Tensor,
                      decoder_input_ids: torch.Tensor,
                      attention_mask: torch.Tensor, *,
                      generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
        """A head's MLM logits over ``[CLS || fresh embeddings[1:]]``."""
        layers = getattr(self, head_name)
        skip = self.encoder.embed(decoder_input_ids, generator=generator)
        seeds = (drop.seeds(generator, len(layers)) if generator is not None
                 else [None] * len(layers))
        hiddens = torch.cat([cls_hiddens.to(skip.dtype), skip[:, 1:]], dim=1)
        for layer, seed in zip(layers, seeds):
            g = None if seed is None else drop.generator(seed, hiddens.device)
            hiddens, _ = layer(hiddens, attention_mask, generator=g)
        return self.mlm(hiddens, self._table())

    def _decode_mlm(self, head_name, cls_hiddens, decoder_input_ids,
                    attention_mask, labels, generator):
        logits = self.decode_logits(head_name, cls_hiddens, decoder_input_ids,
                                    attention_mask, generator=generator)
        return mlm_loss_from_logits(logits, labels)

    def forward(self, batch: Dict[str, torch.Tensor], *,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The 8-loss MASTER objective (``modeling.py:53-160``) over a
        ``CondenserCollator`` batch -> (total, the parts)."""
        g = generator
        enc_loss, cls = self._encode_mlm(batch["input_ids"],
                                         batch["attention_mask"],
                                         batch["labels"], g)
        c_loss = self._decode_mlm("c_head", cls, batch["decoder_input_ids"],
                                  batch["attention_mask"],
                                  batch["decoder_labels"], g)
        query_loss = self._decode_mlm(
            "query_head", cls, batch["query_input_ids"],
            batch["query_attention_mask"], batch["query_labels"], g)
        gpt_loss = self._decode_mlm(
            "gpt_head", cls, batch["gpt_input_ids"],
            batch["gpt_attention_mask"], batch["gpt_labels"], g)
        next_enc_loss, next_cls = self._encode_mlm(
            batch["next_encoder_input_ids"],
            batch["next_encoder_attention_mask"],
            batch["next_encoder_labels"], g)
        next_loss = self._decode_mlm(
            "next_head", next_cls, batch["next_decoder_input_ids"],
            batch["next_decoder_attention_mask"],
            batch["next_decoder_labels"], g)
        overlap_enc_loss, overlap_cls = self._encode_mlm(
            batch["overlap_encoder_input_ids"], batch["attention_mask"],
            batch["overlap_encoder_labels"], g)
        # the overlap decoder reuses the text's mask (modeling.py:146-155)
        overlap_loss = self._decode_mlm(
            "overlap_head", overlap_cls, batch["overlap_decoder_input_ids"],
            batch["attention_mask"], batch["overlap_decoder_labels"], g)
        parts = {"mlm": enc_loss, "c_head": c_loss, "query": query_loss,
                 "gpt": gpt_loss, "next_encoder": next_enc_loss,
                 "next": next_loss, "overlap_encoder": overlap_enc_loss,
                 "overlap": overlap_loss}
        return sum(parts.values()), parts

    def encode_cls(self, input_ids: torch.Tensor,
                   attention_mask: torch.Tensor, *,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
        """CLS vectors (the CoCondenser span loss, the ELECTRA partner)."""
        return self.encoder(input_ids, attention_mask,
                            generator=generator).pooled

    def electra_forward(self, batch: Dict[str, torch.Tensor], *,
                        generator: Optional[torch.Generator] = None
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The ELECTRA variant (``ELECTRACondenserForPretraining.forward``,
        ``modeling.py:235-286``): c_head on the corrupted text, next_head
        on the continuation, overlap_head on the complement mask, all fed by
        the text's CLS, plus the encoder MLM. A 4-loss sum."""
        g = generator
        enc_loss, cls = self._encode_mlm(batch["input_ids"],
                                         batch["attention_mask"],
                                         batch["labels"], g)
        c_loss = self._decode_mlm("c_head", cls, batch["decoder_input_ids"],
                                  batch["attention_mask"],
                                  batch["decoder_labels"], g)
        next_loss = self._decode_mlm(
            "next_head", cls, batch["next_decoder_input_ids"],
            batch["next_decoder_attention_mask"],
            batch["next_decoder_labels"], g)
        overlap_loss = self._decode_mlm(
            "overlap_head", cls, batch["overlap_decoder_input_ids"],
            batch["attention_mask"], batch["overlap_decoder_labels"], g)
        parts = {"mlm": enc_loss, "c_head": c_loss, "next": next_loss,
                 "overlap": overlap_loss}
        return sum(parts.values()), parts


def in_batch_nearest(cls_hiddens: torch.Tensor,
                     pool: Optional[torch.Tensor] = None,
                     offset: int = 0) -> torch.Tensor:
    """Each row's nearest row of ``pool`` (default: the rows themselves) by
    dot product, with its own entry (row i at ``offset + i`` of the pool)
    ZEROED, not -inf (``trainer.py:30`` multiplies by ``1 - eye``).
    Reference quirk, kept: when every other dot is negative the row picks
    itself, and exact ties go to the lowest index."""
    pool = cls_hiddens if pool is None else pool
    sims = cls_hiddens.float() @ pool.float().T
    n = sims.shape[0]
    own = torch.arange(n, device=sims.device)
    sims[own, own + offset] = 0.0
    return pool[_first_argmax(sims)]


def _first_argmax(x: torch.Tensor) -> torch.Tensor:
    """argmax over the last dim, ties to the lowest index (``jnp.argmax``)."""
    top = x.amax(dim=-1, keepdim=True)
    idx = torch.arange(x.shape[-1], device=x.device).expand_as(x)
    return torch.where(x == top, idx, x.shape[-1]).amin(dim=-1)


@torch.no_grad()
def generate_replaced_ids(model: Condenser, batch: Dict[str, torch.Tensor],
                          mask_id: int,
                          gather: Optional[Callable] = None, rank: int = 0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ELECTRA-style realistic corruption (``MASTER/pretrain/trainer.py:
    35-93``): the c_head decodes the masked positions conditioned on the
    in-batch *nearest* example's CLS, and its argmax predictions replace
    the [MASK] tokens. -> (replaced decoder input ids, replaced input
    ids), without gradient (the reference's ``no_grad``). Under data
    parallelism ``gather`` collects the CLS rows of every rank (rank-major;
    this rank's rows at ``rank * B``), so the nearest example is searched
    over the whole batch, as JAX's step does."""
    def swap_decode(src_ids, src_mask, tgt_ids, tgt_mask):
        cls = model.encode_cls(src_ids, src_mask)
        pool = None if gather is None else gather(cls)
        swapped = in_batch_nearest(cls, pool, rank * cls.shape[0])[:, None, :]
        logits = model.decode_logits("c_head", swapped, tgt_ids, tgt_mask)
        pred = _first_argmax(logits).to(tgt_ids.dtype)
        return torch.where(tgt_ids != mask_id, tgt_ids, pred)

    replaced_decoder = swap_decode(
        batch["input_ids"], batch["attention_mask"],
        batch["decoder_input_ids"], batch["attention_mask"])
    replaced_input = swap_decode(
        batch["decoder_input_ids"], batch["attention_mask"],
        batch["input_ids"], batch["attention_mask"])
    return replaced_decoder, replaced_input


def cocondenser_span_loss(span_cls: torch.Tensor) -> torch.Tensor:
    """The CoCondenser contrastive loss over span CLS vectors [2B, H]
    (two spans a passage, interleaved; each span's partner is its
    positive, ``modeling.py:427-453``), self-similarity at -1e9."""
    scores = span_cls.float() @ span_cls.float().T
    n = scores.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=scores.device)
    scores = torch.where(eye, torch.tensor(-1e9, device=scores.device),
                         scores)
    partner = torch.arange(n, device=scores.device) ^ 1
    logp = torch.log_softmax(scores, dim=1)
    return -logp.gather(1, partner[:, None]).mean()
