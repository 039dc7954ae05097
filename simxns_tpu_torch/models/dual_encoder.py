"""Dual-encoder retriever towers (port of ``simxns_tpu/models/dual_encoder.py``).

Separate or shared question/context BERT towers, CLS or mean pooling, and
the optional RobertaDot-style projection head (Dense + LayerNorm).
A call with a ``torch.Generator`` trains with dropout (the
towers draw in call order: the question tower, then the context tower).
:func:`int8_view` is the encode-only ``fused_int8`` view of a live dual
encoder that the mine's ``--fast-encode`` encodes with.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from simxns_tpu_torch.models.bert import (BertConfig, BertEncoder, dense,
                                          init_weights, layer_norm,
                                          share_parameters, skip_init)


@dataclasses.dataclass(frozen=True)
class BiEncoderConfig:
    bert: BertConfig
    share_weight: bool = False        # one tower for q and ctx
    pooling: str = "cls"              # "cls" | "mean"
    projection_dim: Optional[int] = None   # RobertaDot-style head if set
    project_layer_norm: bool = True


def _pool(out, attention_mask: torch.Tensor, pooling: str) -> torch.Tensor:
    if pooling == "cls":
        return out.pooled
    if pooling == "mean":
        h = out.last_hidden_state
        mask = attention_mask[..., None].to(h.dtype)
        summed = torch.sum(h * mask, dim=1)
        count = torch.clamp_min(torch.sum(mask, dim=1), 1.0)
        return summed / count
    raise ValueError(f"unknown pooling {pooling!r}")


class _Tower(nn.Module):
    def __init__(self, cfg: BiEncoderConfig):
        super().__init__()
        self.cfg = cfg
        bert = cfg.bert
        self.encoder = BertEncoder(bert)
        if cfg.projection_dim is not None:
            self.project = nn.Linear(bert.hidden_size, cfg.projection_dim,
                                     dtype=bert.param_dtype)
            if cfg.project_layer_norm:
                self.project_layer_norm = nn.LayerNorm(
                    cfg.projection_dim, eps=bert.layer_norm_eps,
                    dtype=bert.param_dtype)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None, *,
                generator: Optional[torch.Generator] = None,
                output_hidden_states: bool = False):
        """-> the embedding, or ``(embedding, encoder output)`` with
        ``output_hidden_states`` (every layer's hiddens, LEAD)."""
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        out = self.encoder(input_ids, attention_mask, token_type_ids,
                           generator=generator,
                           output_hidden_states=output_hidden_states)
        emb = _pool(out, attention_mask, self.cfg.pooling)
        if self.cfg.projection_dim is not None:
            bert = self.cfg.bert
            emb = dense(self.project, emb, bert.dtype)
            if self.cfg.project_layer_norm:
                emb = layer_norm(self.project_layer_norm, emb, bert.dtype,
                                 bert.layer_norm_eps)
        return (emb, out) if output_hidden_states else emb


class BiEncoder(nn.Module):
    """Question/context tower pair producing dense embeddings.

    ``generator`` seeds the JAX package's initializers; pass a converted
    state_dict (:func:`simxns_tpu_torch.models.convert.params_from_jax`)
    to ``load_state_dict`` for trained weights.
    """

    def __init__(self, cfg: BiEncoderConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        with skip_init(generator is not None):
            self.question_model = _Tower(cfg)
            if not cfg.share_weight:
                self.ctx_model = _Tower(cfg)
        if generator is not None:
            init_weights(self, cfg.bert.initializer_range, generator)

    def _ctx_tower(self) -> _Tower:
        return self.question_model if self.cfg.share_weight else self.ctx_model

    def encode_query(self, input_ids, attention_mask=None,
                     token_type_ids=None, *,
                     generator: Optional[torch.Generator] = None,
                     output_hidden_states: bool = False):
        """-> q embeddings, or ``(emb, EncoderOutput)`` with
        ``output_hidden_states`` (the JAX ``encode_query``)."""
        return self.question_model(input_ids, attention_mask, token_type_ids,
                                   generator=generator,
                                   output_hidden_states=output_hidden_states)

    def encode_passage(self, input_ids, attention_mask=None,
                       token_type_ids=None, *,
                       generator: Optional[torch.Generator] = None,
                       output_hidden_states: bool = False):
        """-> passage embeddings, or ``(emb, EncoderOutput)`` with
        ``output_hidden_states``."""
        return self._ctx_tower()(input_ids, attention_mask, token_type_ids,
                                 generator=generator,
                                 output_hidden_states=output_hidden_states)

    def forward(self, q_ids, q_mask, ctx_ids, ctx_mask, q_type_ids=None,
                ctx_type_ids=None, *,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        return (self.encode_query(q_ids, q_mask, q_type_ids,
                                  generator=generator),
                self.encode_passage(ctx_ids, ctx_mask, ctx_type_ids,
                                    generator=generator))


def int8_view(model: BiEncoder) -> BiEncoder:
    """The ``layer_impl="fused_int8"`` encode-only view of ``model`` over the
    same ``Parameter`` objects (the JAX ``run.py:_int8_view_cfg`` tower
    config over the same param tree); see ``cross_encoder.int8_view``."""
    bert = model.cfg.bert.replace(layer_impl="fused_int8", ffn_impl="xla",
                                  proj_impl="xla", remat=False)
    with torch.device("meta"):
        view = BiEncoder(dataclasses.replace(model.cfg, bert=bert))
    return share_parameters(view, model)
