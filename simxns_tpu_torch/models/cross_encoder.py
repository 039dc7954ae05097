"""Cross-encoder reranker (port of ``simxns_tpu/models/cross_encoder.py``).

A BERT encoder over joint (query, passage) rows [N*M, L], a 1-unit
``qa_classifier`` over the CLS vector, the logits viewed as [N, M] when
``group_size`` is given, and the optional 2-way ``binary_classifier``
(``Reranker_2``). LEAD's per-layer reranker: ``per_layer_logits`` runs
the same ``qa_classifier`` over every layer's CLS, and
``output_attentions`` returns every layer's attention probabilities.
A call with a ``torch.Generator`` trains with dropout
(:mod:`simxns_tpu_torch.models.bert`).

:func:`int8_view` builds the encode-only ``fused_int8`` view of a live
reranker that the AR2 retriever step uses as its frozen teacher: the
JAX view shares the param tree (``run.py:_int8_view_cfg``), this one shares
the ``Parameter`` objects.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from simxns_tpu_torch.models.bert import (BertConfig, BertEncoder, dense,
                                          init_weights, share_parameters,
                                          skip_init)


@dataclasses.dataclass(frozen=True)
class CrossEncoderConfig:
    bert: BertConfig
    binary_head: bool = False         # Reranker_2's extra 2-way head
    per_layer_logits: bool = False    # LEAD: rank logit from every layer's CLS


class CrossEncoder(nn.Module):
    """``generator`` seeds the JAX package's initializers; pass a converted
    state_dict (``params_from_jax``) to ``load_state_dict`` instead."""

    def __init__(self, cfg: CrossEncoderConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        bert = cfg.bert
        with skip_init(generator is not None):
            self.encoder = BertEncoder(bert)
            self.qa_classifier = nn.Linear(bert.hidden_size, 1,
                                           dtype=bert.param_dtype)
            if cfg.binary_head:
                self.binary_classifier = nn.Linear(bert.hidden_size, 2,
                                                   dtype=bert.param_dtype)
        if generator is not None:
            init_weights(self, bert.initializer_range, generator)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None,
                group_size: Optional[int] = None, *,
                generator: Optional[torch.Generator] = None,
                output_attentions: bool = False) -> Dict[str, object]:
        """-> ``{"logits": [N*M] or [N, M]}``, plus ``"binary_logits"``
        ([N*M, 2] or [N, M, 2]) with ``binary_head``; with
        ``per_layer_logits``, ``"per_layer_logits"`` ([L, N*M] or [L, N, M])
        and ``"hidden_states"`` (L+1 x [N*M, S, H]); with
        ``output_attentions``, ``"attentions"`` (L x [N*M, heads, S, S])."""
        cfg = self.cfg
        dt = cfg.bert.dtype
        enc = self.encoder(input_ids, attention_mask, token_type_ids,
                           generator=generator,
                           output_hidden_states=cfg.per_layer_logits,
                           output_attentions=output_attentions)

        def group(x):
            return x.reshape(-1, group_size) if group_size else x

        logits = dense(self.qa_classifier, enc.pooled, dt)[..., 0]
        out = {"logits": group(logits)}
        if cfg.per_layer_logits:
            per_layer = torch.stack(
                [dense(self.qa_classifier, h[:, 0], dt)[..., 0]
                 for h in enc.hidden_states[1:]])
            out["per_layer_logits"] = (
                per_layer.reshape(per_layer.shape[0], -1, group_size)
                if group_size else per_layer)
        if cfg.binary_head:
            binary = dense(self.binary_classifier, enc.pooled, dt)
            out["binary_logits"] = (binary.reshape(-1, group_size, 2)
                                    if group_size else binary)
        if output_attentions:
            out["attentions"] = enc.attentions
        if cfg.per_layer_logits:
            out["hidden_states"] = enc.hidden_states
        return out


def int8_view(model: CrossEncoder) -> CrossEncoder:
    """The ``layer_impl="fused_int8"`` encode-only view of ``model`` over the
    same ``Parameter`` objects (nothing is copied).

    Each layer of the view quantizes its weights once and again whenever
    one of them changes in place (an optimizer update bumps the tensor's
    version), so the view always encodes with the live weights. Run it
    under ``torch.no_grad()``. Raises for ``gelu="tanh"`` (the kernels
    compute exact GELU), as ``BertConfig`` does.
    """
    bert = model.cfg.bert.replace(layer_impl="fused_int8", ffn_impl="xla",
                                  proj_impl="xla", remat=False)
    with torch.device("meta"):
        view = CrossEncoder(dataclasses.replace(model.cfg, bert=bert))
    return share_parameters(view, model)
