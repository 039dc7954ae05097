"""Cross-encoder reranker (port of ``simxns_tpu/models/cross_encoder.py``).

A BERT encoder over joint (query, passage) rows [N*M, L], a 1-unit
``qa_classifier`` over the CLS vector, the logits viewed as [N, M] when
``group_size`` is given, and the optional 2-way ``binary_classifier``
(``Reranker_2``). Not ported yet: ``per_layer_logits`` and
``output_attentions`` (LEAD).

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
                                          init_weights, share_parameters)


@dataclasses.dataclass(frozen=True)
class CrossEncoderConfig:
    bert: BertConfig
    binary_head: bool = False         # Reranker_2's extra 2-way head


class CrossEncoder(nn.Module):
    """``generator`` seeds the JAX package's initializers; pass a converted
    state_dict (``params_from_jax``) to ``load_state_dict`` instead."""

    def __init__(self, cfg: CrossEncoderConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        bert = cfg.bert
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
                group_size: Optional[int] = None
                ) -> Dict[str, torch.Tensor]:
        """-> ``{"logits": [N*M] or [N, M]}``, plus ``"binary_logits"``
        ([N*M, 2] or [N, M, 2]) with ``binary_head``."""
        dt = self.cfg.bert.dtype
        pooled = self.encoder(input_ids, attention_mask,
                              token_type_ids).pooled
        logits = dense(self.qa_classifier, pooled, dt)[..., 0]
        out = {"logits": logits.reshape(-1, group_size) if group_size
               else logits}
        if self.cfg.binary_head:
            binary = dense(self.binary_classifier, pooled, dt)
            out["binary_logits"] = (binary.reshape(-1, group_size, 2)
                                    if group_size else binary)
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
