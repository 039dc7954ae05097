"""The program's models of a configuration, holding the seed's weights.

The models are built on the run's device, then filled from
:mod:`benchmark.weights`; the reference gets the same weights again from
the same seeds. ``seeds`` derives the independent seeds of one run.
"""

from __future__ import annotations

import torch

from benchmark import weights


def _bert(c: dict, remat: bool, joint: bool):
    from simxns_tpu_torch.models.bert import BertConfig

    return BertConfig(
        vocab_size=c["vocab_size"], hidden_size=c["hidden_size"],
        num_layers=c["num_hidden_layers"], num_heads=c["num_attention_heads"],
        intermediate_size=c["intermediate_size"],
        max_position_embeddings=c["max_position_embeddings"],
        type_vocab_size=c["type_vocab_size"],
        layer_norm_eps=c["layer_norm_eps"],
        position_style=c.get("position_style", "bert"),
        pad_token_id=c.get("pad_token_id", 0), dtype=torch.bfloat16,
        param_dtype=torch.float32, remat=remat,
        small_s_attn="group" if joint else None)


def models(cfg: dict, device, reranker: bool = True):
    """The program's dual encoder and (with ``reranker``) reranker of
    ``cfg`` on ``device``; their weights come from
    :mod:`benchmark.weights`."""
    from simxns_tpu_torch.models.cross_encoder import (CrossEncoder,
                                                       CrossEncoderConfig)
    from simxns_tpu_torch.models.dual_encoder import (BiEncoder,
                                                      BiEncoderConfig)

    remat = cfg.get("remat", False)
    de_c, ce_c = cfg["retriever"], cfg["reranker"]
    # built on the run's device: PyTorch's own initializers run there in a
    # few fast calls, where the meta device's first normal_ imports
    # torch._dynamo (~6 s on the card's machine)
    with torch.device(device):
        de = BiEncoder(BiEncoderConfig(
            bert=_bert(de_c, remat, False), pooling="cls",
            projection_dim=de_c.get("projection_dim")))
        ce = (CrossEncoder(CrossEncoderConfig(bert=_bert(ce_c, remat, True)))
              if reranker else None)
    return de, ce


def seeds(seed: int) -> dict:
    return {"retriever": weights.mix(seed, 1), "reranker": weights.mix(seed, 2),
            "dataset": weights.mix(seed, 3) % (2 ** 32)}


def initial_weights(cfg: dict, seed: int, device, which: str):
    spec = (weights.retriever_spec(cfg["retriever"]) if which == "retriever"
            else weights.reranker_spec(cfg["reranker"]))
    return weights.make(spec, seeds(seed)[which], device)
