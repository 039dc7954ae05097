"""HF checkpoint import (port of ``simxns_tpu/models/hf_import.py``): BERT,
RoBERTa, ELECTRA, DistilBERT and T5.

The reference starts every model from a HF checkpoint: BERT and ERNIE-2.0
(the BERT layout; the PROD student), RoBERTa (``RobertaDot``, the MS-Doc
path), ELECTRA (the MASTER reranker) and DistilBERT (the LEAD student).
These converters turn each family's PyTorch ``state_dict`` straight into
the port's names: a :class:`~simxns_tpu_torch.models.bert.BertEncoder`
state_dict and, where the checkpoint has one, an
:class:`~simxns_tpu_torch.models.bert.MLMHead` state_dict. HF's dense
weights are already ``nn.Linear``'s [out, in], so every tensor is copied as
it is, in f32: the result equals ``params_from_jax`` of the JAX
converter's tree bit for bit.

The HF pooler is dropped (the reference retrieves with ``seq[:, 0]``).
Pair each family with its :class:`BertConfig` knobs
(:func:`config_from_hf_params` derives them): RoBERTa
``position_style="roberta", pad_token_id=1``; DistilBERT
``type_vocab_size=0``; ELECTRA-small ``embedding_size``. A T5 artifact
is the docT5query generator, not an encoder warm start:
:func:`convert_hf_auto` refuses it, and :func:`convert_hf_t5` with
:func:`t5_config_from_state_dict` load it into
:class:`~simxns_tpu_torch.models.t5.T5`.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]

_LAYER_KEY = re.compile(r"layers\.(\d+)\.")


def _t(x) -> torch.Tensor:
    """An f32 CPU copy of a checkpoint tensor (or array)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).clone()
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _modern(k: str) -> str:
    """Original-format BERT checkpoints name LayerNorm parameters gamma and
    beta (the remap ``transformers`` carries too)."""
    if k.endswith(".gamma"):
        return k[: -len(".gamma")] + ".weight"
    if k.endswith(".beta"):
        return k[: -len(".beta")] + ".bias"
    return k


def _mlm(sd, transform: str, layer_norm: str, bias: str) -> StateDict:
    """An MLMHead state_dict (tied decoder: its own bias only)."""
    return {"transform.weight": _t(sd[f"{transform}.weight"]),
            "transform.bias": _t(sd[f"{transform}.bias"]),
            "transform_layer_norm.weight": _t(sd[f"{layer_norm}.weight"]),
            "transform_layer_norm.bias": _t(sd[f"{layer_norm}.bias"]),
            "bias": _t(sd[bias])}


def convert_hf_bert(state_dict, num_layers: Optional[int] = None,
                    prefix: str = "") -> Tuple[StateDict, Optional[StateDict]]:
    """HF BERT state_dict -> (encoder state_dict, MLM head state_dict or
    None).

    ``num_layers`` keeps the first layers (the PROD student). ``prefix``
    strips a leading module path (``"bert."`` inside ``BertForMaskedLM``);
    with no prefix a ``bert.`` one is stripped from the encoder's keys, and
    the ``cls.predictions.*`` MLM head is found either way.
    """
    sd = {_modern(k[len(prefix):]): v for k, v in state_dict.items()
          if k.startswith(prefix)}
    if any(k.startswith("bert.") for k in sd) and prefix == "":
        enc_sd = {k[5:]: v for k, v in sd.items() if k.startswith("bert.")}
    else:
        enc_sd = sd
    if prefix and any(k.startswith("cls.predictions.") for k in state_dict):
        # the MLM head lies outside the stripped prefix
        sd = {**sd, **{_modern(k): v for k, v in state_dict.items()
                       if k.startswith("cls.predictions.")}}

    out = {
        "embeddings.word_embeddings.weight":
            _t(enc_sd["embeddings.word_embeddings.weight"]),
        "embeddings.position_embeddings.weight":
            _t(enc_sd["embeddings.position_embeddings.weight"]),
        "embeddings.token_type_embeddings.weight":
            _t(enc_sd["embeddings.token_type_embeddings.weight"]),
        "embeddings.layer_norm.weight":
            _t(enc_sd["embeddings.LayerNorm.weight"]),
        "embeddings.layer_norm.bias": _t(enc_sd["embeddings.LayerNorm.bias"]),
    }
    names = {"attention.query": "attention.self.query",
             "attention.key": "attention.self.key",
             "attention.value": "attention.self.value",
             "attention.output": "attention.output.dense",
             "attention.output_layer_norm": "attention.output.LayerNorm",
             "intermediate": "intermediate.dense",
             "output": "output.dense",
             "output_layer_norm": "output.LayerNorm"}
    i = 0
    while f"encoder.layer.{i}.attention.self.query.weight" in enc_sd:
        if num_layers is not None and i >= num_layers:
            break
        for ours, theirs in names.items():
            for leaf in ("weight", "bias"):
                out[f"layers.{i}.{ours}.{leaf}"] = _t(
                    enc_sd[f"encoder.layer.{i}.{theirs}.{leaf}"])
        i += 1

    mlm = None
    if "cls.predictions.transform.dense.weight" in sd:
        mlm = _mlm(sd, "cls.predictions.transform.dense",
                   "cls.predictions.transform.LayerNorm",
                   "cls.predictions.bias")
    return out, mlm


def convert_hf_roberta(state_dict, num_layers: Optional[int] = None
                       ) -> Tuple[StateDict, Optional[StateDict]]:
    """HF ``RobertaModel`` / ``RobertaForMaskedLM`` state_dict -> (encoder,
    MLM head or None): BERT's layout under ``roberta.``, the MLM head as
    flat ``lm_head.*`` keys. The ``RobertaDot`` warm start of MS-Doc (pair
    with ``position_style="roberta", pad_token_id=1, type_vocab_size=1``).
    """
    sd = dict(state_dict)
    if any(k.startswith("roberta.") for k in sd):
        sd = {k[len("roberta."):] if k.startswith("roberta.") else k: v
              for k, v in sd.items()}
    params, _ = convert_hf_bert(sd, num_layers=num_layers)
    mlm = None
    if "lm_head.dense.weight" in sd:
        mlm = _mlm(sd, "lm_head.dense", "lm_head.layer_norm", "lm_head.bias")
    return params, mlm


def robertadot_projection(state_dict) -> Optional[StateDict]:
    """``RobertaDot``'s CLS head (``embeddingHead`` Linear and ``norm``
    LayerNorm) -> a BiEncoder tower's ``project`` / ``project_layer_norm``
    state_dict; None when the checkpoint has no head."""
    if "embeddingHead.weight" not in state_dict:
        return None
    return {"project.weight": _t(state_dict["embeddingHead.weight"]),
            "project.bias": _t(state_dict["embeddingHead.bias"]),
            "project_layer_norm.weight": _t(state_dict["norm.weight"]),
            "project_layer_norm.bias": _t(state_dict["norm.bias"])}


def convert_hf_electra(state_dict, num_layers: Optional[int] = None
                       ) -> Tuple[StateDict, None]:
    """HF ``ElectraModel`` (discriminator) state_dict -> (encoder, None):
    BERT's layout under ``electra.``, with the factorized embeddings'
    ``embeddings_project`` (pair with ``embedding_size``); its heads are
    dropped (the reference uses ELECTRA as a plain encoder)."""
    sd = dict(state_dict)
    if any(k.startswith("electra.") for k in sd):
        sd = {k[len("electra."):]: v for k, v in sd.items()
              if k.startswith("electra.")}
    params, _ = convert_hf_bert(sd, num_layers=num_layers)
    if "embeddings_project.weight" in sd:
        params["embeddings.embeddings_project.weight"] = _t(
            sd["embeddings_project.weight"])
        params["embeddings.embeddings_project.bias"] = _t(
            sd["embeddings_project.bias"])
    return params, None


def convert_hf_distilbert(state_dict, num_layers: Optional[int] = None
                          ) -> Tuple[StateDict, None]:
    """HF ``DistilBertModel`` state_dict -> (encoder, None): a post-LN BERT
    without token types and with its own module names (the LEAD student;
    pair with ``type_vocab_size=0``)."""
    sd = dict(state_dict)
    if any(k.startswith("distilbert.") for k in sd):
        sd = {k[len("distilbert."):]: v for k, v in sd.items()
              if k.startswith("distilbert.")}
    out = {
        "embeddings.word_embeddings.weight":
            _t(sd["embeddings.word_embeddings.weight"]),
        "embeddings.position_embeddings.weight":
            _t(sd["embeddings.position_embeddings.weight"]),
        "embeddings.layer_norm.weight": _t(sd["embeddings.LayerNorm.weight"]),
        "embeddings.layer_norm.bias": _t(sd["embeddings.LayerNorm.bias"]),
    }
    names = {"attention.query": "attention.q_lin",
             "attention.key": "attention.k_lin",
             "attention.value": "attention.v_lin",
             "attention.output": "attention.out_lin",
             "attention.output_layer_norm": "sa_layer_norm",
             "intermediate": "ffn.lin1",
             "output": "ffn.lin2",
             "output_layer_norm": "output_layer_norm"}
    i = 0
    while f"transformer.layer.{i}.attention.q_lin.weight" in sd:
        if num_layers is not None and i >= num_layers:
            break
        for ours, theirs in names.items():
            for leaf in ("weight", "bias"):
                out[f"layers.{i}.{ours}.{leaf}"] = _t(
                    sd[f"transformer.layer.{i}.{theirs}.{leaf}"])
        i += 1
    return out, None


def convert_hf_t5(state_dict) -> StateDict:
    """HF ``T5ForConditionalGeneration`` / ``T5Model`` state_dict -> a
    :class:`~simxns_tpu_torch.models.t5.T5` state_dict (the docT5query warm
    start, ``castorini/doc2query-t5-base-msmarco``): the shared table, each
    stack's relative-bias table (HF keeps it in block 0), every block's
    attention, cross-attention and ReLU FFN with their RMS norms, both
    final norms, and the LM head when it is untied (a tied checkpoint's
    head is the shared table, scaled by the model). Pair with
    :func:`t5_config_from_state_dict`."""
    sd = state_dict
    rel = ".block.0.layer.0.SelfAttention.relative_attention_bias.weight"
    out = {"shared_embed.weight": _t(sd["shared.weight"]),
           "enc_rel_bias.weight": _t(sd["encoder" + rel]),
           "dec_rel_bias.weight": _t(sd["decoder" + rel]),
           "enc_final_norm.weight": _t(sd["encoder.final_layer_norm.weight"]),
           "dec_final_norm.weight": _t(sd["decoder.final_layer_norm.weight"])}

    def attn(ours: str, theirs: str) -> None:
        for proj in ("q", "k", "v", "o"):
            out[f"{ours}.{proj}.weight"] = _t(sd[f"{theirs}.{proj}.weight"])

    for stack, ours in (("encoder", "enc_blocks"), ("decoder", "dec_blocks")):
        i = 0
        while f"{stack}.block.{i}.layer.0.SelfAttention.q.weight" in sd:
            b, o = f"{stack}.block.{i}.layer", f"{ours}.{i}"
            attn(f"{o}.self_attention", f"{b}.0.SelfAttention")
            out[f"{o}.self_norm.weight"] = _t(sd[f"{b}.0.layer_norm.weight"])
            ffn = 1
            if stack == "decoder":
                attn(f"{o}.cross_attention", f"{b}.1.EncDecAttention")
                out[f"{o}.cross_norm.weight"] = _t(
                    sd[f"{b}.1.layer_norm.weight"])
                ffn = 2
            for w in ("wi", "wo"):
                out[f"{o}.{w}.weight"] = _t(
                    sd[f"{b}.{ffn}.DenseReluDense.{w}.weight"])
            out[f"{o}.ffn_norm.weight"] = _t(
                sd[f"{b}.{ffn}.layer_norm.weight"])
            i += 1
    if not _t5_tied(sd):
        out["lm_head.weight"] = _t(sd["lm_head.weight"])
    return out


def _t5_tied(sd) -> bool:
    """A T5 checkpoint ties its head when it has none or it equals the
    shared table."""
    return "lm_head.weight" not in sd or torch.equal(
        _t(sd["lm_head.weight"]), _t(sd["shared.weight"]))


def t5_config_from_state_dict(state_dict, base=None):
    """The :class:`~simxns_tpu_torch.models.t5.T5Config` a checkpoint needs:
    vocab, ``d_model``, ``d_ff`` and the depths from the weights' shapes,
    heads and buckets from the relative-bias table, ``d_kv`` = inner /
    heads, the tie from the head's equality with the shared table. The
    bucketing's ``relative_attention_max_distance`` leaves no trace in any
    shape: it comes from ``base`` (default ``T5Config()``: 128, what every
    published T5 and docT5query checkpoint uses)."""
    from simxns_tpu_torch.models.t5 import T5Config

    base = base or T5Config()
    sd = state_dict
    vocab, d_model = sd["shared.weight"].shape
    buckets, heads = sd["encoder.block.0.layer.0.SelfAttention"
                        ".relative_attention_bias.weight"].shape
    inner = sd["encoder.block.0.layer.0.SelfAttention.q.weight"].shape[0]
    d_ff = sd["encoder.block.0.layer.1.DenseReluDense.wi.weight"].shape[0]
    depth = {stack: sum(1 for k in sd if k.startswith(stack + ".")
                        and k.endswith(".SelfAttention.q.weight"))
             for stack in ("encoder", "decoder")}
    return base.replace(
        vocab_size=int(vocab), d_model=int(d_model), d_ff=int(d_ff),
        d_kv=int(inner) // int(heads), num_heads=int(heads),
        num_layers=depth["encoder"], num_decoder_layers=depth["decoder"],
        relative_attention_num_buckets=int(buckets),
        tie_word_embeddings=_t5_tied(sd))


_FAMILY_MARKERS = (
    # (state_dict key marker, family): the first match wins
    ("SelfAttention.q.weight", "t5"),
    ("electra.embeddings.", "electra"),
    ("roberta.embeddings.", "roberta"),
    ("distilbert.embeddings.", "distilbert"),
    ("transformer.layer.0.attention.q_lin.weight", "distilbert"),
    ("lm_head.layer_norm.weight", "roberta"),
)


def sniff_hf_family(state_dict) -> str:
    """The architecture family from the state_dict's keys. BERT and
    ERNIE-2.0 share a layout ("bert"); a bare RoBERTa checkpoint (no
    ``roberta.`` prefix, no MLM head) cannot be told from BERT by its
    keys."""
    keys = set(state_dict)
    for marker, family in _FAMILY_MARKERS:
        if any(marker in k for k in keys):
            return family
    return "bert"


def convert_hf_auto(state_dict, num_layers: Optional[int] = None):
    """Sniff the family and convert. -> (family, encoder state_dict, MLM
    head state_dict or None)."""
    family = sniff_hf_family(state_dict)
    if family == "t5":
        raise ValueError(
            "T5 checkpoints are encoder-DECODER artifacts — they cannot "
            "warm-start a BERT-family encoder. Use convert_hf_t5 + "
            "simxns_tpu.models.t5.T5 (the docT5query generator path).")
    fn = {"bert": convert_hf_bert, "roberta": convert_hf_roberta,
          "electra": convert_hf_electra,
          "distilbert": convert_hf_distilbert}[family]
    params, mlm = fn(state_dict, num_layers=num_layers)
    return family, params, mlm


def config_from_hf_params(enc_params: StateDict, family: str, base=None):
    """The :class:`BertConfig` a converted encoder state_dict needs: vocab,
    width, ``embedding_size``, layers, F, positions and token types from
    its shapes; RoBERTa's position style and pad id from ``family``; the
    rest (dtype, impls, heads: no shape holds them) from ``base`` (default
    ``BertConfig()``)."""
    from simxns_tpu_torch.models.bert import BertConfig

    base = base or BertConfig()
    vocab, width = enc_params["embeddings.word_embeddings.weight"].shape
    hidden = enc_params["layers.0.attention.query.weight"].shape[1]
    types = enc_params.get("embeddings.token_type_embeddings.weight")
    kw = dict(
        vocab_size=int(vocab),
        hidden_size=int(hidden),
        embedding_size=int(width) if width != hidden else None,
        num_layers=len({m.group(1) for k in enc_params
                        for m in [_LAYER_KEY.match(k)] if m}),
        intermediate_size=int(
            enc_params["layers.0.intermediate.weight"].shape[0]),
        max_position_embeddings=int(
            enc_params["embeddings.position_embeddings.weight"].shape[0]),
        type_vocab_size=int(types.shape[0]) if types is not None else 0,
    )
    if family == "roberta":
        kw.update(position_style="roberta", pad_token_id=1)
    return dataclasses.replace(base, **kw)


def load_hf_bert_encoder(path_or_state_dict, num_layers: Optional[int] = None):
    """:func:`convert_hf_bert` of a ``pytorch_model.bin`` path (loaded on
    the CPU, tensors only) or of a state_dict in memory."""
    if isinstance(path_or_state_dict, (str, bytes)):
        sd = torch.load(path_or_state_dict, map_location="cpu",
                        weights_only=True)
    else:
        sd = path_or_state_dict
    return convert_hf_bert(sd, num_layers=num_layers)


def as_biencoder_params(encoder_params: StateDict, share_weight: bool = False
                        ) -> StateDict:
    """A converted encoder as a BiEncoder's state_dict: the question tower
    and, unless ``share_weight``, a copy as the passage tower."""
    out = {f"question_model.encoder.{k}": v
           for k, v in encoder_params.items()}
    if not share_weight:
        out.update({f"ctx_model.encoder.{k}": v.clone()
                    for k, v in encoder_params.items()})
    return out
