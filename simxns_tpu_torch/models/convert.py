"""Weights from the JAX package: flax param tree -> the port's state_dict.

The port's modules keep the flax names, so the map is mechanical:

- module ``layer_{i}`` -> ``layers.{i}``, a Condenser head's layer
  ``<name>_head_{i}`` -> ``<name>_head.{i}``, a T5 block
  ``enc_blocks_{i}`` / ``dec_blocks_{i}`` -> ``enc_blocks.{i}`` /
  ``dec_blocks.{i}`` and a Seq2Seq layer ``enc_layer_{i}`` /
  ``dec_layer_{i}`` -> ``enc_layers.{i}`` / ``dec_layers.{i}``; every
  other module name stays;
- leaf ``kernel`` [in, out] -> ``weight`` [out, in] (``nn.Linear``);
- leaf ``embedding`` (``nn.Embed``) and ``scale`` (``nn.LayerNorm``) ->
  ``weight``; ``bias`` and ``weight`` (T5's RMS norm) stay.

Works for a ``BiEncoder`` tree (``question_model``/``ctx_model``; with
``share_weight`` only ``question_model``), a ``CrossEncoder`` tree
(``encoder``, ``qa_classifier``, ``binary_classifier``), a bare
``BertEncoder`` (whole, or cut by ``truncate_layers``: the layers it
keeps), an ``MLMHead`` (``transform``, ``transform_layer_norm``, and the
tied head's ``bias`` leaf or the untied ``decoder``), a ``ColBERT``
(``encoder``, the bias-free ``linear`` and ``doc_linear`` heads, and
``doc_encoder`` without ``share_weight``) and a ``Condenser``
(``encoder``, ``mlm`` and the five heads' layers) and a ``Reader``
(``encoder``, ``qa_outputs``, ``qa_classifier``), a ``T5`` (tied or with
its ``lm_head``) and a ``Seq2Seq``.
The same state_dict serves every ``layer_impl``, as the flax trees do.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_LAYER = re.compile(r"layer_(\d+)")
_HEAD_LAYER = re.compile(r"(\w+_head)_(\d+)")
_STACK = re.compile(r"(enc|dec)_(blocks|layer)_(\d+)")
_STACK_NAME = {"blocks": "blocks", "layer": "layers"}
_LEAF = {"kernel": "weight", "embedding": "weight", "scale": "weight",
         "bias": "bias", "weight": "weight"}


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """``tree`` is ``model.init(...)``'s result (or its ``"params"``), with
    array leaves (numpy or anything ``np.asarray`` takes)."""
    if "params" in tree:
        tree = tree["params"]
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping, prefix: str) -> None:
        for key, val in node.items():
            if isinstance(val, Mapping):
                m = _LAYER.fullmatch(key)
                head = _HEAD_LAYER.fullmatch(key)
                stack = _STACK.fullmatch(key)
                name = (f"layers.{m.group(1)}" if m else
                        f"{head.group(1)}.{head.group(2)}" if head else
                        f"{stack.group(1)}_{_STACK_NAME[stack.group(2)]}."
                        f"{stack.group(3)}" if stack else key)
                walk(val, f"{prefix}{name}.")
                continue
            if key not in _LEAF:
                raise KeyError(f"unexpected flax leaf {prefix}{key}")
            arr = np.array(val, dtype=np.float32)
            if key == "kernel":
                arr = arr.T.copy()
            out[prefix + _LEAF[key]] = torch.from_numpy(arr)

    walk(tree, "")
    return out
