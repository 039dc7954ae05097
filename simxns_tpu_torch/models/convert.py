"""Weights from the JAX package: flax param tree -> the port's state_dict.

The port's modules keep the flax names, so the map is mechanical:

- module ``layer_{i}`` -> ``layers.{i}``, and a Condenser head's layer
  ``<name>_head_{i}`` -> ``<name>_head.{i}``; every other module name
  stays;
- leaf ``kernel`` [in, out] -> ``weight`` [out, in] (``nn.Linear``);
- leaf ``embedding`` (``nn.Embed``) and ``scale`` (``nn.LayerNorm``) ->
  ``weight``; ``bias`` stays.

Works for a ``BiEncoder`` tree (``question_model``/``ctx_model``; with
``share_weight`` only ``question_model``), a ``CrossEncoder`` tree
(``encoder``, ``qa_classifier``, ``binary_classifier``), a bare
``BertEncoder`` (whole, or cut by ``truncate_layers``: the layers it
keeps), an ``MLMHead`` (``transform``, ``transform_layer_norm``, and the
tied head's ``bias`` leaf or the untied ``decoder``), a ``ColBERT``
(``encoder``, the bias-free ``linear`` and ``doc_linear`` heads, and
``doc_encoder`` without ``share_weight``) and a ``Condenser``
(``encoder``, ``mlm`` and the five heads' layers) and a ``Reader``
(``encoder``, ``qa_outputs``, ``qa_classifier``).
The same state_dict serves every ``layer_impl``, as the flax trees do.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_LAYER = re.compile(r"layer_(\d+)")
_HEAD_LAYER = re.compile(r"(\w+_head)_(\d+)")
_LEAF = {"kernel": "weight", "embedding": "weight", "scale": "weight",
         "bias": "bias"}


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
                name = (f"layers.{m.group(1)}" if m else
                        f"{head.group(1)}.{head.group(2)}" if head else key)
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
