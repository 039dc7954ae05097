"""Seeded random weights of a configuration, made on the device in a few
large calls, and handed alike to the program and to the reference.

Each model of a configuration has a spec: its parameters in order, each
with its shape and its initializer (BERT's: normal(0, 0.02) for dense
kernels and embedding tables, zero biases, unit LayerNorm scales). The
names are those of the program's modules, so the program loads the dict
by name and the reference reads it by the same names. All normal draws of
one model come from one generator in one call, so a seed gives the same
weights on every run on the same device.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

Spec = List[Tuple[str, Tuple[int, ...], str]]   # (name, shape, "normal"|"zero"|"one")

_MASK64 = (1 << 64) - 1


def mix(seed: int, tag: int) -> int:
    """splitmix64 of (seed, tag): independent generator seeds from one
    run seed (any whole number, negative ones included)."""
    x = ((seed & _MASK64) + (tag + 1) * 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (x ^ (x >> 31)) & ((1 << 63) - 1)


def _encoder(pre: str, c: dict) -> Spec:
    h, f = c["hidden_size"], c["intermediate_size"]
    e = pre + "embeddings."
    out: Spec = [(e + "word_embeddings.weight", (c["vocab_size"], h), "normal"),
                 (e + "position_embeddings.weight",
                  (c["max_position_embeddings"], h), "normal"),
                 (e + "token_type_embeddings.weight",
                  (c["type_vocab_size"], h), "normal"),
                 (e + "layer_norm.weight", (h,), "one"),
                 (e + "layer_norm.bias", (h,), "zero")]

    def dense(name, o, i):
        out.extend([(name + ".weight", (o, i), "normal"),
                    (name + ".bias", (o,), "zero")])

    def norm(name):
        out.extend([(name + ".weight", (h,), "one"),
                    (name + ".bias", (h,), "zero")])

    for i in range(c["num_hidden_layers"]):
        p = f"{pre}layers.{i}."
        for n in ("query", "key", "value", "output"):
            dense(p + "attention." + n, h, h)
        norm(p + "attention.output_layer_norm")
        dense(p + "intermediate", f, h)
        dense(p + "output", h, f)
        norm(p + "output_layer_norm")
    return out


def retriever_spec(c: dict) -> Spec:
    """A dual encoder with two towers (``question_model``, ``ctx_model``),
    each a BERT encoder and, where ``projection_dim`` is set, a Dense +
    LayerNorm head over the CLS vector."""
    out: Spec = []
    for tower in ("question_model.", "ctx_model."):
        out += _encoder(tower + "encoder.", c)
        p = c.get("projection_dim")
        if p:
            out += [(tower + "project.weight", (p, c["hidden_size"]), "normal"),
                    (tower + "project.bias", (p,), "zero"),
                    (tower + "project_layer_norm.weight", (p,), "one"),
                    (tower + "project_layer_norm.bias", (p,), "zero")]
    return out


def reranker_spec(c: dict) -> Spec:
    """A BERT encoder and a 1-unit relevance head over the CLS vector."""
    return _encoder("encoder.", c) + [
        ("qa_classifier.weight", (1, c["hidden_size"]), "normal"),
        ("qa_classifier.bias", (1,), "zero")]


def make(spec: Spec, seed: int, device, std: float = 0.02
         ) -> Dict[str, torch.Tensor]:
    """The weights of ``spec`` as f32 tensors on ``device``: one normal
    draw for every ``normal`` parameter together, from a generator on the
    device seeded with ``seed``. The tensors are views of one buffer."""
    numel = [int(torch.Size(shape).numel()) for _, shape, _ in spec]
    n_normal = sum(n for n, (_, _, kind) in zip(numel, spec)
                   if kind == "normal")
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.empty(sum(numel), dtype=torch.float32, device=device)
    normal = torch.randn(n_normal, generator=gen, device=device)
    normal.mul_(std)
    out, at, drawn = {}, 0, 0
    for (name, shape, kind), n in zip(spec, numel):
        view = flat[at:at + n]
        if kind == "normal":
            view.copy_(normal[drawn:drawn + n])
            drawn += n
        else:
            view.fill_(1.0 if kind == "one" else 0.0)
        out[name] = view.view(shape)
        at += n
    return out


def load_into(module: torch.nn.Module, weights: Dict[str, torch.Tensor]
              ) -> None:
    """Copy ``weights`` into ``module``'s parameters of the same names;
    raises unless the names and shapes agree exactly."""
    params = dict(module.named_parameters())
    if set(params) != set(weights):
        missing = sorted(set(params) ^ set(weights))[:5]
        raise ValueError(f"the program's parameters and the benchmark's "
                         f"weights differ in names: {missing}")
    names = sorted(params)
    for n in names:
        if tuple(params[n].shape) != tuple(weights[n].shape):
            raise ValueError(f"{n}: program shape {tuple(params[n].shape)}, "
                             f"benchmark shape {tuple(weights[n].shape)}")
    with torch.no_grad():
        torch._foreach_copy_([params[n].data for n in names],
                             [weights[n] for n in names])
