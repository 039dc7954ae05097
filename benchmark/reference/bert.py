"""Plain BERT towers, written from the published model and the
configuration's stated precision, with no kernel and no code of the
program under test.

Precision (the configuration's ``precision`` block): parameters in f32,
activations in bf16, every dense product a bf16 x bf16 product summed in
f32 and rounded to bf16 (cuBLAS with the reduced-precision reduction off),
LayerNorm statistics, softmax and GELU in f32. ``prec="fp8"`` is the
control: the same towers with both operands of every dense product rounded
to float8 e4m3 under a per-tensor scale (amax to 448) and, in the
backward, the incoming gradient to e5m2 (amax to 57,344): the usual fp8
training recipe, the step below bf16 that a faster program might take.

The int8 encoder (:func:`int8_layer`) is the published int8 inference
recipe: per-row symmetric int8 activations and per-output-channel int8
weights (``amax / 127``, round half to even, clip to 127), the products
exact in integers, dequantized in f32; ``levels=7`` is its int4 control.

Weights are dicts of tensors keyed by the names of
:mod:`benchmark.weights`; inputs are token-id and mask tensors.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

BF16 = torch.bfloat16
FP8_MAX = 448.0
FP8_E5M2_MAX = 57344.0


def set_precision() -> None:
    """The configuration's precision on the card: f32 products in true
    f32 (no TF32), bf16 products with f32 partial sums."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def _fp8(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """x rounded to the fp8 ``dtype`` under a per-tensor scale (amax to
    ``top``), in x's dtype."""
    amax = x.detach().abs().amax().float().clamp_min(1e-12)
    scale = top / amax
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


class _Fp8Round(torch.autograd.Function):
    """x rounded to e4m3 under a per-tensor scale; the gradient passes
    straight through (the rounding has none)."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn, FP8_MAX)

    @staticmethod
    def backward(ctx, g):
        return g


class _Fp8GradRound(torch.autograd.Function):
    """The identity forward; the incoming gradient rounded to e5m2 under a
    per-tensor scale, so that both products of a dense layer's backward
    take fp8 operands, as fp8 training does."""

    @staticmethod
    def forward(ctx, y):
        return y

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2, FP8_E5M2_MAX)


def _operand(x: torch.Tensor, prec: str) -> torch.Tensor:
    x = x.to(BF16)
    return _Fp8Round.apply(x) if prec == "fp8" else x


def matmul_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 a @ b with f32 sums, rounded to bf16 (on the CPU the operands
    are upcast, which gives the same values)."""
    if a.is_cuda:
        return a @ b
    return (a.float() @ b.float()).to(BF16)


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
           prec: str = "bf16") -> torch.Tensor:
    """x [..., I] bf16, w [O, I] f32, b [O] f32 -> bf16 [..., O]."""
    y = matmul_bf16(_operand(x, prec), _operand(w, prec).t())
    if prec == "fp8":
        y = _Fp8GradRound.apply(y)
    return y if b is None else y + b.to(BF16)


def layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
               eps: float) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return (xf - mu) * torch.rsqrt(var + eps) * g.float() + b.float()


def gelu(x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    return 0.5 * xf * (1.0 + torch.erf(xf / math.sqrt(2.0)))


def attention(q, k, v, mask, heads: int) -> torch.Tensor:
    """q, k, v [B, S, H] -> [B, S, H]: f32 scores over the real keys,
    f32 softmax, probabilities rounded to the values' dtype, p v in f32."""
    b, s, h = q.shape
    d = h // heads

    def split(t):
        return t.reshape(b, s, heads, d).transpose(1, 2).float()

    sc = split(q) @ split(k).transpose(-1, -2) / math.sqrt(d)
    sc = sc.masked_fill(mask[:, None, None, :] == 0, -1e9)
    p = torch.softmax(sc, dim=-1).to(v.dtype).float()
    out = p @ split(v)
    return out.transpose(1, 2).reshape(b, s, h)


def positions(ids: torch.Tensor, cfg: dict) -> torch.Tensor:
    """Each token's position: 0, 1, .. (BERT), or with ``position_style``
    "roberta" the count of non-pad tokens up to it plus the pad id, and
    the pad id itself at pads (RoBERTa)."""
    if cfg.get("position_style", "bert") != "roberta":
        return torch.arange(ids.shape[1], device=ids.device)[None]
    pad = cfg["pad_token_id"]
    real = (ids != pad).long()
    return torch.cumsum(real, 1) * real + pad


def embed(w: Dict[str, torch.Tensor], pre: str, ids: torch.Tensor,
          cfg: dict) -> torch.Tensor:
    """Word + position + segment-0 embeddings, each in bf16, summed in
    bf16, then LayerNorm."""
    x = (w[pre + "word_embeddings.weight"][ids].to(BF16)
         + w[pre + "position_embeddings.weight"][positions(ids, cfg)]
         .to(BF16)
         + w[pre + "token_type_embeddings.weight"][0].to(BF16))
    return layer_norm(x, w[pre + "layer_norm.weight"],
                      w[pre + "layer_norm.bias"],
                      cfg["layer_norm_eps"]).to(BF16)


def layer(w, pre: str, x: torch.Tensor, mask: torch.Tensor, heads: int,
          eps: float, prec: str = "bf16") -> torch.Tensor:
    """One post-LN BERT layer in the configuration's precision."""
    def lin(name, t):
        return linear(t, w[pre + name + ".weight"], w[pre + name + ".bias"],
                      prec)

    q, k, v = (lin("attention." + n, x) for n in ("query", "key", "value"))
    ctx = attention(q, k, v, mask, heads).to(BF16)
    a = lin("attention.output", ctx)
    a = layer_norm(a + x, w[pre + "attention.output_layer_norm.weight"],
                   w[pre + "attention.output_layer_norm.bias"], eps).to(BF16)
    mid = gelu(lin("intermediate", a)).to(BF16)
    out = lin("output", mid)
    return layer_norm(out + a, w[pre + "output_layer_norm.weight"],
                      w[pre + "output_layer_norm.bias"], eps).to(BF16)


def encoder(w, pre: str, ids, mask, cfg: dict, prec: str = "bf16",
            checkpointed: bool = False) -> torch.Tensor:
    """Token ids [B, S] -> last hiddens [B, S, H] (bf16).
    ``checkpointed`` recomputes each layer in the backward (memory only:
    the values are the same)."""
    eps = cfg["layer_norm_eps"]
    x = embed(w, pre + "embeddings.", ids, cfg)
    for i in range(cfg["num_hidden_layers"]):
        args = (w, f"{pre}layers.{i}.", )
        if checkpointed and torch.is_grad_enabled():
            x = torch.utils.checkpoint.checkpoint(
                lambda t, a=args: layer(*a, t, mask, cfg["num_attention_heads"],
                                        eps, prec), x, use_reentrant=False)
        else:
            x = layer(*args, x, mask, cfg["num_attention_heads"], eps, prec)
    return x


def tower(w, pre: str, ids, mask, cfg: dict, prec: str = "bf16",
          checkpointed: bool = False) -> torch.Tensor:
    """A retriever tower: the CLS hidden, then the projection head
    (Dense + LayerNorm) where the configuration has one. -> bf16 [B, P]."""
    h = encoder(w, pre + "encoder.", ids, mask, cfg, prec, checkpointed)
    emb = h[:, 0]
    if cfg.get("projection_dim"):
        emb = linear(emb, w[pre + "project.weight"], w[pre + "project.bias"],
                     prec)
        emb = layer_norm(emb, w[pre + "project_layer_norm.weight"],
                         w[pre + "project_layer_norm.bias"],
                         cfg["layer_norm_eps"]).to(BF16)
    return emb


def cross_logits(w, ids, mask, cfg: dict, prec: str = "bf16",
                 checkpointed: bool = False) -> torch.Tensor:
    """The reranker's relevance logit of each joint row [R] (f32)."""
    h = encoder(w, "encoder.", ids, mask, cfg, prec, checkpointed)
    return linear(h[:, 0], w["qa_classifier.weight"],
                  w["qa_classifier.bias"], prec)[:, 0].float()


# --- the int8 encoder ------------------------------------------------------

def quant_rows(x: torch.Tensor, levels: int = 127):
    """Per-row symmetric codes: (codes as float, scales f32 [rows])."""
    xf = x.float()
    s = torch.clamp_min(xf.abs().amax(-1) / levels, 1e-12)
    q = torch.clamp(torch.round(xf / s[..., None]), -levels, levels)
    return q, s


def int_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer a @ b^T of integer-valued floats (f64 past f32's
    exact range)."""
    exact32 = a.shape[-1] * 127 * 127 < 2 ** 24
    dt = torch.float32 if exact32 else torch.float64
    return (a.to(dt) @ b.to(dt).t()).float()


def int8_linear(x, w, b, levels: int = 127, w_codes=None):
    """Quantized x [M, I] times quantized w [O, I], dequantized in f32,
    plus the f32 bias -> f32 [M, O]."""
    qx, sx = quant_rows(x, levels)
    qw, sw = w_codes if w_codes is not None else quant_rows(w, levels)
    return int_product(qx, qw) * sx[:, None] * sw[None, :] + b.float()


def int8_layer(w, pre: str, x: torch.Tensor, mask, heads: int, eps: float,
               levels: int = 127) -> torch.Tensor:
    """One post-LN layer with int8 products (encode only): x [B, S, H]
    bf16 -> bf16."""
    b, s, h = x.shape
    x2 = x.reshape(b * s, h)

    def lin(name, t):
        return int8_linear(t, w[pre + name + ".weight"].float(),
                           w[pre + name + ".bias"], levels)

    q, k, v = (lin("attention." + n, x2).to(BF16).reshape(b, s, h)
               for n in ("query", "key", "value"))
    ctx = attention(q, k, v, mask, heads).reshape(b * s, h)
    a = lin("attention.output", ctx) + x2.float()
    a = layer_norm(a, w[pre + "attention.output_layer_norm.weight"],
                   w[pre + "attention.output_layer_norm.bias"], eps)
    mid = gelu(lin("intermediate", a))
    out = lin("output", mid) + a
    out = layer_norm(out, w[pre + "output_layer_norm.weight"],
                     w[pre + "output_layer_norm.bias"], eps)
    return out.to(BF16).reshape(b, s, h)


@torch.no_grad()
def int8_encoder(w, pre: str, ids, mask, cfg: dict,
                 levels: int = 127) -> torch.Tensor:
    eps = cfg["layer_norm_eps"]
    x = embed(w, pre + "embeddings.", ids, cfg)
    for i in range(cfg["num_hidden_layers"]):
        x = int8_layer(w, f"{pre}layers.{i}.", x, mask,
                       cfg["num_attention_heads"], eps, levels)
    return x


@torch.no_grad()
def int8_tower(w, pre: str, ids, mask, cfg: dict, levels: int = 127):
    """The retriever tower on the int8 encoder; the projection head, where
    there is one, in bf16 as in :func:`tower`. -> bf16 [B, P]."""
    h = int8_encoder(w, pre + "encoder.", ids, mask, cfg, levels)
    emb = h[:, 0]
    if cfg.get("projection_dim"):
        emb = linear(emb, w[pre + "project.weight"], w[pre + "project.bias"])
        emb = layer_norm(emb, w[pre + "project_layer_norm.weight"],
                         w[pre + "project_layer_norm.bias"],
                         cfg["layer_norm_eps"]).to(BF16)
    return emb


@torch.no_grad()
def int8_cross_logits(w, ids, mask, cfg: dict, levels: int = 127):
    h = int8_encoder(w, "encoder.", ids, mask, cfg, levels)
    return linear(h[:, 0], w["qa_classifier.weight"],
                  w["qa_classifier.bias"])[:, 0].float()
