"""Int8 quantization and GELU helpers, and the FFN/projection knobs.

Own copy of the helpers in ``simxns_tpu/ops/fused_ffn.py``: ``_erf``
(Abramowitz & Stegun 7.1.26, :58-70), ``_gelu_exact`` (:73),
``_quant_rows`` (:144) and ``quantize_weight`` (:152). Weights here are in
``nn.Linear`` layout [out, in], so "per output channel" is per row.

The Pallas kernels of that file (``fused_ffn``, ``fused_ffn_vjp``,
``int8_ffn``, ``int8_dense``) are not ported yet (ROADMAP Queue 2, items
5-10). :func:`ffn` and :func:`dense` run their plain versions for CPU
tensors and raise ``NotImplementedError`` for CUDA tensors; the serving
slice reaches neither.
"""

from __future__ import annotations

from typing import Tuple

import torch

_ROADMAP_FFN = "ROADMAP.md Queue 2 (fused_ffn.py kernels)"


def erf_as(z: torch.Tensor) -> torch.Tensor:
    """f32 erf via Abramowitz & Stegun 7.1.26 (|err| < 1.5e-7), the erf the
    TPU kernels compute; the port's kernels compute the same polynomial."""
    a = torch.abs(z)
    t = 1.0 / (1.0 + 0.3275911 * a)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    e = 1.0 - poly * torch.exp(-a * a)
    return torch.where(z < 0, -e, e)


def gelu_exact(h: torch.Tensor) -> torch.Tensor:
    return 0.5 * h * (1.0 + erf_as(h * 0.7071067811865476))


def quant_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8: [M, K] -> (codes int8 [M, K], scales f32 [M]).

    ``s = max|x| / 127`` clamped at 1e-12, codes ``round(x / s)`` (half to
    even, a true division) clipped to +-127.
    """
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which is not the rounded quotient
    s = torch.clamp_min(amax / torch.full_like(amax, 127.0), 1e-12)
    q = torch.clamp(torch.round(xf / s.unsqueeze(-1)), -127, 127)
    return q.to(torch.int8), s


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 of an ``nn.Linear`` weight [O, I]
    -> (int8 [O, I], f32 [O]); the JAX ``quantize_weight`` of the [I, O]
    flax kernel, transposed."""
    return quant_rows(w)


def int8_matmul(a8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """Exact int8 x int8^T [M, K] x [N, K] -> integer-valued float [M, N]
    (the kernels' int32 accumulator). f32 holds every partial sum exactly
    while K * 127^2 < 2^24; longer rows go through f64."""
    dt = torch.float32 if a8.shape[-1] * 127 * 127 < 2 ** 24 else torch.float64
    return a8.to(dt) @ w8.to(dt).T


def _require_cpu(x: torch.Tensor, what: str) -> None:
    if x.is_cuda:
        raise NotImplementedError(
            f"{what} has no CUDA kernel yet ({_ROADMAP_FFN}); use the "
            "default 'xla' knob or layer_impl='fused_int8' on the card")


def _ffn_reference(x, w1, b1, w2, b2):
    """Two bf16-style dense layers around exact GELU (flax Dense semantics:
    operands in the activation dtype, f32 accumulation, bias post-cast)."""
    dt = x.dtype
    h = (x.float() @ w1.to(dt).float().T).to(dt) + b1.to(dt)
    g = torch.nn.functional.gelu(h.float()).to(dt)
    return (g.float() @ w2.to(dt).float().T).to(dt) + b2.to(dt)


def _tiles(m: int, lanes: Tuple[int, ...], tile_m: int, sub: int) -> bool:
    """The TPU kernels' tiling rule: lane dims multiples of 128 and the
    token dim a multiple of the tile, else they take the XLA expression."""
    tile = min(tile_m, max(sub, -(-m // sub) * sub))
    return not (any(d % 128 for d in lanes) or m % tile)


def ffn(x: torch.Tensor, w1, b1, w2, b2, impl: str) -> torch.Tensor:
    """``BertConfig.ffn_impl`` in {fused, fused_vjp, int8}: plain versions
    of the TPU FFN kernels, CPU tensors only."""
    _require_cpu(x, f"ffn_impl={impl!r}")
    lead, hdim = x.shape[:-1], x.shape[-1]
    m = x.numel() // hdim
    if impl != "int8" or not _tiles(m, (hdim, w1.shape[0]), 256, 32):
        return _ffn_reference(x, w1, b1, w2, b2)
    x2 = x.reshape(m, hdim)
    xq, xs = quant_rows(x2)
    w1q, s1 = quantize_weight(w1)
    w2q, s2 = quantize_weight(w2)
    h = int8_matmul(xq, w1q).float() * xs[:, None] * s1 + b1.float()
    gq, gs = quant_rows(gelu_exact(h))
    y = int8_matmul(gq, w2q).float() * gs[:, None] * s2 + b2.float()
    return y.to(x.dtype).reshape(*lead, hdim)


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``BertConfig.proj_impl="int8"``: the TPU ``int8_dense`` plain, CPU
    tensors only (bf16 dense where its shapes do not tile)."""
    _require_cpu(x, "proj_impl='int8'")
    lead, i = x.shape[:-1], x.shape[-1]
    m = x.numel() // i
    dt = x.dtype
    if not _tiles(m, (i, w.shape[0]), 512, 32):
        return (x.float() @ w.to(dt).float().T).to(dt) + b.to(dt)
    xq, xs = quant_rows(x.reshape(m, i))
    wq, s = quantize_weight(w)
    y = int8_matmul(xq, wq).float() * xs[:, None] * s + b.float()
    return y.to(dt).reshape(*lead, w.shape[0])
