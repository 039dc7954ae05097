"""The int8 BERT encoder layer on Hopper kernels (encode only).

Port of ``simxns_tpu/ops/fused_layer.py:fused_encoder_layer_int8``. The TPU
kernel runs a whole post-LN layer as ONE Pallas program with ~7 MB of int8
weights resident in VMEM (``fused_layer.py:14-18,50-77``). An H100 SM has at
most 227 KB of shared memory, so that block structure does not carry over;
this module keeps the kernel's numerical contract and composes it from
three hand-written kernels:

- K1 :func:`int8_linear` (CUDA, ``csrc/int8_linear.cu``): int8 GEMM with a
  fused dequantize / bias / optional GELU epilogue — the six projections.
  A Hopper GEMM (``csrc/wgmma_ring.cuh``): TMA copies into a 4-stage ring
  of shared-memory tiles, one producer thread, two consumer warpgroups on
  the int8 warpgroup MMA (128 x 256 tiles, a persistent grid), and result
  tiles staged through shared memory into 16-byte stores; 64-row tiles
  below two waves of 128 x 256 ones (a request, the mine's queries);
- K2 :func:`row_quant` (Triton, below): optional residual add and f32
  LayerNorm, then per-token int8 quantization of the row;
- K3 :func:`small_s_attention` (CUDA, ``csrc/small_s_attention.cu``): the
  per-(sequence, head) softmax attention.

Order: K2 -> K1(qkv) -> K3 -> K2 -> K1(o) -> K2(+res, LN) -> K1(w1, GELU)
-> K2 -> K1(w2) -> K2(+res, LN). Each wrapper launches its kernel for a
CUDA tensor and runs its plain PyTorch version only for a CPU tensor; it
counts its launches in ``<wrapper>.launches``. :func:`layer_int8_plain` is
the same composition over the plain versions (the card checks hold the
kernels against it), and :func:`layer_reference` the unquantized f32 layer.

Parameters use the JAX kernel's names (``wq``/``bq`` ... ``ln2_bias``)
with weights in ``nn.Linear`` layout [out, in]. Quantizing the weights is
done once per :class:`QuantizedLayer` (:func:`quantize_layer`).
"""

import ctypes
import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch

from simxns_tpu_torch.ops import _native
from simxns_tpu_torch.ops.fused_ffn import (gelu_exact, int8_matmul,
                                            quant_rows, quantize_weight)


# --- K1: int8_linear ---------------------------------------------------------

_LINEAR_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _int8_linear_plain(a8, xs, w8, ws, b, gelu, out_dtype):
    y = int8_matmul(a8, w8).float() * xs[:, None] * ws + b
    if gelu:
        y = gelu_exact(y)
    return y.to(out_dtype)


def int8_linear(a8: torch.Tensor, xs: torch.Tensor, w8: torch.Tensor,
                ws: torch.Tensor, b: torch.Tensor, *, gelu: bool = False,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``y = (a8 @ w8^T) * xs[:, None] * ws + b`` (then GELU if asked).

    a8 [M, K] int8 with per-row scales xs [M]; w8 [N, K] int8 with
    per-output-channel scales ws [N]; b [N] f32. The int32 accumulator is
    dequantized in f32 in the TPU kernel's order, ``(acc * xs) * ws + b``.
    """
    if not a8.is_cuda:
        return _int8_linear_plain(a8, xs, w8, ws, b, gelu, out_dtype)
    m, k = a8.shape
    n = w8.shape[0]
    _native.check_tensor(a8, torch.int8, (m, k), "a8")
    _native.check_tensor(w8, torch.int8, (n, k), "w8")
    for name, t, size in (("xs", xs, m), ("ws", ws, n), ("b", b, n)):
        _native.check_tensor(t, torch.float32, (size,), name)
    if k % 16 or out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"int8_linear: K={k} must be a multiple of 16 and "
                         f"out_dtype f32 or bf16 (got {out_dtype})")
    out = torch.empty(m, n, dtype=out_dtype, device=a8.device)
    if m == 0:
        return out
    fn = _native.function("int8_linear", "sx_int8_linear", _LINEAR_ARGS)
    code = fn(_native.ptr(a8), _native.ptr(w8), _native.ptr(xs),
              _native.ptr(ws), _native.ptr(b), _native.ptr(out), m, n, k,
              int(gelu), int(out_dtype == torch.bfloat16),
              _native.stream(a8.device))
    _native.check("int8_linear", code, "int8_linear")
    int8_linear.launches += 1
    return out


int8_linear.launches = 0


# --- K2: row_quant (Triton) --------------------------------------------------
#
# Triton rather than CUDA: this is a row reduction plus elementwise work with
# no tensor-core product, which Triton expresses in a few lines at full
# memory rate. Bound on the card: bytes (a row is read once and written once
# as int8 + scale, and as f32/bf16 where asked). One program per row; the
# whole row sits in registers, so mean, variance and max|x| are three
# in-register reductions with no second read. Divisions and the square
# root use the correctly rounded libdevice forms (div_rn, sqrt_rn) and
# quantization rounds half to even (rint), so the codes are those of the
# plain version; contraction into FMAs is switched off for the same reason.

_ROW_QUANT = None
tl = None          # triton.language, bound when the kernel is first built
_libdevice = None


def _row_quant_kernel():
    global _ROW_QUANT, tl, _libdevice
    if _ROW_QUANT is not None:
        return _ROW_QUANT
    import triton
    import triton.language as tl
    try:
        from triton.language.extra.cuda import libdevice as _libdevice
    except ImportError:
        from triton.language.extra import libdevice as _libdevice

    @triton.jit
    def row_quant_kernel(x_ptr, r_ptr, g_ptr, b_ptr, q_ptr, s_ptr, y32_ptr,
                         y16_ptr, n, eps,
                         HAS_RES: tl.constexpr, DO_LN: tl.constexpr,
                         QUANT: tl.constexpr, OUT_F32: tl.constexpr,
                         OUT_BF16: tl.constexpr, BLOCK: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK)
        live = cols < n
        off = row * n + cols
        x = tl.load(x_ptr + off, mask=live, other=0.0).to(tl.float32)
        if HAS_RES:
            x = x + tl.load(r_ptr + off, mask=live, other=0.0).to(tl.float32)
        if DO_LN:
            nf = n.to(tl.float32)
            mean = _libdevice.div_rn(tl.sum(x, axis=0), nf)
            d = tl.where(live, x - mean, 0.0)
            var = _libdevice.div_rn(tl.sum(d * d, axis=0), nf)
            rstd = _libdevice.div_rn(1.0, _libdevice.sqrt_rn(var + eps))
            g = tl.load(g_ptr + cols, mask=live, other=0.0)
            b = tl.load(b_ptr + cols, mask=live, other=0.0)
            x = d * rstd * g + b
        if OUT_F32:
            tl.store(y32_ptr + off, x, mask=live)
        if OUT_BF16:
            tl.store(y16_ptr + off, x.to(tl.bfloat16), mask=live)
        if QUANT:
            amax = tl.max(tl.where(live, tl.abs(x), 0.0), axis=0)
            s = tl.maximum(_libdevice.div_rn(amax, 127.0), 1e-12)
            q = _libdevice.rint(_libdevice.div_rn(x, s))
            q = tl.minimum(tl.maximum(q, -127.0), 127.0)
            tl.store(q_ptr + off, q.to(tl.int8), mask=live)
            tl.store(s_ptr + row, s)

    _ROW_QUANT = row_quant_kernel
    return _ROW_QUANT


def _layer_norm(x, g, b, eps):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * g + b


def _row_quant_plain(x, residual, ln, eps, quant, out_f32, out_bf16):
    y = x.float()
    if residual is not None:
        y = y + residual.float()
    if ln is not None:
        y = _layer_norm(y, ln[0], ln[1], eps)
    codes, scales = quant_rows(y) if quant else (None, None)
    return (codes, scales, y if out_f32 else None,
            y.to(torch.bfloat16) if out_bf16 else None)


def row_quant(x: torch.Tensor, *, residual: Optional[torch.Tensor] = None,
              ln: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              eps: float = 1e-12, quant: bool = True, out_f32: bool = False,
              out_bf16: bool = False):
    """Per row of x [M, N]: ``y = LN(x + residual)`` (each step optional, in
    f32), then per-token int8 quantization of y.

    Returns ``(codes int8 [M, N] | None, scales f32 [M] | None,
    y f32 [M, N] | None, y bf16 [M, N] | None)``.
    """
    if not x.is_cuda:
        return _row_quant_plain(x, residual, ln, eps, quant, out_f32,
                                out_bf16)
    m, n = x.shape
    if x.dtype not in (torch.float32, torch.bfloat16) or not x.is_contiguous():
        raise ValueError("row_quant: x must be contiguous f32 or bf16")
    if residual is not None and (residual.shape != x.shape
                                 or not residual.is_contiguous()):
        raise ValueError("row_quant: residual must match x and be contiguous")
    if ln is not None:
        for t in ln:
            _native.check_tensor(t, torch.float32, (n,), "ln")
    dev = x.device
    codes = torch.empty(m, n, dtype=torch.int8, device=dev) if quant else None
    scales = torch.empty(m, dtype=torch.float32, device=dev) if quant else None
    y32 = torch.empty(m, n, dtype=torch.float32, device=dev) if out_f32 else None
    y16 = torch.empty(m, n, dtype=torch.bfloat16, device=dev) if out_bf16 else None
    if m == 0:
        return codes, scales, y32, y16
    kernel = _row_quant_kernel()
    block = max(16, 1 << (n - 1).bit_length())
    dummy = x
    kernel[(m,)](
        x, residual if residual is not None else dummy,
        ln[0] if ln is not None else dummy, ln[1] if ln is not None else dummy,
        codes if quant else dummy, scales if quant else dummy,
        y32 if out_f32 else dummy, y16 if out_bf16 else dummy, n, eps,
        HAS_RES=residual is not None, DO_LN=ln is not None, QUANT=quant,
        OUT_F32=out_f32, OUT_BF16=out_bf16, BLOCK=block,
        num_warps=min(16, max(4, block // 256)), enable_fp_fusion=False)
    row_quant.launches += 1
    return codes, scales, y32, y16


row_quant.launches = 0


# --- K3: small_s_attention ---------------------------------------------------

_ATTN_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_float,
                                                           ctypes.c_void_p]


def _small_s_attention_plain(qkv, mask, num_heads):
    m, h3 = qkv.shape
    h = h3 // 3
    b, s = mask.shape
    d = h // num_heads
    q, k, v = (t.transpose(1, 2) for t in
               qkv.float().view(b, s, 3, num_heads, d).unbind(2))
    sc = (q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(d))
    sc = sc + torch.where(mask > 0, 0.0, -1e9).float()[:, None, None, :]
    sc = sc - sc.amax(dim=-1, keepdim=True)
    e = torch.exp(sc)
    p = (e / e.sum(dim=-1, keepdim=True)).to(torch.bfloat16).float()
    return (p @ v).transpose(1, 2).reshape(m, h)


def small_s_attention(qkv: torch.Tensor, mask: torch.Tensor,
                      num_heads: int) -> torch.Tensor:
    """Softmax attention of each (sequence, head), S <= 512.

    qkv [B*S, 3H] bf16 holds q | k | v (head ``i`` at columns ``i*d``);
    mask [B, S] is the 1/0 key mask. -> context [B*S, H] f32.
    """
    if not qkv.is_cuda:
        return _small_s_attention_plain(qkv, mask, num_heads)
    b, s = mask.shape
    m, h3 = qkv.shape
    h = h3 // 3
    d = h // num_heads
    _native.check_tensor(qkv, torch.bfloat16, (b * s, h3), "qkv")
    if h3 % 3 or d * num_heads != h or d not in (32, 64, 128):
        raise ValueError(f"small_s_attention: head width {d} (H={h}, "
                         f"{num_heads} heads) must be 32, 64 or 128")
    if not 1 <= s <= 512 or b > 65535:
        raise ValueError(f"small_s_attention takes 1 <= S <= 512 and at most "
                         f"65535 sequences per call (got S={s}, B={b})")
    mask32 = mask.to(device=qkv.device, dtype=torch.int32).contiguous()
    ctx = torch.empty(m, h, dtype=torch.float32, device=qkv.device)
    if b == 0:
        return ctx
    fn = _native.function("small_s_attention", "sx_small_s_attention",
                          _ATTN_ARGS)
    code = fn(_native.ptr(qkv), _native.ptr(mask32), _native.ptr(ctx), b, s,
              h, d, 1.0 / math.sqrt(d), _native.stream(qkv.device))
    _native.check("small_s_attention", code, "small_s_attention")
    small_s_attention.launches += 1
    return ctx


small_s_attention.launches = 0


# --- the layer ---------------------------------------------------------------


@dataclasses.dataclass
class QuantizedLayer:
    """One layer's weights as the kernels take them: int8 [out, in] with
    f32 per-output-channel scales, f32 biases and LayerNorm vectors."""

    wqkv: torch.Tensor
    sqkv: torch.Tensor
    bqkv: torch.Tensor
    wo: torch.Tensor
    so: torch.Tensor
    bo: torch.Tensor
    ln1: Tuple[torch.Tensor, torch.Tensor]
    w1: torch.Tensor
    s1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    s2: torch.Tensor
    b2: torch.Tensor
    ln2: Tuple[torch.Tensor, torch.Tensor]


def quantize_layer(params: Dict[str, torch.Tensor]) -> QuantizedLayer:
    """Quantize a layer's f32 weights (per output channel, the TPU kernel's
    ``quantize_weight``). q, k and v are concatenated along the output
    channels, which leaves every channel's codes and scale unchanged."""
    def f32(name):
        return params[name].detach().float().contiguous()

    def q(name):
        w8, s = quantize_weight(f32(name))
        return w8.contiguous(), s.contiguous()

    (wq, sq), (wk, sk), (wv, sv) = q("wq"), q("wk"), q("wv")
    wo, so = q("wo")
    w1, s1 = q("w1")
    w2, s2 = q("w2")
    return QuantizedLayer(
        wqkv=torch.cat([wq, wk, wv]).contiguous(),
        sqkv=torch.cat([sq, sk, sv]).contiguous(),
        bqkv=torch.cat([f32("bq"), f32("bk"), f32("bv")]).contiguous(),
        wo=wo, so=so, bo=f32("bo"),
        ln1=(f32("ln1_scale"), f32("ln1_bias")),
        w1=w1, s1=s1, b1=f32("b1"), w2=w2, s2=s2, b2=f32("b2"),
        ln2=(f32("ln2_scale"), f32("ln2_bias")))


def _compose(x, attention_mask, ql: QuantizedLayer, num_heads, eps,
             linear: Callable, quant: Callable, attend: Callable):
    b, s, h = x.shape
    x2 = x.reshape(b * s, h).contiguous()
    if attention_mask is None:
        attention_mask = torch.ones(b, s, dtype=torch.int32, device=x.device)
    out_f32 = x.dtype == torch.float32
    xq, xs, _, _ = quant(x2)
    qkv = linear(xq, xs, ql.wqkv, ql.sqkv, ql.bqkv,
                 out_dtype=torch.bfloat16)
    ctx = attend(qkv, attention_mask, num_heads)
    cq, cs, _, _ = quant(ctx)
    attn = linear(cq, cs, ql.wo, ql.so, ql.bo)
    yq, ys, y1, _ = quant(attn, residual=x2, ln=ql.ln1, eps=eps, out_f32=True)
    mid = linear(yq, ys, ql.w1, ql.s1, ql.b1, gelu=True)
    mq, ms, _, _ = quant(mid)
    ffn = linear(mq, ms, ql.w2, ql.s2, ql.b2)
    _, _, o32, o16 = quant(ffn, residual=y1, ln=ql.ln2, eps=eps, quant=False,
                           out_f32=out_f32, out_bf16=not out_f32)
    return (o32 if out_f32 else o16).to(x.dtype).reshape(b, s, h)


def fused_encoder_layer_int8(x: torch.Tensor,
                             attention_mask: Optional[torch.Tensor],
                             params: Optional[Dict[str, torch.Tensor]] = None,
                             *, num_heads: int, layer_norm_eps: float = 1e-12,
                             quantized: Optional[QuantizedLayer] = None
                             ) -> torch.Tensor:
    """One post-LN BERT layer with int8 projections (encode only).

    x [B, S, H] (bf16 or f32; the output has its dtype), attention_mask
    [B, S] 1/0 or None. Pass raw ``params`` or a cached ``quantized``.
    """
    ql = quantized if quantized is not None else quantize_layer(params)
    return _compose(x, attention_mask, ql, num_heads, layer_norm_eps,
                    int8_linear, row_quant, small_s_attention)


def layer_int8_plain(x: torch.Tensor, attention_mask: Optional[torch.Tensor],
                     quantized: QuantizedLayer, *, num_heads: int,
                     layer_norm_eps: float = 1e-12) -> torch.Tensor:
    """The whole quantized layer in plain PyTorch on any device: the same
    composition over the kernels' plain versions."""
    def linear(a8, xs, w8, ws, b, gelu=False, out_dtype=torch.float32):
        return _int8_linear_plain(a8, xs, w8, ws, b, gelu, out_dtype)

    def quant(x, residual=None, ln=None, eps=1e-12, quant=True,
              out_f32=False, out_bf16=False):
        return _row_quant_plain(x, residual, ln, eps, quant, out_f32,
                                out_bf16)

    return _compose(x, attention_mask, quantized, num_heads, layer_norm_eps,
                    linear, quant, _small_s_attention_plain)


def layer_reference(x: torch.Tensor, attention_mask: Optional[torch.Tensor],
                    params: Dict[str, torch.Tensor], *, num_heads: int,
                    layer_norm_eps: float = 1e-12) -> torch.Tensor:
    """The unquantized f32 layer the int8 one approximates (test oracle)."""
    b, s, h = x.shape
    d = h // num_heads
    xf = x.float()

    def dense(w, bias, t):
        return t @ params[w].float().T + params[bias].float()

    def heads(t):
        return t.reshape(b, s, num_heads, d).transpose(1, 2)

    q = heads(dense("wq", "bq", xf))
    k = heads(dense("wk", "bk", xf))
    v = heads(dense("wv", "bv", xf))
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(d)
    if attention_mask is not None:
        scores = scores + torch.where(attention_mask > 0, 0.0, -1e9
                                      ).float()[:, None, None, :]
    ctx = (torch.softmax(scores, dim=-1) @ v).transpose(1, 2).reshape(b, s, h)
    y1 = _layer_norm(dense("wo", "bo", ctx) + xf, params["ln1_scale"].float(),
                     params["ln1_bias"].float(), layer_norm_eps)
    mid = torch.nn.functional.gelu(dense("w1", "b1", y1))
    out = _layer_norm(dense("w2", "b2", mid) + y1, params["ln2_scale"].float(),
                      params["ln2_bias"].float(), layer_norm_eps)
    return out.to(x.dtype)
