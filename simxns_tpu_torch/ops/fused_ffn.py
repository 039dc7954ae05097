"""The fused feed-forward kernels, GELU and int8 helpers, and the FFN knobs.

Port of ``simxns_tpu/ops/fused_ffn.py``. Weights here are in ``nn.Linear``
layout (``w1`` [F, H], ``w2`` [H, F]), so "per output channel" is per row.

Four of its Pallas kernels are hand-written CUDA kernels
(``csrc/fused_ffn.cu``), each with its plain PyTorch version beside its
wrapper and a launch count in ``<wrapper>.launches``:

- K9 :func:`ffn_train_fwd` replaces ``_ffn_train_fwd_kernel`` (:324);
- K10 :func:`ffn_bwd_dx` replaces ``_ffn_bwd_dx_kernel`` (:348);
- K11 :func:`ffn_bwd_dw` replaces ``_ffn_bwd_dw_kernel`` (:374);
- K12 :func:`ffn_fused_fwd` replaces ``_ffn_kernel`` (:77).

Their arithmetic is the TPU kernels': f32 accumulation, each product
rounded to the activation dtype before the bias is added in that dtype,
GELU and its derivative in f32 from the rounded pre-activation ``hb`` with
the Abramowitz-Stegun erf (:func:`erf_as`), ``g`` and ``dh`` rounded before
their second product, the weight gradients in f32. A wrapper launches its
kernel for a CUDA tensor (bf16 only, H in 256, 768, 1024, F a multiple of
128, any M; anything else raises ``ValueError``) and runs its plain version
only for a CPU tensor.

:func:`fused_ffn_vjp` (``ffn_impl="fused_vjp"``, K9 forward, K10 + K11
backward, one [M, F] residual) and :func:`fused_ffn` (``ffn_impl="fused"``,
K12 forward, the backward of :func:`ffn_reference`) keep the JAX names and
argument order. For CPU tensors they keep the JAX dispatch too: where the
shapes do not tile (:func:`_train_tiles`, :func:`_fused_tile`) they return
:func:`ffn_reference`, the composition ``ffn_impl="xla"`` runs. For CUDA
tensors there is no such way out: the kernels mask their ragged edge, so
every M launches them, and a width they do not take raises.

The int8 encode kernels (``csrc/int8_ffn.cu``) replace the other two:

- K13 :func:`int8_dense_fwd` replaces ``_dense_int8_kernel`` (:222);
- K14 :func:`int8_ffn_fwd` replaces ``_ffn_int8_kernel`` (:160).

Their arithmetic is the TPU kernels': per-row int8 of the activations and
per-output-channel int8 of the weights (:func:`quant_rows`), exact int32
products, the f32 dequantization ``(acc * xs) * ws + b``, GELU with the
A&S erf on the unrounded f32 ``h``, one rounding to the activation dtype at
the end. :func:`int8_ffn` (``ffn_impl="int8"``) and :func:`int8_dense`
(``proj_impl="int8"``) keep the JAX names and the JAX dispatch on BOTH
devices: where the shapes do not tile they return the unquantized
expression (:func:`ffn_reference`, :func:`linear_dt`), as the JAX package
does; where they tile, a CUDA tensor launches K14 / K13 or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from simxns_tpu_torch.ops import _native

_TILE_M = 256                 # simxns_tpu/ops/fused_ffn.py:41
_TILE_TRAIN_M = 256           # :310
_F_BLOCK = 768                # :311
_KERNEL_H = (256, 768, 1024)  # csrc/fused_ffn.cu: the widths the chained
                              # kernel is built for (the [32, H] f32 sum of
                              # a block lives in its registers)
_TRAIN_FWD, _FWD, _BWD_DX = 0, 1, 2   # csrc/fused_ffn.cu Mode
_CHAIN_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_DW_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_TILE_INT8_FFN_M = 256        # int8_ffn's tile_m (:177)
_TILE_INT8_DENSE_M = 512      # int8_dense's tile_m (:231)
_INT8_DENSE_K = (128, 1024)   # csrc/int8_ffn.cu: a block's rows of x are
                              # quantized in registers, one warp a row
_DENSE8_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_FFN8_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


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


def gelu_grad(h: torch.Tensor) -> torch.Tensor:
    """f32 d gelu / dh = Phi(h) + h phi(h) with the kernels' erf
    (``_gelu_and_deriv``, :314-321)."""
    cdf = 0.5 * (1.0 + erf_as(h * 0.7071067811865476))
    pdf = 0.3989422804014327 * torch.exp(-0.5 * h * h)
    return cdf + h * pdf


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


def linear_dt(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              dt: torch.dtype) -> torch.Tensor:
    """flax ``Dense(dtype=dt)`` with an ``nn.Linear`` weight: operands cast
    to ``dt``, f32 accumulation, result rounded to ``dt``, then the ``dt``
    bias added. On the card a ``dt`` GEMM with f32 accumulation; on the CPU
    the operands are upcast and the result rounded, the same values."""
    if x.is_cuda:
        y = torch.matmul(x.to(dt), weight.to(dt).T)
    else:
        y = torch.matmul(x.to(dt).float(), weight.to(dt).float().T).to(dt)
    return y + bias.to(dt)


def ffn_reference(x, w1, b1, w2, b2):
    """Two dense layers around exact (true erf) GELU, the composition of
    ``ffn_impl="xla"`` (``ffn_reference``, :44-55): what the fused knobs
    return for CPU tensors whose shapes do not tile, and the expression whose
    backward :func:`fused_ffn` takes."""
    dt = x.dtype
    h = linear_dt(x, w1, b1, dt)
    g = torch.nn.functional.gelu(h.float()).to(dt)
    return linear_dt(g, w2, b2, dt)


# --- the tiling rules (the dispatch of the JAX package) ----------------------

def _tile(m: int, lanes: Tuple[int, ...], tile_m: int,
          sub: int) -> Optional[int]:
    """The TPU kernels' tiling rule: the token tile, or None where a lane
    dim is off the 128 grid or the token dim is no multiple of the tile
    (they then take the XLA expression)."""
    tile = min(tile_m, max(sub, -(-m // sub) * sub))
    return None if (any(d % 128 for d in lanes) or m % tile) else tile


def _fused_tile(m: int, h: int, f: int) -> Optional[int]:
    """``fused_ffn``'s token tile, or None -> :func:`ffn_reference`
    (:579-581)."""
    return _tile(m, (h, f), _TILE_M, 16)


def _train_tiles(m: int, h: int, f: int) -> Optional[Tuple[int, int]]:
    """(tile_m, f_block) of the train kernels, or None ->
    :func:`ffn_reference` (:395-409): the f-block is the largest multiple
    of 128 up to 768 that divides F (F=3072 -> 768, F=4096 -> 512). The
    rule decides for CPU tensors only, where both packages then run the
    same arithmetic; the CUDA kernels take any M and chunk F by 128."""
    tile = _tile(m, (h, f), _TILE_TRAIN_M, 16)
    if tile is None:
        return None
    fb = next(c for c in range(min(_F_BLOCK, f), 127, -128) if f % c == 0)
    return tile, fb


# --- the plain versions ------------------------------------------------------

def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The f32 product of two activation-dtype operands."""
    return a.float() @ b.float()


def _ffn_train_fwd_plain(x, w1, b1, w2, b2):
    dt = x.dtype
    hb = _mm(x, w1.T).to(dt) + b1
    g = gelu_exact(hb.float()).to(dt)
    return _mm(g, w2.T).to(dt) + b2, hb


def _ffn_bwd_dx_plain(dy, w1, w2, hb):
    dt = dy.dtype
    dh = (_mm(dy, w2) * gelu_grad(hb.float())).to(dt)
    return _mm(dh, w1).to(dt), dh


def _ffn_bwd_dw_plain(x, dy, hb, dh):
    g = gelu_exact(hb.float()).to(hb.dtype)
    return _mm(dh.T, x), dh.float().sum(dim=0), _mm(dy.T, g)


# --- K9-K12 ------------------------------------------------------------------

def _kernel_dims(what: str, x: torch.Tensor, f: int):
    """(M, H, F) of a kernel call on x [M, H], or raise on what the kernels
    do not take: another dtype than bf16, a width the chained kernel is not
    built for, F off the 128 grid."""
    m, h = x.shape
    if x.dtype != torch.bfloat16:
        raise ValueError(
            f"{what}: the CUDA kernels take bfloat16 activations, got "
            f"{x.dtype}; cast to bfloat16, or run float32 on the CPU")
    if m < 1 or h not in _KERNEL_H or f < 128 or f % 128:
        raise ValueError(
            f"{what}: the CUDA kernels take H in {_KERNEL_H}, F a multiple "
            f"of 128 and at least one row, got M={m}, H={h}, F={f}")
    return m, h, f


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else _native.ptr(t)


def _chain(what, mode, a, b1m, bias1, b2m, bias2, res_in, dims):
    """Launch the chained kernel of csrc/fused_ffn.cu; -> (out, res_out)."""
    m, h, f = dims
    bf = torch.bfloat16
    _native.check_tensor(a, bf, (m, h), f"{what}: activations")
    first, second = ((h, f), (f, h)) if mode == _BWD_DX else ((f, h), (h, f))
    _native.check_tensor(b1m, bf, first, f"{what}: first weight")
    _native.check_tensor(b2m, bf, second, f"{what}: second weight")
    if mode == _BWD_DX:
        _native.check_tensor(res_in, bf, (m, f), f"{what}: hb")
    else:
        _native.check_tensor(bias1, bf, (f,), f"{what}: b1")
        _native.check_tensor(bias2, bf, (h,), f"{what}: b2")
    out = torch.empty(m, h, dtype=bf, device=a.device)
    res_out = (None if mode == _FWD
               else torch.empty(m, f, dtype=bf, device=a.device))
    fn = _native.function("fused_ffn", "sx_ffn_chain", _CHAIN_ARGS)
    code = fn(_ptr(a), _ptr(b1m), _ptr(bias1), _ptr(b2m), _ptr(bias2),
              _ptr(res_in), _ptr(out), _ptr(res_out), m, h, f, mode,
              _native.stream(a.device))
    _native.check("fused_ffn", code, what)
    return out, res_out


def ffn_train_fwd(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                  w2: torch.Tensor, b2: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K9: the training forward. x [M, H], w1 [F, H], b1 [F], w2 [H, F],
    b2 [H], all in the activation dtype. -> (y [M, H], hb [M, F]):
    ``hb = dt(x w1^T) + b1`` is the one residual of the backward,
    ``y = dt(dt(gelu(f32(hb))) w2^T) + b2``."""
    if not x.is_cuda:
        return _ffn_train_fwd_plain(x, w1, b1, w2, b2)
    dims = _kernel_dims("ffn_train_fwd", x, w1.shape[0])
    out = _chain("ffn_train_fwd", _TRAIN_FWD, x, w1, b1, w2, b2, None, dims)
    ffn_train_fwd.launches += 1
    return out


ffn_train_fwd.launches = 0


def ffn_fused_fwd(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                  w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """K12: the forward of :func:`ffn_train_fwd` without ``hb``: the [M, F]
    intermediate never reaches device memory."""
    if not x.is_cuda:
        return _ffn_train_fwd_plain(x, w1, b1, w2, b2)[0]
    dims = _kernel_dims("ffn_fused_fwd", x, w1.shape[0])
    y, _ = _chain("ffn_fused_fwd", _FWD, x, w1, b1, w2, b2, None, dims)
    ffn_fused_fwd.launches += 1
    return y


ffn_fused_fwd.launches = 0


def ffn_bwd_dx(dy: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
               hb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K10: dy [M, H], w1 [F, H], w2 [H, F], hb [M, F]. -> (dx [M, H],
    dh [M, F]): ``dh = dt((dy w2) * gelu'(f32(hb)))``, ``dx = dt(dh w1)``;
    ``dy w2`` stays on the chip. Both products contract over the weights'
    rows; the kernel reads the weights as they lie and transposes the
    fragments on their way out of shared memory, so nothing is transposed
    in device memory."""
    if not dy.is_cuda:
        return _ffn_bwd_dx_plain(dy, w1, w2, hb)
    dims = _kernel_dims("ffn_bwd_dx", dy, w1.shape[0])
    out = _chain("ffn_bwd_dx", _BWD_DX, dy, w2, None, w1, None, hb, dims)
    ffn_bwd_dx.launches += 1
    return out


ffn_bwd_dx.launches = 0


def ffn_bwd_dw(x: torch.Tensor, dy: torch.Tensor, hb: torch.Tensor,
               dh: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K11: x, dy [M, H]; hb, dh [M, F]. -> f32 (dw1 [F, H], db1 [F],
    dw2 [H, F]): ``dw1 = dh^T x``, ``db1 = sum_m f32(dh)``,
    ``dw2 = dy^T dt(gelu(f32(hb)))``, each sum over M in one block (the
    same bits every run)."""
    if not x.is_cuda:
        return _ffn_bwd_dw_plain(x, dy, hb, dh)
    m, h, f = _kernel_dims("ffn_bwd_dw", x, dh.shape[1])
    bf = torch.bfloat16
    _native.check_tensor(x, bf, (m, h), "ffn_bwd_dw: x")
    _native.check_tensor(dy, bf, (m, h), "ffn_bwd_dw: dy")
    _native.check_tensor(hb, bf, (m, f), "ffn_bwd_dw: hb")
    _native.check_tensor(dh, bf, (m, f), "ffn_bwd_dw: dh")
    dw1 = torch.empty(f, h, dtype=torch.float32, device=x.device)
    db1 = torch.empty(f, dtype=torch.float32, device=x.device)
    dw2 = torch.empty(h, f, dtype=torch.float32, device=x.device)
    fn = _native.function("fused_ffn", "sx_ffn_bwd_dw", _DW_ARGS)
    code = fn(_ptr(x), _ptr(dy), _ptr(hb), _ptr(dh), _ptr(dw1), _ptr(db1),
              _ptr(dw2), m, h, f, _native.stream(x.device))
    _native.check("fused_ffn", code, "ffn_bwd_dw")
    ffn_bwd_dw.launches += 1
    return dw1, db1, dw2


ffn_bwd_dw.launches = 0


# --- the two knobs under autograd --------------------------------------------

class _FusedFFNTrain(torch.autograd.Function):
    """``_fused_train`` (:413-539): K9 forward, K10 + K11 backward. Saves
    ``(x, w1, w2, hb)`` with the weights in the activation dtype: one
    [M, F] residual. Under ``torch.utils.checkpoint`` the forward runs
    again in the backward pass and ``hb`` lives only from there to K11."""

    @staticmethod
    def forward(ctx, x2d, w1, b1, w2, b2):
        dt = x2d.dtype
        x2d = x2d.contiguous()
        w1d, w2d = w1.to(dt), w2.to(dt)
        y, hb = ffn_train_fwd(x2d, w1d, b1.to(dt), w2d, b2.to(dt))
        ctx.save_for_backward(x2d, w1d, w2d, hb)
        ctx.param_dtypes = (w1.dtype, b1.dtype, w2.dtype, b2.dtype)
        return y

    @staticmethod
    def backward(ctx, dy):
        x2d, w1d, w2d, hb = ctx.saved_tensors
        dy = dy.to(x2d.dtype).contiguous()
        dx, dh = ffn_bwd_dx(dy, w1d, w2d, hb)
        dw1, db1, dw2 = ffn_bwd_dw(x2d, dy, hb, dh)
        db2 = dy.float().sum(dim=0)
        t1, tb1, t2, tb2 = ctx.param_dtypes
        return dx, dw1.to(t1), db1.to(tb1), dw2.to(t2), db2.to(tb2)


class _FusedFFN(torch.autograd.Function):
    """``_fused`` (:117-132): K12 forward; the backward differentiates
    :func:`ffn_reference` from the saved inputs (library GEMMs, as the JAX
    package leaves them to XLA)."""

    @staticmethod
    def forward(ctx, x2d, w1, b1, w2, b2):
        dt = x2d.dtype
        ctx.save_for_backward(x2d, w1, b1, w2, b2)
        return ffn_fused_fwd(x2d.contiguous(), w1.to(dt), b1.to(dt),
                             w2.to(dt), b2.to(dt))

    @staticmethod
    def backward(ctx, dy):
        with torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            y = ffn_reference(*ins)
        return torch.autograd.grad(y, ins, dy.to(y.dtype))


def _flat(x: torch.Tensor):
    lead, h = x.shape[:-1], x.shape[-1]
    return lead, x.numel() // h, h


def fused_ffn_vjp(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                  w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """The fused FFN over [..., H] with its own backward (the TRAIN path,
    ``fused_ffn_vjp`` :542-562). For CPU tensors :func:`ffn_reference`
    where the shapes do not tile, as in JAX; CUDA tensors always reach the
    kernels, which take them or raise."""
    lead, m, h = _flat(x)
    if not x.is_cuda and _train_tiles(m, h, w1.shape[0]) is None:
        return ffn_reference(x, w1, b1, w2, b2)
    y = _FusedFFNTrain.apply(x.reshape(m, h), w1, b1, w2, b2)
    return y.reshape(*lead, h)


def fused_ffn(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """The fused FFN over [..., H] (the encode path, ``fused_ffn``
    :565-583). For CPU tensors :func:`ffn_reference` where the shapes do
    not tile, as in JAX; CUDA tensors always reach the kernel, which takes
    them or raises."""
    lead, m, h = _flat(x)
    if not x.is_cuda and _fused_tile(m, h, w1.shape[0]) is None:
        return ffn_reference(x, w1, b1, w2, b2)
    y = _FusedFFN.apply(x.reshape(m, h), w1, b1, w2, b2)
    return y.reshape(*lead, h)




# --- K13, K14: the int8 encode kernels --------------------------------------

def int8_ffn_tile(m: int, h: int, f: int) -> Optional[int]:
    """``int8_ffn``'s token tile, or None -> :func:`ffn_reference`
    (:190-192; the int8 sublane tile is 32 rows)."""
    return _tile(m, (h, f), _TILE_INT8_FFN_M, 32)


def int8_dense_tile(m: int, i: int, o: int) -> Optional[int]:
    """``int8_dense``'s token tile, or None -> the unquantized dense
    (:247-251). ``o`` and ``3 o`` tile together (gcd(3, 128) = 1), so q, k
    and v tile as one call exactly where they tile as three."""
    return _tile(m, (i, o), _TILE_INT8_DENSE_M, 32)


def _int8_dense_plain(x, w8, ws, b):
    xq, xs = quant_rows(x)
    return (int8_matmul(xq, w8).float() * xs[:, None] * ws + b).to(x.dtype)


def _int8_ffn_plain(x, w1_8, s1, b1, w2_8, s2, b2):
    xq, xs = quant_rows(x)
    h = int8_matmul(xq, w1_8).float() * xs[:, None] * s1 + b1
    gq, gs = quant_rows(gelu_exact(h))
    y = int8_matmul(gq, w2_8).float() * gs[:, None] * s2 + b2
    return y.to(x.dtype)


def _check_scales(what, pairs):
    for name, t, size in pairs:
        _native.check_tensor(t, torch.float32, (size,), f"{what}: {name}")


def int8_dense_fwd(x: torch.Tensor, w8: torch.Tensor, ws: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """K13: x [M, I], w8 [O, I] int8 with per-output-channel scales ws [O],
    b [O] f32. -> ``y = (acc * xs) * ws + b`` [M, O] in x's dtype, with
    ``(codes, xs) = quant_rows(x)`` and ``acc`` their exact int32 product
    with w8; the codes never reach device memory. On the card: bf16 x,
    I a multiple of 128 up to 1024, O a multiple of 128."""
    if not x.is_cuda:
        return _int8_dense_plain(x, w8, ws, b)
    m, i = x.shape
    o = w8.shape[0]
    lo, hi = _INT8_DENSE_K
    if x.dtype != torch.bfloat16:
        raise ValueError(f"int8_dense_fwd: the CUDA kernel takes bfloat16 "
                         f"activations, got {x.dtype}")
    if m < 1 or i % 128 or not lo <= i <= hi or o < 128 or o % 128:
        raise ValueError(
            f"int8_dense_fwd: the CUDA kernel takes I a multiple of 128 in "
            f"[{lo}, {hi}], O a multiple of 128 and at least one row, got "
            f"M={m}, I={i}, O={o}")
    _native.check_tensor(x, torch.bfloat16, (m, i), "int8_dense_fwd: x")
    _native.check_tensor(w8, torch.int8, (o, i), "int8_dense_fwd: w8")
    _check_scales("int8_dense_fwd", (("ws", ws, o), ("b", b, o)))
    out = torch.empty(m, o, dtype=torch.bfloat16, device=x.device)
    fn = _native.function("int8_ffn", "sx_int8_dense", _DENSE8_ARGS)
    code = fn(_ptr(x), _ptr(w8), _ptr(ws), _ptr(b), _ptr(out), m, i, o,
              _native.stream(x.device))
    _native.check("int8_ffn", code, "int8_dense_fwd")
    int8_dense_fwd.launches += 1
    return out


int8_dense_fwd.launches = 0


def int8_ffn_fwd(x: torch.Tensor, w1_8: torch.Tensor, s1: torch.Tensor,
                 b1: torch.Tensor, w2_8: torch.Tensor, s2: torch.Tensor,
                 b2: torch.Tensor) -> torch.Tensor:
    """K14: x [M, H]; w1_8 [F, H], w2_8 [H, F] int8 with per-output-channel
    scales s1 [F], s2 [H]; b1 [F], b2 [H] f32. -> y [M, H] in x's dtype:
    ``h = (acc1 * xs) * s1 + b1``, ``g = gelu(h)`` (A&S erf, f32),
    ``(gq, gs) = quant_rows(g)`` over all of F, ``y = (acc2 * gs) * s2 +
    b2``; the [M, F] intermediate never reaches device memory. On the card:
    bf16 x, H in 256, 768, 1024, F a multiple of 128."""
    if not x.is_cuda:
        return _int8_ffn_plain(x, w1_8, s1, b1, w2_8, s2, b2)
    m, h, f = _kernel_dims("int8_ffn_fwd", x, w1_8.shape[0])
    _native.check_tensor(x, torch.bfloat16, (m, h), "int8_ffn_fwd: x")
    _native.check_tensor(w1_8, torch.int8, (f, h), "int8_ffn_fwd: w1_8")
    _native.check_tensor(w2_8, torch.int8, (h, f), "int8_ffn_fwd: w2_8")
    _check_scales("int8_ffn_fwd", (("s1", s1, f), ("b1", b1, f),
                                   ("s2", s2, h), ("b2", b2, h)))
    out = torch.empty(m, h, dtype=torch.bfloat16, device=x.device)
    fn = _native.function("int8_ffn", "sx_int8_ffn", _FFN8_ARGS)
    code = fn(_ptr(x), _ptr(w1_8), _ptr(s1), _ptr(b1), _ptr(w2_8), _ptr(s2),
              _ptr(b2), _ptr(out), m, h, f, _native.stream(x.device))
    _native.check("int8_ffn", code, "int8_ffn_fwd")
    int8_ffn_fwd.launches += 1
    return out


int8_ffn_fwd.launches = 0


def int8_ffn(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
             w2: torch.Tensor, b2: torch.Tensor, *,
             quantized: Optional[tuple] = None) -> torch.Tensor:
    """The int8 FFN over [..., H] (encode only; ``int8_ffn`` :175-219).

    Where the shapes tile (:func:`int8_ffn_tile`) K14 over the weights'
    per-channel codes, ``quantized = (w1_8, s1, b1, w2_8, s2, b2)`` (f32
    biases) where the caller keeps them, else quantized here as the JAX
    package does per call (:193-194). Where they do not tile,
    :func:`ffn_reference`, the unquantized composition the JAX package
    returns there (:191-192): on both devices, because it is another
    function than K14's, not a way around a failure. A CUDA tensor at a
    tiling shape launches K14 or raises."""
    lead, m, h = _flat(x)
    if int8_ffn_tile(m, h, w1.shape[0]) is None:
        return ffn_reference(x, w1, b1, w2, b2)
    if quantized is None:
        quantized = (*quantize_weight(w1), b1.float(),
                     *quantize_weight(w2), b2.float())
    y = int8_ffn_fwd(x.reshape(m, h).contiguous(), *quantized)
    return y.reshape(*lead, h)


def int8_dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
               quantized: Optional[tuple] = None) -> torch.Tensor:
    """The int8 dense ``x w^T + b`` over [..., I] (encode only;
    ``int8_dense`` :230-273), with ``w`` [O, I] in ``nn.Linear`` layout.

    Where the shapes tile (:func:`int8_dense_tile`) K13 over ``quantized =
    (w8, ws, b)`` (f32 bias) or the weight quantized here; where they do
    not, the unquantized dense (:func:`linear_dt`), as the JAX package
    returns there (:247-251), on both devices. A CUDA tensor at a tiling
    shape launches K13 or raises."""
    lead, m, i = _flat(x)
    o = w.shape[0]
    if int8_dense_tile(m, i, o) is None:
        return linear_dt(x, w, b, x.dtype)
    if quantized is None:
        quantized = (*quantize_weight(w), b.float())
    y = int8_dense_fwd(x.reshape(m, i).contiguous(), *quantized)
    return y.reshape(*lead, o)


_FFN_IMPLS = {"fused": fused_ffn, "fused_vjp": fused_ffn_vjp,
              "int8": int8_ffn}


def ffn(x: torch.Tensor, w1, b1, w2, b2, impl: str) -> torch.Tensor:
    """``BertConfig.ffn_impl`` in {fused, fused_vjp, int8}."""
    return _FFN_IMPLS[impl](x, w1, b1, w2, b2)
