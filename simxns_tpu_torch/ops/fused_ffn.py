"""The fused feed-forward kernels, GELU and int8 helpers, and the FFN knobs.

Port of ``simxns_tpu/ops/fused_ffn.py``. Weights here are in ``nn.Linear``
layout (``w1`` [F, H], ``w2`` [H, F]), so "per output channel" is per row.

Four of its Pallas kernels are hand-written CUDA kernels, each with its
plain PyTorch version beside its wrapper and a launch count in
``<wrapper>.launches`` (one a wrapper call, however many launches the call
makes on the card):

- K9 :func:`ffn_train_fwd` replaces ``_ffn_train_fwd_kernel`` (:324);
- K10 :func:`ffn_bwd_dx` replaces ``_ffn_bwd_dx_kernel`` (:348);
- K11 :func:`ffn_bwd_dw` replaces ``_ffn_bwd_dw_kernel`` (:374);
- K12 :func:`ffn_fused_fwd` replaces ``_ffn_kernel`` (:77).

All four run on the persistent wgmma GEMM (``csrc/wgmma_gemm.cuh``). K9 and
K12 are two launches each (``csrc/ffn_fwd.cu``) with their [M, F]
intermediate ``g`` in device memory (:func:`ffn_fwd_workspace`); K9's first
GEMM also stores ``hb``. K10 is two launches (``csrc/fused_ffn.cu``; both
contract over the weights' rows, read MN-major): the first stores ``dh``,
``g`` and the column sums of ``dh`` over each 64 rows, the second ``dx``.
K11 is one launch over the tiles of both weight gradients (both operands
MN-major, K = M cut into splits where the tiles leave SMs idle,
:func:`~simxns_tpu_torch.ops._native.dw_tile`) and a pass that adds db1's
parts and the splits in order. ``g`` and the parts are workspaces of the
pair (:func:`ffn_bwd_workspace`), returned by K10 and read by K11.

Their arithmetic is the TPU kernels': f32 accumulation, each product
rounded to the activation dtype before the bias is added in that dtype,
GELU and its derivative in f32 from the rounded pre-activation ``hb`` with
the Abramowitz-Stegun erf (:func:`erf_as`), ``g`` and ``dh`` rounded before
their second product, the weight gradients in f32. A wrapper launches its
kernel for a CUDA tensor (bf16 only, H and F multiples of 128, the JAX
kernels' lane grid, any M; anything else raises ``ValueError``) and runs
its plain version only for a CPU tensor.

:func:`fused_ffn_vjp` (``ffn_impl="fused_vjp"``, K9 forward, K10 + K11
backward, one [M, F] residual) and :func:`fused_ffn` (``ffn_impl="fused"``,
K12 forward, the backward of :func:`ffn_reference`) keep the JAX names,
argument order and dispatch (:func:`reaches_kernels`): where H or F is off
the 128 grid they are :func:`ffn_reference`, the composition
``ffn_impl="xla"`` runs, on both devices, as in JAX. For CPU tensors an M
that does not tile (:func:`_train_tiles`, :func:`_fused_tile`) takes it
too; on the card the kernels mask their ragged edge, so every M launches
them.

The int8 encode kernels (``csrc/int8_ffn.cu``) replace the other two:

- K13 :func:`int8_dense_fwd` replaces ``_dense_int8_kernel`` (:222): two
  launches (the codes of x, a wgmma GEMM; :func:`int8_dense_workspace`);
- K14 :func:`int8_ffn_fwd` replaces ``_ffn_int8_kernel`` (:160): four
  launches (the codes of x, a wgmma GEMM to ``g`` in f32 with its per-tile
  row maxima, the codes of g, a second wgmma GEMM;
  :func:`int8_ffn_workspace`).

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
_LANE = 128                   # the JAX kernels' lane grid for H and F
_PART_ROWS = 64               # K10: one row of db1's parts per 64 rows
_DX_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_DW_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_TILE_INT8_FFN_M = 256        # int8_ffn's tile_m (:177)
_TILE_INT8_DENSE_M = 512      # int8_dense's tile_m (:231)
_DENSE8_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_FFN8_ARGS = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_FFN_FWD_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


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
    s = _row_scale(xf.abs().amax(dim=-1))
    return _codes(xf, s), s


def _row_scale(amax: torch.Tensor) -> torch.Tensor:
    """``max(amax / 127, 1e-12)``, the quotient correctly rounded: a tensor
    divisor, because PyTorch's CUDA division by a Python scalar multiplies
    by its reciprocal, which is not the rounded quotient."""
    return torch.clamp_min(amax / torch.full_like(amax, 127.0), 1e-12)


def _codes(xf: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """int8 ``round(xf / s)`` (half to even, a true division) clipped to
    +-127, with one scale a row."""
    return torch.clamp(torch.round(xf / s.unsqueeze(-1)), -127,
                       127).to(torch.int8)


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


def linear_dt(x: torch.Tensor, weight: torch.Tensor,
              bias: Optional[torch.Tensor], dt: torch.dtype) -> torch.Tensor:
    """flax ``Dense(dtype=dt)`` with an ``nn.Linear`` weight: operands cast
    to ``dt``, f32 accumulation, result rounded to ``dt``, then the ``dt``
    bias added (None: ``use_bias=False``). On the card a ``dt`` GEMM with
    f32 accumulation; on the CPU the operands are upcast and the result
    rounded, the same values."""
    if x.is_cuda:
        y = torch.matmul(x.to(dt), weight.to(dt).T)
    else:
        y = torch.matmul(x.to(dt).float(), weight.to(dt).float().T).to(dt)
    return y if bias is None else y + bias.to(dt)


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
    of 128 up to 768 that divides F (F=3072 -> 768, F=4096 -> 512). Its M
    part decides for CPU tensors only, where both packages then run the
    same arithmetic; the CUDA kernels take any M."""
    tile = _tile(m, (h, f), _TILE_TRAIN_M, 16)
    if tile is None:
        return None
    fb = next(c for c in range(min(_F_BLOCK, f), 127, -128) if f % c == 0)
    return tile, fb


def reaches_kernels(m: int, h: int, f: int, cuda: bool, train: bool) -> bool:
    """Whether :func:`fused_ffn_vjp` (``train``) or :func:`fused_ffn` run
    their kernels for m rows of width h and F = f, on a CUDA tensor
    (``cuda``) or a CPU one; where not, they return :func:`ffn_reference`.

    The JAX package's dispatch, decided by shape alone before any launch:
    H or F off the 128 grid is ``ffn_reference`` on both devices
    (:579-581, :395-409). On the CPU an M off the token tile is too, since
    there the plain versions stand in for the JAX kernels; the CUDA kernels
    mask a ragged M, so on the card every M reaches them (and a kernel
    that fails to build or launch raises)."""
    if h % _LANE or f % _LANE:
        return False
    if cuda:
        return True
    return (_train_tiles if train else _fused_tile)(m, h, f) is not None


# --- the plain versions ------------------------------------------------------

def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The f32 product of two activation-dtype operands."""
    return a.float() @ b.float()


def _ffn_train_fwd_plain(x, w1, b1, w2, b2):
    dt = x.dtype
    hb = _mm(x, w1.T).to(dt) + b1
    g = gelu_exact(hb.float()).to(dt)
    return _mm(g, w2.T).to(dt) + b2, hb


def _column_parts(dh: torch.Tensor) -> torch.Tensor:
    """[M, F] -> [ceil(M / 64), F] f32: the column sums of dh over each 64
    rows (K10's first GEMM writes these beside dh; K11 adds them up)."""
    m, f = dh.shape
    d = dh.float()
    if m % _PART_ROWS:
        d = torch.cat([d, d.new_zeros(-m % _PART_ROWS, f)])
    return d.view(-1, _PART_ROWS, f).sum(dim=1)


def _ffn_bwd_dx_plain(dy, w1, w2, hb):
    dt = dy.dtype
    h = hb.float()
    dh = (_mm(dy, w2) * gelu_grad(h)).to(dt)
    return _mm(dh, w1).to(dt), dh, gelu_exact(h).to(dt), _column_parts(dh)


def _ffn_bwd_dw_plain(x, dy, g, dh, parts):
    return _mm(dh.T, x), parts.sum(dim=0), _mm(dy.T, g)


# --- K9-K12 ------------------------------------------------------------------

def _kernel_dims(what: str, m: int, h: int, f: int, dtype: torch.dtype):
    """(M, H, F) of a call of K9-K14 on [M, H] activations with weights of
    F rows (K13: I and O), or raise on what their GEMMs do not take:
    another dtype than bf16, a width off the 128 grid (the JAX kernels'
    lanes), no row."""
    if dtype != torch.bfloat16:
        raise ValueError(
            f"{what}: the CUDA kernels take bfloat16 activations, got "
            f"{dtype}; cast to bfloat16, or run float32 on the CPU")
    if m < 1 or h < _LANE or h % _LANE or f < _LANE or f % _LANE:
        raise ValueError(
            f"{what}: the CUDA kernels take widths that are multiples of "
            f"{_LANE} and at least one row, got M={m}, widths {h} and {f}")
    return m, h, f


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else _native.ptr(t)


def ffn_fwd_workspace(m: int, h: int, f: int, sms: int) -> dict:
    """K9's and K12's tiles and device-memory workspace for x [m, h] and
    F = f on ``sms`` SMs: ``{"tiles": ((bm1, bn1), (bm2, bn2)), "g":
    (shape, dtype)}``. The first GEMM ([m, f]) writes ``g``, which the
    second ([m, h]) reads."""
    return {"tiles": (_native.wgmma_tile(m, f, sms),
                      _native.wgmma_tile(m, h, sms)),
            "g": ((m, f), torch.bfloat16)}


def _ffn_fwd(what, x, w1, b1, w2, b2, with_hb):
    """Launch the GEMM pair of csrc/ffn_fwd.cu; -> (y, hb or None)."""
    m, h, f = _kernel_dims(what, *x.shape, w1.shape[0], x.dtype)
    bf = torch.bfloat16
    _native.check_tensor(x, bf, (m, h), f"{what}: activations")
    _native.check_tensor(w1, bf, (f, h), f"{what}: w1")
    _native.check_tensor(b1, bf, (f,), f"{what}: b1")
    _native.check_tensor(w2, bf, (h, f), f"{what}: w2")
    _native.check_tensor(b2, bf, (h,), f"{what}: b2")
    ws = ffn_fwd_workspace(m, h, f, _native.sm_count(x.device))
    shape, dt = ws["g"]
    g = torch.empty(shape, dtype=dt, device=x.device)
    hb = torch.empty(m, f, dtype=bf, device=x.device) if with_hb else None
    y = torch.empty(m, h, dtype=bf, device=x.device)
    (bm1, bn1), (bm2, bn2) = ws["tiles"]
    fn = _native.function("ffn_fwd", "sx_ffn_fwd", _FFN_FWD_ARGS)
    code = _native.launch(
            fn, x.device, _ptr(x), _ptr(w1), _ptr(b1), _ptr(w2), _ptr(b2),
            _ptr(g), _ptr(hb), _ptr(y), m, h, f, bm1, bn1, bm2, bn2)
    _native.check("ffn_fwd", code, what)
    return y, hb


def ffn_train_fwd(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                  w2: torch.Tensor, b2: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K9: the training forward. x [M, H], w1 [F, H], b1 [F], w2 [H, F],
    b2 [H], all in the activation dtype. -> (y [M, H], hb [M, F]):
    ``hb = dt(x w1^T) + b1`` is the one residual of the backward,
    ``y = dt(dt(gelu(f32(hb))) w2^T) + b2``. On the card two wgmma GEMMs,
    K12's with ``hb`` stored by the first beside ``g`` (a workspace of this
    call)."""
    if not x.is_cuda:
        return _ffn_train_fwd_plain(x, w1, b1, w2, b2)
    out = _ffn_fwd("ffn_train_fwd", x, w1, b1, w2, b2, with_hb=True)
    ffn_train_fwd.launches += 1
    return out


ffn_train_fwd.launches = 0


def ffn_fused_fwd(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                  w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """K12: the forward of :func:`ffn_train_fwd` without ``hb``. On the
    card two wgmma GEMMs: ``g = dt(gelu(f32(hb)))`` [M, F] goes through
    device memory between them (a workspace of this call)."""
    if not x.is_cuda:
        return _ffn_train_fwd_plain(x, w1, b1, w2, b2)[0]
    y, _ = _ffn_fwd("ffn_fused_fwd", x, w1, b1, w2, b2, with_hb=False)
    ffn_fused_fwd.launches += 1
    return y


ffn_fused_fwd.launches = 0


def ffn_bwd_workspace(m: int, h: int, f: int, sms: int) -> dict:
    """K10's and K11's tiles and device-memory workspaces for dy [m, h] and
    F = f on ``sms`` SMs: ``{"tiles": ((bm1, bn1), (bm2, bn2)), "dw": (bm,
    bn, splits), name: (shape, dtype)}``. K10's GEMMs ([m, f], then [m, h])
    write ``g`` = bf16(gelu(hb)) and ``parts``, the column sums of dh over
    each 64 rows; K11 (``dw``: :func:`_native.dw_tile`) reads them and,
    where it splits K, writes each split's dW1 and dW2 into ``partials``
    (empty otherwise), which its second pass adds in order."""
    bm, bn, splits = _native.dw_tile(m, h, f, sms)
    return {"tiles": (_native.wgmma_tile(m, f, sms),
                      _native.wgmma_tile(m, h, sms)),
            "dw": (bm, bn, splits),
            "g": ((m, f), torch.bfloat16),
            "parts": ((-(-m // _PART_ROWS), f), torch.float32),
            "partials": ((splits * 2 * h * f if splits > 1 else 0,),
                         torch.float32)}


def ffn_bwd_dx(dy: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
               hb: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """K10: dy [M, H], w1 [F, H], w2 [H, F], hb [M, F]. -> (dx [M, H],
    dh [M, F], g [M, F], parts [ceil(M / 64), F] f32):
    ``dh = dt((dy w2) * gelu'(f32(hb)))``, ``dx = dt(dh w1)``, and for K11
    ``g = dt(gelu(f32(hb)))`` and the column sums of dh over each 64 rows.
    On the card two wgmma GEMMs that read the weights as they lie (MN-major
    B); ``dy w2`` stays in registers, ``g`` and ``parts`` are workspaces of
    the pair (:func:`ffn_bwd_workspace`)."""
    if not dy.is_cuda:
        return _ffn_bwd_dx_plain(dy, w1, w2, hb)
    m, h, f = _kernel_dims("ffn_bwd_dx", *dy.shape, w1.shape[0], dy.dtype)
    bf = torch.bfloat16
    _native.check_tensor(dy, bf, (m, h), "ffn_bwd_dx: dy")
    _native.check_tensor(w1, bf, (f, h), "ffn_bwd_dx: w1")
    _native.check_tensor(w2, bf, (h, f), "ffn_bwd_dx: w2")
    _native.check_tensor(hb, bf, (m, f), "ffn_bwd_dx: hb")
    ws = ffn_bwd_workspace(m, h, f, _native.sm_count(dy.device))
    (bm1, bn1), (bm2, bn2) = ws["tiles"]
    g, parts = (torch.empty(ws[k][0], dtype=ws[k][1], device=dy.device)
                for k in ("g", "parts"))
    dx = torch.empty(m, h, dtype=bf, device=dy.device)
    dh = torch.empty(m, f, dtype=bf, device=dy.device)
    fn = _native.function("fused_ffn", "sx_ffn_bwd_dx", _DX_ARGS)
    code = _native.launch(
            fn, dy.device, _ptr(dy), _ptr(w1), _ptr(w2), _ptr(hb), _ptr(dx),
            _ptr(dh), _ptr(g), _ptr(parts), m, h, f, bm1, bn1, bm2, bn2)
    _native.check("fused_ffn", code, "ffn_bwd_dx")
    ffn_bwd_dx.launches += 1
    return dx, dh, g, parts


ffn_bwd_dx.launches = 0


def ffn_bwd_dw(x: torch.Tensor, dy: torch.Tensor, g: torch.Tensor,
               dh: torch.Tensor, parts: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K11: x, dy [M, H]; g, dh [M, F]; parts [ceil(M / 64), F] f32 (K10's).
    -> f32 (dw1 [F, H], db1 [F], dw2 [H, F]): ``dw1 = dh^T x``, ``db1`` the
    sum of ``parts``, ``dw2 = dy^T g``. On the card one wgmma GEMM over the
    tiles of both products (A and B MN-major: both contract over M), then
    one pass that adds db1's parts and, where K was split, the splits'
    partial products, each in a fixed order (the same bits every run)."""
    if not x.is_cuda:
        return _ffn_bwd_dw_plain(x, dy, g, dh, parts)
    m, h, f = _kernel_dims("ffn_bwd_dw", *x.shape, dh.shape[1], x.dtype)
    bf = torch.bfloat16
    _native.check_tensor(x, bf, (m, h), "ffn_bwd_dw: x")
    _native.check_tensor(dy, bf, (m, h), "ffn_bwd_dw: dy")
    _native.check_tensor(g, bf, (m, f), "ffn_bwd_dw: g")
    _native.check_tensor(dh, bf, (m, f), "ffn_bwd_dw: dh")
    _native.check_tensor(parts, torch.float32, (-(-m // _PART_ROWS), f),
                         "ffn_bwd_dw: parts")
    ws = ffn_bwd_workspace(m, h, f, _native.sm_count(x.device))
    bm, bn, splits = ws["dw"]
    partials = torch.empty(ws["partials"][0], dtype=torch.float32,
                           device=x.device)
    dw1 = torch.empty(f, h, dtype=torch.float32, device=x.device)
    db1 = torch.empty(f, dtype=torch.float32, device=x.device)
    dw2 = torch.empty(h, f, dtype=torch.float32, device=x.device)
    fn = _native.function("fused_ffn", "sx_ffn_bwd_dw", _DW_ARGS)
    code = _native.launch(
            fn, x.device, _ptr(x), _ptr(dy), _ptr(g), _ptr(dh), _ptr(parts),
            _ptr(dw1), _ptr(db1), _ptr(dw2), _ptr(partials), m, h, f, bm, bn,
            splits)
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
        dx, dh, g, parts = ffn_bwd_dx(dy, w1d, w2d, hb)
        dw1, db1, dw2 = ffn_bwd_dw(x2d, dy, g, dh, parts)
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
    ``fused_ffn_vjp`` :542-562): K9, then K10 and K11, where
    :func:`reaches_kernels`, else :func:`ffn_reference`, as in JAX."""
    lead, m, h = _flat(x)
    if not reaches_kernels(m, h, w1.shape[0], x.is_cuda, train=True):
        return ffn_reference(x, w1, b1, w2, b2)
    y = _FusedFFNTrain.apply(x.reshape(m, h), w1, b1, w2, b2)
    return y.reshape(*lead, h)


def fused_ffn(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """The fused FFN over [..., H] (the encode path, ``fused_ffn``
    :565-583): K12 where :func:`reaches_kernels`, else
    :func:`ffn_reference`, as in JAX."""
    lead, m, h = _flat(x)
    if not reaches_kernels(m, h, w1.shape[0], x.is_cuda, train=False):
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


def int8_dense_workspace(m: int, i: int, o: int, sms: int) -> dict:
    """K13's tile and device-memory workspaces for x [m, i] and O = o on
    ``sms`` SMs: ``{"tiles": (bm, bn), name: (shape, dtype)}``. The codes
    of x and their scales ``xs`` feed the GEMM ([m, o])."""
    return {"tiles": _native.wgmma_tile(m, o, sms),
            "codes": ((m, i), torch.int8), "xs": ((m,), torch.float32)}


def int8_ffn_workspace(m: int, h: int, f: int, sms: int) -> dict:
    """K14's tiles and device-memory workspaces for x [m, h] and F = f on
    ``sms`` SMs: ``{"tiles": ((bm1, bn1), (bm2, bn2)), name: (shape,
    dtype)}``. The codes of x and their scales ``xs`` feed the first GEMM
    ([m, f]), which writes ``g`` and ``parts``, each row's max |g| over
    each of its bn1-column tiles; a pass over g reduces ``parts`` to
    ``gs`` (:func:`_scales_from_parts`) and writes ``gcodes``, which the
    second GEMM ([m, h]) reads."""
    tile1, tile2 = _native.wgmma_tile(m, f, sms), _native.wgmma_tile(m, h, sms)
    return {"tiles": (tile1, tile2),
            "codes": ((m, h), torch.int8), "xs": ((m,), torch.float32),
            "g": ((m, f), torch.float32),
            "parts": ((m, -(-f // tile1[1])), torch.float32),
            "gcodes": ((m, f), torch.int8), "gs": ((m,), torch.float32)}


def _row_max_parts(g: torch.Tensor, bn: int) -> torch.Tensor:
    """[M, F] -> [M, ceil(F / bn)]: each row's max |g| over each bn-column
    tile (K14's first GEMM writes these beside g)."""
    a = g.abs()
    return torch.stack([a[:, c:c + bn].amax(dim=1)
                        for c in range(0, g.shape[1], bn)], dim=1)


def _scales_from_parts(parts: torch.Tensor) -> torch.Tensor:
    """Per-tile row maxima -> the rows' int8 scales, as :func:`quant_rows`
    gives them from the whole row (a max is exact in any order)."""
    return _row_scale(parts.amax(dim=1))


def _int8_ffn_plain(x, w1_8, s1, b1, w2_8, s2, b2):
    """K14's stages in PyTorch: the codes of x, h and g, the per-tile row
    maxima of g (256 columns a tile; any width gives the same gs), gs from
    them, the codes of g and the second product."""
    xq, xs = quant_rows(x)
    h = int8_matmul(xq, w1_8).float() * xs[:, None] * s1 + b1
    g = gelu_exact(h)
    gs = _scales_from_parts(_row_max_parts(g, 256))
    y = int8_matmul(_codes(g, gs), w2_8).float() * gs[:, None] * s2 + b2
    return y.to(x.dtype)


def _check_scales(what, pairs):
    for name, t, size in pairs:
        _native.check_tensor(t, torch.float32, (size,), f"{what}: {name}")


def int8_dense_fwd(x: torch.Tensor, w8: torch.Tensor, ws: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """K13: x [M, I], w8 [O, I] int8 with per-output-channel scales ws [O],
    b [O] f32. -> ``y = (acc * xs) * ws + b`` [M, O] in x's dtype, with
    ``(codes, xs) = quant_rows(x)`` and ``acc`` their exact int32 product
    with w8. On the card: bf16 x, I and O multiples of 128; two launches,
    the codes of x and the wgmma GEMM, with the codes and ``xs`` in device
    memory between them (:func:`int8_dense_workspace`)."""
    if not x.is_cuda:
        return _int8_dense_plain(x, w8, ws, b)
    m, i, o = _kernel_dims("int8_dense_fwd", *x.shape, w8.shape[0], x.dtype)
    _native.check_tensor(x, torch.bfloat16, (m, i), "int8_dense_fwd: x")
    _native.check_tensor(w8, torch.int8, (o, i), "int8_dense_fwd: w8")
    _check_scales("int8_dense_fwd", (("ws", ws, o), ("b", b, o)))
    out = torch.empty(m, o, dtype=torch.bfloat16, device=x.device)
    work = int8_dense_workspace(m, i, o, _native.sm_count(x.device))
    bm, bn = work.pop("tiles")
    buf = {name: torch.empty(shape, dtype=dt, device=x.device)
           for name, (shape, dt) in work.items()}
    fn = _native.function("int8_ffn", "sx_int8_dense", _DENSE8_ARGS)
    code = _native.launch(
            fn, x.device, _ptr(x), _ptr(w8), _ptr(ws), _ptr(b), _ptr(out),
            _ptr(buf["codes"]), _ptr(buf["xs"]), m, i, o, bm, bn)
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
    b2``. On the card: bf16 x, H and F multiples of 128; four launches,
    with ``g`` in f32, its per-tile row maxima and its codes in device
    memory between them (:func:`int8_ffn_workspace`)."""
    if not x.is_cuda:
        return _int8_ffn_plain(x, w1_8, s1, b1, w2_8, s2, b2)
    m, h, f = _kernel_dims("int8_ffn_fwd", *x.shape, w1_8.shape[0],
                           x.dtype)
    _native.check_tensor(x, torch.bfloat16, (m, h), "int8_ffn_fwd: x")
    _native.check_tensor(w1_8, torch.int8, (f, h), "int8_ffn_fwd: w1_8")
    _native.check_tensor(w2_8, torch.int8, (h, f), "int8_ffn_fwd: w2_8")
    _check_scales("int8_ffn_fwd", (("s1", s1, f), ("b1", b1, f),
                                   ("s2", s2, h), ("b2", b2, h)))
    out = torch.empty(m, h, dtype=torch.bfloat16, device=x.device)
    ws = int8_ffn_workspace(m, h, f, _native.sm_count(x.device))
    (bm1, bn1), (bm2, bn2) = ws.pop("tiles")
    buf = {name: torch.empty(shape, dtype=dt, device=x.device)
           for name, (shape, dt) in ws.items()}
    fn = _native.function("int8_ffn", "sx_int8_ffn", _FFN8_ARGS)
    code = _native.launch(
            fn, x.device, _ptr(x), _ptr(w1_8), _ptr(s1), _ptr(b1), _ptr(w2_8),
            _ptr(s2), _ptr(b2), _ptr(out), _ptr(buf["codes"]), _ptr(buf["xs"]),
            _ptr(buf["g"]), _ptr(buf["parts"]), _ptr(buf["gcodes"]),
            _ptr(buf["gs"]), m, h, f, bm1, bn1, bm2, bn2)
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
