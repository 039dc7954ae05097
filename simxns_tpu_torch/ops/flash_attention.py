"""Fused softmax attention and its backward (``simxns_tpu/ops/flash_attention.py``).

:func:`flash_attention` keeps the JAX dispatch (``flash_attention.py:305-332``):
a ones mask is synthesized when none is given; 256 <= S <= 1024 takes the
per-(batch, head) Pallas pair; S < 256 takes the grouped pair when
``small_s_impl`` (else :data:`SMALL_S_IMPL`) is ``"group"``; everything else
the XLA composition (``multi_head_attention(impl="xla")``). :func:`route`
is that decision, with the card's own: on the card a dtype or a head width
the kernels do not take goes to the plain attention.

The grouped pair is ported as two hand-written CUDA kernels:

- K5 :func:`group_attention_fwd` (``csrc/attention_fwd_wgmma.cu``, on
  ``wgmma``, K7's source: ``group_attention_fwd_kernel``, its route below
  S = 256) replaces ``_fwd_call_group`` (kernel ``_fwd_kernel_group``,
  ``flash_attention.py:113``);
- K6 :func:`group_attention_bwd` (``csrc/attention_bwd_wgmma.cu``, on
  ``wgmma``) replaces ``_fused_group_bwd`` (kernel ``_bwd_kernel_group``,
  ``:125``).

Both compute in f32: ``s = q k^T / sqrt(d)``, ``where(mask > 0, s, -1e9)``,
``p = softmax(s)`` kept in f32 (unlike the XLA composition, which rounds p
to the value dtype), ``o = p v`` cast to q's dtype; the backward recomputes
p and returns dq, dk, dv in the inputs' dtypes. A ``torch.autograd.Function``
joins them. Each wrapper launches its kernel for a CUDA tensor and runs its
plain PyTorch version (``_group_fwd_plain`` / ``_group_bwd_plain``) only for
a CPU tensor; it counts its launches in ``<wrapper>.launches``.

The per-(batch, head) pair (256 <= S <= 1024) computes the same function
and is ported as two more CUDA kernels, which stream key and query tiles
through shared memory instead of holding a whole head:

- K7 :func:`bh_attention_fwd` (``csrc/attention_fwd_wgmma.cu``, on
  ``wgmma``) replaces ``_fwd_call`` (kernel ``_fwd_kernel``,
  ``flash_attention.py:67``);
- K8 :func:`bh_attention_bwd` (``csrc/attention_bwd_wgmma.cu``, on
  ``wgmma``) replaces ``_fused_bwd`` (kernel ``_bwd_kernel``, ``:80``).

Their plain versions are the grouped pair's (the same function). K8 folds
each query row's log-sum-exp and rowsum(dP p) in one walk over the keys
(``csrc/attention_bwd.cuh``), and every later walk gets
p = 2^(s log2(e) - lse) with one ``ex2`` a score. K6, one block a head,
folds them from each warpgroup's 64 keys in shared memory and keeps p and
dS there for dV and dK, so nothing is computed twice (at S <= 192 and d <=
64; longer heads and wider ones take K8's two passes, whose row
statistics pass through an f32 scratch [2, B, heads, S]).

The JAX kernels cast to f32 inside and block whole (S, d) heads, so they
take any dtype and any d. On the card the four kernels have an instance
for every head width on the 16 grid up to 128 (:func:`kernel_head_width`);
a d off that grid runs the next instance over q, k, v (and dO) zero-padded
along d, with the scale 1/sqrt(d) of the true width, and the results are
sliced back: zero columns add exact zeros to every product, so it is the
same function. The wrappers refuse d > 128 (a warp's fragments of a
16-row tile would outgrow its registers), and :func:`route` sends such
heads to the plain attention, which computes the same f32 function.

Each kernel has a bf16 and an f32 instance, chosen by the inputs' dtype
before any launch. An f32 instance takes each f32 operand as hi = bf16(x)
and lo = bf16(x - hi), runs every product as three bf16 tensor-core
products (hi hi + hi lo + lo hi) into f32 accumulators, and stores its
results in f32: an f32-class function (about 16 bits of each operand; not
bitwise an f32 product). The f32 instances run on ``wgmma`` and split
each tile in shared memory as it lands, with no split scratch: K5 and K7
share one f32 forward, K7's source (``csrc/attention_fwd_wgmma.cu``, one
launch a call: one pass over the keys); K6 and K8 share K8's two passes
(``csrc/attention_bwd_wgmma.cu``, whose only scratch is the row
statistics). The f32 launches count
apart, in ``<wrapper>.f32.launches``. :func:`flash_attention` sends any
other dtype (f16: no recipe runs f16 attention) to the plain attention
(``multi_head_attention``), which computes JAX's f32 function.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from simxns_tpu_torch.ops import _native
from simxns_tpu_torch.ops.attention import multi_head_attention

_MAX_FUSED_SEQ = 1024         # simxns_tpu/ops/flash_attention.py:38
_MIN_FUSED_SEQ = 256          # :42
_NEG = -1e9
SMALL_S_IMPL = "xla"          # :49
_MAX_GROUP_S = 255            # csrc/attention_fwd_wgmma.cu kMaxGroupS
_MAX_BH_S = 1024              # csrc/attention_wgmma.cuh kMaxS
_MAX_KERNEL_D = 128           # the widest template instance of the kernels

_KERNEL_DTYPES = (torch.bfloat16, torch.float32)

_VIEW = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
         ctypes.c_longlong]
_FWD_ARGS = ([ctypes.c_void_p] * 3 + _VIEW[1:] + [ctypes.c_void_p] + _VIEW
             + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p])
# every backward takes the f32 scratch of row statistics (the pointer
# after dq, dk, dv's strides)
_BWD_ARGS = ([ctypes.c_void_p] * 3 + _VIEW[1:] + _VIEW + [ctypes.c_void_p] * 4
             + _VIEW[1:] + [ctypes.c_void_p] + [ctypes.c_int] * 4
             + [ctypes.c_float, ctypes.c_void_p])


class F32Instance:
    """The launch count of a wrapper's f32 instance, which ``ops.KERNELS``
    lists apart as ``<wrapper>_f32``."""

    def __init__(self, wrapper):
        self.__name__ = f"{wrapper.__name__}_f32"
        self.launches = 0


# --- the plain versions ------------------------------------------------------

def _probs(q, k, mask, scale=None):
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    s = torch.where(mask[:, None, None, :] > 0, s, _NEG)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True), scale


def _group_fwd_plain(q, k, v, mask, scale=None):
    p, _ = _probs(q, k, mask, scale)
    return (p @ v.float()).to(q.dtype)


def _group_bwd_plain(q, k, v, mask, do, scale=None):
    p, scale = _probs(q, k, mask, scale)
    dof = do.float()
    dv = p.transpose(-1, -2) @ dof
    dp = dof @ v.float().transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = (ds @ k.float()) * scale
    dk = (ds.transpose(-1, -2) @ q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# --- the f32 instances' limits -----------------------------------------------

# The f32 instances against an f64 evaluation of the same function
# (attention_f64): the forward within F32_FWD_TOL of max|v| (o is a mean of
# v rows), each gradient within F32_BWD_TOL of its largest value, and at
# least F32_VS_BF16 times closer to f64 than the bf16 instance on the inputs
# cast to bf16, which is what shows that they compute in f32. The split
# keeps about 16 bits of each operand (2^-17 a term over d terms). On an
# NVIDIA H100 80GB HBM3 at 700.00 W the worst readings were 4.0e-6 forward
# and 2.1e-5 backward (chip_smoke.py phase 23): the limit leaves about 11x.
F32_FWD_TOL, F32_BWD_TOL, F32_VS_BF16 = 2.0 ** -12, 2.0 ** -12, 16.0


def attention_f64(q, k, v, mask, do):
    """o and (dq, dk, dv) of the kernels' function, evaluated in f64."""
    q, k, v, do = (t.double() for t in (q, k, v, do))
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = (q @ k.transpose(-1, -2)) * scale
    s = torch.where(mask[:, None, None, :] > 0, s, _NEG)
    p = torch.softmax(s, dim=-1)
    dp = do @ v.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    return p @ v, ((ds @ k) * scale, (ds.transpose(-1, -2) @ q) * scale,
                   p.transpose(-1, -2) @ do)


def errors_of_largest(got, want):
    """max |got - want| over max |want|, for each pair of tensors."""
    return [float((g.double() - w).abs().max() / w.abs().max())
            for g, w in zip(got, want)]


# --- head widths -------------------------------------------------------------

def kernels_take_width(d: int) -> bool:
    """Whether the attention kernels (K3, K5-K8) have an instance for heads
    of width ``d`` (:func:`kernel_head_width`)."""
    return 1 <= d <= _MAX_KERNEL_D


def kernel_head_width(d: int, what: str = "attention") -> int:
    """The head width of the kernel instance that takes heads of width
    ``d``: d rounded up to the 16 grid (one m16n8k16 k-step a 16 columns),
    for 1 <= d <= 128."""
    if not kernels_take_width(d):
        raise ValueError(
            f"{what} takes head widths 1 .. {_MAX_KERNEL_D} (got d={d}): a "
            f"warp holds its 16 rows' q fragments and d/8 accumulator tiles "
            f"in registers")
    return -(-d // 16) * 16


def _at_kernel_width(fn, q, k, v, mask, *rest):
    """``fn(q, k, v, mask, *rest, scale=...)`` over tensors zero-padded
    along d to :func:`kernel_head_width`, with the scale of the true d,
    and its result(s) sliced back to d."""
    d = q.shape[-1]
    dp = kernel_head_width(d)
    scale = 1.0 / math.sqrt(d)
    if dp == d:
        return fn(q, k, v, mask, *rest, scale=scale)

    def pad(t):
        return torch.nn.functional.pad(t, (0, dp - d))

    out = fn(pad(q), pad(k), pad(v), mask, *map(pad, rest), scale=scale)
    if isinstance(out, tuple):
        return tuple(o[..., :d] for o in out)
    return out[..., :d]


def route(s: int, d: int, dtype: torch.dtype, is_cuda: bool,
          small_s_impl: Optional[str] = None) -> str:
    """Where :func:`flash_attention` sends [B, heads, S, d] of ``dtype``:
    ``"bh"`` (K7/K8), ``"group"`` (K5/K6) or ``"plain"``
    (``multi_head_attention``). JAX's dispatch, and on the card (``is_cuda``)
    the plain attention for a dtype or a head width the kernels do not
    take (the same f32 function)."""
    if s > _MAX_FUSED_SEQ or (is_cuda and (dtype not in _KERNEL_DTYPES
                                           or not kernels_take_width(d))):
        return "plain"
    if s >= _MIN_FUSED_SEQ:
        return "bh"
    if (small_s_impl or SMALL_S_IMPL) == "group":
        return "group"
    return "plain"


# --- K5 / K6 -----------------------------------------------------------------

def _kernel_view(t: torch.Tensor, name: str) -> torch.Tensor:
    """``t`` itself if a kernel can read it (bf16 or f32 on the card, d
    contiguous, 16-byte rows), else a contiguous copy."""
    if t.dtype not in _KERNEL_DTYPES or not t.is_cuda:
        raise ValueError(f"attention kernels: {name} must be a bf16 or f32 "
                         f"CUDA tensor (got {t.dtype} on {t.device})")
    per_16 = 16 // t.element_size()
    if (t.stride(-1) != 1 or any(s % per_16 for s in t.stride()[:3])
            or t.data_ptr() % 16):
        t = t.contiguous()
    return t


def _check_shapes(q, k, v, mask, max_s=_MAX_GROUP_S, what="group_attention"):
    b, h, s, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{what}: q, k, v shapes differ "
                         f"({tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)})")
    kernel_head_width(d, what)
    if not 1 <= s <= max_s or b > 65535 or h > 65535:
        raise ValueError(f"{what} takes 1 <= S <= {max_s} and B, heads <= "
                         f"65535 (got S={s}, B={b}, heads={h})")
    if tuple(mask.shape) != (b, s):
        raise ValueError(f"{what}: mask {tuple(mask.shape)} is not "
                         f"[{b}, {s}]")


def _qkv(q, k, v):
    q, k, v = (_kernel_view(t, n) for t, n in ((q, "q"), (k, "k"), (v, "v")))
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"attention kernels: q, k, v dtypes differ "
                         f"({q.dtype}, {k.dtype}, {v.dtype})")
    if not (q.stride() == k.stride() == v.stride()):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return q, k, v


def _out(q):
    """A [B, heads, S, d] result stored as [B, S, heads, d]: the layout of
    the [B, S, H] projections the heads came from."""
    b, h, s, d = q.shape
    return torch.empty(b, s, h, d, dtype=q.dtype,
                       device=q.device).transpose(1, 2)


def _view_args(t):
    return [_native.ptr(t), *t.stride()[:3]]


def _fwd_launch(bf16, f32, wrapper):
    """The forward launcher of a kernel: ``bf16`` and ``f32`` are the
    (library, C function) of its two instances."""
    def launch(q, k, v, mask, scale):
        q, k, v = _qkv(q, k, v)
        b, h, s, d = q.shape
        mask32 = mask.to(device=q.device, dtype=torch.int32).contiguous()
        o = _out(q)
        (lib, symbol), counter = ((f32, wrapper.f32)
                                  if q.dtype == torch.float32
                                  else (bf16, wrapper))
        fn = _native.function(lib, symbol, _FWD_ARGS)
        code = _native.launch(
                fn, q.device, _native.ptr(q), _native.ptr(k), _native.ptr(v),
                *q.stride()[:3], _native.ptr(mask32), *_view_args(o),
                b, h, s, d, scale)
        _native.check(lib, code, counter.__name__)
        counter.launches += 1
        return o
    launch.instances = {"bf16": (*bf16, _FWD_ARGS), "f32": (*f32, _FWD_ARGS)}
    return launch


def _bwd_launch(bf16, f32, wrapper):
    """The backward launcher of a kernel: ``bf16`` and ``f32`` are the
    (library, C function) of its two instances; each takes an f32 scratch
    of row statistics [2, B, heads, S] (K8's two passes pass them through
    it; K6 uses it only where it runs them)."""
    def launch(q, k, v, mask, do, scale):
        q, k, v = _qkv(q, k, v)
        do = _kernel_view(do, "do")
        if do.dtype != q.dtype:
            raise ValueError(f"attention kernels: do is {do.dtype}, q "
                             f"{q.dtype}")
        b, h, s, d = q.shape
        mask32 = mask.to(device=q.device, dtype=torch.int32).contiguous()
        dq, dk, dv = _out(q), _out(q), _out(q)
        (lib, symbol), counter = ((f32, wrapper.f32)
                                  if q.dtype == torch.float32
                                  else (bf16, wrapper))
        # held until the launch is enqueued
        scratch = torch.empty(2, b, h, s, dtype=torch.float32,
                              device=q.device)
        fn = _native.function(lib, symbol, _BWD_ARGS)
        code = _native.launch(
                fn, q.device, _native.ptr(q), _native.ptr(k), _native.ptr(v),
                *q.stride()[:3], *_view_args(do), _native.ptr(mask32),
                _native.ptr(dq), _native.ptr(dk), _native.ptr(dv),
                *dq.stride()[:3], _native.ptr(scratch), b, h, s, d, scale)
        _native.check(lib, code, counter.__name__)
        counter.launches += 1
        return dq, dk, dv
    launch.instances = {"bf16": (*bf16, _BWD_ARGS), "f32": (*f32, _BWD_ARGS)}
    return launch


def _check_do(q, do, what):
    if do.shape != q.shape:
        raise ValueError(f"{what}: do {tuple(do.shape)} is not "
                         f"{tuple(q.shape)}")


def group_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    """K5: softmax attention of each (batch, head), S <= 255, in f32.

    q, k, v [B, heads, S, d] (bf16 or f32 on the card: the kernel's two
    instances; d <= 128; any strides with d contiguous), mask [B, S] int32
    1/0 key mask. -> o [B, heads, S, d] in q's dtype (on the card a view of
    a [B, S, heads, d] tensor).
    """
    if not q.is_cuda:
        return _group_fwd_plain(q, k, v, mask)
    _check_shapes(q, k, v, mask)
    return _at_kernel_width(_K5, q, k, v, mask)


group_attention_fwd.launches = 0


def group_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: torch.Tensor, do: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K6: the backward of :func:`group_attention_fwd` for the output
    gradient ``do``; recomputes p. -> (dq, dk, dv) in the inputs' dtypes."""
    if not q.is_cuda:
        return _group_bwd_plain(q, k, v, mask, do)
    _check_shapes(q, k, v, mask)
    _check_do(q, do, "group_attention_bwd")
    return _at_kernel_width(_K6, q, k, v, mask, do)


group_attention_bwd.launches = 0


# --- K7 / K8 -----------------------------------------------------------------

def bh_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """K7: softmax attention of each (batch, head), S <= 1024 (the dispatch
    sends 256 <= S <= 1024), in f32; arguments and result as
    :func:`group_attention_fwd`."""
    if not q.is_cuda:
        return _group_fwd_plain(q, k, v, mask)
    _check_shapes(q, k, v, mask, _MAX_BH_S, "bh_attention")
    return _at_kernel_width(_K7, q, k, v, mask)


bh_attention_fwd.launches = 0


def bh_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: torch.Tensor, do: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K8: the backward of :func:`bh_attention_fwd` (two launches: a query
    pass for the row statistics and dq, a key pass for dk and dv; the
    statistics, each row's log-sum-exp and rowsum(dP p), pass between them
    in an f32 scratch [2, B, heads, S])."""
    if not q.is_cuda:
        return _group_bwd_plain(q, k, v, mask, do)
    _check_shapes(q, k, v, mask, _MAX_BH_S, "bh_attention")
    _check_do(q, do, "bh_attention_bwd")
    return _at_kernel_width(_K8, q, k, v, mask, do)


bh_attention_bwd.launches = 0

for _wrapper in (group_attention_fwd, group_attention_bwd, bh_attention_fwd,
                 bh_attention_bwd):
    _wrapper.f32 = F32Instance(_wrapper)

# K5's and K7's f32 instance: the forward on wgmma
# (csrc/attention_fwd_wgmma.cu, both bf16 kernels' source too); K6's and
# K8's: K8's backward on wgmma (csrc/attention_bwd_wgmma.cu, K6's bf16
# kernel's source too)
_F32_FWD = ("attention_fwd_wgmma", "sx_attention_fwd_f32")
_F32_BWD = ("attention_bwd_wgmma", "sx_attention_bwd_f32")
_K5 = _fwd_launch(("attention_fwd_wgmma", "sx_group_attention_fwd"),
                  _F32_FWD, group_attention_fwd)
_K6 = _bwd_launch(("attention_bwd_wgmma", "sx_group_attention_bwd"),
                  _F32_BWD, group_attention_bwd)
_K7 = _fwd_launch(("attention_fwd_wgmma", "sx_bh_attention_fwd"), _F32_FWD,
                  bh_attention_fwd)
_K8 = _bwd_launch(("attention_bwd_wgmma", "sx_bh_attention_bwd"),
                  _F32_BWD, bh_attention_bwd)


class _FusedAttention(torch.autograd.Function):
    """A fused pair under autograd: K5/K6, or K7/K8 when ``per_head`` (their
    plain versions for CPU tensors). The mask gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, mask, per_head):
        ctx.per_head = per_head
        ctx.save_for_backward(q, k, v, mask)
        fwd = bh_attention_fwd if per_head else group_attention_fwd
        return fwd(q, k, v, mask)

    @staticmethod
    def backward(ctx, do):
        q, k, v, mask = ctx.saved_tensors
        bwd = bh_attention_bwd if ctx.per_head else group_attention_bwd
        dq, dk, dv = bwd(q, k, v, mask, do)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    attention_mask: Optional[torch.Tensor] = None,
                    small_s_impl: Optional[str] = None) -> torch.Tensor:
    """Fused attention over [B, heads, S, d]; BERT [B, S] 1/0 key mask.
    On the card bf16 and f32 at d <= 128 take the kernels (each dtype its
    own instance); any other dtype or width takes the plain attention,
    which computes JAX's f32 function (:func:`route`)."""
    b, h, s, d = q.shape
    where = route(s, d, q.dtype, q.is_cuda, small_s_impl)
    if where == "plain":
        return multi_head_attention(q, k, v, attention_mask)[0]
    if attention_mask is None:
        attention_mask = torch.ones(b, s, dtype=torch.int32, device=q.device)
    mask = attention_mask.to(torch.int32)
    return _FusedAttention.apply(q, k, v, mask, where == "bh")
