"""Fused softmax attention and its backward (``simxns_tpu/ops/flash_attention.py``).

:func:`flash_attention` keeps the JAX dispatch (``flash_attention.py:305-332``):
a ones mask is synthesized when none is given; 256 <= S <= 1024 takes the
per-(batch, head) Pallas pair; S < 256 takes the grouped pair when
``small_s_impl`` (else :data:`SMALL_S_IMPL`) is ``"group"``; everything else
the XLA composition (``multi_head_attention(impl="xla")``).

The grouped pair is ported as two hand-written CUDA kernels
(``csrc/group_attention.cu``):

- K5 :func:`group_attention_fwd` replaces ``_fwd_call_group`` (kernel
  ``_fwd_kernel_group``, ``flash_attention.py:113``);
- K6 :func:`group_attention_bwd` replaces ``_fused_group_bwd`` (kernel
  ``_bwd_kernel_group``, ``:125``).

Both compute in f32: ``s = q k^T / sqrt(d)``, ``where(mask > 0, s, -1e9)``,
``p = softmax(s)`` kept in f32 (unlike the XLA composition, which rounds p
to the value dtype), ``o = p v`` cast to q's dtype; the backward recomputes
p and returns dq, dk, dv in the inputs' dtypes. A ``torch.autograd.Function``
joins them. Each wrapper launches its kernel for a CUDA tensor and runs its
plain PyTorch version (``_group_fwd_plain`` / ``_group_bwd_plain``) only for
a CPU tensor; it counts its launches in ``<wrapper>.launches``.

The per-(batch, head) pair (256 <= S <= 1024) computes the same function
and is ported as two more CUDA kernels (``csrc/bh_attention.cu``), which
stream key and query tiles through shared memory instead of holding a
whole head:

- K7 :func:`bh_attention_fwd` replaces ``_fwd_call`` (kernel
  ``_fwd_kernel``, ``flash_attention.py:67``);
- K8 :func:`bh_attention_bwd` replaces ``_fused_bwd`` (kernel
  ``_bwd_kernel``, ``:80``).

Their plain versions are the grouped pair's (the same function). K6 and
K8 share one backward design (``csrc/attention_bwd.cuh``): one walk over
the keys folds each query row's log-sum-exp and rowsum(dP p), and every
later walk gets p = 2^(s log2(e) - lse) with one ``ex2`` a score.
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
_MAX_GROUP_S = 255            # csrc/group_attention.cu kMaxS
_MAX_BH_S = 1024              # csrc/bh_attention.cu kMaxS

_VIEW = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
         ctypes.c_longlong]
_FWD_ARGS = ([ctypes.c_void_p] * 3 + _VIEW[1:] + [ctypes.c_void_p] + _VIEW
             + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p])
_BWD_ARGS = ([ctypes.c_void_p] * 3 + _VIEW[1:] + _VIEW + [ctypes.c_void_p] * 4
             + _VIEW[1:] + [ctypes.c_int] * 4
             + [ctypes.c_float, ctypes.c_void_p])
# K8 takes one more pointer, its f32 scratch of row statistics
_BH_BWD_ARGS = _BWD_ARGS[:17] + [ctypes.c_void_p] + _BWD_ARGS[17:]


# --- the plain versions ------------------------------------------------------

def _probs(q, k, mask):
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    s = torch.where(mask[:, None, None, :] > 0, s, _NEG)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True), scale


def _group_fwd_plain(q, k, v, mask):
    p, _ = _probs(q, k, mask)
    return (p @ v.float()).to(q.dtype)


def _group_bwd_plain(q, k, v, mask, do):
    p, scale = _probs(q, k, mask)
    dof = do.float()
    dv = p.transpose(-1, -2) @ dof
    dp = dof @ v.float().transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = (ds @ k.float()) * scale
    dk = (ds.transpose(-1, -2) @ q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# --- K5 / K6 -----------------------------------------------------------------

def _kernel_view(t: torch.Tensor, name: str) -> torch.Tensor:
    """``t`` itself if the kernel can read it (bf16 on the card, d
    contiguous, 16-byte rows), else a contiguous copy."""
    if t.dtype != torch.bfloat16 or not t.is_cuda:
        raise ValueError(f"group_attention: {name} must be a bf16 CUDA tensor "
                         f"(got {t.dtype} on {t.device})")
    if (t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3])
            or t.data_ptr() % 16):
        t = t.contiguous()
    return t


def _check_shapes(q, k, v, mask, max_s=_MAX_GROUP_S, what="group_attention"):
    b, h, s, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{what}: q, k, v shapes differ "
                         f"({tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)})")
    if (d not in (32, 64, 128) or not 1 <= s <= max_s or b > 65535
            or h > 65535):
        raise ValueError(f"{what} takes d in (32, 64, 128), 1 <= S <= "
                         f"{max_s} and B, heads <= 65535 (got d={d}, S={s}, "
                         f"B={b}, heads={h})")
    if tuple(mask.shape) != (b, s):
        raise ValueError(f"{what}: mask {tuple(mask.shape)} is not "
                         f"[{b}, {s}]")


def _qkv(q, k, v):
    q, k, v = (_kernel_view(t, n) for t, n in ((q, "q"), (k, "k"), (v, "v")))
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


def group_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    """K5: softmax attention of each (batch, head), S <= 255, in f32.

    q, k, v [B, heads, S, d] (bf16 on the card; any strides with d
    contiguous), mask [B, S] int32 1/0 key mask. -> o [B, heads, S, d] in
    q's dtype (on the card a view of a [B, S, heads, d] tensor).
    """
    if not q.is_cuda:
        return _group_fwd_plain(q, k, v, mask)
    _check_shapes(q, k, v, mask)
    q, k, v = _qkv(q, k, v)
    b, h, s, d = q.shape
    mask32 = mask.to(device=q.device, dtype=torch.int32).contiguous()
    o = _out(q)
    fn = _native.function("group_attention", "sx_group_attention_fwd",
                          _FWD_ARGS)
    code = fn(_native.ptr(q), _native.ptr(k), _native.ptr(v),
              *q.stride()[:3], _native.ptr(mask32), *_view_args(o), b, h, s,
              d, 1.0 / math.sqrt(d), _native.stream(q.device))
    _native.check("group_attention", code, "group_attention_fwd")
    group_attention_fwd.launches += 1
    return o


group_attention_fwd.launches = 0


def group_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: torch.Tensor, do: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K6: the backward of :func:`group_attention_fwd` for the output
    gradient ``do``; recomputes p. -> (dq, dk, dv) in the inputs' dtypes."""
    if not q.is_cuda:
        return _group_bwd_plain(q, k, v, mask, do)
    _check_shapes(q, k, v, mask)
    if do.shape != q.shape:
        raise ValueError(f"group_attention_bwd: do {tuple(do.shape)} is not "
                         f"{tuple(q.shape)}")
    q, k, v = _qkv(q, k, v)
    do = _kernel_view(do, "do")
    b, h, s, d = q.shape
    mask32 = mask.to(device=q.device, dtype=torch.int32).contiguous()
    dq, dk, dv = _out(q), _out(q), _out(q)
    fn = _native.function("group_attention", "sx_group_attention_bwd",
                          _BWD_ARGS)
    code = fn(_native.ptr(q), _native.ptr(k), _native.ptr(v),
              *q.stride()[:3], *_view_args(do), _native.ptr(mask32),
              _native.ptr(dq), _native.ptr(dk), _native.ptr(dv),
              *dq.stride()[:3], b, h, s, d, 1.0 / math.sqrt(d),
              _native.stream(q.device))
    _native.check("group_attention", code, "group_attention_bwd")
    group_attention_bwd.launches += 1
    return dq, dk, dv


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
    q, k, v = _qkv(q, k, v)
    b, h, s, d = q.shape
    mask32 = mask.to(device=q.device, dtype=torch.int32).contiguous()
    o = _out(q)
    fn = _native.function("bh_attention", "sx_bh_attention_fwd", _FWD_ARGS)
    code = fn(_native.ptr(q), _native.ptr(k), _native.ptr(v),
              *q.stride()[:3], _native.ptr(mask32), *_view_args(o), b, h, s,
              d, 1.0 / math.sqrt(d), _native.stream(q.device))
    _native.check("bh_attention", code, "bh_attention_fwd")
    bh_attention_fwd.launches += 1
    return o


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
    if do.shape != q.shape:
        raise ValueError(f"bh_attention_bwd: do {tuple(do.shape)} is not "
                         f"{tuple(q.shape)}")
    q, k, v = _qkv(q, k, v)
    do = _kernel_view(do, "do")
    b, h, s, d = q.shape
    mask32 = mask.to(device=q.device, dtype=torch.int32).contiguous()
    dq, dk, dv = _out(q), _out(q), _out(q)
    stats = torch.empty(2, b, h, s, dtype=torch.float32, device=q.device)
    fn = _native.function("bh_attention", "sx_bh_attention_bwd",
                          _BH_BWD_ARGS)
    code = fn(_native.ptr(q), _native.ptr(k), _native.ptr(v),
              *q.stride()[:3], *_view_args(do), _native.ptr(mask32),
              _native.ptr(dq), _native.ptr(dk), _native.ptr(dv),
              *dq.stride()[:3], _native.ptr(stats), b, h, s, d,
              1.0 / math.sqrt(d), _native.stream(q.device))
    _native.check("bh_attention", code, "bh_attention_bwd")
    bh_attention_bwd.launches += 1
    return dq, dk, dv


bh_attention_bwd.launches = 0


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
    """Fused attention over [B, heads, S, d]; BERT [B, S] 1/0 key mask."""
    b, h, s, d = q.shape
    if s > _MAX_FUSED_SEQ:
        return multi_head_attention(q, k, v, attention_mask)[0]
    if attention_mask is None:
        attention_mask = torch.ones(b, s, dtype=torch.int32, device=q.device)
    mask = attention_mask.to(torch.int32)
    if s >= _MIN_FUSED_SEQ:
        return _FusedAttention.apply(q, k, v, mask, True)
    if (small_s_impl or SMALL_S_IMPL) == "group":
        return _FusedAttention.apply(q, k, v, mask, False)
    return multi_head_attention(q, k, v, attention_mask)[0]
