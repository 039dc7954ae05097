"""Multi-head attention as plain PyTorch (``simxns_tpu/ops/attention.py``).

``_xla_attention`` is the JAX package's XLA composition: f32 scores
(``q k^T / sqrt(d)``), the BERT key mask as an additive -1e9 bias, an f32
softmax, probabilities cast to the value dtype, and ``p v`` accumulated in
f32. On the card it is plain PyTorch, as it is plain XLA on the TPU.

``impl="flash"`` goes through :func:`simxns_tpu_torch.ops.flash_attention.
flash_attention`, the JAX package's dispatch: the per-(batch, head)
kernels K7/K8 for 256 <= S <= 1024 and, below that, the grouped kernels
K5/K6 when ``small_s_impl="group"``. At the serving
lengths (S=128 passages, S=32 queries) with no ``small_s_impl`` the
dispatch takes the XLA path, as it does on the TPU.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   bias: Optional[torch.Tensor], *, return_probs: bool
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    # q, k, v: [B, heads, S, D]; bias broadcastable to [B, heads, S, S]
    depth = q.shape[-1]
    scores = (q.float() @ k.float().transpose(-1, -2)) / torch.sqrt(
        torch.tensor(float(depth), dtype=torch.float32, device=q.device))
    if bias is not None:
        scores = scores + bias.float()
    probs = torch.softmax(scores, dim=-1)
    out = (probs.to(v.dtype).float() @ v.float()).to(v.dtype)
    return out, (probs if return_probs else None)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         attention_mask: Optional[torch.Tensor] = None, *,
                         impl: str = "xla", return_probs: bool = False,
                         small_s_impl: Optional[str] = None
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Scaled dot-product attention over [B, heads, S, D] tensors.

    ``attention_mask`` is the BERT [B, S] 1/0 key mask, turned into an
    additive bias (0 -> -1e9). Returns ``(context, probs or None)``.
    """
    if impl == "flash" and not return_probs:
        from simxns_tpu_torch.ops.flash_attention import flash_attention

        return flash_attention(q, k, v, attention_mask,
                               small_s_impl=small_s_impl), None
    bias = None
    if attention_mask is not None:
        bias = torch.where(attention_mask[:, None, None, :] > 0,
                           torch.tensor(0.0, device=q.device),
                           torch.tensor(-1e9, device=q.device))
    return _xla_attention(q, k, v, bias, return_probs=return_probs)
