"""Maximum-inner-product top-k (port of ``simxns_tpu/ops/topk.py``).

- :func:`exact_topk` — one product + one selection.
- :func:`blocked_mips_topk` — over corpus blocks, so the score matrix is
  at most ``Q x block_size``: ``mode="exact"`` keeps a running top-k
  (merge and reselect per block), ``"approx"`` selects per block and merges
  once (on the TPU that is ``lax.approx_max_k``; off the TPU JAX computes
  it exactly, and so does this port), ``"fused"`` dispatches to the fused
  bucket kernel (:mod:`simxns_tpu_torch.ops.mips_kernel`).
- :func:`merge_topk` — merge per-shard lists.

Every selection is :func:`~simxns_tpu_torch.ops.mips_kernel.stable_topk`:
equal scores come back in column order, as ``jax.lax.top_k`` returns them
(duplicate passages tie exactly).

Scores are f32; the products outside the fused kernel are plain PyTorch
(f32 products of the stored values), as they are plain XLA on the TPU.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from simxns_tpu_torch.ops.mips_kernel import (NEG_INF, fused_mips_topk,
                                              fused_mips_topk_int8,
                                              stable_topk)


def exact_topk(queries: torch.Tensor, corpus: torch.Tensor, k: int, *,
               id_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k inner products of queries [Q, H] against corpus [N, H]."""
    scores = queries.float() @ corpus.float().T
    top_s, top_i = stable_topk(scores, k)
    return top_s, (top_i + id_offset).to(torch.int32)


def blocked_mips_topk(queries: torch.Tensor, corpus: torch.Tensor, k: int, *,
                      block_size: int = 8192, id_offset: int = 0,
                      valid_n: Optional[int] = None, mode: str = "exact",
                      row_scales: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over corpus blocks; rows >= ``valid_n`` are masked.

    ``row_scales`` marks the corpus as int8 codes with per-row scales
    (scores on the dequantized values). Returns (scores [Q, k] f32, ids
    [Q, k] int32), ids offset by ``id_offset`` and -1 where fewer than k
    rows are live.
    """
    n = corpus.shape[0]
    if mode == "fused" and n < 64 * k:
        # the bucket reduction keeps ~N/bucket candidates; on a tiny corpus
        # that is too lossy for a top-k list — exact is cheap at this size
        mode = "exact"
    if mode == "fused":
        if row_scales is not None:
            return fused_mips_topk_int8(
                queries, corpus, row_scales, k,
                block_n=min(block_size, 2048), id_offset=id_offset,
                valid_n=valid_n)
        return fused_mips_topk(queries.to(corpus.dtype), corpus, k,
                               block_n=min(block_size, 2048),
                               id_offset=id_offset, valid_n=valid_n)
    if mode not in ("exact", "approx"):
        raise ValueError(f"unknown search mode {mode!r}")
    valid_n = n if valid_n is None else valid_n
    q = queries.float()
    nq = q.shape[0]
    best_s = torch.full((nq, k), NEG_INF, device=q.device)
    best_i = torch.full((nq, k), -1, dtype=torch.int64, device=q.device)
    all_s, all_i = [], []
    for start in range(0, n, block_size):
        block = corpus[start:start + block_size]
        s = q @ block.float().T
        if row_scales is not None:
            s = s * row_scales[start:start + block_size].float()[None, :]
        ids = torch.arange(start, start + block.shape[0], device=q.device)
        s = torch.where(ids[None, :] < valid_n, s, torch.full_like(s, NEG_INF))
        if mode == "approx":
            bs, bi = stable_topk(s, min(k, s.shape[1]))
            all_s.append(bs)
            all_i.append(ids[bi])
            continue
        cand_s = torch.cat([best_s, s], dim=1)
        cand_i = torch.cat([best_i, ids[None, :].expand(nq, -1)], dim=1)
        best_s, sel = stable_topk(cand_s, k)
        best_i = torch.gather(cand_i, 1, sel)
    if mode == "approx":
        cat_s = torch.cat([best_s] + all_s, dim=1)
        cat_i = torch.cat([best_i] + all_i, dim=1)
        best_s, sel = stable_topk(cat_s, k)
        best_i = torch.gather(cat_i, 1, sel)
    best_i = torch.where(best_s > NEG_INF / 2, best_i + id_offset,
                         torch.full_like(best_i, -1))
    return best_s, best_i.to(torch.int32)


def merge_topk(scores: torch.Tensor, ids: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge per-shard top-k lists: [S, Q, k'] -> global [Q, k]."""
    s = scores.transpose(0, 1).reshape(scores.shape[1], -1)
    i = ids.transpose(0, 1).reshape(ids.shape[1], -1)
    top_s, sel = stable_topk(s, k)
    return top_s, torch.gather(i, 1, sel)
