"""Fused MIPS top-k (port of ``simxns_tpu/ops/mips_kernel.py``).

The TPU kernels fuse the score product with a bucket reduction so the
[Q, N] score matrix never exists: each aligned ``bucket`` of corpus rows
collapses to (max score, first index reaching it), and one exact top-k
over the surviving [Q, N/bucket] candidates finishes the search. Both TPU
kernels (bf16 ``_mips_kernel`` and int8 ``_mips_kernel_int8``) become the
one CUDA kernel K4 :func:`mips_bucket_candidates`
(``csrc/mips_candidates.cu``: the persistent TMA + wgmma GEMM of
``csrc/wgmma_gemm.cuh`` with a bucket epilogue in registers), over bf16 x
bf16 -> f32 and int8 x int8 -> int32 (x qs x cs). The exact top-k over the
candidates (:func:`_finalize`) stays in PyTorch, as it stays in XLA on the
TPU.

Semantics: FAISS-exact search except that two true top-k hits landing in
one bucket return only the better one (recall@k ~ 1 - k(k-1)/2 / (N/bucket)).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from simxns_tpu_torch.ops import _native
from simxns_tpu_torch.ops.fused_ffn import int8_matmul, quant_rows
from simxns_tpu_torch.parallel.mesh import pad_to_multiple

NEG_INF = -1e30
_PLAIN_CHUNK_ROWS = 65536     # corpus rows per plain-version product

_KERNEL_BUCKETS = 128          # K4 reduces buckets that divide 128
_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 2
         + [ctypes.c_int] * 2 + [ctypes.c_void_p])


def _fit_bucket(bucket: int, block_n: int, total_n: int, k: int) -> int:
    """Shrink the candidate bucket for small corpora/blocks: it must divide
    ``block_n`` and leave a 4x candidate margin over ``k``."""
    bucket = min(bucket, block_n)
    while block_n % bucket:
        bucket //= 2
    while (bucket > 8 and total_n // bucket < 4 * k
           and block_n % (bucket // 2) == 0):
        bucket //= 2
    return max(bucket, 1)


def _pad_candidates(flat_s: torch.Tensor, flat_i: torch.Tensor, k: int):
    """Guarantee >= k candidate columns (scores -inf, ids 0 -> -1 later)."""
    if flat_s.shape[1] < k:
        pad = k - flat_s.shape[1]
        flat_s = torch.nn.functional.pad(flat_s, (0, pad), value=NEG_INF)
        flat_i = torch.nn.functional.pad(flat_i, (0, pad))
    return flat_s, flat_i


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 (FAISS SQ8 analog): [N, H] -> (codes, scales
    [N] f32), ``x ~ codes * scales[:, None]``."""
    return quant_rows(x)


def _order(scores: torch.Tensor, cols: torch.Tensor, n: int) -> torch.Tensor:
    """``cols`` [Q, k] (columns of ``n``) reordered by (score descending,
    column ascending): one int64 key each, the score's order-preserving
    bits above and the reversed column below, so no two keys tie."""
    bits = (scores.float() + 0.0).view(torch.int32)   # -0.0 -> +0.0
    key = (bits ^ ((bits >> 31) & 0x7FFFFFFF)).to(torch.int64)
    key = key * (1 << 32) + (n - 1 - cols)
    return torch.gather(cols, 1, torch.sort(key, dim=1,
                                            descending=True).indices)


def stable_topk(scores: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``torch.topk(scores, k, dim=1)`` with ``jax.lax.top_k``'s order:
    among equal scores the earlier column comes first (``torch.topk`` leaves
    that order undefined, on both devices).

    Exact, at the price of a second selection: the k-th score t of
    ``torch.topk``; every column above t (all of them are in its result);
    then the first columns equal to t, in column order (a ``topk`` over
    distinct int32 keys, n - column where the score equals t, else minus
    the column); the k columns ordered by (score descending, column
    ascending). -> (scores [Q, k], columns [Q, k] int64).
    """
    n = scores.shape[1]
    vals, cols = torch.topk(scores, k, dim=1)
    t = vals[:, -1:]
    above = (vals > t).sum(dim=1, keepdim=True)
    col = torch.arange(n, dtype=torch.int32, device=scores.device)
    key = torch.where(scores == t, n - col, -col)
    first_eq = n - torch.topk(key, k, dim=1).values.long()
    j = torch.arange(k, device=scores.device)
    cols = torch.where(j < above, cols,
                       torch.gather(first_eq, 1, (j - above).clamp_(min=0)))
    cols = _order(torch.gather(scores, 1, cols), cols, n)
    return torch.gather(scores, 1, cols), cols


def _finalize(flat_s: torch.Tensor, flat_i: torch.Tensor, k: int,
              id_offset: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over the [Q, C] candidates (columns in global bucket
    order, the layout of the JAX ``_finalize``'s ``moveaxis(cand, 0, 1)``;
    ties go to the earlier column), the id offset, and -1 ids for scores
    under ``NEG_INF / 2``."""
    flat_s, flat_i = _pad_candidates(flat_s, flat_i, k)
    top_s, sel = stable_topk(flat_s, k)
    top_i = torch.gather(flat_i, 1, sel)
    top_i = torch.where(top_s > NEG_INF / 2, top_i + id_offset,
                        torch.full_like(top_i, -1))
    return top_s, top_i.to(torch.int32)


def kernel_row_width(h: int, itemsize: int) -> int:
    """The row width K4 takes for rows of ``h`` values of ``itemsize``
    bytes: h padded up to a multiple of 16 bytes (its TMA maps need 16-byte
    row strides), as many values as that is."""
    per_16 = 16 // itemsize
    return -(-h // per_16) * per_16


def _candidates_plain(queries, corpus, valid_n, bucket, n_pad, qs, cs):
    nq = queries.shape[0]
    out_s, out_i = [], []
    step = max(1, _PLAIN_CHUNK_ROWS // bucket) * bucket   # whole buckets
    for start in range(0, n_pad, step):
        stop = min(start + step, n_pad)
        rows = corpus[start:stop]
        if rows.shape[0] < stop - start:       # rows past N are zeros
            rows = torch.nn.functional.pad(
                rows, (0, 0, 0, stop - start - rows.shape[0]))
        if cs is not None:
            sc = cs[start:stop].float()
            sc = torch.nn.functional.pad(sc, (0, stop - start - sc.shape[0]))
            scores = int8_matmul(queries, rows).float() * qs[:, None] * sc
        else:
            scores = queries.float() @ rows.float().T
        col = torch.arange(start, stop, device=corpus.device)
        scores = torch.where(col[None, :] < valid_n, scores,
                             torch.full_like(scores, NEG_INF))
        s3 = scores.view(nq, -1, bucket)
        best = s3.amax(dim=-1)
        lane = torch.arange(bucket, device=corpus.device)
        first = torch.where(s3 >= best[..., None], lane,
                            torch.full_like(lane, bucket)).amin(dim=-1)
        base = start + torch.arange(s3.shape[1], device=corpus.device) * bucket
        out_s.append(best)
        out_i.append((base[None, :] + first).to(torch.int32))
    return torch.cat(out_s, dim=1), torch.cat(out_i, dim=1)


def _merge_buckets(flat_s: torch.Tensor, flat_i: torch.Tensor, r: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Candidates of buckets of g columns [Q, C] -> those of buckets of r g
    [Q, C / r]: each run of r to (max, the id of the first reaching it).
    The first maximum of the sub-buckets' first maxima is the bucket's
    first maximum, so this is exact."""
    nq, cols = flat_s.shape
    s3 = flat_s.view(nq, cols // r, r)
    best = s3.amax(dim=-1)
    lane = torch.arange(r, device=flat_s.device)
    first = torch.where(s3 >= best[..., None], lane,
                        torch.full_like(lane, r)).amin(dim=-1)
    ids = torch.gather(flat_i.view(nq, cols // r, r), 2, first[..., None])
    return best, ids[..., 0]


def mips_bucket_candidates(queries: torch.Tensor, corpus: torch.Tensor,
                           valid_n: int, *, bucket: int, block_n: int,
                           query_scales: Optional[torch.Tensor] = None,
                           row_scales: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scores of queries [Q, H] against corpus [N, H], rows >= ``valid_n``
    set to -1e30, each aligned ``bucket`` of rows reduced to (max, first
    argmax). The corpus is covered to a ``block_n`` multiple (rows past N
    count as zeros); ``bucket`` divides ``block_n``. -> (scores f32, ids
    int32), each [Q, N_pad / bucket] in global bucket order.

    int8: queries/corpus int8 with ``query_scales`` [Q] / ``row_scales``
    [N] (scores ``(acc * qs) * cs``); else both bf16 (f32 accumulation).

    On the card K4 reduces buckets that divide 128. Any other bucket runs it
    at g = gcd(bucket, 128), and each bucket's ``bucket / g`` candidates are
    then reduced to its (max, first id reaching it) here, exactly; the
    kernel then writes ``bucket / g`` times more candidates (``bucket=100``:
    25 times). The kernel takes rows of a multiple of 16 bytes (its TMA
    maps need 16-byte row strides: H a multiple of 16 int8 or 8 bf16
    values); rows off that grid are copied with zero columns up to it
    (:func:`kernel_row_width`), queries and corpus both: zero columns add
    exact zeros to every score, so the scores and ids are the unpadded
    ones.
    """
    n, h = corpus.shape
    if bucket < 1 or block_n % bucket:
        raise ValueError(f"mips_bucket_candidates: bucket {bucket} must "
                         f"divide block_n {block_n}")
    n_pad = pad_to_multiple(max(n, 1), block_n)
    if not corpus.is_cuda:
        return _candidates_plain(queries, corpus, valid_n, bucket, n_pad,
                                 query_scales, row_scales)
    int8 = row_scales is not None
    dtype = torch.int8 if int8 else torch.bfloat16
    nq = queries.shape[0]
    _native.check_tensor(queries, dtype, (nq, h), "queries")
    _native.check_tensor(corpus, dtype, (n, h), "corpus")
    if int8:
        _native.check_tensor(query_scales, torch.float32, (nq,),
                             "query_scales")
        _native.check_tensor(row_scales, torch.float32, (n,), "row_scales")
    if n == 0:
        raise ValueError(f"mips_bucket_candidates: the kernel takes at least "
                         f"one corpus row (H={h}, {corpus.dtype}, N=0)")
    hp = kernel_row_width(h, corpus.element_size())
    if hp != h:
        queries, corpus = (torch.nn.functional.pad(t, (0, hp - h))
                           for t in (queries, corpus))
        h = hp
    g = math.gcd(bucket, _KERNEL_BUCKETS)
    out_s = torch.empty(nq, n_pad // g, dtype=torch.float32,
                        device=corpus.device)
    out_i = torch.empty(nq, n_pad // g, dtype=torch.int32,
                        device=corpus.device)
    if nq > 0:
        bm, bn = _native.mips_tile(nq, n_pad, g,
                                   _native.sm_count(corpus.device))
        fn = _native.function("mips_candidates", "sx_mips_candidates", _ARGS)
        null = ctypes.c_void_p(0)
        code = _native.launch(
                fn, corpus.device, _native.ptr(queries), _native.ptr(corpus),
                _native.ptr(query_scales) if int8 else null,
                _native.ptr(row_scales) if int8 else null, nq, n, n_pad, h,
                int(int8), int(min(valid_n, n)), g, _native.ptr(out_s),
                _native.ptr(out_i), bm, bn)
        _native.check("mips_candidates", code, "mips_bucket_candidates")
        mips_bucket_candidates.launches += 1
    if g != bucket:
        return _merge_buckets(out_s, out_i, bucket // g)
    return out_s, out_i


mips_bucket_candidates.launches = 0


def fused_mips_topk_int8(queries: torch.Tensor, codes: torch.Tensor,
                         row_scales: torch.Tensor, k: int, *,
                         block_n: int = 2048, bucket: int = 128,
                         id_offset: int = 0, valid_n: Optional[int] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused top-k over an int8-quantized corpus: [Q, H] x int8 [N, H].

    Queries (float) are quantized per row here. -> (scores [Q, k] f32,
    ids [Q, k] int32), ids offset by ``id_offset`` and -1 past the corpus.
    """
    n = codes.shape[0]
    q8, qs = quantize_rows(queries)
    bucket = _fit_bucket(bucket, block_n, pad_to_multiple(max(n, 1), block_n),
                         k)
    flat_s, flat_i = mips_bucket_candidates(
        q8, codes, n if valid_n is None else valid_n, bucket=bucket,
        block_n=block_n, query_scales=qs, row_scales=row_scales)
    return _finalize(flat_s, flat_i, k, id_offset)


def fused_mips_topk(queries: torch.Tensor, corpus: torch.Tensor, k: int, *,
                    block_n: int = 2048, bucket: int = 128,
                    id_offset: int = 0, valid_n: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused top-k inner products: [Q, H] x [N, H] -> ([Q, k], [Q, k]).

    Same contract as :func:`fused_mips_topk_int8`; on the card queries and
    corpus are bf16 (f32 accumulation).
    """
    n = corpus.shape[0]
    bucket = _fit_bucket(bucket, block_n, pad_to_multiple(max(n, 1), block_n),
                         k)
    flat_s, flat_i = mips_bucket_candidates(
        queries.contiguous(), corpus, n if valid_n is None else valid_n,
        bucket=bucket, block_n=block_n)
    return _finalize(flat_s, flat_i, k, id_offset)
