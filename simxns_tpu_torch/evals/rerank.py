"""Cross-encoder reranking of retrieved top-k lists (port of
``simxns_tpu/evals/rerank.py``).

The PROD pipeline reranks the student's top-k with the CE teacher to build
distillation data and rerank metrics (``PROD/ProD_base/rerank_train_eval_
marco.py:146-340``): :func:`build_joint_inputs` assembles [Q, K] joint
rows from the token-array corpus (no re-tokenization), :func:`rerank_topk`
scores them with the CE and returns each query's reorder. With
``fused_int8=True`` the CE scores through its ``int8_view`` (K1-K3 on the
card), which shares the model's ``Parameter`` objects and int8 cache.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from simxns_tpu_torch.models.cross_encoder import int8_view


def build_joint_inputs(query_ids: np.ndarray, corpus_ids: np.ndarray,
                       topk_ids: np.ndarray, max_joint_length: int,
                       pad_id: int = 0, sep_id: int = 2) -> np.ndarray:
    """[Q, Lq] queries + [N, Lc] corpus + [Q, K] ids -> [Q, K, Lj] joints:
    the query's tokens, then the passage's without its first token (CLS)
    and without a trailing ``sep_id``, cut at ``max_joint_length``."""
    q, k = topk_ids.shape
    out = np.full((q, k, max_joint_length), pad_id, np.int32)
    for qi in range(q):
        q_row = query_ids[qi]
        q_len = int((q_row != pad_id).sum())
        rows = corpus_ids[topk_ids[qi]]
        out[qi, :, :q_len] = q_row[:q_len]
        body = rows[:, 1:].copy()
        lens = (body != pad_id).sum(1)
        ri = np.arange(body.shape[0])
        last = np.clip(lens - 1, 0, body.shape[1] - 1)
        is_sep = (lens > 0) & (body[ri, last] == sep_id)
        body[ri[is_sep], last[is_sep]] = pad_id   # strip the trailing SEP
        take = min(max_joint_length - q_len, body.shape[1])
        out[qi, :, q_len: q_len + take] = body[:, :take]
    return out


@torch.no_grad()
def rerank_topk(ce_model, joint_ids: np.ndarray, pad_id: int = 0,
                batch: int = 256, fused_int8: bool = False
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Score [Q, K, Lj] joint rows with ``ce_model`` (a ``CrossEncoder``)
    on its device, in batches of ``batch`` rows (the last padded with pad
    rows to ``batch``, as the JAX scorer's one compiled shape); -> (scores
    [Q, K] f32, reorder [Q, K]: positions into the top-k by descending
    score, equal scores in top-k order)."""
    q, k, lj = joint_ids.shape
    model = int8_view(ce_model) if fused_int8 else ce_model
    dev = next(ce_model.parameters()).device
    flat = joint_ids.reshape(q * k, lj)
    mask = (flat != pad_id).astype(np.int32)
    scores = []
    for s in range(0, q * k, batch):
        ids_c, mask_c = flat[s: s + batch], mask[s: s + batch]
        valid = ids_c.shape[0]
        if valid < batch:
            ids_c = np.pad(ids_c, ((0, batch - valid), (0, 0)))
            mask_c = np.pad(mask_c, ((0, batch - valid), (0, 0)))
        logits = model(torch.from_numpy(ids_c).long().to(dev),
                       torch.from_numpy(mask_c).to(dev))["logits"]
        scores.append(logits[:valid].float())
    ce_scores = torch.cat(scores).cpu().numpy().reshape(q, k)
    order = np.argsort(-ce_scores, axis=1, kind="stable")
    return ce_scores, order
