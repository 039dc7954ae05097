"""Retrieval metrics (own copy of part of ``simxns_tpu/evals/metrics.py``).

- ``Eval_Tool``'s MRR/MAP/DCG/nDCG/P at {1,5,10,20,50,100} over
  per-question binary hit lists (``SimANS/utils/dpr_utils.py:91-164``),
  with the reference's quirks: ``MAP_n`` divides by ``n``, and ``nDCG_n``
  normalizes by ``sum(log2(i+2) for i in range(n))``, not the ideal DCG.
- The DPR top-k hit accuracy curve
  (``co_training_generate_new_train_wiki.py:167-179``).

The MS MARCO and TREC evaluators wait for the rerank slice.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np


def _as_hit_matrix(results_list: Sequence[Sequence[bool]], n: int) -> np.ndarray:
    """[Q, n] binary matrix from per-question hit lists (truncate/pad to n)."""
    mat = np.zeros((len(results_list), n), dtype=np.float64)
    for i, hits in enumerate(results_list):
        h = np.asarray(hits[:n], dtype=np.float64)
        mat[i, : len(h)] = h
    return mat


def mrr_n(results_list: Sequence[Sequence[bool]], n: int) -> float:
    mat = _as_hit_matrix(results_list, n)
    ranks = np.argmax(mat, axis=1)
    any_hit = mat.max(axis=1) > 0
    return float(np.where(any_hit, 1.0 / (ranks + 1.0), 0.0).mean())


def map_n(results_list: Sequence[Sequence[bool]], n: int) -> float:
    mat = _as_hit_matrix(results_list, n)
    prec = np.cumsum(mat, axis=1) / np.arange(1, n + 1)[None, :]
    return float(((prec * mat).sum(axis=1) / n).mean())


def dcg_n(results_list: Sequence[Sequence[bool]], n: int) -> float:
    mat = _as_hit_matrix(results_list, n)
    gains = 1.0 / np.log2(np.arange(n)[None, :] + 2.0)
    return float((mat * gains).sum(axis=1).mean())


def ndcg_n(results_list: Sequence[Sequence[bool]], n: int) -> float:
    mat = _as_hit_matrix(results_list, n)
    gains = 1.0 / np.log2(np.arange(n)[None, :] + 2.0)
    norm = sum(math.log2(i + 2) for i in range(n))
    return float(((mat * gains).sum(axis=1) / norm).mean())


def p_n(results_list: Sequence[Sequence[bool]], n: int) -> float:
    mat = _as_hit_matrix(results_list, n)
    return float((mat.sum(axis=1) / n).mean())


def get_metrics(results_list: Sequence[Sequence[bool]]) -> Dict[str, float]:
    """The ``Eval_Tool.get_matrics`` result dict (same key format)."""
    fns = {"MRR_n": mrr_n, "MAP_n": map_n, "DCG_n": dcg_n,
           "nDCG_n": ndcg_n, "P_n": p_n}
    return {f"{name}@_{p}": fn(results_list, p)
            for name, fn in fns.items() for p in (1, 5, 10, 20, 50, 100)}


def top_k_hits_accuracy(results_list: Sequence[Sequence[bool]]) -> List[float]:
    """acc[k] = fraction of questions with a hit at rank <= k+1."""
    if not results_list:
        return []
    n_docs = len(results_list[0])
    top_k_hits = [0] * n_docs
    for hits in results_list:
        best = next((i for i, x in enumerate(hits) if x), None)
        if best is not None:
            for i in range(best, n_docs):
                top_k_hits[i] += 1
    return [v / len(results_list) for v in top_k_hits]
