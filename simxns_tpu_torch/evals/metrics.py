"""Retrieval metrics (own copy of ``simxns_tpu/evals/metrics.py``).

- ``Eval_Tool``'s MRR/MAP/DCG/nDCG/P at {1,5,10,20,50,100} over
  per-question binary hit lists (``SimANS/utils/dpr_utils.py:91-164``),
  with the reference's quirks: ``MAP_n`` divides by ``n``, and ``nDCG_n``
  normalizes by ``sum(log2(i+2) for i in range(n))``, not the ideal DCG.
- The DPR top-k hit accuracy curve
  (``co_training_generate_new_train_wiki.py:167-179``) and the
  ``*_eval_result<step>.json`` file (:func:`write_eval_result`).
- MS MARCO MRR@k and binary recall@k over qrels, both over the judged
  queries (``PROD/ProD_base/inference_DE_marco.py:493-560``).
- trec_eval's ``ndcg_cut`` (linear gain), ``map_cut``, ``recip_rank`` and
  ``recall`` over graded qrels (``CAPSTONE/utils/evaluate_trec.py``), with
  the JAX package's tie and cutoff rules: rankings are taken as given
  (position order), and each cutoff counts the first k positions.
"""

from __future__ import annotations

import json
import math
from typing import Dict, Iterable, List, Mapping, Sequence

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


def marco_mrr_at_k(ranked_ids: Mapping[str, Sequence[int]],
                   qrels: Mapping[str, Iterable[int]], k: int = 10) -> float:
    """MS MARCO MRR@k: qid -> ranked pids against qid -> relevant pids,
    over the number of judged queries (``len(qrels)``): a judged query
    missing from the run counts 0."""
    total = 0.0
    for qid, ranked in ranked_ids.items():
        if qid not in qrels:
            continue
        rel = set(qrels[qid])
        for rank, pid in enumerate(ranked[:k]):
            if pid in rel:
                total += 1.0 / (rank + 1)
                break
    return total / max(len(qrels), 1)


def marco_recall_at_k(ranked_ids: Mapping[str, Sequence[int]],
                      qrels: Mapping[str, Iterable[int]], k: int) -> float:
    """MS MARCO recall@k: a judged query counts 1 if any relevant pid is in
    its top k (not the fraction found), over ``len(qrels)``."""
    hits = 0
    for qid, ranked in ranked_ids.items():
        if qid not in qrels:
            continue
        rel = set(qrels[qid])
        if any(pid in rel for pid in ranked[:k]):
            hits += 1
    return hits / max(len(qrels), 1)


def _graded(ranked_ids, graded_qrels):
    """(ranked pids, grades) of every query with a non-empty judgement."""
    for qid, ranked in ranked_ids.items():
        grades = graded_qrels.get(qid)
        if grades:
            yield ranked, grades


def _relevant(grades: Mapping[int, int]) -> set:
    return {pid for pid, g in grades.items() if g > 0}


def trec_ndcg_at_k(ranked_ids: Mapping[str, Sequence[int]],
                   graded_qrels: Mapping[str, Mapping[int, int]],
                   k: int = 10) -> float:
    """nDCG@k with trec_eval's linear gain (gain = grade), the ideal DCG
    from the k highest grades."""
    total, count = 0.0, 0
    for ranked, grades in _graded(ranked_ids, graded_qrels):
        count += 1
        dcg = sum(grades.get(pid, 0) / math.log2(rank + 2)
                  for rank, pid in enumerate(ranked[:k]))
        ideal = sorted(grades.values(), reverse=True)[:k]
        idcg = sum(g / math.log2(r + 2) for r, g in enumerate(ideal))
        total += dcg / idcg if idcg > 0 else 0.0
    return total / max(count, 1)


def trec_map_at_k(ranked_ids: Mapping[str, Sequence[int]],
                  graded_qrels: Mapping[str, Mapping[int, int]],
                  k: int = 10) -> float:
    """trec_eval ``map_cut_k``: average precision over the first k
    positions, divided by the total number of relevant pids (grade > 0)."""
    total, count = 0.0, 0
    for ranked, grades in _graded(ranked_ids, graded_qrels):
        count += 1
        rel = _relevant(grades)
        if not rel:
            continue
        hits, ap = 0, 0.0
        for rank, pid in enumerate(ranked[:k]):
            if pid in rel:
                hits += 1
                ap += hits / (rank + 1)
        total += ap / len(rel)
    return total / max(count, 1)


def trec_recip_rank(ranked_ids: Mapping[str, Sequence[int]],
                    graded_qrels: Mapping[str, Mapping[int, int]]) -> float:
    """trec_eval ``recip_rank``: 1 / rank of the first relevant pid in the
    whole ranking (no cutoff)."""
    total, count = 0.0, 0
    for ranked, grades in _graded(ranked_ids, graded_qrels):
        count += 1
        rel = _relevant(grades)
        for rank, pid in enumerate(ranked):
            if pid in rel:
                total += 1.0 / (rank + 1)
                break
    return total / max(count, 1)


def trec_recall_at_k(ranked_ids: Mapping[str, Sequence[int]],
                     graded_qrels: Mapping[str, Mapping[int, int]],
                     k: int = 100) -> float:
    """trec_eval ``recall_k``: the fraction of a query's relevant pids in
    its top k, averaged over the judged queries."""
    total, count = 0.0, 0
    for ranked, grades in _graded(ranked_ids, graded_qrels):
        count += 1
        rel = _relevant(grades)
        if rel:
            total += sum(1 for pid in ranked[:k] if pid in rel) / len(rel)
    return total / max(count, 1)


def trec_eval_all(ranked_ids: Mapping[str, Sequence[int]],
                  graded_qrels: Mapping[str, Mapping[int, int]],
                  k: int = 10, recall_k: int = 100) -> Dict[str, float]:
    """nDCG@k, map_cut_k, recip_rank and recall_N in one dict, under
    trec_eval's names."""
    return {
        f"ndcg_cut_{k}": trec_ndcg_at_k(ranked_ids, graded_qrels, k),
        f"map_cut_{k}": trec_map_at_k(ranked_ids, graded_qrels, k),
        "recip_rank": trec_recip_rank(ranked_ids, graded_qrels),
        f"recall_{recall_k}": trec_recall_at_k(ranked_ids, graded_qrels,
                                               recall_k),
    }


def write_eval_result(path: str, top_k_hits: Sequence[float],
                      results_list: Sequence[Sequence[bool]]) -> dict:
    """Write the reference's ``*_eval_result<step>.json``: ``top1``,
    ``top5``, ``top20``, ``top100`` (only those the curve reaches) and
    ``result_dict`` (:func:`get_metrics`)."""
    payload = {f"top{k}": top_k_hits[k - 1]
               for k in (1, 5, 20, 100) if len(top_k_hits) >= k}
    payload["result_dict"] = get_metrics(results_list)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=2)
    return payload
