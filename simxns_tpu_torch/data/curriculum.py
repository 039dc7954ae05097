"""CAPSTONE's curriculum query expansion (port of
``simxns_tpu/data/curriculum.py``; host numpy, as there).

During training every positive and negative passage is expanded with one
doc2query-generated query; a curriculum moves from the least to the most
gold-similar generated queries as training progresses
(``CAPSTONE/utils/util.py:100-260``, ``CAPSTONE/models/
run_de_model_ernie.py``).

- :func:`gradual_bucket`: the schedule (``reset_select_generated_query``
  :120-139): with N parts, bucket ``i = max(N - step // (max_steps // N),
  1)`` (mode ``gradual``), or down to the gold query (``gradual-gold``).
- :meth:`QueryExpander.select_query`: per-passage selection
  (``create_passage_queries`` :156-240): dedupe against the gold query,
  score the candidates by ROUGE-L (or BLEU) against it, drop scores above
  ``filter_threshold``, then pick by mode: ``first``, ``random``,
  ``top-k``, ``bottom-k``, ``i-th``, ``k-part`` (a uniform draw inside the
  k-th descending-score segment), ``batch-uniform[-gold]``. The draws from
  the caller's ``np.random.Generator`` are the JAX module's, call for call,
  so one seed gives the same choices in both packages.
- :meth:`QueryExpander.expand_passage` appends the query after the
  delimiter (``' '`` or ``' [SEP] '``); at inference the corpus is
  expanded with the top-k queries a passage
  (``run_de_model_expand_corpus_cocondenser.sh:36-60``).
- :func:`rouge_l_f1` and :func:`bleu`: the metric utils
  (``CAPSTONE/utils/metric_utils.py:13-135``); ALLIES scores answers with
  the first.

The queries come from the doc2query TSV (``psg_id\\tquery\\tquery...``),
which :func:`simxns_tpu_torch.models.t5.doc2query_tsv` writes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


# --- metrics ---------------------------------------------------------------

def _lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    """The length of the longest common subsequence of two token lists."""
    if not a or not b:
        return 0
    dp = np.zeros((len(b) + 1,), dtype=np.int32)
    for x in a:
        prev = 0
        for j, y in enumerate(b, start=1):
            cur = dp[j]
            dp[j] = prev + 1 if x == y else max(dp[j], dp[j - 1])
            prev = cur
    return int(dp[-1])


def rouge_l_f1(reference: str, candidate: str) -> float:
    """ROUGE-L F1 over lowercased whitespace tokens."""
    ref = reference.lower().split()
    cand = candidate.lower().split()
    lcs = _lcs_len(ref, cand)
    if lcs == 0:
        return 0.0
    p = lcs / len(cand)
    r = lcs / len(ref)
    return 2 * p * r / (p + r)


def bleu(reference: str, candidate: str, max_n: int = 4) -> float:
    """Sentence BLEU up to ``max_n``-grams over lowercased whitespace
    tokens (clipped counts, brevity penalty; 0 when any order matches
    nothing)."""
    ref = reference.lower().split()
    cand = candidate.lower().split()
    if not cand:
        return 0.0
    logs = []
    for n in range(1, max_n + 1):
        ref_ngrams: Dict[tuple, int] = {}
        for i in range(len(ref) - n + 1):
            g = tuple(ref[i: i + n])
            ref_ngrams[g] = ref_ngrams.get(g, 0) + 1
        matches, total = 0, max(len(cand) - n + 1, 0)
        seen: Dict[tuple, int] = {}
        for i in range(total):
            g = tuple(cand[i: i + n])
            seen[g] = seen.get(g, 0) + 1
        for g, c in seen.items():
            matches += min(c, ref_ngrams.get(g, 0))
        if total == 0 or matches == 0:
            return 0.0
        logs.append(np.log(matches / total))
    bp = (min(1.0, np.exp(1 - len(ref) / len(cand)))
          if len(cand) < len(ref) else 1.0)
    return float(bp * np.exp(np.mean(logs)))


# --- curriculum ------------------------------------------------------------

def gradual_bucket(global_step: int, max_steps: int, total_part: int,
                   mode: str = "gradual") -> Tuple[int, float]:
    """Returns ``(bucket, gold_query_prob)``.

    ``gradual``: bucket N (least similar) -> 1 (most similar), never gold.
    ``gradual-gold``: bucket N -> 0, where 0 means train on the gold query.
    """
    n = total_part
    if mode == "gradual":
        iter_steps = max(max_steps // n, 1)
        i = max(n - global_step // iter_steps, 1)
        return i, 0.0
    if mode == "gradual-gold":
        iter_steps = max(max_steps // (n + 1), 1)
        i = max(n - global_step // iter_steps, 0)
        return i, (1.0 if i == 0 else 0.0)
    raise ValueError(f"unknown curriculum mode {mode!r}")


@dataclasses.dataclass
class QueryExpander:
    """psg_id -> generated-query list, with curriculum selection."""

    queries: Dict[int, List[str]]          # from the doc2query TSV
    delimiter: str = " "                   # ' ' or '[SEP]'
    total_part: int = 5
    filter_threshold: float = 1.0
    metric: str = "rouge"

    @staticmethod
    def from_tsv(path: str, max_query: int = 80, **kw) -> "QueryExpander":
        queries: Dict[int, List[str]] = {}
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) < 2:
                    continue
                queries[int(parts[0])] = parts[1: 1 + max_query]
        return QueryExpander(queries=queries, **kw)

    def _scores(self, gold_query: str, cands: List[str]) -> np.ndarray:
        fn = rouge_l_f1 if self.metric == "rouge" else bleu
        return np.asarray([fn(gold_query, c) for c in cands], np.float64)

    def select_query(
        self,
        psg_id: int,
        gold_query: str,
        mode: str,
        rng: np.random.Generator,
        gold_query_prob: float = 0.0,
        index: int = 0,
    ) -> Optional[str]:
        """One query for this passage under the given selection mode."""
        cands = self.queries.get(int(psg_id), [])
        cands = [c for c in dict.fromkeys(cands) if c != gold_query]
        if not cands:
            return gold_query if gold_query else None
        n = len(cands)

        if mode == "batch-uniform":
            mode = f"{index % n + 1}-th"
            gold_query_prob = 0.0           # util.py:172 forces it off
        elif mode == "batch-uniform-gold":
            i = index % (n + 1) + 1
            if i == n + 1:
                return gold_query
            mode = f"{i}-th"
            gold_query_prob = 0.0           # util.py:178-179

        if rng.random() < gold_query_prob:
            return gold_query
        if mode == "first":
            return cands[0]
        if mode == "random":
            return cands[int(rng.integers(n))]

        scores = self._scores(gold_query, cands)
        keep = scores <= self.filter_threshold
        if not keep.any():
            # all near-duplicates: fall back to the least similar
            return cands[int(np.argmin(scores))]
        cands = [c for c, k in zip(cands, keep) if k]
        scores = scores[keep]
        n = len(cands)
        order = np.argsort(-scores, kind="stable")    # descending similarity

        if mode.startswith("top-"):
            k = min(int(mode.split("top-")[1]), n)
            return cands[int(order[int(rng.integers(k))])]
        if mode.startswith("bottom-"):
            k = min(int(mode.split("bottom-")[1]), n)
            return cands[int(order[::-1][int(rng.integers(k))])]
        if mode.endswith("-th"):
            k = min(int(mode.split("-th")[0]), n)
            return cands[int(order[k - 1])]
        if mode.endswith("-part"):
            k = int(mode.split("-part")[0])
            start = int(n / self.total_part * (k - 1))
            end = int(n / self.total_part * k)
            # util.py:184-187: i = end+1 when the bucket is empty
            # (start == end), else randint(start+1, end) inclusive
            pick = (end + 1 if start == end
                    else int(rng.integers(start + 1, end + 1)))
            pick = min(pick, n)
            return cands[int(order[pick - 1])]
        raise ValueError(f"unknown selection mode {mode!r}")

    def expand_passage(self, text: str, query: Optional[str]) -> str:
        if not query:
            return text
        return f"{text}{self.delimiter}{query}"

    def expand_corpus_entry(self, psg_id: int, text: str,
                            top_k_query: int) -> str:
        """Inference-time corpus expansion: append exactly k queries —
        deduplicated, then REPEATED to length k when fewer exist
        (``util.py:256-258`` ``(query_list*top_k)[:top_k]``)."""
        qs = list(dict.fromkeys(self.queries.get(int(psg_id), [])))
        if qs and len(qs) < top_k_query:
            qs = (qs * top_k_query)[:top_k_query]
        out = text
        for q in qs[:top_k_query]:
            out = f"{out}{self.delimiter}{q}"
        return out
