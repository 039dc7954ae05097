"""Negative sampling, including the SimANS ambiguity-weighted sampler.

Own copy of ``simxns_tpu/data/sampling.py`` (numpy only, the same draws
for the same ``np.random.Generator``). SimANS draws hard negatives with
probability peaked around the positive's score:

- wiki/NQ/TQ form:  w = exp(-a * (s_neg - s_pos + b)^2)
  (``SimANS/utils/util_wiki.py:613-640``)
- MARCO form:       w = exp(-|s_neg - s_pos| * tau), tau=3
  (``SimANS/utils/MARCO_until_new.py:179-202``)

The reference's selection procedure, edge cases included: fewer
candidates than k cycles the list and takes the last k; a zero positive
score takes the last k; otherwise weighted draws with replacement are
unioned until k unique ids are collected, and the first k in candidate
order are kept. PROD's plain modes ``random``, ``descend`` and
``rand_pool`` are :func:`select_negatives`.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def simans_weights(
    neg_scores: np.ndarray,
    pos_score: float,
    mode: str = "quadratic",
    a: float = 0.5,
    b: float = 0.0,
    tau: float = 3.0,
) -> np.ndarray:
    """Ambiguity weights for negative scores given the positive's score."""
    s = np.asarray(neg_scores, dtype=np.float64)
    if mode == "quadratic":           # wiki/NQ/TQ form
        return np.exp(-a * (s - pos_score + b) ** 2)
    if mode == "abs":                 # MARCO form
        return np.exp(-np.abs(s - pos_score) * tau)
    raise ValueError(f"unknown SimANS mode {mode!r}")


def sample_hard_negatives(
    neg_ids: Sequence[int],
    neg_scores: Sequence[float],
    pos_score: float,
    k: int,
    rng: np.random.Generator,
    mode: str = "quadratic",
    a: float = 0.5,
    b: float = 0.0,
    tau: float = 3.0,
) -> List[int]:
    """Draw ``k`` unique negative ids with SimANS ambiguity weighting."""
    neg_ids = list(neg_ids)
    n = len(neg_ids)
    if n == 0:
        return []
    if n < k:
        cycled = neg_ids * k
        return cycled[-k:]
    if pos_score == 0:
        return neg_ids[-k:]

    weights = simans_weights(np.asarray(neg_scores), pos_score, mode, a, b, tau)
    total = weights.sum()
    if not np.isfinite(total) or total <= 0:
        weights = np.ones(n, dtype=np.float64)
        total = float(n)
    p = weights / total

    # Reference loop: weighted draws with replacement, union until k unique.
    # Equivalent distribution, vectorized: successive weighted draws without
    # replacement via Gumbel top-k trick would NOT match (the union-of-
    # choices process favors high-weight ids slightly differently), so we
    # keep the literal loop — it's host-side and k is tiny.
    selected: set = set()
    ids = np.asarray(neg_ids)
    probs = p
    alive = np.ones(n, dtype=bool)
    while len(selected) < k:
        cur_ids = ids[alive]
        cur_p = probs[alive]
        cur_total = cur_p.sum()
        if cur_total <= 0 or not np.isfinite(cur_total):
            # remaining weights underflowed to 0 (exp(-a*d^2) with a large
            # score gap) — fall back to uniform like the pre-loop guard
            cur_p = np.ones(len(cur_ids), dtype=np.float64)
            cur_total = float(len(cur_ids))
        cur_p = cur_p / cur_total
        draws = rng.choice(cur_ids, size=k, replace=True, p=cur_p)
        selected.update(int(d) for d in draws)
        alive = np.array([i not in selected for i in ids.tolist()], dtype=bool)
        if not alive.any() and len(selected) < k:
            break
    # first k in original candidate order (util_wiki.py:640)
    out = [i for i in neg_ids if i in selected][:k]
    return out


def select_negatives(
    neg_ids: Sequence[int],
    neg_scores: Sequence[float],
    k: int,
    rng: np.random.Generator,
    neg_type: str = "random",
) -> List[int]:
    """PROD-style plain selection: 'random' shuffles, 'descend' keeps
    top-score order, 'rand_pool' samples from the top-``4k`` pool."""
    neg_ids = list(neg_ids)
    if len(neg_ids) == 0:
        return []
    if len(neg_ids) < k:
        cycled = neg_ids * k
        return cycled[-k:]
    if neg_type == "descend":
        order = np.argsort(-np.asarray(neg_scores), kind="stable")
        return [neg_ids[i] for i in order[:k]]
    if neg_type == "random":
        idx = rng.permutation(len(neg_ids))[:k]
        return [neg_ids[i] for i in idx]
    if neg_type == "rand_pool":
        pool = min(len(neg_ids), 4 * k)
        order = np.argsort(-np.asarray(neg_scores), kind="stable")[:pool]
        idx = rng.permutation(pool)[:k]
        return [neg_ids[order[i]] for i in idx]
    raise ValueError(f"unknown neg_type {neg_type!r}")
