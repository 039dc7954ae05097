"""CAPSTONE's curriculum (port of ``simxns_tpu/data/curriculum.py``), begun
with its metric: :func:`rouge_l_f1`, which ALLIES scores answers with. The
rest of the module (the query-expansion curriculum) follows with the
CAPSTONE slice (ROADMAP.md Queue 1 item 15).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


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
