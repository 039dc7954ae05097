"""QA answer metrics (port of ``simxns_tpu/allies/qa_metrics.py``): EM, F1
and ROUGE-L over normalized answers (``ALLIES/utils.py:136-182``: SQuAD's
normalization, lowercase, no punctuation or articles, single spaces).
"""

from __future__ import annotations

import re
import string
from collections import Counter
from typing import Sequence

from simxns_tpu_torch.data.curriculum import rouge_l_f1


def normalize_answer(s: str) -> str:
    s = s.lower()
    s = "".join(ch for ch in s if ch not in set(string.punctuation))
    s = re.sub(r"\b(a|an|the)\b", " ", s)
    return " ".join(s.split())


def exact_match(prediction: str, ground_truths: Sequence[str]) -> float:
    pred = normalize_answer(prediction)
    return float(any(pred == normalize_answer(gt) for gt in ground_truths))


def _f1_single(prediction: str, ground_truth: str) -> float:
    pred_tokens = normalize_answer(prediction).split()
    gt_tokens = normalize_answer(ground_truth).split()
    common = Counter(pred_tokens) & Counter(gt_tokens)
    num_same = sum(common.values())
    if num_same == 0:
        return 0.0
    precision = num_same / len(pred_tokens)
    recall = num_same / len(gt_tokens)
    return 2 * precision * recall / (precision + recall)


def f1_score(prediction: str, ground_truths: Sequence[str]) -> float:
    return max((_f1_single(prediction, gt) for gt in ground_truths),
               default=0.0)


def rouge_l(prediction: str, ground_truths: Sequence[str]) -> float:
    pred = normalize_answer(prediction)
    return max((rouge_l_f1(normalize_answer(gt), pred)
                for gt in ground_truths), default=0.0)
