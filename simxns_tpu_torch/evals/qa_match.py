"""DPR-style answer-string matching (port of ``simxns_tpu/evals/qa_match.py``).

It decides which retrieved passages become positives in the mined training
data (``SimANS/utils/dpr_utils.py:300-384``), so a tokenizer that differs
on one Unicode class changes the training distribution without any error.

Pipeline: NFD-normalize -> tokenize -> uncased sliding-window subsequence
match of each answer's token list inside the passage's token list.

The JAX package tokenizes with the ``regex`` package's
``([\\p{L}\\p{N}\\p{M}]+)|([^\\p{Z}\\p{C}])``. This module needs no
``regex``: a scanner over ``unicodedata.category`` gives the same tokens.
A run of letters, numbers and marks (L*, N*, M*) is one token; any other
character outside the separators (Z*) and the controls, formats,
surrogates and unassigned code points (C*) is a token of its own; Z* and
C* characters are dropped. Python's ``re`` is no substitute (its ``\\w``
takes ``_`` and leaves out some marks).

``regex``'s Unicode tables are newer than ``unicodedata``'s: a code point
that ``unicodedata`` calls unassigned ("Cn") takes its class from
``_unicode_ranges.RANGES``, generated from ``regex`` by
``scripts/torch_unicode_ranges.py``.
"""

from __future__ import annotations

import unicodedata
from bisect import bisect_right
from functools import lru_cache
from typing import List, Sequence

from simxns_tpu_torch.evals._unicode_ranges import RANGES

_WORD = frozenset("LNM")       # major categories that join into one token
_DROP = frozenset("ZC")        # major categories that are never a token
_STARTS = tuple(r[0] for r in RANGES)


def _major(ch: str) -> str:
    """The major class the ``regex`` package gives ``ch``."""
    cat = unicodedata.category(ch)
    if cat == "Cn":
        i = bisect_right(_STARTS, ord(ch)) - 1
        if i >= 0 and ord(ch) <= RANGES[i][1]:
            return RANGES[i][2]
    return cat[0]


def _normalize(text: str) -> str:
    return unicodedata.normalize("NFD", text)


class SimpleTokenizer:
    """Word tokenizer matching DPR's ``SimpleTokenizer`` output."""

    def tokenize(self, text: str) -> List[str]:
        tokens = []
        i, n = 0, len(text)
        while i < n:
            major = _major(text[i])
            if major in _WORD:
                j = i + 1
                while j < n and _major(text[j]) in _WORD:
                    j += 1
                tokens.append(text[i:j])
                i = j
                continue
            if major not in _DROP:
                tokens.append(text[i])
            i += 1
        return tokens

    def words(self, text: str, uncased: bool = True) -> List[str]:
        toks = self.tokenize(text)
        return [t.lower() for t in toks] if uncased else toks


_TOKENIZER = SimpleTokenizer()


@lru_cache(maxsize=100_000)
def _answer_words(answer: str) -> tuple:
    return tuple(_TOKENIZER.words(_normalize(answer)))


def has_answer(answers: Sequence[str], text: str,
               match_type: str = "string") -> bool:
    """True if any answer appears as a token subsequence of ``text``.

    ``match_type="regex"`` (the curated-TREC path of the reference) is not
    ported: it compiles each answer as a ``regex`` pattern.
    """
    if match_type == "regex":
        raise NotImplementedError(
            "has_answer(match_type='regex') needs the regex package's "
            "pattern syntax; not ported yet (ROADMAP.md Queue 1)")
    if match_type != "string":
        raise ValueError(f"unknown match_type {match_type!r}")
    words = _TOKENIZER.words(_normalize(text))
    for answer in answers:
        asw = _answer_words(answer)
        n, m = len(words), len(asw)
        # reference quirk (dpr_utils.py:324-326): an answer that tokenizes
        # to [] matches every passage (`[] == text[i:i]` at i=0)
        if m == 0:
            return True
        for i in range(n - m + 1):
            if tuple(words[i: i + m]) == asw:
                return True
    return False


def check_answer(answers: Sequence[str], passage_texts: Sequence[str],
                 match_type: str = "string") -> List[bool]:
    """Hit list over ranked passages (``dpr_utils.py:check_answer``)."""
    return [has_answer(answers, t, match_type) for t in passage_texts]
