"""A deterministic LLM for offline ALLIES runs (port of
``simxns_tpu/allies/scripted.py``).

The reference drives ``gpt-3.5-turbo`` through seven prompt templates
(``ALLIES/utils.py:185-222``). The launcher's ``allies_qa`` recipe runs
offline, with this scripted :class:`EvidenceLLM`: it answers with the
first token of the evidence that matches ``answer_regex``, so the run is
reproducible and still drives the whole beam search (retrieval, scoring,
expansion, early stop). A real :class:`~simxns_tpu_torch.allies.beam.
LLMClient` takes its place in production.
"""

from __future__ import annotations

import re
from typing import List, Sequence


class EvidenceLLM:
    """LLMClient whose knowledge is exactly the evidence it is shown."""

    def __init__(self, answer_regex: str = r"fact\d+",
                 found_score: float = 0.95, miss_score: float = 0.3):
        self.pattern = re.compile(answer_regex)
        self.found_score = found_score
        self.miss_score = miss_score

    def _extract(self, question: str, evidence: Sequence[str]) -> str:
        # prefer a fact mentioned in the question itself (the gold one)
        asked = set(self.pattern.findall(question))
        for doc in evidence:
            for m in self.pattern.findall(doc):
                if m in asked:
                    return m
        for doc in evidence:
            m = self.pattern.search(doc)
            if m:
                return m.group(0)
        return "unknown"

    # --- LLMClient protocol -------------------------------------------------
    def directly_answer(self, question: str) -> str:
        return "unknown"

    def directly_cal_score(self, question: str, answer: str) -> float:
        return self.miss_score if answer == "unknown" else self.found_score

    def gen_background(self, question: str) -> str:
        return question

    def summary(self, question: str, doc: str) -> str:
        return doc

    def answer_with_evidence(self, question: str, queries: Sequence[str],
                             evidence: Sequence[str]) -> str:
        return self._extract(question, evidence)

    def cal_score_with_evidence(self, question: str, answer: str,
                                queries: Sequence[str],
                                evidence: Sequence[str]) -> float:
        asked = set(self.pattern.findall(question))
        if answer != "unknown" and (not asked or answer in asked):
            return self.found_score
        return self.miss_score

    def expand_question(self, question: str, queries: Sequence[str],
                        evidence: Sequence[str]) -> List[str]:
        # re-ask the original question plus a keyword-only variant — enough
        # for the retriever to land on the answer-bearing passage
        words = question.split()
        return [question, " ".join(words[-2:]) if len(words) > 2 else question]
