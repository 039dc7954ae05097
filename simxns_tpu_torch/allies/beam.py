"""ALLIES: beam search over LLM-generated query expansions (port of
``simxns_tpu/allies/beam.py``).

``ALLIES/tools.py:240-360`` (``ALLIES_model``) as an orchestration layer
over two backends:

- an :class:`LLMClient` with the operations the reference prompts
  ``gpt-3.5-turbo`` for (``ALLIES/utils.py:185-222``): direct answer,
  direct score, background, summary, answer and score with evidence,
  question expansion;
- a retrieval callable (question, k) -> passages: in the launcher the
  port's dense retriever over a device-resident index.

The algorithm: seed the beam with a direct answer and an answer grounded in
the evidence retrieved for the question; then for ``beam_depth`` rounds
expand every node's question, retrieve (or generate) evidence for each
expansion, optionally summarize it, answer and score each new node, keep
the best ``beam_size``, and stop early once a node's score reaches
``threshold``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Protocol, Sequence, Tuple


class LLMClient(Protocol):
    def directly_answer(self, question: str) -> str: ...
    def directly_cal_score(self, question: str, answer: str) -> float: ...
    def gen_background(self, question: str) -> str: ...
    def summary(self, question: str, doc: str) -> str: ...
    def answer_with_evidence(self, question: str, queries: Sequence[str],
                             evidence: Sequence[str]) -> str: ...
    def cal_score_with_evidence(self, question: str, answer: str,
                                queries: Sequence[str],
                                evidence: Sequence[str]) -> float: ...
    def expand_question(self, question: str, queries: Sequence[str],
                        evidence: Sequence[str]) -> List[str]: ...


@dataclasses.dataclass
class ALLIESConfig:
    beam_size: int = 2
    beam_depth: int = 2
    threshold: float = 0.8
    top_k: int = 5
    retrieval_type: str = "retrieve"     # "retrieve" | "generate"
    summarize: bool = True


@dataclasses.dataclass
class BeamNode:
    question: str                        # the ORIGINAL question
    queries: List[str]
    evidence: List[str]
    answer: str
    score: float


def allies_answer(
    question: str,
    llm: LLMClient,
    cfg: ALLIESConfig,
    retrieve: Optional[Callable[[str, int], List[str]]] = None,
) -> Tuple[str, List[BeamNode], Dict[str, int]]:
    """Returns (final_answer, final_beam, counters)."""
    counters = {"api_calls": 0, "retrievals": 0}

    def _evidence(q: str) -> str:
        if cfg.retrieval_type == "retrieve":
            if retrieve is None:
                raise ValueError("retrieval_type='retrieve' needs a retriever")
            counters["retrievals"] += 1
            doc = " ".join(retrieve(q, cfg.top_k))
        else:
            counters["api_calls"] += 1
            doc = llm.gen_background(q)
        if cfg.summarize:
            counters["api_calls"] += 1
            doc = llm.summary(question, doc)
        return doc

    # seed node 1: direct answer
    counters["api_calls"] += 1
    answer = llm.directly_answer(question)
    counters["api_calls"] += 1
    score = llm.directly_cal_score(question, answer)
    beam = [BeamNode(question, [], [], answer, score)]

    # seed node 2: answer grounded in the original question's evidence
    doc = _evidence(question)
    counters["api_calls"] += 1
    answer = llm.answer_with_evidence(question, [question], [doc])
    counters["api_calls"] += 1
    score = llm.cal_score_with_evidence(question, answer, [question], [doc])
    beam.append(BeamNode(question, [question], [doc], answer, score))

    current = beam
    best_seen = max(beam, key=lambda nd: nd.score)
    for _ in range(cfg.beam_depth):
        current = []
        for node in beam:
            counters["api_calls"] += 1
            expansions = llm.expand_question(node.question, node.queries,
                                             node.evidence)
            for q in expansions:
                doc = _evidence(q)
                queries = node.queries + [q]
                evidence = node.evidence + [doc]
                counters["api_calls"] += 1
                answer = llm.answer_with_evidence(question, queries, evidence)
                counters["api_calls"] += 1
                score = llm.cal_score_with_evidence(question, answer,
                                                    queries, evidence)
                current.append(BeamNode(question, queries, evidence,
                                        answer, score))
        current.sort(key=lambda n: n.score, reverse=True)
        beam = current[: cfg.beam_size]
        if current and current[0].score > best_seen.score:
            best_seen = current[0]
        for node in beam:
            if node.score >= cfg.threshold:
                return node.answer, current, counters
        if not beam:
            break          # no expansions anywhere — nothing left to grow

    current.sort(key=lambda n: n.score, reverse=True)
    # an empty final round (LLM returned no expansions) falls back to the
    # best node seen so far — the seed answer at worst
    final = current[0] if current else best_seen
    return final.answer, current, counters
