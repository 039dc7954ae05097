"""The port's ALLIES (``simxns_tpu_torch.allies``, ``data.curriculum.
rouge_l_f1`` and ``run.run_allies``) against the JAX package's, case for
case with ``tests/test_capstone_allies.py:10, 100, 119, 128`` and
``tests/test_run.py:363``.

The beam search and the metrics are host Python on both sides: answers,
beams, counters and scores must be equal (floats to the last bit). The
launcher run trains a tiny retriever on each side (f32 on the CPU, JAX's
from its PRNGKey, the port's from its generator) and answers with the
scripted LLM: em, f1 and the counters of the tiny run must be JAX's."""

import dataclasses
import json
import os

import numpy as np
import pytest

from simxns_tpu import allies as jallies
from simxns_tpu import run as jrun
from simxns_tpu.data import curriculum as jcurriculum
from simxns_tpu_torch import allies
from simxns_tpu_torch import run as prun
from simxns_tpu_torch.data import curriculum
from torch_parity import one_torch_thread  # noqa: F401


class ScriptedLLM:
    """Knows the answer only given the good evidence."""

    good_evidence = "paris is the capital of france"

    def directly_answer(self, q):
        return "london"

    def directly_cal_score(self, q, a):
        return 0.2

    def gen_background(self, q):
        return "some imagined background"

    def summary(self, q, doc):
        return doc

    def answer_with_evidence(self, q, queries, evidence):
        return ("paris" if any(self.good_evidence in e for e in evidence)
                else "london")

    def cal_score_with_evidence(self, q, a, queries, evidence):
        return 0.95 if a == "paris" else 0.3

    def expand_question(self, q, queries, evidence):
        return ["capital city of france", "france capital"]


CORPUS = {"capital city of france": ["paris is the capital of france"],
          "france capital": ["france is in europe"]}


def _retrieve(q, k):
    return CORPUS.get(q, ["nothing relevant"])


def _both(question, kw, retrieve):
    got = allies.allies_answer(question, ScriptedLLM(),
                               allies.ALLIESConfig(**kw), retrieve)
    want = jallies.allies_answer(question, ScriptedLLM(),
                                 jallies.ALLIESConfig(**kw), retrieve)
    assert got[0] == want[0]
    assert [dataclasses.asdict(n) for n in got[1]] == \
        [dataclasses.asdict(n) for n in want[1]]
    assert got[2] == want[2]
    return got


@pytest.mark.parametrize("a,b", [
    ("the cat sat", "the cat sat"), ("the cat sat", "dog runs fast"),
    ("a b c d", "a c d e"), ("", "x"), ("A B a", "a b A b"),
    ("one two three four five", "five four three two one")])
def test_rouge_l_matches_jax(a, b):
    """``tests/test_capstone_allies.py:10``."""
    assert curriculum.rouge_l_f1(a, b) == jcurriculum.rouge_l_f1(a, b)
    assert curriculum.rouge_l_f1("a b c d", "a c d e") == 0.75


@pytest.mark.parametrize("threshold,depth", [(0.9, 2), (0.99, 2), (0.5, 0)])
def test_allies_beam_search_finds_answer(threshold, depth):
    """``tests/test_capstone_allies.py:100``: the beam finds the grounded
    answer (and stops early at the threshold), as JAX's."""
    answer, beam, counters = _both(
        "what is the capital of france?",
        dict(beam_size=2, beam_depth=depth, threshold=threshold,
             summarize=False), _retrieve)
    if depth:
        assert answer == "paris" and counters["retrievals"] >= 2


def test_allies_generate_mode_and_exhaustion():
    """``tests/test_capstone_allies.py:119``: no node crosses the
    threshold, the best of the beam answers; generated evidence makes no
    retrieval."""
    answer, _, counters = _both(
        "question?", dict(beam_size=1, beam_depth=1, threshold=0.99,
                          retrieval_type="generate", summarize=True), None)
    assert answer == "london"
    assert counters["retrievals"] == 0 and counters["api_calls"] > 5


@pytest.mark.parametrize("pred,truths", [
    ("The Eiffel Tower!", ["eiffel tower"]), ("big ben", ["eiffel tower"]),
    ("the eiffel tower in paris", ["eiffel tower", "paris"]),
    ("eiffel tower", ["the eiffel tower"]), ("", []), ("a an the", ["x"])])
def test_qa_metrics_match_jax(pred, truths):
    """``tests/test_capstone_allies.py:128``."""
    for name in ("exact_match", "f1_score", "rouge_l"):
        assert (getattr(allies, name)(pred, truths)
                == getattr(jallies, name)(pred, truths)), name


def test_evidence_llm_matches_jax():
    """The scripted LLM of the launcher: the same answers, scores and
    expansions."""
    ours, theirs = allies.EvidenceLLM(), jallies.EvidenceLLM()
    q = "document 3 fact3"
    for ev in (["document 3 mentions fact3"], ["fact9 fact3"], ["none"],
               []):
        a = ours.answer_with_evidence(q, [q], ev)
        assert a == theirs.answer_with_evidence(q, [q], ev)
        assert (ours.cal_score_with_evidence(q, a, [q], ev)
                == theirs.cal_score_with_evidence(q, a, [q], ev))
    assert ours.expand_question(q, [], []) == theirs.expand_question(q, [],
                                                                     [])


def test_allies_recipe_matches_jax(tmp_path):
    """``tests/test_run.py:363``: the tiny ``allies_qa`` run (6 questions
    over 48 synthetic passages) writes eval.json, and its em, f1 and
    counters a question are the JAX launcher's."""
    argv = ["--recipe", "allies_qa", "--synthetic", "--steps", "6",
            "--corpus-size", "48", "--num-queries", "16"]
    want = jrun.main(argv + ["--output-dir", str(tmp_path / "jax")])
    got = prun.main(argv + ["--device", "cpu", "--output-dir",
                            str(tmp_path / "port")])
    for key in ("questions", "em", "f1", "api_calls_per_q",
                "retrievals_per_q"):
        assert got[key] == want[key], key
    assert got["em"] > 0.5 and got["retrievals_per_q"] >= 1
    with open(os.path.join(tmp_path / "port", "eval.json")) as f:
        assert json.load(f)["f1"] == got["f1"]
