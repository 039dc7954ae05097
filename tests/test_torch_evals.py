"""The port's MS MARCO and TREC evaluators, ``write_eval_result`` and
``has_answer(match_type="regex")`` against the JAX package's, on random
runs and judgements: equal floats, equal file text, equal hits."""

import json

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from simxns_tpu.evals import metrics as jm
from simxns_tpu.evals import qa_match as jqa
from simxns_tpu_torch.evals import metrics as pm
from simxns_tpu_torch.evals import qa_match as pqa


def _run_and_qrels(seed):
    """A run over 40 queries (some unjudged), binary qrels (some judged
    queries missing from the run) and graded qrels (empty judgements,
    all-zero grades, ties in the ranking's pids)."""
    rng = np.random.default_rng(seed)
    run, qrels, graded = {}, {}, {}
    for q in range(40):
        qid = f"q{q}"
        if q % 7 != 3:
            depth = int(rng.integers(0, 150))
            run[qid] = [int(x) for x in rng.integers(0, 300, depth)]
        if q % 5 != 1:
            qrels[qid] = {int(x) for x in rng.integers(0, 300,
                                                       rng.integers(1, 6))}
            pids = rng.integers(0, 300, rng.integers(0, 8))
            graded[qid] = {int(p): int(g) for p, g in
                           zip(pids, rng.integers(0 if q % 3 else 1, 4,
                                                  len(pids)))}
    return run, qrels, graded


@pytest.mark.parametrize("seed", range(4))
def test_marco_and_trec_evaluators_match_jax(seed):
    run, qrels, graded = _run_and_qrels(seed)
    for k in (1, 10, 100, 1000):
        assert pm.marco_mrr_at_k(run, qrels, k) == jm.marco_mrr_at_k(
            run, qrels, k)
        assert pm.marco_recall_at_k(run, qrels, k) == jm.marco_recall_at_k(
            run, qrels, k)
        assert pm.trec_ndcg_at_k(run, graded, k) == jm.trec_ndcg_at_k(
            run, graded, k)
        assert pm.trec_map_at_k(run, graded, k) == jm.trec_map_at_k(
            run, graded, k)
        assert pm.trec_recall_at_k(run, graded, k) == jm.trec_recall_at_k(
            run, graded, k)
    assert pm.trec_recip_rank(run, graded) == jm.trec_recip_rank(run, graded)
    assert pm.trec_eval_all(run, graded, 10, 100) == jm.trec_eval_all(
        run, graded, 10, 100)
    assert pm.marco_mrr_at_k({}, {}) == jm.marco_mrr_at_k({}, {}) == 0.0


@pytest.mark.parametrize("depth", [3, 20, 100, 120])
def test_write_eval_result_matches_jax(tmp_path, depth):
    """The same JSON text, keys past the curve's depth left out."""
    rng = np.random.default_rng(depth)
    results = [list(rng.random(depth) < 0.1) for _ in range(25)]
    curve = pm.top_k_hits_accuracy(results)
    got = pm.write_eval_result(str(tmp_path / "port.json"), curve, results)
    want = jm.write_eval_result(str(tmp_path / "jax.json"), curve, results)
    assert got == want
    assert ((tmp_path / "port.json").read_text()
            == (tmp_path / "jax.json").read_text())
    assert ("top100" in json.loads((tmp_path / "port.json").read_text())
            ) == (depth >= 100)


_PATTERN = st.text(st.sampled_from(list("abAB .*+?()[]|^$\\{}1é")),
                   max_size=8)
_TEXT = st.text(st.sampled_from(list("abAB .(\n1éé")), max_size=30)


@settings(max_examples=400, derandomize=True, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(answers=st.lists(_PATTERN, max_size=3), text=_TEXT)
def test_has_answer_regex_matches_jax(answers, text):
    """Each answer a case-insensitive pattern over the NFD text; patterns
    that do not compile are skipped."""
    assert pqa.has_answer(answers, text, "regex") == jqa.has_answer(
        answers, text, "regex")
    assert pqa.check_answer(answers, [text, text.upper()], "regex") == \
        jqa.check_answer(answers, [text, text.upper()], "regex")
