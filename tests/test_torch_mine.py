"""The mine of the port against the JAX package: ``reform_out``, the
metrics, ``RetrievalEngine.mine`` with both labelings on the same
embeddings, and the multi-pass search against a resident index."""

import numpy as np
import pytest
import torch

from simxns_tpu.evals import metrics as jmetrics
from simxns_tpu.index import MIPSIndex as JaxIndex
from simxns_tpu.index import RetrievalEngine as JaxEngine
from simxns_tpu.index.engine import reform_out as jax_reform_out
from simxns_tpu.parallel import create_mesh
from simxns_tpu_torch.evals import metrics as pmetrics
from simxns_tpu_torch.index import MIPSIndex, RetrievalEngine, reform_out
from torch_parity import one_torch_thread  # noqa: F401


def _hits(rng, q, k):
    return [[bool(x) for x in row] for row in rng.random((q, k)) < 0.2]


def test_metrics_match():
    rng = np.random.default_rng(0)
    for q, k in ((1, 1), (7, 5), (20, 100), (13, 120)):
        hits = _hits(rng, q, k)
        assert (pmetrics.top_k_hits_accuracy(hits)
                == jmetrics.top_k_hits_accuracy(hits))
        assert pmetrics.get_metrics(hits) == jmetrics.get_metrics(hits)
    assert pmetrics.top_k_hits_accuracy([]) == []


def test_reform_out_matches():
    rng = np.random.default_rng(1)
    q, k = 6, 9
    ids = rng.integers(0, 30, (q, k))
    scores = rng.normal(size=(q, k)).astype(np.float32)
    hits = _hits(rng, q, k)
    hits[0][3] = True
    passages = {i: (f"text {i}", f"title {i}") for i in range(25)}
    gold = {"q0": {"id": int(ids[0, 3]), "title": "g", "text": "gold"},
            "q2": {"title": "only text", "text": "no id"}}
    args = ([f"q{i}" for i in range(q)], [[f"a{i}"] for i in range(q)],
            [str(100 + i) for i in range(q)], ids, scores, hits, passages)
    assert reform_out(*args, gold) == jax_reform_out(*args, gold)
    assert reform_out(*args) == jax_reform_out(*args)


def _strip_scores(examples):
    """Train records without their score strings, and the scores."""
    scores = []

    def strip(ctxs):
        out = []
        for c in ctxs:
            c = dict(c)
            scores.append(float(c.pop("score")))
            out.append(c)
        return out

    records = [{**e, "positive_ctxs": strip(e["positive_ctxs"]),
                "hard_negative_ctxs": strip(e["hard_negative_ctxs"])}
               for e in examples]
    return records, np.array(scores)


@pytest.mark.parametrize("labeling", ["has_answer", "positive_ids"])
def test_engine_mine_matches(labeling):
    """Same embeddings, exact f32 search: identical ids, hits, metrics and
    train records; scores to f32 summation order."""
    rng = np.random.default_rng(2)
    n, q, h, k = 200, 12, 16, 20
    emb = rng.normal(size=(n, h)).astype(np.float32)
    queries = rng.normal(size=(q, h)).astype(np.float32)
    passages = {i: (f"doc {i} about topic{i % 5}", f"t{i}")
                for i in range(n)}
    questions = [f"question {i}" for i in range(q)]
    answers = [[f"topic{i % 5}"] for i in range(q)]
    kw = dict(k=k)
    if labeling == "positive_ids":
        kw["positive_ids"] = [list(rng.integers(0, n, 30)) for _ in range(q)]

    jindex = JaxIndex(create_mesh(), block_size=32, store_dtype=np.float32)
    jindex.build(emb)
    want = JaxEngine(jindex, passages).mine(queries, questions, answers, **kw)
    pindex = MIPSIndex("cpu", block_size=32, store_dtype=torch.float32)
    pindex.build(emb)
    got = RetrievalEngine(pindex, passages).mine(queries, questions,
                                                 answers, **kw)
    np.testing.assert_array_equal(got.topk_ids, want.topk_ids)
    np.testing.assert_allclose(got.topk_scores, want.topk_scores,
                               rtol=1e-5, atol=1e-5)
    assert got.hits == want.hits
    assert got.top_k_hits == want.top_k_hits
    assert got.metrics == want.metrics
    rec_g, sc_g = _strip_scores(got.train_examples)
    rec_w, sc_w = _strip_scores(want.train_examples)
    assert rec_g == rec_w
    np.testing.assert_allclose(sc_g, sc_w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.int8, torch.float32])
def test_multipass_search_matches_resident(dtype):
    """``max_resident_rows``: build slice -> search -> free per pass and a
    host top-k merge equal a resident index exactly, ragged tail pass
    included (the twin of tests/test_index.py's multipass test)."""
    rng = np.random.default_rng(18)
    n, length, vocab, h = 147, 10, 60, 16
    table = torch.from_numpy(rng.standard_normal((vocab, h)).astype(
        np.float32))
    ids = rng.integers(1, vocab, size=(n, length)).astype(np.int32)
    q = rng.standard_normal((7, h)).astype(np.float32)

    def encode(tok, mask):
        return (table[tok] * mask[..., None]).sum(1)

    multi = MIPSIndex("cpu", block_size=8, store_dtype=dtype,
                      max_resident_rows=64)
    multi.build_streaming(encode, ids, chunk_size=16)
    assert multi.embeddings is None and multi.num_rows == n
    oracle = MIPSIndex("cpu", block_size=8, store_dtype=dtype)
    oracle.build_streaming(encode, ids, chunk_size=16)
    s1, i1 = multi.search(q, 5)
    s2, i2 = oracle.search(q, 5)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(s1, s2)
    assert multi.embeddings is None and multi.num_rows == n
    _, i3 = multi.search(q, 5)
    np.testing.assert_array_equal(i3, i2)
    with pytest.raises(RuntimeError, match="multi-pass"):
        multi.update_rows(0, np.zeros((2, h), np.float32))
    # the mine over the passes: global ids from the pass offsets
    rows = [3, 70, 140]
    with torch.no_grad():
        rq = encode(torch.from_numpy(ids[rows]).long(),
                    torch.ones(3, length)).numpy()
    res = RetrievalEngine(multi, {}).mine(rq, ["a", "b", "c"], [[]] * 3,
                                          k=4, positive_ids=[[r] for r in rows])
    assert list(res.topk_ids[:, 0]) == rows and res.top_k_hits[0] == 1.0


def test_watchdog_bounds_and_retries():
    """``run_with_deadline`` re-issues a stalled read and raises
    ``StallError`` when every attempt stalls; ``retry_on_stall`` re-runs a
    whole phase after a ``StallError`` (cleanup in between), and the last
    attempt's error propagates."""
    import threading

    from simxns_tpu_torch.parallel.watchdog import (StallError,
                                                    retry_on_stall,
                                                    run_with_deadline)

    assert run_with_deadline(lambda: 7, None) == 7
    assert run_with_deadline(lambda: 8, 5.0) == 8
    release = threading.Event()
    calls = []

    def stalls_once():
        calls.append(1)
        if len(calls) == 1:
            release.wait(10)         # the abandoned first attempt
        return len(calls)

    assert run_with_deadline(stalls_once, 0.2, retries=1, backoff_s=0) == 2
    with pytest.raises(StallError, match="2 attempt"):
        run_with_deadline(lambda: release.wait(10), 0.1, desc="pull",
                          retries=1, backoff_s=0)
    release.set()

    attempts, cleaned = [], []

    def phase():
        attempts.append(1)
        if len(attempts) < 2:
            raise StallError("index build", 1.0, 1)
        return "built"

    assert retry_on_stall(phase, cleanup=lambda: cleaned.append(1)) == "built"
    assert (len(attempts), len(cleaned)) == (2, 1)

    def always():
        raise StallError("search", 1.0, 1)

    with pytest.raises(StallError):
        retry_on_stall(always, attempts=2, cleanup=lambda: cleaned.append(1))
    assert len(cleaned) == 3
