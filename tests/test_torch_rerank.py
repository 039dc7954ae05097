"""Cross-encoder reranking of the port against ``simxns_tpu.evals.rerank``:
``build_joint_inputs`` element for element, and ``rerank_topk``'s scores
and orders from the same weights (f32 models: 2e-5 through the plain
path; 5e-3 through the int8 path, the two-layer bound of
``test_torch_models.py``, whose per-layer bound is
``test_torch_fused_layer.py``'s 1e-3 in f32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import simxns_tpu.ops.fused_layer as jfl
from simxns_tpu.evals.rerank import build_joint_inputs as jbuild
from simxns_tpu.evals.rerank import rerank_topk as jrerank
from simxns_tpu_torch.evals import build_joint_inputs, rerank_topk
from torch_parity import crossencoder_pair, jax_bert, token_batch
from torch_parity import one_torch_thread  # noqa: F401


@st.composite
def _corpus(draw):
    """Queries with padded tails; passages of at least two columns (a
    CLS column and a body; with one, both packages raise) that carry SEP
    (2) inside, at their end, or not at all; empty rows; top-k ids with
    repeats; joint lengths from the query length to past q + passage."""
    n, lc, q, lq, k = (draw(st.integers(1, 6)), draw(st.integers(2, 10)),
                       draw(st.integers(1, 3)), draw(st.integers(1, 8)),
                       draw(st.integers(1, 4)))
    tok = st.integers(1, 6)
    corpus = np.zeros((n, lc), np.int32)
    for i in range(n):
        length = draw(st.integers(0, lc))
        row = [draw(tok) for _ in range(length)]
        if length and draw(st.booleans()):
            row[-1] = 2
        corpus[i, :length] = row
    queries = np.zeros((q, lq), np.int32)
    for i in range(q):
        length = draw(st.integers(0, lq))
        queries[i, :length] = [draw(tok) for _ in range(length)]
    topk = np.array([[draw(st.integers(0, n - 1)) for _ in range(k)]
                     for _ in range(q)], np.int32)
    joint = draw(st.integers(lq, lq + lc + 2))
    return queries, corpus, topk, joint


@settings(max_examples=300, derandomize=True, deadline=None)
@given(case=_corpus(), sep=st.sampled_from([2, 3]))
def test_build_joint_inputs_matches_jax(case, sep):
    queries, corpus, topk, joint = case
    got = build_joint_inputs(queries, corpus, topk, joint, sep_id=sep)
    want = jbuild(queries, corpus, topk, joint, sep_id=sep)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.fixture
def _interpret():
    old = jfl.INTERPRET
    jfl.INTERPRET = True
    yield
    jfl.INTERPRET = old


@pytest.mark.parametrize("fused_int8,atol", [(False, 2e-5), (True, 5e-3)])
def test_rerank_topk_matches_jax(_interpret, fused_int8, atol):
    """3 queries x top-5 joint rows of 24 tokens in batches of 4 (the last
    batch padded). The port's order is the stable argsort of its scores,
    and it orders JAX's scores too, up to the tolerance."""
    jmodel, params, port = crossencoder_pair(jax_bert(dtype=jnp.float32),
                                             seed=61)
    q, k, lj = 3, 5, 24
    ids, _ = token_batch(np.random.default_rng(62), q * k, lj)
    joint = ids.reshape(q, k, lj)
    scores, order = rerank_topk(port, joint, batch=4, fused_int8=fused_int8)
    want, jorder = jrerank(jmodel, params, joint, batch=4,
                           fused_int8=fused_int8)
    assert scores.shape == order.shape == (q, k)
    assert scores.dtype == np.float32
    np.testing.assert_allclose(scores, want, atol=atol)
    np.testing.assert_array_equal(
        order, np.argsort(-scores, axis=1, kind="stable"))
    reordered = np.take_along_axis(want, order, axis=1)
    assert (np.diff(reordered, axis=1) <= 2 * atol).all()
    if not fused_int8:
        np.testing.assert_array_equal(order, jorder)


def test_rerank_topk_int8_view_leaves_the_model_alone():
    """The int8 scorer is a view over the model's Parameters: scoring
    through it neither moves a parameter nor changes the plain path's
    scores afterwards."""
    _, _, port = crossencoder_pair(jax_bert(dtype=jnp.float32), seed=63)
    ids, _ = token_batch(np.random.default_rng(64), 6, 16)
    joint = ids.reshape(2, 3, 16)
    before = {n: p.detach().clone() for n, p in port.named_parameters()}
    plain, _ = rerank_topk(port, joint)
    rerank_topk(port, joint, fused_int8=True)
    again, _ = rerank_topk(port, joint)
    np.testing.assert_array_equal(plain, again)
    for n, p in port.named_parameters():
        assert torch.equal(p.detach(), before[n]), n
