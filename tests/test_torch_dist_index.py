"""The port's row-sharded MIPSIndex and CorpusEncoder (gloo ranks) against
the JAX engine on ``create_mesh(n_data=W)``, W in {2, 4}, f32 and int8
stores, exact mode (``tests/test_index.py:28,241,279``).

Every rank must return the JAX ids and scores (f32: products of the same
values, summed in another order, 1e-5 relative; int8: the same codes and
scales, 1e-5), the same on every rank. A corpus of small-integer rows
copied 4 times makes exact ties across shards: they must come back in
global-id order, bitwise JAX's. One module-scoped pool of 4 ranks.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from simxns_tpu.index.engine import MIPSIndex as JaxIndex
from simxns_tpu.parallel import create_mesh
import torch_dist
from torch_parity import one_torch_thread  # noqa: F401

STORES = {"f32": jnp.float32, "int8": jnp.int8}


@pytest.fixture(scope="module")
def pool():
    p = torch_dist.Pool(4)
    yield p
    p.close()


def _jax_index(w, store, block_size):
    return JaxIndex(create_mesh(n_data=w), block_size=block_size,
                    store_dtype=STORES[store], mode="exact")


def _same(got, want, exact=False):
    for rank_result in got:
        np.testing.assert_array_equal(rank_result[1], np.asarray(want[1]))
        if exact:
            np.testing.assert_array_equal(rank_result[0],
                                          np.asarray(want[0]))
        else:
            np.testing.assert_allclose(rank_result[0], np.asarray(want[0]),
                                       rtol=1e-5)


@pytest.mark.parametrize("store", ["f32", "int8"])
@pytest.mark.parametrize("w", [2, 4])
def test_build_update_search_match_jax_mesh(pool, w, store):
    """build (the corpus padded to W blocks), search, then update_rows
    across a shard boundary (the rows the queries point at move) and across
    the last live row, searching after each."""
    rng = np.random.default_rng(w)
    emb = rng.standard_normal((1000, 64), dtype=np.float32)
    queries = rng.standard_normal((6, 64), dtype=np.float32)
    block = 64
    jidx = _jax_index(w, store, block)
    jidx.build(emb)
    shard = jidx.embeddings.shape[0] // w
    new = queries[:4] * 3.0 + rng.standard_normal((4, 64),
                                                  dtype=np.float32) * 0.1
    updates = [(shard - 2, new), (996, new * 1.5)]
    want = [jidx.search(queries, 10)]
    for start, rows in updates:
        jidx.update_rows(start, rows)
        want.append(jidx.search(queries, 10))
    got = pool.run(torch_dist.index_build_update_search, store, "exact",
                   block, emb, queries, 10, updates, world=w)
    for r, (_, rows) in enumerate(got):
        assert rows == shard, (r, rows)
    for i, expect in enumerate(want):
        _same([results[i] for results, _ in got], expect)
    # the update crossing the boundary is what the queries find first
    assert list(got[0][0][1][1][:4, 0]) == list(range(shard - 2, shard + 2))
    assert list(got[0][0][2][1][:4, 0]) == [996, 997, 998, 999]


@pytest.mark.parametrize("w", [2, 4])
def test_shards_past_the_corpus_match_jax_mesh(pool, w):
    """20 rows in blocks of 32: every shard after the first holds only
    padding (its live rows are 0) and contributes nothing; k above the live
    rows returns -1 ids, as JAX."""
    rng = np.random.default_rng(10 + w)
    emb = rng.standard_normal((20, 16), dtype=np.float32)
    queries = rng.standard_normal((3, 16), dtype=np.float32)
    jidx = _jax_index(w, "f32", 32)
    jidx.build(emb)
    want = jidx.search(queries, 50)
    got = pool.run(torch_dist.index_build_update_search, "f32", "exact",
                   32, emb, queries, 50, [], world=w)
    _same([results[0] for results, _ in got], want)
    assert (np.asarray(want[1])[:, 20:] == -1).all()


@pytest.mark.parametrize("store", ["f32", "int8"])
@pytest.mark.parametrize("w", [2, 4])
def test_duplicate_rows_across_shards_in_global_id_order(pool, w, store):
    """1,024 small-integer passages stored 4 times (f32 products exact; the
    copies tie exactly and lie on different shards): 8 queries at k=100
    return JAX's ids and scores bitwise, at every position."""
    rng = np.random.default_rng(7)
    emb = np.tile(rng.integers(-3, 4, (1024, 64)).astype(np.float32), (4, 1))
    queries = rng.integers(-3, 4, (8, 64)).astype(np.float32)
    jidx = _jax_index(w, store, 256)
    jidx.build(emb)
    want = jidx.search(queries, 100)
    got = pool.run(torch_dist.index_build_update_search, store, "exact",
                   256, emb, queries, 100, [], world=w)
    _same([results[0] for results, _ in got], want, exact=True)
    ids = np.asarray(want[1])
    scores = np.asarray(want[0])
    ties = (scores[:, 1:] == scores[:, :-1])
    assert ties.any() and (ids[:, 1:][ties] > ids[:, :-1][ties]).all()


def _jax_encode(params, ids, mask):
    return params[ids[:, 1]] / mask.sum(axis=1, keepdims=True).astype(
        jnp.float32)


def _tokens(rng, n):
    ids = rng.integers(4, 1024, (n, 8)).astype(np.int32)
    ids[:, 1] = rng.permutation(np.arange(4, 1024))[:n]   # distinct rows
    ids[:, 6:] = 0
    ids[[5, n - 50]] = 0                     # two all-pad rows
    return ids


@pytest.mark.parametrize("store", ["f32", "int8"])
@pytest.mark.parametrize("w", [2, 4])
def test_build_streaming_matches_jax_mesh(pool, w, store):
    """Each rank encodes only its shard's passages (uint16 ids, the mask
    derived from them, all-pad rows zeroed): the shards laid end to end
    are JAX's stored rows (int8: the codes; scales within one f32 ulp, as
    ``test_torch_index.py`` explains) and the search returns its hits."""
    table = np.random.default_rng(1).standard_normal((1024, 64),
                                                     dtype=np.float32)
    rng = np.random.default_rng(2)
    ids = _tokens(rng, 700)
    queries = rng.standard_normal((6, 64), dtype=np.float32)
    jidx = _jax_index(w, store, 64)
    jidx.build_streaming(_jax_encode, jnp.asarray(table), ids,
                         chunk_size=96, wire_dtype=np.uint16)
    want = jidx.search(queries, 10)
    got = pool.run(torch_dist.index_streaming_search, store, 64, table, ids,
                   96, queries, 10, world=w)
    _same([g[0] for g in got], want)
    rows = np.concatenate([g[1] for g in got])
    np.testing.assert_array_equal(
        rows, np.asarray(jidx.embeddings.astype(jnp.float32)))
    assert sum(g[2] for g in got) == 700


@pytest.mark.parametrize("w", [2, 4])
def test_search_passes_under_shards_match_jax_mesh(pool, w):
    """A corpus larger than ``max_resident_rows``: each pass built over the
    shards, searched, freed, merged on the host, as the JAX index does."""
    table = np.random.default_rng(3).standard_normal((1024, 64),
                                                     dtype=np.float32)
    rng = np.random.default_rng(4)
    ids = _tokens(rng, 700)
    queries = rng.standard_normal((5, 64), dtype=np.float32)
    jidx = _jax_index(w, "int8", 64)
    jidx.max_resident_rows = 300
    jidx.build_streaming(_jax_encode, jnp.asarray(table), ids,
                         chunk_size=64, wire_dtype=np.uint16)
    want = jidx.search(queries, 10)
    got = pool.run(torch_dist.index_streaming_search, "int8", 64, table, ids,
                   64, queries, 10, 300, world=w)
    _same([g[0] for g in got], want)
    assert all(g[1] is None for g in got)


@pytest.mark.parametrize("w", [2, 4])
def test_corpus_encoder_splits_chunks_over_ranks(pool, w):
    """Each chunk (its tail off a multiple of W) split over the ranks and
    gathered in row order: every rank returns one whole-corpus encode."""
    table = np.random.default_rng(5).standard_normal((1024, 64),
                                                     dtype=np.float32)
    rng = np.random.default_rng(6)
    ids = rng.integers(4, 1024, (23, 8)).astype(np.int32)
    mask = np.ones_like(ids)
    want = np.asarray(_jax_encode(jnp.asarray(table), ids, mask))
    for got in pool.run(torch_dist.corpus_encode, table, ids, mask, 5,
                        world=w):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("w", [2, 4])
def test_mine_records_identical_on_every_rank(pool, w):
    """The mine over the sharded index (hits labelled by ``has_answer`` over
    the passage text) gives every rank the records, accuracies and
    ``RecallGuard`` verdicts of the single-device mine: the ranks build the
    same next dataset and take the same branches."""
    rng = np.random.default_rng(8)
    emb = rng.standard_normal((90, 32), dtype=np.float32)
    queries = emb[:12] + 0.3 * rng.standard_normal((12, 32),
                                                   dtype=np.float32)
    texts = [f"passage {i} about fact{i % 20}" for i in range(90)]
    answers = [[f"fact{i % 20}"] for i in range(12)]
    got = pool.run(torch_dist.mine_records, emb, queries, texts, answers, 8,
                   world=w)
    want = torch_dist.mine_records(None, emb, queries, texts, answers, 8)
    for records, accuracy, verdicts in got:
        assert records == want[0]
        assert accuracy == want[1]
        assert verdicts == want[2] == [True, False]
