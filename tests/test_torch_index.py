"""The port's MIPSIndex and CorpusEncoder vs the JAX engine (one-device mesh).

The JAX fused search runs its Pallas kernels under the interpreter. Index
rows and queries are continuous random values, so no two scores of a query
tie and the top-k order is unambiguous, except in the duplicate-row test,
whose ties must come back in ``jax.lax.top_k``'s order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simxns_tpu.ops.mips_kernel as jmk
from simxns_tpu.index.engine import MIPSIndex as JaxIndex
from simxns_tpu.parallel import create_mesh
from simxns_tpu_torch.index import CorpusEncoder, MIPSIndex
from torch_parity import one_torch_thread  # noqa: F401

STORES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16),
          "int8": (jnp.int8, torch.int8)}


@pytest.fixture(autouse=True)
def _interpret():
    old = jmk.INTERPRET
    jmk.INTERPRET = True
    yield
    jmk.INTERPRET = old


def _pair(store, mode, block_size=1024):
    jdt, tdt = STORES[store]
    return (JaxIndex(create_mesh(n_data=1), block_size=block_size,
                     store_dtype=jdt, mode=mode),
            MIPSIndex("cpu", block_size=block_size, store_dtype=tdt,
                      mode=mode))


def _assert_same_hits(got, want, rtol):
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=rtol)


# Tolerance: f32 and bf16 stores score the same stored values with f32
# sums in another order (1e-5 relative); int8 scores are exact int32 sums
# times the same two f32 scales in the fused kernel, and f32 products of
# the same codes in exact mode (1e-5).
@pytest.mark.parametrize("mode", ["exact", "fused"])
@pytest.mark.parametrize("store", ["f32", "bf16", "int8"])
def test_build_update_search_match_jax(store, mode):
    """build (padded tail masked), search, update_rows, search again."""
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((3000, 128), dtype=np.float32)
    queries = rng.standard_normal((12, 128), dtype=np.float32)
    jidx, tidx = _pair(store, mode)
    jidx.build(emb)
    tidx.build(emb)
    assert tidx.num_rows == 3000 and tidx.embeddings.shape == (3072, 128)
    if store == "int8":
        np.testing.assert_array_equal(tidx.embeddings.numpy(),
                                      np.asarray(jidx.embeddings))
        np.testing.assert_array_equal(tidx.row_scales.numpy(),
                                      np.asarray(jidx.row_scales))
    _assert_same_hits(tidx.search(queries, 10), jidx.search(queries, 10),
                      1e-5)

    # the rows the queries point at move: the update must be visible
    new = queries[:5] * 3.0 + rng.standard_normal((5, 128),
                                                  dtype=np.float32) * 0.1
    jidx.update_rows(2990, new)
    tidx.update_rows(2990, new)
    got = tidx.search(queries, 10)
    _assert_same_hits(got, jidx.search(queries, 10), 1e-5)
    assert list(got[1][:5, 0]) == [2990, 2991, 2992, 2993, 2994]
    with pytest.raises(ValueError, match="outside the live row range"):
        tidx.update_rows(2999, new[:2])


@pytest.mark.parametrize("mode", ["exact", "fused"])
@pytest.mark.parametrize("store", ["f32", "bf16", "int8"])
def test_duplicate_rows_search_matches_jax(store, mode):
    """An index of 1,024 small-integer passages stored 4 times (products
    exact in f32, copies tie exactly): 8 queries at k=100 return JAX's ids
    at every position."""
    rng = np.random.default_rng(7)
    emb = np.tile(rng.integers(-3, 4, (1024, 64)).astype(np.float32), (4, 1))
    queries = rng.integers(-3, 4, (8, 64)).astype(np.float32)
    jidx, tidx = _pair(store, mode)
    jidx.build(emb)
    tidx.build(emb)
    got, want = tidx.search(queries, 100), jidx.search(queries, 100)
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))


def _table(vocab=1024, h=64, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (vocab, h), dtype=np.float32)


def _jax_encode(params, ids, mask):
    # the second token's row over the live length: an all-pad row divides
    # by zero, which the streaming build must keep out of the index
    return params[ids[:, 1]] / mask.sum(axis=1, keepdims=True).astype(
        jnp.float32)


def _port_encode(table):
    def encode(ids, mask):
        return table[ids[:, 1]] / mask.sum(dim=1, keepdim=True).float()
    return encode


@pytest.mark.parametrize("store", ["bf16", "int8"])
def test_build_streaming_matches_jax(store):
    """Token ids on the wire as uint16, the mask derived on the device,
    all-pad rows zeroed, int8 codes quantized on the device: the stored
    rows are identical and so are the search results."""
    table = _table()
    rng = np.random.default_rng(2)
    ids = rng.integers(4, 1024, (700, 8)).astype(np.int32)
    ids[:, 1] = rng.permutation(np.arange(4, 1024))[:700]   # distinct rows
    ids[:, 6:] = 0
    ids[[5, 650]] = 0                          # two all-pad rows
    jidx, tidx = _pair(store, "fused", block_size=256)
    jidx.build_streaming(_jax_encode, jnp.asarray(table), ids, chunk_size=96,
                         wire_dtype=np.uint16)
    tidx.build_streaming(_port_encode(torch.from_numpy(table)), ids,
                         chunk_size=96, wire_dtype=np.uint16)
    assert tidx.num_rows == 700
    np.testing.assert_array_equal(
        tidx.embeddings.float().numpy(),
        np.asarray(jidx.embeddings.astype(jnp.float32)))
    if store == "int8":
        # live rows only (padding rows are masked in every search); jit
        # lets XLA divide by 127 as a product with its reciprocal, one f32
        # ulp off the true quotient the port (and the JAX host path) takes
        np.testing.assert_allclose(tidx.row_scales[:700].numpy(),
                                   np.asarray(jidx.row_scales)[:700],
                                   rtol=2.0 ** -23)
    assert not tidx.embeddings[[5, 650]].float().any()
    queries = rng.standard_normal((6, 64), dtype=np.float32)
    _assert_same_hits(tidx.search(queries, 10), jidx.search(queries, 10),
                      1e-5)
    with pytest.raises(ValueError, match="overflows wire dtype"):
        tidx.build_streaming(_port_encode(torch.from_numpy(table)),
                             ids + 70000, wire_dtype=np.uint16)
    tidx.free()
    with pytest.raises(RuntimeError, match="index not built"):
        tidx.search(queries, 10)


def test_corpus_encoder_chunks_in_order():
    """A bounded in-flight window of chunks (with the stall watchdog on)
    returns the rows of one whole-corpus encode, in order."""
    table = torch.from_numpy(_table())
    rng = np.random.default_rng(3)
    ids = rng.integers(4, 1024, (23, 8)).astype(np.int32)
    mask = np.ones_like(ids)
    enc = CorpusEncoder(_port_encode(table), "cpu", chunk_size=5, inflight=2,
                        stall_timeout_s=30.0)
    got = enc(ids, mask)
    want = _port_encode(table)(torch.from_numpy(ids),
                               torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32 and got.shape == (23, 64)


def test_entry_points_refuse_a_missing_card(monkeypatch):
    """Asking for CUDA without a card raises; nothing moves to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device was requested"):
        MIPSIndex()
    with pytest.raises(RuntimeError, match="CUDA device was requested"):
        CorpusEncoder(lambda i, m: i, device="cuda")
