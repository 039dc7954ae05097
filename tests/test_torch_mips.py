"""The port's MIPS top-k (plain version of K4 + PyTorch finalize) vs JAX.

The JAX kernels run under the Pallas interpreter, as
tests/test_mips_kernel.py runs them. Inputs are continuous random values,
so no two scores of a query tie and the top-k order is unambiguous.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simxns_tpu.ops.mips_kernel as jmk
from simxns_tpu.ops.topk import blocked_mips_topk as jax_blocked
from simxns_tpu.ops.topk import merge_topk as jax_merge
from simxns_tpu_torch.ops import mips_kernel as tmk
from simxns_tpu_torch.ops.topk import blocked_mips_topk, exact_topk, merge_topk
from torch_parity import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _interpret():
    old = jmk.INTERPRET
    jmk.INTERPRET = True
    yield
    jmk.INTERPRET = old


def _data(h, n=4096, nq=12, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((nq, h), dtype=np.float32),
            rng.standard_normal((n, h), dtype=np.float32))


@pytest.mark.parametrize("h", [64, 128])
def test_fused_int8_matches_jax(h):
    """N=4096, k=10, valid_n < N, an id offset. The int32 accumulators are
    exact on both sides and the f32 scaling is the same two products, so
    the ids are equal and the scores agree to 1e-6 relative."""
    q, c = _data(h)
    codes, scales = jmk.quantize_rows(jnp.asarray(c))
    want_s, want_i = jmk.fused_mips_topk_int8(
        jnp.asarray(q), codes, scales, 10, valid_n=3900, id_offset=1000)
    t_codes, t_scales = tmk.quantize_rows(torch.from_numpy(c))
    np.testing.assert_array_equal(t_codes.numpy(), np.asarray(codes))
    got_s, got_i = tmk.fused_mips_topk_int8(
        torch.from_numpy(q), t_codes, t_scales, 10, valid_n=3900,
        id_offset=1000)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-6)
    assert got_i.numpy().max() < 1000 + 3900


@pytest.mark.parametrize("h", [64, 128])
def test_fused_bf16_matches_jax(h):
    """bf16 queries and corpus, f32 accumulation on both sides (only the
    order of the sums differs): ids equal, scores to 1e-5 relative."""
    q, c = _data(h, seed=1)
    qb = jnp.asarray(q, jnp.bfloat16)
    cb = jnp.asarray(c, jnp.bfloat16)
    want_s, want_i = jmk.fused_mips_topk(qb, cb, 10, valid_n=4000,
                                         id_offset=7)
    got_s, got_i = tmk.fused_mips_topk(
        torch.from_numpy(q).to(torch.bfloat16),
        torch.from_numpy(c).to(torch.bfloat16), 10, valid_n=4000,
        id_offset=7)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5)


@pytest.mark.parametrize("mode,int8", [("fused", False), ("fused", True),
                                       ("exact", False), ("exact", True),
                                       ("approx", False), ("approx", True)])
def test_blocked_mips_topk_matches_jax(mode, int8):
    """blocked_mips_topk in every mode, f32 and int8 corpora, with a masked
    tail: equal ids, scores to 1e-5 relative."""
    q, c = _data(128, n=4096, seed=2)
    kw = dict(block_size=1024, valid_n=4000, id_offset=3)
    if int8:
        codes, scales = jmk.quantize_rows(jnp.asarray(c))
        jq = jnp.asarray(q, jnp.bfloat16)
        want = jax_blocked(jq, codes, 10, mode=mode, row_scales=scales, **kw)
        got = blocked_mips_topk(
            torch.from_numpy(np.array(jq.astype(jnp.float32))).to(
                torch.bfloat16),
            torch.from_numpy(np.asarray(codes)), 10, mode=mode,
            row_scales=torch.from_numpy(np.asarray(scales)), **kw)
    else:
        want = jax_blocked(jnp.asarray(q), jnp.asarray(c), 10, mode=mode,
                           **kw)
        got = blocked_mips_topk(torch.from_numpy(q), torch.from_numpy(c), 10,
                                mode=mode, **kw)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5)


def test_small_corpus_takes_exact_path():
    """A corpus under 64*k rows takes the exact path in fused mode (the JAX
    rule at topk.py:94-99): every true top-k hit comes back, including
    two that share a bucket."""
    q, c = _data(128, n=600, seed=3)
    c[10] = c[11] + 1e-3 * c[10]            # two near rows, one bucket
    q[0] = c[11]
    want = jax_blocked(jnp.asarray(q), jnp.asarray(c), 10, mode="fused",
                       block_size=256)
    got = blocked_mips_topk(torch.from_numpy(q), torch.from_numpy(c), 10,
                            mode="fused", block_size=256)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert {10, 11} <= set(got[1][0].tolist())
    exact = exact_topk(torch.from_numpy(q), torch.from_numpy(c), 10)
    np.testing.assert_array_equal(got[1].numpy(), exact[1].numpy())


def test_candidates_pad_when_fewer_than_k():
    """Fewer candidate columns than k: the list is backfilled with -1 ids
    and -1e30 scores (jax _pad_candidates), as on the JAX side."""
    q, c = _data(64, n=48, nq=5, seed=4)
    want_s, want_i = jmk.fused_mips_topk(jnp.asarray(q), jnp.asarray(c), 10,
                                         block_n=16, bucket=128)
    got_s, got_i = tmk.fused_mips_topk(torch.from_numpy(q),
                                       torch.from_numpy(c), 10, block_n=16,
                                       bucket=128)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5)


@pytest.mark.parametrize("args", [(128, 2048, 8_847_360, 10),
                                  (128, 256, 4096, 10), (128, 16, 48, 10),
                                  (64, 2048, 2048, 100)])
def test_fit_bucket_matches_jax(args):
    assert tmk._fit_bucket(*args) == jmk._fit_bucket(*args)


def test_merge_topk_matches_jax():
    rng = np.random.default_rng(5)
    s = rng.standard_normal((3, 4, 6)).astype(np.float32)
    i = rng.integers(0, 1000, (3, 4, 6)).astype(np.int32)
    want = jax_merge(jnp.asarray(s), jnp.asarray(i), 5)
    got = merge_topk(torch.from_numpy(s), torch.from_numpy(i), 5)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
