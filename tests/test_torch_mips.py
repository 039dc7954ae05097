"""The port's MIPS top-k (plain version of K4 + PyTorch finalize) vs JAX.

The JAX kernels run under the Pallas interpreter, as
tests/test_mips_kernel.py runs them. Inputs are continuous random values,
so no two scores of a query tie and the top-k order is unambiguous, except
in the duplicate-row test, where ties are the point: equal scores must come
back in ``jax.lax.top_k``'s order (the earlier column first).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simxns_tpu.ops.mips_kernel as jmk
from simxns_tpu.ops.topk import blocked_mips_topk as jax_blocked
from simxns_tpu.ops.topk import exact_topk as jax_exact
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


@pytest.mark.parametrize("h", [64, 128, 100])
def test_fused_int8_matches_jax(h):
    """N=4096, k=10, valid_n < N, an id offset; h = 100 is off K4's 16-byte
    grid (the card pads it, ``test_rows_off_16_bytes_pad_exactly``). The
    int32 accumulators are exact on both sides and the f32 scaling is the
    same two products, so the ids are equal and the scores agree to 1e-6
    relative."""
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


@pytest.mark.parametrize("h", [64, 128, 100])
def test_fused_bf16_matches_jax(h):
    """bf16 queries and corpus (h = 100: 200-byte rows, off K4's 16-byte
    grid), f32 accumulation on both sides (only the order of the sums
    differs): ids equal, scores to 1e-5 relative."""
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


def _duplicate_rows(h=64, passages=1024, copies=4, nq=8, seed=6):
    """A corpus of ``passages`` rows repeated ``copies`` times (1024 apart)
    with small-integer values, so every product is exact in f32 and the
    copies, and many distinct rows, tie exactly."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(-3, 4, (passages, h)).astype(np.float32)
    return (rng.integers(-3, 4, (nq, h)).astype(np.float32),
            np.tile(rows, (copies, 1)))


def _scores_and_ids(out):
    return np.asarray(out[0], np.float32), np.asarray(out[1])


@pytest.mark.parametrize("what", ["fused_int8", "fused_bf16", "exact_topk",
                                  "blocked_exact", "blocked_approx",
                                  "blocked_fused", "merge_topk"])
def test_tied_scores_come_back_in_jax_order(what):
    """4,096 rows = 1,024 passages x 4, 8 queries, k=100: the ids equal
    JAX's at every position (the scores are exact on both sides)."""
    q, c = _duplicate_rows()
    k, kw = 100, dict(block_size=1024, valid_n=4000, id_offset=5)
    tq, tc = torch.from_numpy(q), torch.from_numpy(c)
    if what == "fused_int8":
        codes, scales = jmk.quantize_rows(jnp.asarray(c))
        want = jmk.fused_mips_topk_int8(jnp.asarray(q), codes, scales, k,
                                        valid_n=4000, id_offset=5)
        got = tmk.fused_mips_topk_int8(
            tq, torch.from_numpy(np.asarray(codes)),
            torch.from_numpy(np.asarray(scales)), k, valid_n=4000,
            id_offset=5)
    elif what == "fused_bf16":
        want = jmk.fused_mips_topk(jnp.asarray(q, jnp.bfloat16),
                                   jnp.asarray(c, jnp.bfloat16), k,
                                   valid_n=4000, id_offset=5)
        got = tmk.fused_mips_topk(tq.to(torch.bfloat16),
                                  tc.to(torch.bfloat16), k, valid_n=4000,
                                  id_offset=5)
    elif what == "exact_topk":
        want = jax_exact(jnp.asarray(q), jnp.asarray(c), k, id_offset=5)
        got = exact_topk(tq, tc, k, id_offset=5)
    elif what.startswith("blocked_"):
        mode = what.split("_")[1]
        want = jax_blocked(jnp.asarray(q), jnp.asarray(c), k, mode=mode, **kw)
        got = blocked_mips_topk(tq, tc, k, mode=mode, **kw)
    else:
        # per-shard lists of the duplicate corpus's quarters, merged
        want_l, got_l = [], []
        for r0 in range(0, 4096, 1024):
            want_l.append(jax_exact(jnp.asarray(q), jnp.asarray(c[r0:r0 + 1024]),
                                    k, id_offset=r0))
            got_l.append(exact_topk(tq, tc[r0:r0 + 1024], k, id_offset=r0))
        want = jax_merge(jnp.stack([w[0] for w in want_l]),
                         jnp.stack([w[1] for w in want_l]), k)
        got = merge_topk(torch.stack([g[0] for g in got_l]),
                         torch.stack([g[1] for g in got_l]), k)
    want_s, want_i = _scores_and_ids(want)
    got_s, got_i = _scores_and_ids(got)
    np.testing.assert_array_equal(got_s, want_s)
    np.testing.assert_array_equal(got_i, want_i)
    # the ties are real: each query's list holds equal scores
    assert all(len(set(row)) < k for row in got_s.tolist())


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("block_n,bucket", [(2000, 128), (2000, 100),
                                            (1750, 128)])
def test_fused_at_any_block_and_bucket_matches_jax(int8, block_n, bucket):
    """~4,000 rows at a block that is not a multiple of 128 (the JAX kernel
    pads the corpus to any block) and at a bucket that does not divide 128
    (bucket=100 at block_n=2000): equal ids; scores as the tests above hold
    them. On the card K4 covers the padded corpus whatever the block and
    runs such a bucket at gcd(bucket, 128)."""
    q, c = _data(64, n=3990, seed=7)
    kw = dict(block_n=block_n, bucket=bucket, valid_n=3950, id_offset=11)
    if int8:
        codes, scales = jmk.quantize_rows(jnp.asarray(c))
        want = jmk.fused_mips_topk_int8(jnp.asarray(q), codes, scales, 10,
                                        **kw)
        got = tmk.fused_mips_topk_int8(
            torch.from_numpy(q), torch.from_numpy(np.asarray(codes)),
            torch.from_numpy(np.asarray(scales)), 10, **kw)
        rtol = 1e-6
    else:
        want = jmk.fused_mips_topk(jnp.asarray(q, jnp.bfloat16),
                                   jnp.asarray(c, jnp.bfloat16), 10, **kw)
        got = tmk.fused_mips_topk(torch.from_numpy(q).to(torch.bfloat16),
                                  torch.from_numpy(c).to(torch.bfloat16), 10,
                                  **kw)
        rtol = 1e-5
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=rtol)


@pytest.mark.parametrize("int8", [False, True])
def test_blocked_fused_at_block_size_1750_matches_jax(int8):
    """blocked_mips_topk(mode="fused", block_size=1750): the block the JAX
    launcher's min(8192, max(32, N // 4)) gives a corpus of 7,000 rows
    (bucket 2 there, from _fit_bucket); equal ids, scores to 1e-5."""
    q, c = _data(128, n=4000, seed=8)
    kw = dict(block_size=1750, valid_n=3900, id_offset=3, mode="fused")
    if int8:
        codes, scales = jmk.quantize_rows(jnp.asarray(c))
        jq = jnp.asarray(q, jnp.bfloat16)
        want = jax_blocked(jq, codes, 10, row_scales=scales, **kw)
        got = blocked_mips_topk(
            torch.from_numpy(np.array(jq.astype(jnp.float32))).to(
                torch.bfloat16),
            torch.from_numpy(np.asarray(codes)), 10,
            row_scales=torch.from_numpy(np.asarray(scales)), **kw)
    else:
        want = jax_blocked(jnp.asarray(q), jnp.asarray(c), 10, **kw)
        got = blocked_mips_topk(torch.from_numpy(q), torch.from_numpy(c), 10,
                                **kw)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5)


@pytest.mark.parametrize("bucket,g,n_pad", [(100, 4, 1600),
                                            (256, 128, 1792),
                                            (12, 4, 1608), (40, 8, 1600)])
def test_merging_kernel_buckets_is_exact(bucket, g, n_pad):
    """What the wrapper does on the card for a bucket that does not divide
    128: candidates of buckets of g = gcd(bucket, 128), merged by runs of
    bucket / g, equal those of ``bucket`` itself, ties included (the
    duplicate corpus: the first row reaching a bucket's maximum wins)."""
    q, c = _duplicate_rows(h=32, passages=800, copies=2, nq=5, seed=9)
    tq, tc = torch.from_numpy(q), torch.from_numpy(c)
    want = tmk._candidates_plain(tq, tc, 1580, bucket, n_pad, None, None)
    sub = tmk._candidates_plain(tq, tc, 1580, g, n_pad, None, None)
    got = tmk._merge_buckets(*sub, bucket // g)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # ties across sub-buckets are real: some bucket's maximum is reached in
    # more than one of its sub-buckets
    runs = sub[0].view(sub[0].shape[0], -1, bucket // g)
    assert bool(((runs == want[0][..., None]).sum(dim=-1) > 1).any())


def test_kernel_row_width():
    """K4's row width: the values of a row padded up to 16 bytes."""
    for h, itemsize, want in ((100, 1, 112), (100, 2, 104), (64, 1, 64),
                              (768, 2, 768), (24, 1, 32), (1, 2, 8),
                              (16, 1, 16), (17, 1, 32)):
        assert tmk.kernel_row_width(h, itemsize) == want


@pytest.mark.parametrize("int8", [False, True])
def test_rows_off_16_bytes_pad_exactly(int8):
    """The card's route for rows off the 16-byte grid (width 100): queries
    and corpus take zero columns up to ``kernel_row_width`` before K4.
    Zero columns add exact zeros to every score: over the plain version
    the padded candidates are the unpadded ones, bitwise in int8 (integer
    sums), and in bf16 the same ids with scores to f32 rounding."""
    q, c = _data(100, n=3000, nq=9, seed=12)
    if int8:
        qv, qs = tmk.quantize_rows(torch.from_numpy(q))
        cv, cs = tmk.quantize_rows(torch.from_numpy(c))
    else:
        qv, cv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, c))
        qs = cs = None
    hp = tmk.kernel_row_width(100, cv.element_size())
    assert hp == (112 if int8 else 104)
    pad = [torch.nn.functional.pad(t, (0, hp - 100)) for t in (qv, cv)]
    want = tmk._candidates_plain(qv, cv, 2990, 128, 4096, qs, cs)
    got = tmk._candidates_plain(*pad, 2990, 128, 4096, qs, cs)
    assert torch.equal(got[1], want[1])
    if int8:
        assert torch.equal(got[0], want[0])
    else:
        torch.testing.assert_close(got[0], want[0], rtol=1e-6, atol=0)


def test_plain_candidates_cut_whole_buckets():
    """The plain version walks the corpus in chunks of whole buckets: a
    bucket that does not divide its 65,536-row chunk (100) still reduces
    aligned buckets past the first chunk."""
    rng = np.random.default_rng(10)
    q = torch.from_numpy(rng.standard_normal((2, 16), dtype=np.float32))
    c = torch.from_numpy(rng.standard_normal((70000, 16), dtype=np.float32))
    s, i = tmk._candidates_plain(q, c, 70000, 100, 70000, None, None)
    scores = q @ c.T
    want = scores.view(2, 700, 100).max(dim=-1)
    assert torch.equal(s, want.values)
    assert torch.equal(i.long(), want.indices + torch.arange(700) * 100)


@pytest.mark.parametrize("q,n_pad,bucket,tile", [
    (8, 8_847_360, 128, (64, 128)), (1, 8_847_360, 16, (64, 128)),
    (64, 24_576, 32, (64, 128)), (1024, 8_847_360, 128, (128, 256)),
    (300, 4096, 128, (64, 128)), (300, 70_001, 16, (128, 256)),
    (1024, 8_847_360, 4, (64, 128))])
def test_mips_tile_rule(q, n_pad, bucket, tile):
    """K4's tile on an H100's 132 SMs: 64 x 128 up to 64 queries, 128 x 256
    above once its tiles fill the SMs, else 64 x 128; 64 x 128 (the only
    kernel) for buckets under 8."""
    from simxns_tpu_torch.ops import _native

    assert _native.mips_tile(q, n_pad, bucket, 132) == tile
