"""Checks of the port that need a CUDA card (marker ``cuda``).

They skip on a machine without one. On the card, from the repo root (the
JAX conftest is not needed and JAX need not be installed):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Each kernel wrapper launches its kernel for CUDA tensors (its launch count
rises) and agrees with its plain version at small shapes (K1, the int8
GEMM, bitwise at its tile edges in both epilogues; K5/K6, the grouped
attention pair, and K7/K8, the per-(batch, head) pair, at every S class
they take and at their tile edges, with a fully
masked batch row; two backward calls bitwise equal; K9-K12, the fused FFN
kernels, at tiling and ragged shapes, at H = 128 to 1152, and under
autograd, K12 at every branch of its GEMMs' tile rule, K10 and K11's
MN-major GEMM exact on small integers, K11 bitwise from run to run;
K13/K14, the int8 encode kernels, bitwise against their plain versions at
tiling and ragged shapes (K14 at every branch of its tile rule, without a
launch of K1 or K2; both at I = H = 1152), in a model, and the JAX
dispatch where the shapes do not tile); the knobs at every width on the
128 grid through their kernels, and off it as the JAX package's
expressions; K4, the MIPS bucket candidates, bitwise (int8) at every
bucket, at query counts across both tiles, at blocks off the 128 grid
and through the gcd merge of a bucket off 128, with the fused search at
the launcher's block for 8,000 rows; what a kernel does not take raises
instead of running a plain version on the card. The f32 instances of
K5-K8 are held against an f64 evaluation (and against the bf16 instance,
which they must beat 16-fold).
"""

import pytest
import torch

from simxns_tpu_torch import ops
from simxns_tpu_torch.ops import flash_attention as fa
from simxns_tpu_torch.ops import fused_ffn
from simxns_tpu_torch.ops import fused_layer as fl
from simxns_tpu_torch.ops import mips_kernel as mk
from simxns_tpu_torch.ops.attention import multi_head_attention

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _randn(dev, *shape, scale=1.0, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(*shape, device=dev, generator=gen) * scale


# (M, N, K) across K1's tile edges: 64-row (one consumer warpgroup) and
# 128-row tiles; 64-, 128- and 256-column tiles (the tile choice follows the
# tile count against the SMs, on 132 of them: M=4097 x N=3072 and M=8500 x
# N=1000 take 128 x 256, M=4097 x N=768 and M=8191 x N=1000 take 64 x 128,
# the rest 64 x 64); K within one 128-byte stage (16, 48), across stages
# (208, 768) and past the 4-stage ring (3072); N not a multiple of 8 (1000
# past the last 256-column tile; 97: rows not 16-byte aligned, no vector
# stores)
K1_CASES = [(1, 96, 16), (63, 768, 48), (64, 2304, 768), (65, 3072, 3072),
            (255, 96, 768), (256, 2304, 768), (300, 97, 16),
            (4097, 3072, 768), (4097, 768, 3072), (4097, 96, 48),
            (8191, 1000, 208), (8500, 1000, 208)]


@pytest.mark.parametrize("m,n,k", K1_CASES)
def test_int8_linear_and_row_quant_match_plain(dev, m, n, k):
    """Integer sums are exact and the epilogue is the same f32 operations:
    K1 equals its plain version bit for bit, with and without GELU, to f32
    and to bf16 (each staged at its own pitch and slice width); K2's codes
    and scales equal the plain ones on these rows (a code may flip only
    across a rounding tie)."""
    x = _randn(dev, m, k, seed=m + n + k)
    before = fl.int8_linear.launches, fl.row_quant.launches
    a8, xs, _, _ = fl.row_quant(x)
    p8, ps, _, _ = fl._row_quant_plain(x, None, None, 1e-12, True, False,
                                       False)
    assert torch.equal(a8, p8) and torch.equal(xs, ps)
    w8, ws = fl.quant_rows(_randn(dev, n, k, scale=0.02, seed=1))
    b = _randn(dev, n, scale=0.02, seed=2)
    epilogues = [(gelu, od) for gelu in (False, True)
                 for od in (torch.float32, torch.bfloat16)]
    for gelu, od in epilogues:
        got = fl.int8_linear(a8, xs, w8, ws, b, gelu=gelu, out_dtype=od)
        want = fl._int8_linear_plain(a8, xs, w8, ws, b, gelu, od)
        assert got.shape == (m, n) and got.dtype == od
        assert torch.equal(got, want), (gelu, od, float(
            (got.float() - want.float()).abs().max()))
    assert (fl.int8_linear.launches, fl.row_quant.launches) == (
        before[0] + len(epilogues), before[1] + 1)


@pytest.mark.parametrize("d", [16, 32, 64, 80, 96, 128, 24])
@pytest.mark.parametrize("s", [1, 32, 128, 160, 300, 512, 1024, 1100])
def test_small_s_attention_matches_plain(dev, s, d):
    """Every key-tile count K3 meets (S = 1 .. 1,100: one tile of 128 keys
    up to S = 128, 64-key tiles past it, ragged last tiles, past the 1,024
    it once refused), head widths on the 16 grid and one off it (24: the 32
    instance over zero-padded heads), one sequence fully masked, one cut
    short, one with every key and one with its first key alone (the
    shortest and longest key lengths). p is rounded to bf16 on both sides;
    the context may move by one bf16 step of p times |v| (<= 2^-7
    max|v|). Heads wider than 128 raise: the layer routes them to the plain
    version (``layer_attention``)."""
    b, heads = 4, 2
    h = heads * d
    qkv = _randn(dev, b * s, 3 * h, seed=s + d).to(torch.bfloat16)
    mask = torch.ones(b, s, dtype=torch.int32, device=dev)
    mask[0] = 0
    mask[1, (s + 1) // 2:] = 0
    mask[3, 1:] = 0
    before = fl.small_s_attention.launches
    got = fl.small_s_attention(qkv, mask, heads)
    want = fl._small_s_attention_plain(qkv, mask, heads)
    tol = 2.0 ** -7 * float(qkv[:, 2 * h:].float().abs().max())
    assert float((got - want).abs().max()) <= tol
    assert fl.small_s_attention.launches == before + 1
    with pytest.raises(ValueError, match="head widths 1 .. 128"):
        fl.small_s_attention(qkv.new_zeros(s, 3 * 192), mask[:1], 1)


def test_stable_finalize_on_duplicate_rows(dev):
    """A corpus of 1,024 small-integer passages stored 4 times: on the
    card the fused int8 search, the fused bf16 search and exact_topk return
    the plain versions' scores and ids (the earlier of equal scores first)
    at every position."""
    from simxns_tpu_torch.ops.topk import exact_topk

    gen = torch.Generator().manual_seed(9)
    rows = torch.randint(-3, 4, (1024, 64), generator=gen).float()
    c = rows.repeat(4, 1)
    q = torch.randint(-3, 4, (8, 64), generator=gen).float()
    codes, scales = mk.quantize_rows(c)
    before = mk.mips_bucket_candidates.launches
    cases = [
        (lambda t: mk.fused_mips_topk_int8(t(q), t(codes), t(scales), 100,
                                           valid_n=4000, id_offset=5)),
        (lambda t: mk.fused_mips_topk(t(q).to(torch.bfloat16),
                                      t(c).to(torch.bfloat16), 100,
                                      valid_n=4000, id_offset=5)),
        (lambda t: exact_topk(t(q), t(c), 100, id_offset=5))]
    for case in cases:
        got = case(lambda x: x.to(dev))
        want = case(lambda x: x)
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])
        assert all(len(set(r)) < 100 for r in want[0].tolist())   # ties
    assert mk.mips_bucket_candidates.launches == before + 2


# (Q, N, block_n, bucket) across K4's tiles and edges: Q from 1 to 300 (one
# or two consumer warpgroups, ragged query tiles), N off every tile and
# block (a tile wholly past N runs no products), blocks off the 128 grid
# (2,000 and 1,750: the JAX launcher's block for 8,000 and 7,000 rows),
# every bucket from 1 to 128 (under 8 the small-bucket kernel), and both
# tiles (64 x 128 up to 64 queries; 128 x 256 from 130 queries over 70,001
# rows on 132 SMs)
K4_CASES = [(5, 3000, 2048, 64), (1, 3001, 2048, 128), (8, 3001, 2048, 8),
            (63, 5000, 2048, 16), (64, 2999, 2048, 32), (65, 3001, 2048, 128),
            (130, 4097, 2048, 64), (300, 3001, 2048, 128),
            (8, 7999, 2000, 16), (130, 8000, 2000, 8), (64, 7001, 1750, 2),
            (65, 3001, 2048, 1), (300, 3001, 2048, 4), (8, 40000, 2048, 128),
            (130, 70001, 2048, 128), (300, 70001, 2048, 16)]


@pytest.mark.parametrize("q,n,block_n,bucket", K4_CASES)
def test_mips_candidates_match_plain(dev, q, n, block_n, bucket):
    """int8: the same integer sums and the same two f32 products, so scores
    and ids are equal; bf16 scores agree to f32 summation order, and where
    an id differs the two rows' f32 scores tie to that order (a near-tie
    inside a bucket)."""
    valid_n = n - 37
    n_pad = -(-n // block_n) * block_n
    qf = _randn(dev, q, 128, seed=q)
    c = _randn(dev, n, 128, seed=n)
    q8, qs = mk.quantize_rows(qf)
    c8, cs = mk.quantize_rows(c)
    before = mk.mips_bucket_candidates.launches
    kw = dict(bucket=bucket, block_n=block_n)
    got = mk.mips_bucket_candidates(q8, c8, valid_n, query_scales=qs,
                                    row_scales=cs, **kw)
    want = mk._candidates_plain(q8, c8, valid_n, bucket, n_pad, qs, cs)
    assert got[0].shape == (q, n_pad // bucket)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    q16, c16 = qf.to(torch.bfloat16), c.to(torch.bfloat16)
    got = mk.mips_bucket_candidates(q16, c16, valid_n, **kw)
    want = mk._candidates_plain(q16, c16, valid_n, bucket, n_pad, None, None)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-4)
    off = got[1] != want[1]
    if bool(off.any()):
        rows = off.nonzero()[:, 0]
        full = q16.float() @ c16.float().T
        mine = full[rows, got[1][off].long()]
        theirs = full[rows, want[1][off].long()]
        torch.testing.assert_close(mine, theirs, rtol=1e-5, atol=1e-4)
    assert int(off.sum()) <= max(2, 1e-5 * off.numel())
    assert mk.mips_bucket_candidates.launches == before + 2


@pytest.mark.parametrize("bucket", [1, 4, 8, 128])
def test_mips_candidates_first_duplicate_wins(dev, bucket):
    """Small-integer rows, each stored twice side by side (so both copies
    lie in one bucket) and products exact in f32 on both sides: the first
    copy is the bucket's id, int8 and bf16 bitwise equal to the plain
    version."""
    gen = torch.Generator().manual_seed(11)
    rows = torch.randint(-3, 4, (1500, 64), generator=gen).float()
    c = rows.repeat_interleave(2, dim=0)
    q = torch.randint(-3, 4, (70, 64), generator=gen).float()
    codes, scales = mk.quantize_rows(c)
    q8, qs = mk.quantize_rows(q)
    kw = dict(bucket=bucket, block_n=2048)
    for args, scl in (((q8, codes), dict(query_scales=qs, row_scales=scales)),
                      ((q.to(torch.bfloat16), c.to(torch.bfloat16)), {})):
        got = mk.mips_bucket_candidates(*(a.to(dev) for a in args), 2990,
                                        **kw, **{k: v.to(dev)
                                                 for k, v in scl.items()})
        want = mk.mips_bucket_candidates(*args, 2990, **kw, **scl)
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])
        if bucket > 1:
            assert bool((want[1][:, :1400] % 2 == 0).all())   # first copy


def test_mips_bucket_off_128_through_gcd(dev):
    """bucket=100 at block_n=2000: the kernel runs at gcd(100, 128) = 4 (one
    launch) and the wrapper merges runs of 25; equal to the plain version
    at bucket 100 (int8 bitwise), and through fused_mips_topk_int8."""
    qf, c = _randn(dev, 70, 128, seed=4), _randn(dev, 4000, 128, seed=5)
    q8, qs = mk.quantize_rows(qf)
    c8, cs = mk.quantize_rows(c)
    before = mk.mips_bucket_candidates.launches
    got = mk.mips_bucket_candidates(q8, c8, 3950, bucket=100, block_n=2000,
                                    query_scales=qs, row_scales=cs)
    want = mk._candidates_plain(q8, c8, 3950, 100, 4000, qs, cs)
    assert got[0].shape == (70, 40)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert mk.mips_bucket_candidates.launches == before + 1
    kw = dict(block_n=2000, bucket=100, valid_n=3950, id_offset=3)
    top = mk.fused_mips_topk_int8(qf, c8, cs, 10, **kw)
    ref = mk.fused_mips_topk_int8(qf.cpu(), c8.cpu(), cs.cpu(), 10, **kw)
    assert torch.equal(top[1].cpu(), ref[1])
    assert torch.equal(top[0].cpu(), ref[0])


@pytest.mark.parametrize("int8", [True, False])
def test_fused_search_at_block_size_2000(dev, int8):
    """The launcher's block for 8,000 passages (min(8192, max(32, N // 4))
    = 2,000, not a multiple of 128) at k=100: blocked_mips_topk in fused
    mode and a fused MIPSIndex launch K4 and return what the plain version
    returns on the CPU (int8 bitwise; bf16 ids where no near-tie decides,
    top-100 overlap >= 0.99)."""
    import numpy as np

    from simxns_tpu_torch.index.engine import MIPSIndex
    from simxns_tpu_torch.ops.topk import blocked_mips_topk

    rng = np.random.default_rng(12)
    emb = rng.standard_normal((8000, 128), dtype=np.float32)
    qry = rng.standard_normal((64, 128), dtype=np.float32)
    dtype = torch.int8 if int8 else torch.bfloat16
    before = mk.mips_bucket_candidates.launches
    out = {}
    for device in (dev, torch.device("cpu")):
        index = MIPSIndex(device=device, block_size=2000, store_dtype=dtype,
                          mode="fused")
        index.build(emb)
        out[device.type] = index.search(qry, 100)
        qt = torch.from_numpy(qry).to(device).to(index.query_dtype())
        out[device.type + "_blocked"] = blocked_mips_topk(
            qt, index.embeddings, 100, block_size=2000, valid_n=7990,
            mode="fused",
            row_scales=index.row_scales if int8 else None)
    assert mk.mips_bucket_candidates.launches == before + 2
    got_i, want_i = out["cuda"][1], out["cpu"][1]
    got_b = [t.cpu() for t in out["cuda_blocked"]]
    want_b = out["cpu_blocked"]
    if int8:
        np.testing.assert_array_equal(got_i, want_i)
        np.testing.assert_array_equal(out["cuda"][0], out["cpu"][0])
        assert torch.equal(got_b[0], want_b[0])
        assert torch.equal(got_b[1], want_b[1])
    else:
        for g, w in ((got_i, want_i), (got_b[1].numpy(), want_b[1].numpy())):
            overlap = sum(len(set(a) & set(b)) for a, b in zip(
                g.tolist(), w.tolist())) / g.size
            assert overlap >= 0.99
        np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5,
                                   atol=1e-4)
    assert int(want_i.max()) < 8000 and int(want_b[1].max()) < 7990


def test_mips_candidates_refuse_rows_off_16_bytes(dev):
    """Rows off K4's 16-byte grid (its TMA maps need 16-byte row strides),
    once refused, now take zero columns up to it (ROADMAP Queue 3 item 9
    (c)): an int8 index of width 100 (100 bytes a row, padded to 112) and
    bf16 rows of 100 (200 bytes, padded to 104) launch K4, the int8
    candidates bitwise the unpadded plain version's, the bf16 ones to f32
    summation order; and the fused int8 search over that index returns
    the plain search's ids."""
    qf = _randn(dev, 9, 100, seed=1)
    c = _randn(dev, 3001, 100, seed=2)
    q8, qs = mk.quantize_rows(qf)
    c8, cs = mk.quantize_rows(c)
    before = mk.mips_bucket_candidates.launches
    kw = dict(bucket=128, block_n=2048)
    got = mk.mips_bucket_candidates(q8, c8, 2990, query_scales=qs,
                                    row_scales=cs, **kw)
    want = mk._candidates_plain(q8, c8, 2990, 128, 4096, qs, cs)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    q16, c16 = qf.to(torch.bfloat16), c.to(torch.bfloat16)
    got = mk.mips_bucket_candidates(q16, c16, 2990, **kw)
    want = mk._candidates_plain(q16, c16, 2990, 128, 4096, None, None)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-4)
    assert mk.mips_bucket_candidates.launches == before + 2
    top = mk.fused_mips_topk_int8(qf, c8, cs, 10)
    plain = mk.fused_mips_topk_int8(qf.cpu(), c8.cpu(), cs.cpu(), 10)
    assert torch.equal(top[1].cpu(), plain[1])
    assert mk.mips_bucket_candidates.launches == before + 3


def _int8_weights(dev, o, i, seed):
    """An nn.Linear weight [o, i] and bias at a BERT layer's scale, with
    its per-channel codes and scales: (w, b, (w8, ws, b))."""
    w = _randn(dev, o, i, scale=0.02, seed=seed)
    b = _randn(dev, o, scale=0.02, seed=seed + 1)
    return w, b, (*fused_ffn.quantize_weight(w), b)


@pytest.mark.parametrize("m,i,o", [(256, 768, 2304), (37, 256, 384),
                                   (1, 1024, 128), (600, 768, 768),
                                   (4000, 128, 256), (131, 768, 768),
                                   (65, 1024, 2304), (2048, 768, 2304),
                                   (4097, 768, 2304), (300, 1152, 3456)])
def test_int8_dense_matches_plain(dev, m, i, o):
    """K13 (the codes of x, then the wgmma GEMM, through the workspaces of
    ``int8_dense_workspace``) bitwise against its plain version at ragged
    M, one K stage (I = 128), the quantizer's widest row (I = 1024) and
    every GEMM tile on 132 SMs (64 x 64 up to 600 rows, 64 x 128 at 2,048,
    128 x 256 at 4,097), I = 1152 (a row longer than a warp holds: read
    twice); one launch count a call."""
    x = _randn(dev, m, i, seed=m).to(torch.bfloat16)
    _, _, q = _int8_weights(dev, o, i, seed=i)
    before = fused_ffn.int8_dense_fwd.launches
    got = fused_ffn.int8_dense_fwd(x, *q)
    want = fused_ffn._int8_dense_plain(x, *q)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (m, o)
    assert torch.equal(got, want)
    assert fused_ffn.int8_dense_fwd.launches == before + 1


# (M, H, F) for K12 and K14, two GEMMs each ([M, F], then [M, H]); their
# tiles on 132 SMs (ops/_native.py:wgmma_tile): 64 x 64 for both up to
# M = 256; 4,000 x 3072 and 4,097 x 4096 take 128 x 256 for the first GEMM
# and 64 x 128 for the second; 12,000 x 768 takes 128 x 256 for both. M = 1,
# 37, 65 and 129 (one row past a 64- and a 128-row tile), 4,000 and 4,097
# leave ragged row tiles; F = 384 is off the 256 grid (a ragged 256-column
# tile of the first GEMM). H = 128, 512 and 1152 (F = 4 H, ragged M) are
# widths off the models', on the JAX kernels' 128 grid.
FFN_TILE_CASES = [(1, 256, 128), (33, 1024, 384), (37, 768, 512),
                  (64, 256, 256),
                  (65, 1024, 384), (129, 256, 384), (256, 768, 3072),
                  (4000, 768, 3072), (4097, 1024, 4096), (12000, 768, 3072),
                  (77, 128, 512), (301, 512, 2048), (65, 1152, 4608)]


@pytest.mark.parametrize("m,h,f", FFN_TILE_CASES)
def test_int8_ffn_matches_plain(dev, m, h, f):
    """K14 bitwise against its plain version (the same codes, exact integer
    sums, the same f32 operations in the same order) at every branch of
    the tile rule and at ragged M; one launch count a call."""
    x = _randn(dev, m, h, seed=m + h).to(torch.bfloat16)
    _, _, (w1_8, s1, b1) = _int8_weights(dev, f, h, seed=1)
    _, _, (w2_8, s2, b2) = _int8_weights(dev, h, f, seed=3)
    args = (x, w1_8, s1, b1, w2_8, s2, b2)
    before = fused_ffn.int8_ffn_fwd.launches
    got = fused_ffn.int8_ffn_fwd(*args)
    want = fused_ffn._int8_ffn_plain(*args)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (m, h)
    assert torch.equal(got, want), int((got != want).sum())
    assert fused_ffn.int8_ffn_fwd.launches == before + 1


def test_int8_ffn_bypasses_k1_and_k2(dev):
    """K14 runs its own launches: the int8 encode path moves neither K1's
    nor K2's launch count."""
    x = _randn(dev, 300, 768, seed=2).to(torch.bfloat16)
    _, _, (w1_8, s1, b1) = _int8_weights(dev, 3072, 768, seed=1)
    _, _, (w2_8, s2, b2) = _int8_weights(dev, 768, 3072, seed=3)
    before = (fl.int8_linear.launches, fl.row_quant.launches,
              fused_ffn.int8_ffn_fwd.launches)
    fused_ffn.int8_ffn_fwd(x, w1_8, s1, b1, w2_8, s2, b2)
    torch.cuda.synchronize()
    assert (fl.int8_linear.launches, fl.row_quant.launches,
            fused_ffn.int8_ffn_fwd.launches) == (*before[:2], before[2] + 1)


@pytest.mark.parametrize("m,h,f", FFN_TILE_CASES)
def test_ffn_train_fwd_matches_plain(dev, m, h, f):
    """K9, K12's GEMM pair with hb stored by the first GEMM's epilogue,
    against its plain version at every branch of the tile rule and at
    ragged M: y and hb within one bf16 step of the largest value; one
    launch count a call."""
    x, w1, b1, w2, b2, _ = _ffn_inputs(dev, m, h, f, seed=m + h)
    before = fused_ffn.ffn_train_fwd.launches
    y, hb = fused_ffn.ffn_train_fwd(x, w1, b1, w2, b2)
    y_ref, hb_ref = fused_ffn._ffn_train_fwd_plain(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert y.dtype == hb.dtype == torch.bfloat16
    assert y.shape == (m, h) and hb.shape == (m, f)
    _close_bf16(hb, hb_ref, ("hb", m, h, f))
    _close_bf16(y, y_ref, ("y", m, h, f))
    assert fused_ffn.ffn_train_fwd.launches == before + 1


@pytest.mark.parametrize("m,h,f", FFN_TILE_CASES)
def test_ffn_fused_fwd_matches_plain(dev, m, h, f):
    """K12's two GEMMs against its plain version at every branch of the
    tile rule and at ragged M: within one bf16 step of the largest value
    (the f32 sums run in another order); one launch count a call."""
    x, w1, b1, w2, b2, _ = _ffn_inputs(dev, m, h, f, seed=m + h)
    before = fused_ffn.ffn_fused_fwd.launches
    got = fused_ffn.ffn_fused_fwd(x, w1, b1, w2, b2)
    want = fused_ffn._ffn_train_fwd_plain(x, w1, b1, w2, b2)[0]
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (m, h)
    _close_bf16(got, want, (m, h, f))
    assert fused_ffn.ffn_fused_fwd.launches == before + 1


def test_int8_knobs_dispatch_and_refuse(dev):
    """The public int8_ffn / int8_dense keep the JAX rule on the card:
    where the shapes do not tile (40 rows; O = 100; H = I = 96, off the
    128 grid) they ARE the unquantized expression and launch nothing;
    where they tile, the kernel runs or raises (an f32 CUDA tensor), and
    the kernel wrappers themselves refuse H = I = 96."""
    names = ("int8_ffn_fwd", "int8_dense_fwd")
    before = [getattr(fused_ffn, n).launches for n in names]
    x = _randn(dev, 40, 256).to(torch.bfloat16)      # 40 rows: no tile
    w1, b1, _ = _int8_weights(dev, 512, 256, seed=1)
    w2, b2, _ = _int8_weights(dev, 256, 512, seed=3)
    assert torch.equal(fused_ffn.ffn(x, w1, b1, w2, b2, "int8"),
                       fused_ffn.ffn_reference(x, w1, b1, w2, b2))
    w, b, _ = _int8_weights(dev, 100, 256, seed=5)    # O = 100: no tile
    x64 = _randn(dev, 64, 256).to(torch.bfloat16)
    assert torch.equal(fused_ffn.int8_dense(x64, w, b),
                       fused_ffn.linear_dt(x64, w, b, torch.bfloat16))
    assert [getattr(fused_ffn, n).launches for n in names] == before
    # the same public calls at tiling shapes launch their kernels
    y = fused_ffn.int8_ffn(x64.view(2, 32, 256), w1, b1, w2, b2)
    assert torch.equal(y.view(64, 256), fused_ffn._int8_ffn_plain(
        x64, *fused_ffn.quantize_weight(w1), b1,
        *fused_ffn.quantize_weight(w2), b2))
    w, b, q = _int8_weights(dev, 384, 256, seed=7)
    assert torch.equal(fused_ffn.int8_dense(x64, w, b),
                       fused_ffn._int8_dense_plain(x64, *q))
    assert [getattr(fused_ffn, n).launches for n in names] == [
        n + 1 for n in before]
    with pytest.raises(ValueError, match="bfloat16"):
        fused_ffn.int8_ffn(x64.float(), w1, b1, w2, b2)
    with pytest.raises(ValueError, match="bfloat16"):
        fused_ffn.int8_dense(x64.float(), w, b)
    odd = _randn(dev, 64, 96).to(torch.bfloat16)
    w3, b3, q3 = _int8_weights(dev, 256, 96, seed=9)
    w4, b4, q4 = _int8_weights(dev, 96, 256, seed=11)
    assert torch.equal(fused_ffn.int8_ffn(odd, w3, b3, w4, b4),
                       fused_ffn.ffn_reference(odd, w3, b3, w4, b4))
    assert torch.equal(fused_ffn.int8_dense(odd, w3, b3),
                       fused_ffn.linear_dt(odd, w3, b3, torch.bfloat16))
    with pytest.raises(ValueError, match="multiples of 128"):
        fused_ffn.int8_ffn_fwd(odd, *q3[:2], q3[2], *q4)
    with pytest.raises(ValueError, match="multiples of 128"):
        fused_ffn.int8_dense_fwd(odd, *q3)
    assert [getattr(fused_ffn, n).launches for n in names] == [
        n + 1 for n in before]


def test_int8_knobs_launch_in_a_model(dev):
    """A BertEncoder (H = 256, 2 layers) under ffn_impl="int8" and
    proj_impl="int8": K13 twice a layer (q, k, v as one call; the output
    projection), K14 once; every layer's hiddens equal the same model's
    on the plain versions (expected bitwise; a code one step off moves the
    roundings downstream, so the floor is a row cosine of 0.9999)."""
    from simxns_tpu_torch.models import BertConfig, BertEncoder

    cfg = BertConfig(vocab_size=512, hidden_size=256, num_layers=2,
                     num_heads=4, intermediate_size=512,
                     max_position_embeddings=64, ffn_impl="int8",
                     proj_impl="int8")
    model = BertEncoder(cfg).to(dev)
    ids = torch.randint(1, 512, (4, 32), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
    names = ("int8_ffn_fwd", "int8_dense_fwd")
    before = [getattr(fused_ffn, n).launches for n in names]
    kernels = [getattr(fused_ffn, n) for n in names]
    with torch.no_grad():
        got = model(ids, output_hidden_states=True).hidden_states
        after = [getattr(fused_ffn, n).launches for n in names]
        fused_ffn.int8_ffn_fwd = fused_ffn._int8_ffn_plain
        fused_ffn.int8_dense_fwd = fused_ffn._int8_dense_plain
        try:
            want = model(ids, output_hidden_states=True).hidden_states
        finally:
            fused_ffn.int8_ffn_fwd, fused_ffn.int8_dense_fwd = kernels
    assert [a - b for a, b in zip(after, before)] == [2, 4]
    for g, w in zip(got, want):
        cos = torch.nn.functional.cosine_similarity(
            g.float().flatten(0, 1), w.float().flatten(0, 1), dim=-1)
        assert torch.equal(g, w) or float(cos.min()) >= 0.9999


def _ffn_inputs(dev, m, h, f, seed=0):
    bf = torch.bfloat16
    x = _randn(dev, m, h, seed=seed).to(bf)
    w1 = _randn(dev, f, h, scale=0.05, seed=seed + 1).to(bf)
    b1 = _randn(dev, f, scale=0.05, seed=seed + 2).to(bf)
    w2 = _randn(dev, h, f, scale=0.05, seed=seed + 3).to(bf)
    b2 = _randn(dev, h, scale=0.05, seed=seed + 4).to(bf)
    dy = _randn(dev, m, h, seed=seed + 5).to(bf)
    return x, w1, b1, w2, b2, dy


def _close_bf16(got, want, what):
    """Within one bf16 step of the largest value (2^-7 relative): the f32
    sums run in another order, which moves a result across a rounding
    boundary, and a moved ``hb`` or ``dh`` element moves what is summed
    from it by far less than that."""
    err = float((got.float() - want.float()).abs().max())
    assert err <= 2.0 ** -7 * float(want.float().abs().max()), (what, err)


def _close_f32(got, want, what):
    """The f32 sums over M of bf16 products, taken in another order: 1e-3
    of the largest value and a cosine of 0.99999."""
    err = float((got - want).abs().max())
    assert err <= 1e-3 * float(want.abs().max()), (what, err)
    cos = float(torch.nn.functional.cosine_similarity(
        got.flatten(), want.flatten(), dim=0))
    assert cos >= 0.99999, (what, cos)


@pytest.mark.parametrize("m,h,f", [(64, 256, 256), (256, 256, 384),
                                   (37, 256, 128), (1, 768, 256),
                                   (200, 768, 512), (96, 1024, 256),
                                   (300, 384, 1536), (77, 128, 512),
                                   (301, 512, 2048), (4100, 768, 3072)])
def test_ffn_kernels_match_plain(dev, m, h, f):
    """K9-K12 against their plain versions at tiling and ragged M (the
    kernels mask their edge) and at widths off the models' (H = 128, 384,
    512), one launch each; K10's g and db1 parts too, and K11 bitwise from
    run to run (its sums in a fixed order; M = 4,100 splits K)."""
    x, w1, b1, w2, b2, dy = _ffn_inputs(dev, m, h, f, seed=m + h)
    names = ("ffn_train_fwd", "ffn_fused_fwd", "ffn_bwd_dx", "ffn_bwd_dw")
    before = [getattr(fused_ffn, n).launches for n in names]
    y, hb = fused_ffn.ffn_train_fwd(x, w1, b1, w2, b2)
    y_ref, hb_ref = fused_ffn._ffn_train_fwd_plain(x, w1, b1, w2, b2)
    _close_bf16(hb, hb_ref, "hb")
    _close_bf16(y, y_ref, "y")
    _close_bf16(fused_ffn.ffn_fused_fwd(x, w1, b1, w2, b2), y_ref, "y fused")
    # the backward kernels from the plain hb, so both sides read the same
    dx, dh, g, parts = fused_ffn.ffn_bwd_dx(dy, w1, w2, hb_ref)
    dx_ref, dh_ref, g_ref, parts_ref = fused_ffn._ffn_bwd_dx_plain(
        dy, w1, w2, hb_ref)
    _close_bf16(dh, dh_ref, "dh")
    _close_bf16(dx, dx_ref, "dx")
    assert torch.equal(g, g_ref)        # the same GELU of the same hb
    _close_f32(parts, fused_ffn._column_parts(dh), "parts")   # its own dh
    # K11 from the plain dh, g and parts, so both sides read the same
    got = fused_ffn.ffn_bwd_dw(x, dy, g_ref, dh_ref, parts_ref)
    want = fused_ffn._ffn_bwd_dw_plain(x, dy, g_ref, dh_ref, parts_ref)
    for name, gt, w in zip(("dw1", "db1", "dw2"), got, want):
        assert gt.dtype == torch.float32 and gt.shape == w.shape
        _close_f32(gt, w, name)
    again = fused_ffn.ffn_bwd_dw(x, dy, g_ref, dh_ref, parts_ref)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    torch.cuda.synchronize()
    assert [getattr(fused_ffn, n).launches for n in names] == [
        b + (2 if n == "ffn_bwd_dw" else 1) for n, b in zip(names, before)]


@pytest.mark.parametrize("m,h,f", [(300, 384, 640), (64, 128, 256),
                                   (4100, 256, 768)])
def test_mn_major_gemm_is_exact_on_small_integers(dev, m, h, f):
    """The MN-major operands of the wgmma GEMM alone: K10 (B MN-major) and
    K11 (A and B MN-major, two products in one launch; M = 4,100 splits K)
    on small integers in bf16, where every f32 sum is exact, so a layout
    or descriptor error shows as a wrong value and not as rounding. hb =
    10 makes gelu'(hb) = 1 and gelu(hb) = 10 in f32 exactly: dh = bf16(dy
    w2), dx = bf16(dh w1), g = 10, db1's parts and dW1, dW2 the float64
    products, bitwise. Ragged M, and F = 640 past the last 256-column
    tile."""
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(m + h)

    def ints(*shape, hi=2):
        return torch.randint(-hi, hi + 1, shape, device=dev,
                             generator=gen).to(bf)

    dy, x = ints(m, h), ints(m, h)
    w1, w2 = ints(f, h, hi=1), ints(h, f, hi=1)
    hb = torch.full((m, f), 10.0, dtype=bf, device=dev)
    dx, dh, g, parts = fused_ffn.ffn_bwd_dx(dy, w1, w2, hb)
    d = torch.float64
    want_dh = (dy.to(d) @ w2.to(d)).to(bf)
    assert torch.equal(dh, want_dh)
    assert torch.equal(dx, (want_dh.to(d) @ w1.to(d)).to(bf))
    assert torch.equal(g, torch.full_like(g, 10.0))
    pad = torch.zeros(-m % 64, f, dtype=d, device=dev)
    assert torch.equal(parts, torch.cat([want_dh.to(d), pad]).view(
        -1, 64, f).sum(1).float())
    dw1, db1, dw2 = fused_ffn.ffn_bwd_dw(x, dy, g, dh, parts)
    assert torch.equal(dw1, (dh.to(d).T @ x.to(d)).float())
    assert torch.equal(dw2, (dy.to(d).T @ g.to(d)).float())
    assert torch.equal(db1, dh.to(d).sum(0).float())


@pytest.mark.parametrize("impl", ["fused_vjp", "fused"])
def test_ffn_knobs_under_autograd(dev, impl):
    """Both knobs on [B, S, H] activations over f32 parameters: the kernels
    launch (K9, K10, K11 once for fused_vjp; K12 for fused), the result
    and the five gradients, typed like their primals, agree with the same
    knob on its plain versions (CPU tensors) within bf16 rounding."""
    b, s, h, f = 4, 64, 256, 512
    x = _randn(dev, b, s, h).to(torch.bfloat16).requires_grad_()
    params = [_randn(dev, f, h, scale=0.05, seed=1), _randn(dev, f, seed=2),
              _randn(dev, h, f, scale=0.05, seed=3), _randn(dev, h, seed=4)]
    params = [p.requires_grad_() for p in params]
    names = ("ffn_train_fwd", "ffn_bwd_dx", "ffn_bwd_dw", "ffn_fused_fwd")
    before = [getattr(fused_ffn, n).launches for n in names]
    y = fused_ffn.ffn(x, *params, impl)
    grads = torch.autograd.grad(y.float().square().sum(), [x, *params])
    after = [getattr(fused_ffn, n).launches for n in names]
    want = [1, 1, 1, 0] if impl == "fused_vjp" else [0, 0, 0, 1]
    assert [a - b for a, b in zip(after, before)] == want
    cpu = [t.detach().cpu().requires_grad_() for t in [x, *params]]
    y_ref = fused_ffn.ffn(*cpu, impl)
    refs = torch.autograd.grad(y_ref.float().square().sum(), cpu)
    _close_bf16(y.cpu(), y_ref, "y")
    for g, r, t in zip(grads, refs, [x, *params]):
        assert g.dtype == t.dtype and g.shape == t.shape
        err = float((g.cpu().float() - r.float()).abs().max())
        assert err <= 2e-2 * float(r.float().abs().max()), err


def test_ffn_kernels_refuse_what_they_do_not_take(dev):
    """On the card a kernel wrapper launches its kernel or raises (f32
    activations; H = 96 or F = 192, off the 128 grid), and a knob on the
    grid launches at any M, whatever the JAX tiling rule says about M. Off
    the grid the knobs are ``ffn_reference``, as in JAX, and launch
    nothing."""
    x, w1, b1, w2, b2, _ = _ffn_inputs(dev, 32, 256, 256)
    with pytest.raises(ValueError, match="bfloat16"):
        fused_ffn.ffn_train_fwd(x.float(), w1.float(), b1.float(),
                                w2.float(), b2.float())
    odd = torch.zeros(32, 96, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="multiples of 128"):
        fused_ffn.ffn_fused_fwd(odd, odd.new_zeros(256, 96), b1,
                                odd.new_zeros(96, 256), odd.new_zeros(96))
    with pytest.raises(ValueError, match="multiples of 128"):
        fused_ffn.ffn_bwd_dx(x, x.new_zeros(192, 256), x.new_zeros(256, 192),
                             x.new_zeros(32, 192))
    with pytest.raises(ValueError, match="multiples of 128"):
        fused_ffn.ffn_bwd_dw(odd, odd, x.new_zeros(32, 256),
                             x.new_zeros(32, 256),
                             torch.zeros(1, 256, device=dev))
    # M = 7 is off the JAX tiling rule: the kernels mask the edge and launch
    names = ("ffn_fused_fwd", "ffn_train_fwd")
    before = [getattr(fused_ffn, n).launches for n in names]
    ragged = x[:7].reshape(1, 7, 256)
    for impl in ("fused", "fused_vjp"):
        out = fused_ffn.ffn(ragged, w1.float(), b1.float(), w2.float(),
                            b2.float(), impl)
        _close_bf16(out[0], fused_ffn._ffn_train_fwd_plain(
            x[:7], w1, b1, w2, b2)[0], impl)
    assert [getattr(fused_ffn, n).launches for n in names] == [
        b + 1 for b in before]
    # a width off the 128 grid is ffn_reference under both knobs, with its
    # gradients, and launches nothing
    odd = _randn(dev, 7, 96).to(torch.bfloat16).requires_grad_()
    params = [p.requires_grad_() for p in (
        _randn(dev, 200, 96), _randn(dev, 200), _randn(dev, 96, 200),
        _randn(dev, 96))]
    bwd = (fused_ffn.ffn_bwd_dx.launches, fused_ffn.ffn_bwd_dw.launches)
    for impl in ("fused", "fused_vjp"):
        y = fused_ffn.ffn(odd, *params, impl)
        y_ref = fused_ffn.ffn_reference(odd, *params)
        assert torch.equal(y, y_ref)
        grads = torch.autograd.grad(y.float().sum(), [odd, *params])
        refs = torch.autograd.grad(y_ref.float().sum(), [odd, *params])
        assert all(torch.equal(a, b) for a, b in zip(grads, refs))
    assert [getattr(fused_ffn, n).launches for n in names] == [
        b + 1 for b in before]
    assert (fused_ffn.ffn_bwd_dx.launches,
            fused_ffn.ffn_bwd_dw.launches) == bwd


@pytest.mark.parametrize("h", [128, 512, 1152])
@pytest.mark.parametrize("impl", ["fused", "fused_vjp", "int8", "proj_int8"])
def test_knobs_run_at_every_lane_width(dev, impl, h):
    """Every FFN knob, and proj_impl="int8", at widths off the models' on
    the 128 grid (F = 4 H), through its kernels: the launch counts rise,
    and the result (and for fused_vjp the input's gradient) agrees with the
    same call on the plain versions within the bounds of the tests above
    (bitwise for the int8 kernels)."""
    bf = torch.bfloat16
    m, f = 256, 4 * h                   # 256 rows tile for the int8 knobs
    x = _randn(dev, 2, m // 2, h, seed=h).to(bf)
    w1, b1 = _randn(dev, f, h, scale=0.05, seed=1), _randn(dev, f, seed=2)
    w2, b2 = _randn(dev, h, f, scale=0.05, seed=3), _randn(dev, h, seed=4)
    name = {"fused": "ffn_fused_fwd", "fused_vjp": "ffn_train_fwd",
            "int8": "int8_ffn_fwd", "proj_int8": "int8_dense_fwd"}[impl]
    before = getattr(fused_ffn, name).launches
    if impl == "proj_int8":
        got = fused_ffn.int8_dense(x, w1, b1)
        want = fused_ffn._int8_dense_plain(
            x.view(m, h), *fused_ffn.quantize_weight(w1), b1).view(2, -1, f)
        assert torch.equal(got, want)
    elif impl == "int8":
        got = fused_ffn.ffn(x, w1, b1, w2, b2, impl)
        want = fused_ffn._int8_ffn_plain(
            x.view(m, h), *fused_ffn.quantize_weight(w1), b1,
            *fused_ffn.quantize_weight(w2), b2).view(2, -1, h)
        assert torch.equal(got, want)
    else:
        xg = x.requires_grad_()
        got = fused_ffn.ffn(xg, w1, b1, w2, b2, impl)
        cpu = [t.detach().cpu() for t in (x, w1, b1, w2, b2)]
        cpu[0].requires_grad_()
        want = fused_ffn.ffn(*cpu, impl)
        _close_bf16(got.cpu(), want, (impl, h))
        if impl == "fused_vjp":
            (gx,) = torch.autograd.grad(got.float().square().sum(), [xg])
            (rx,) = torch.autograd.grad(want.float().square().sum(), [cpu[0]])
            err = float((gx.cpu().float() - rx.float()).abs().max())
            assert err <= 2e-2 * float(rx.float().abs().max()), err
    torch.cuda.synchronize()
    assert getattr(fused_ffn, name).launches == before + 1


def _attention_inputs(dev, b, heads, s, d, seed=0):
    q, k, v, do = (_randn(dev, b, heads, s, d, seed=seed + i).to(
        torch.bfloat16) for i in range(4))
    mask = torch.ones(b, s, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    lens = torch.randint(1, s + 1, (b,), device=dev, generator=gen)
    mask[torch.arange(s, device=dev)[None, :] >= lens[:, None]] = 0
    return q, k, v, do, mask


# K6's tile edges (its 32-row chunks and the 64 query rows of a warp
# round) and K5's (its 64-row query tiles and 32-key tiles)
GROUP_EDGES = [(3, 2, s, d)
               for s in (31, 32, 33, 63, 64, 65, 127, 128, 129, 191, 192,
                         193, 255)
               for d in (32, 64, 128)]


# the head widths the JAX kernels take besides 32, 64 and 128: the other
# instances on the 16 grid and, off it, the next instance over zero pads
GROUP_WIDTHS = [(2, 3, 160, d) for d in (16, 48, 80, 96, 112, 8, 24, 72)]

# those widths at K5's edges: one key, around its 32-key tiles and its
# 64-row query tiles, the longest S of the route
GROUP_WIDTH_EDGES = [(2, 3, s, d) for s in (1, 31, 32, 33, 192, 193, 255)
                     for _, _, _, d in GROUP_WIDTHS]


@pytest.mark.parametrize("b,heads,s,d", [(3, 2, 1, 64), (3, 2, 17, 32),
                                         (2, 4, 160, 64), (1, 2, 255, 128),
                                         (5, 3, 40, 128)] + GROUP_EDGES
                         + GROUP_WIDTHS + GROUP_WIDTH_EDGES)
def test_group_attention_matches_plain(dev, b, heads, s, d):
    """K5 against its plain version: the f32 results round to bf16 on both
    sides (one bf16 step, <= 2^-8 max|v| at |o| <= max|v| / 2); K6's
    gradients, where p and dS enter the products as hi + lo bf16 halves
    (~16 bits), to 2^-7 of their largest value, cosine >= 0.9999. With
    more than one batch row, the last has every key masked (the uniform
    softmax over S keys)."""
    q, k, v, do, mask = _attention_inputs(dev, b, heads, s, d)
    if b > 1:
        mask[-1] = 0
    before = fa.group_attention_fwd.launches, fa.group_attention_bwd.launches
    got = fa.group_attention_fwd(q, k, v, mask)
    want = fa._group_fwd_plain(q, k, v, mask)
    tol = 2.0 ** -8 * float(v.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= tol
    grads = fa.group_attention_bwd(q, k, v, mask, do)
    refs = fa._group_bwd_plain(q, k, v, mask, do)
    for g, r in zip(grads, refs):
        assert g.shape == r.shape == q.shape
        err = float((g.float() - r.float()).abs().max())
        assert err <= 2.0 ** -7 * float(r.float().abs().max()), err
        if s > 1:   # at S=1, p = 1: dS, dq and dk are exactly 0 (err above)
            cos = float(torch.nn.functional.cosine_similarity(
                g.float().flatten(), r.float().flatten(), dim=0))
            assert cos >= 0.9999, cos
    torch.cuda.synchronize()
    assert (fa.group_attention_fwd.launches,
            fa.group_attention_bwd.launches) == (before[0] + 1, before[1] + 1)


def test_group_attention_autograd_on_head_views(dev):
    """The dispatch (small_s_impl="group") runs K5/K6 under autograd on
    head views of [B, S, H] projections, as the model calls it, and the
    gradients land in the projections' layout."""
    b, s, heads, d = 2, 48, 4, 64
    x = [_randn(dev, b, s, heads * d, seed=i).to(torch.bfloat16)
         .requires_grad_() for i in range(3)]
    q, k, v = (t.view(b, s, heads, d).transpose(1, 2) for t in x)
    mask = torch.ones(b, s, dtype=torch.int32, device=dev)
    mask[1, 30:] = 0
    before = fa.group_attention_bwd.launches
    out, _ = multi_head_attention(q, k, v, mask, impl="flash",
                                  small_s_impl="group")
    out.float().square().sum().backward()
    assert fa.group_attention_bwd.launches == before + 1
    refs = [t.detach().clone().requires_grad_() for t in x]
    rq, rk, rv = (t.view(b, s, heads, d).transpose(1, 2) for t in refs)
    fa._group_fwd_plain(rq, rk, rv, mask).float().square().sum().backward()
    for got, ref in zip(x, refs):
        err = float((got.grad.float() - ref.grad.float()).abs().max())
        assert err <= 2.0 ** -7 * float(ref.grad.float().abs().max()), err


# K8's tile edges: one query or key row past a 64-row tile, and one short
BH_EDGES = [(2, 2, s, d) for s in (257, 320, 1023) for d in (32, 64, 128)]


BH_WIDTHS = [(2, 3, 512, d) for d in (16, 48, 80, 96, 112, 8, 24, 72)]


# the shapes K8's A/B times (scripts/torch_kernel_bench.py): the msdoc
# reranker's, the most shared memory (d = 128, S = 1,024) and the
# shortest S of its route
BH_BENCH = [(128, 12, 512, 64), (4, 8, 1024, 128), (16, 8, 256, 64)]


@pytest.mark.parametrize("b,heads,s,d", [(3, 2, 256, 64), (2, 2, 288, 32),
                                         (2, 3, 512, 128), (1, 2, 1024, 64),
                                         (3, 2, 300, 128), (2, 2, 17, 32)]
                         + BH_EDGES + BH_WIDTHS + BH_BENCH)
def test_bh_attention_matches_plain(dev, b, heads, s, d):
    """K7/K8 against their plain versions, with the tolerances of K5/K6;
    batch row 0 has every key masked (the uniform softmax over S keys)."""
    q, k, v, do, mask = _attention_inputs(dev, b, heads, s, d, seed=s + d)
    mask[0] = 0
    before = fa.bh_attention_fwd.launches, fa.bh_attention_bwd.launches
    got = fa.bh_attention_fwd(q, k, v, mask)
    want = fa._group_fwd_plain(q, k, v, mask)
    tol = 2.0 ** -8 * float(v.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= tol
    grads = fa.bh_attention_bwd(q, k, v, mask, do)
    refs = fa._group_bwd_plain(q, k, v, mask, do)
    for g, r in zip(grads, refs):
        assert g.shape == r.shape == q.shape
        err = float((g.float() - r.float()).abs().max())
        assert err <= 2.0 ** -7 * float(r.float().abs().max()), err
        cos = float(torch.nn.functional.cosine_similarity(
            g.float().flatten(), r.float().flatten(), dim=0))
        assert cos >= 0.9999, cos
    torch.cuda.synchronize()
    assert (fa.bh_attention_fwd.launches,
            fa.bh_attention_bwd.launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("per_head,s", [(False, 160), (True, 512)])
def test_attention_backward_is_deterministic(dev, per_head, s):
    """K6 and K8 write every gradient row from one block, with no atomics:
    two calls give bitwise equal dq, dk and dv."""
    q, k, v, do, mask = _attention_inputs(dev, 4, 3, s, 64, seed=7)
    mask[-1] = 0
    bwd = fa.bh_attention_bwd if per_head else fa.group_attention_bwd
    first = bwd(q, k, v, mask, do)
    second = bwd(q, k, v, mask, do)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("b,heads,s,d", BH_BENCH + [(2, 3, 512, 80)])
def test_k8_two_calls_are_bitwise_equal(dev, b, heads, s, d):
    """K8's two launches (no atomics, no partial sums) at the bench shapes
    and a padded width: two calls give bitwise equal dq, dk and dv."""
    q, k, v, do, mask = _attention_inputs(dev, b, heads, s, d, seed=s + 1)
    mask[0] = 0
    first = fa.bh_attention_bwd(q, k, v, mask, do)
    second = fa.bh_attention_bwd(q, k, v, mask, do)
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("b,heads,s,d", BH_BENCH + [(2, 3, 512, 80),
                                                    (2, 2, 17, 32)])
def test_k7_two_calls_are_bitwise_equal(dev, b, heads, s, d):
    """K7's bf16 instance (csrc/attention_fwd_wgmma.cu: every row of o from
    one block, no atomics) at the bench shapes, a padded width and a short
    S: two calls give bitwise equal o, one launch each."""
    q, k, v, _, mask = _attention_inputs(dev, b, heads, s, d, seed=s + 2)
    mask[0] = 0
    before = fa.bh_attention_fwd.launches
    first = fa.bh_attention_fwd(q, k, v, mask)
    second = fa.bh_attention_fwd(q, k, v, mask)
    torch.cuda.synchronize()
    assert fa.bh_attention_fwd.launches == before + 2
    assert torch.equal(first, second)


@pytest.mark.parametrize("b,heads,s,d", [(128, 16, 160, 64), (2, 3, 255, 80),
                                         (3, 2, 192, 64), (3, 2, 17, 32)])
def test_k5_two_calls_are_bitwise_equal(dev, b, heads, s, d):
    """K5's bf16 kernel (``group_attention_fwd_kernel`` in
    csrc/attention_fwd_wgmma.cu, no atomics) at the reranker's shape, a
    padded width and short S: two calls give bitwise equal o, and the
    profiler sees K5's kernel, not K7's ``attention_fwd``."""
    from torch.profiler import ProfilerActivity, profile

    q, k, v, _, mask = _attention_inputs(dev, b, heads, s, d, seed=s + 3)
    mask[0] = 0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        first = fa.group_attention_fwd(q, k, v, mask)
        torch.cuda.synchronize()
    second = fa.group_attention_fwd(q, k, v, mask)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    names = {ev.name for ev in prof.events()
             if ev.device_type == torch.autograd.DeviceType.CUDA}
    assert any("group_attention_fwd_kernel" in n for n in names), names
    assert not any("attention_fwd<" in n for n in names), names


# K6's route by S and width: its one-launch kernel up to S = 192 at d <=
# 64, K8's two passes beyond and past d = 64 (csrc/attention_bwd_wgmma.cu,
# group_by_length)
K6_ROUTES = ([(3, 2, s, d) for s in (31, 32, 33, 255) for d in (32, 64, 128)]
             + GROUP_WIDTHS)


@pytest.mark.parametrize("b,heads,s,d", K6_ROUTES)
def test_k6_runs_its_wgmma_kernel(dev, b, heads, s, d):
    """K6 at its tile edges and every width of GROUP_WIDTHS: the wrapper's
    launch counter rises once a call, the profiler sees the kernel its rule
    names (``group_attention_bwd_kernel``, else K8's two passes), the
    gradients are within K6's limits of the plain version (2^-7 of the
    largest, cosine >= 0.9999) and two calls are bitwise equal; the last
    batch row has every key masked."""
    from torch.profiler import ProfilerActivity, profile

    q, k, v, do, mask = _attention_inputs(dev, b, heads, s, d, seed=s * d)
    mask[-1] = 0
    before = fa.group_attention_bwd.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        grads = fa.group_attention_bwd(q, k, v, mask, do)
        torch.cuda.synchronize()
    again = fa.group_attention_bwd(q, k, v, mask, do)
    torch.cuda.synchronize()
    assert fa.group_attention_bwd.launches == before + 2
    names = {ev.name for ev in prof.events()
             if ev.device_type == torch.autograd.DeviceType.CUDA}
    one_launch = s <= 192 and fa.kernel_head_width(d) <= 64
    want = ("group_attention_bwd_kernel" if one_launch
            else "bh_attention_bwd_query_kernel")
    assert any(want in n for n in names), names
    refs = fa._group_bwd_plain(q, k, v, mask, do)
    for g, a, r in zip(grads, again, refs):
        assert torch.equal(g, a)
        err = float((g.float() - r.float()).abs().max())
        assert err <= 2.0 ** -7 * float(r.float().abs().max()), err
        cos = float(torch.nn.functional.cosine_similarity(
            g.float().flatten(), r.float().flatten(), dim=0))
        assert cos >= 0.9999, cos


@pytest.mark.parametrize("name", ["small_s_attention", "attention_fwd_wgmma",
                                  "attention_bwd_wgmma"])
def test_attention_libraries_run_on_wgmma(dev, name):
    """Every attention library as built (K3; K5 and K7; K6 and K8; the f32
    instances): its SASS holds HGMMA (wgmma) and no HMMA (mma.sync), and
    ptxas reports no spills for any of its kernels."""
    import shutil
    import subprocess

    from simxns_tpu_torch.ops import _native

    _native.build([name])
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(_native.lib_path(name))],
                          capture_output=True, text=True, check=True).stdout
    assert sass.count("HGMMA") > 0
    assert "HMMA" not in sass
    log = (_native.BUILD_DIR / f"{name}.log").read_text()
    spills = [ln for ln in log.splitlines() if "spill stores" in ln]
    assert spills and all(" 0 bytes spill stores, 0 bytes spill loads" in ln
                          for ln in spills), spills


def test_bh_attention_autograd_on_head_views(dev):
    """The dispatch runs K7/K8 at S >= 256 under autograd on head views of
    [B, S, H] projections, and the gradients land in that layout."""
    b, s, heads, d = 2, 320, 4, 64
    x = [_randn(dev, b, s, heads * d, seed=i).to(torch.bfloat16)
         .requires_grad_() for i in range(3)]
    q, k, v = (t.view(b, s, heads, d).transpose(1, 2) for t in x)
    mask = torch.ones(b, s, dtype=torch.int32, device=dev)
    mask[1, 200:] = 0
    before = fa.bh_attention_bwd.launches
    out, _ = multi_head_attention(q, k, v, mask, impl="flash")
    out.float().square().sum().backward()
    assert fa.bh_attention_bwd.launches == before + 1
    refs = [t.detach().clone().requires_grad_() for t in x]
    rq, rk, rv = (t.view(b, s, heads, d).transpose(1, 2) for t in refs)
    fa._group_fwd_plain(rq, rk, rv, mask).float().square().sum().backward()
    for got, ref in zip(x, refs):
        err = float((got.grad.float() - ref.grad.float()).abs().max())
        assert err <= 2.0 ** -7 * float(ref.grad.float().abs().max()), err


# The f32 instances of K5-K8 against an f64 evaluation (fa.attention_f64)
# within the module's limits (fa.F32_*), the ones chip_smoke.py holds them to


@pytest.mark.parametrize("b,heads,s,d", [(2, 4, 160, 64), (1, 2, 255, 128),
                                         (3, 2, 17, 32), (3, 2, 65, 64)]
                         + GROUP_WIDTHS)
def test_group_attention_f32_matches_f64(dev, b, heads, s, d):
    """K5/K6's f32 instances (K6's is K8's two passes) on f32 inputs: within
    the f32 limits of an f64 evaluation, fa.F32_VS_BF16 times closer than the
    bf16 instance, outputs in f32, launches on the f32 counters only."""
    _check_f32_instances(dev, fa.group_attention_fwd, fa.group_attention_bwd,
                         b, heads, s, d)


@pytest.mark.parametrize("b,heads,s,d", [(2, 3, 512, 64), (2, 2, 288, 32),
                                         (1, 2, 1024, 128), (2, 2, 257, 128)]
                         + BH_WIDTHS)
def test_bh_attention_f32_matches_f64(dev, b, heads, s, d):
    """K7/K8's f32 instances, as K5/K6's."""
    _check_f32_instances(dev, fa.bh_attention_fwd, fa.bh_attention_bwd,
                         b, heads, s, d)


def _check_f32_instances(dev, fwd, bwd, b, heads, s, d):
    q, k, v, do = (_randn(dev, b, heads, s, d, seed=s + d + i)
                   for i in range(4))
    mask = torch.ones(b, s, dtype=torch.int32, device=dev)
    mask[0, s // 2 + 1:] = 0
    if b > 2:
        mask[-1] = 0          # every key masked: the uniform softmax
    o64, g64 = fa.attention_f64(q, k, v, mask, do)
    counts = (fwd.launches, bwd.launches, fwd.f32.launches, bwd.f32.launches)
    o = fwd(q, k, v, mask)
    grads = bwd(q, k, v, mask, do)
    torch.cuda.synchronize()
    assert (fwd.launches, bwd.launches, fwd.f32.launches,
            bwd.f32.launches) == (counts[0], counts[1], counts[2] + 1,
                                  counts[3] + 1)
    assert o.dtype == torch.float32 and o.shape == q.shape
    assert all(g.dtype == torch.float32 and g.shape == q.shape
               for g in grads)
    # the forward's error relative to max|v| (o is a mean of v rows)
    err_o = float((o.double() - o64).abs().max()) / float(v.abs().max())
    err_g = fa.errors_of_largest(grads, g64)
    assert err_o <= fa.F32_FWD_TOL, err_o
    assert max(err_g) <= fa.F32_BWD_TOL, err_g
    qb, kb, vb, dob = (t.to(torch.bfloat16) for t in (q, k, v, do))
    ob = fwd(qb, kb, vb, mask)
    gb = bwd(qb, kb, vb, mask, dob)
    err_ob = float((ob.double() - o64).abs().max()) / float(v.abs().max())
    assert err_ob >= fa.F32_VS_BF16 * err_o, (err_ob, err_o)
    for e32, e16 in zip(err_g, fa.errors_of_largest(gb, g64)):
        assert e16 >= fa.F32_VS_BF16 * e32, (e16, e32)


# The f32 backward (K6's and K8's, csrc/attention_bwd_f32.cu, on wgmma) at
# its edges: S = 1024 at d = 128 (its most shared memory), S = 256 and
# S = 255 on K6's route (tiles of 32 keys below 256, the last one 31 of
# 32), widths off the 16 grid (24 and 80: padded to 32 and 96, run by the
# 32 and 128 instances)
F32_BWD_EDGES = [("bh", 2, 2, 1024, 128), ("bh", 2, 3, 256, 64),
                 ("group", 2, 3, 255, 64), ("group", 3, 2, 255, 128),
                 ("bh", 2, 2, 300, 24), ("bh", 2, 2, 512, 80),
                 ("group", 3, 2, 160, 24), ("group", 2, 2, 160, 80)]


@pytest.mark.parametrize("pair,b,heads,s,d", F32_BWD_EDGES)
def test_f32_backward_edges_on_head_views(dev, pair, b, heads, s, d):
    """K8's and K6's f32 backward on q, k, v as head views of [b, s, heads
    d] projections (strided rows, as the models make them), batch row 0
    with half its keys and the last with none: within fa.F32_BWD_TOL of
    an f64 evaluation, fa.F32_VS_BF16 times closer than the bf16 instance,
    two calls bitwise equal, each launch on the f32 counter."""
    fwd, bwd = ((fa.bh_attention_fwd, fa.bh_attention_bwd) if pair == "bh"
                else (fa.group_attention_fwd, fa.group_attention_bwd))
    x = [_randn(dev, b, s, heads * d, seed=s + d + i) for i in range(3)]
    q, k, v = (t.view(b, s, heads, d).transpose(1, 2) for t in x)
    do = _randn(dev, b, heads, s, d, seed=s + d + 3)
    mask = torch.ones(b, s, dtype=torch.int32, device=dev)
    mask[0, s // 2 + 1:] = 0
    mask[-1] = 0
    _, g64 = fa.attention_f64(q, k, v, mask, do)
    before = (bwd.launches, bwd.f32.launches)
    grads = bwd(q, k, v, mask, do)
    again = bwd(q, k, v, mask, do)
    torch.cuda.synchronize()
    assert (bwd.launches, bwd.f32.launches) == (before[0], before[1] + 2)
    assert all(g.dtype == torch.float32 and g.shape == q.shape
               for g in grads)
    assert all(torch.equal(g, a) for g, a in zip(grads, again))
    err = fa.errors_of_largest(grads, g64)
    assert max(err) <= fa.F32_BWD_TOL, err
    gb = bwd(*(t.to(torch.bfloat16) for t in (q, k, v)), mask,
             do.to(torch.bfloat16))
    for e32, e16 in zip(err, fa.errors_of_largest(gb, g64)):
        assert e16 >= fa.F32_VS_BF16 * e32, (e16, e32)


# The f32 forward (K5's and K7's, csrc/attention_fwd_wgmma.cu, on wgmma) at
# its edges: S = 1, 255 (K5's route: one warpgroup, 32-key tiles, the last
# one 31 of 32), 256 and 1024 (K7's: two warpgroups, its most shared
# memory) at d = 128, widths off the 16 grid (24 and 80: padded to 32 and
# 96, run by the 32 and 128 instances) on both routes
F32_FWD_EDGES = [("group", 3, 2, 1, 128), ("group", 2, 3, 255, 128),
                 ("bh", 2, 3, 256, 128), ("bh", 2, 2, 1024, 128),
                 ("group", 3, 2, 160, 24), ("bh", 2, 2, 300, 24),
                 ("group", 2, 2, 160, 80), ("bh", 2, 2, 512, 80)]


@pytest.mark.parametrize("pair,b,heads,s,d", F32_FWD_EDGES)
def test_f32_forward_edges_on_head_views(dev, pair, b, heads, s, d):
    """K7's and K5's f32 forward on q, k, v as head views of [b, s, heads
    d] projections, batch row 0 with half its keys and the last with none:
    within fa.F32_FWD_TOL of max|v| of an f64 evaluation, fa.F32_VS_BF16
    times closer than the bf16 instance, two calls bitwise equal, one
    launch a call on the f32 counter."""
    fwd = fa.bh_attention_fwd if pair == "bh" else fa.group_attention_fwd
    x = [_randn(dev, b, s, heads * d, seed=s + d + i) for i in range(3)]
    q, k, v = (t.view(b, s, heads, d).transpose(1, 2) for t in x)
    mask = torch.ones(b, s, dtype=torch.int32, device=dev)
    mask[0, s // 2 + 1:] = 0
    mask[-1] = 0
    o64, _ = fa.attention_f64(q, k, v, mask, torch.zeros_like(q))
    before = (fwd.launches, fwd.f32.launches)
    o = fwd(q, k, v, mask)
    again = fwd(q, k, v, mask)
    torch.cuda.synchronize()
    assert (fwd.launches, fwd.f32.launches) == (before[0], before[1] + 2)
    assert o.dtype == torch.float32 and o.shape == q.shape
    assert torch.equal(o, again)
    vmax = float(v.abs().max())
    err = float((o.double() - o64).abs().max()) / vmax
    assert err <= fa.F32_FWD_TOL, err
    ob = fwd(*(t.to(torch.bfloat16) for t in (q, k, v)), mask)
    err_b = float((ob.double() - o64).abs().max()) / vmax
    assert err_b >= fa.F32_VS_BF16 * err, (err_b, err)


@pytest.mark.parametrize("s", [160, 512])
def test_f32_attention_takes_the_kernels(dev, s):
    """f32 q, k, v on the card through the dispatch (small_s_impl="group"
    below 256) under autograd, on head views: the f32 instances launch
    (K5/K6 or K7/K8), the bf16 counters stay, and the result and the
    gradients are the f32 function's (F32_* limits against f64); f16
    takes the plain attention with no launch."""
    b, heads, d = 2, 3, 64
    x = [_randn(dev, b, s, heads * d, seed=i).requires_grad_()
         for i in range(3)]
    q, k, v = (t.view(b, s, heads, d).transpose(1, 2) for t in x)
    mask = torch.ones(b, s, dtype=torch.int32, device=dev)
    mask[1, s // 3:] = 0
    fwd, bwd = ((fa.bh_attention_fwd, fa.bh_attention_bwd) if s >= 256 else
                (fa.group_attention_fwd, fa.group_attention_bwd))
    counts = (fwd.launches, bwd.launches, fwd.f32.launches, bwd.f32.launches)
    out, _ = multi_head_attention(q, k, v, mask, impl="flash",
                                  small_s_impl="group")
    do = _randn(dev, *out.shape, seed=9)
    out.backward(do)
    assert out.dtype == torch.float32
    assert (fwd.launches, bwd.launches, fwd.f32.launches,
            bwd.f32.launches) == (counts[0], counts[1], counts[2] + 1,
                                  counts[3] + 1)
    o64, g64 = fa.attention_f64(q.detach(), k.detach(), v.detach(), mask, do)
    err_o = float((out.detach().double() - o64).abs().max()
                  / v.detach().abs().max())
    assert err_o <= fa.F32_FWD_TOL, err_o
    grads = [t.grad.view(b, s, heads, d).transpose(1, 2) for t in x]
    assert max(fa.errors_of_largest(grads, g64)) <= fa.F32_BWD_TOL
    h = [t.detach().half() for t in (q, k, v)]
    before = ops.launches()
    got = multi_head_attention(*h, mask, impl="flash",
                               small_s_impl="group")[0]
    assert got.dtype == torch.float16 and ops.launches() == before
    assert torch.equal(got, multi_head_attention(*h, mask)[0])
    with pytest.raises(ValueError, match="head widths 1 .. 128"):
        fwd(*(torch.zeros(1, 1, s, 144, device=dev) for _ in range(3)),
            mask[:1])
    with pytest.raises(ValueError, match="bf16 or f32"):
        fwd(*h, mask)


def test_fused_int8_layer_follows_the_jax_dispatch(dev):
    """``layer_impl="fused_int8"`` on the card: the tiny config (H=64, off
    the 128 grid) computes ``layer_reference`` with no launch of K1-K3;
    H=128 with 8 heads (d=16) runs K1-K3 and agrees with the plain int8
    composition (the context of K3 may move by one bf16 step of p)."""
    from simxns_tpu_torch.models import BertConfig
    from simxns_tpu_torch.models.bert import BertLayer

    for h, heads, on_kernels in ((64, 4, False), (128, 8, True)):
        cfg = BertConfig(vocab_size=64, hidden_size=h, num_layers=1,
                         num_heads=heads, intermediate_size=2 * h,
                         max_position_embeddings=64, dtype=torch.bfloat16,
                         layer_impl="fused_int8")
        layer = BertLayer(cfg).to(dev)
        with torch.no_grad():
            for i, (name, p) in enumerate(layer.named_parameters()):
                p.copy_(_randn(dev, *p.shape, scale=0.05, seed=i))
                if "layer_norm.weight" in name:
                    p.add_(1.0)
        x = _randn(dev, 3, 40, h, seed=h).to(torch.bfloat16)
        mask = torch.ones(3, 40, dtype=torch.int32, device=dev)
        mask[1, 25:] = 0
        counts = [fl.int8_linear.launches, fl.row_quant.launches,
                  fl.small_s_attention.launches]
        with torch.no_grad():
            got, _ = layer(x, mask)
        after = [fl.int8_linear.launches, fl.row_quant.launches,
                 fl.small_s_attention.launches]
        assert fl.reaches_kernels(40, h, 2 * h) == on_kernels
        if on_kernels:
            assert [a - b for a, b in zip(after, counts)] == [4, 5, 1]
            want = fl.layer_int8_plain(x, mask, layer.quantized(),
                                       num_heads=heads)
            # a flipped int8 code moves an output by about one step
            d = (got.float() - want.float()).abs()
            assert float(d.max()) <= 0.0625 and float(d.mean()) <= 1e-3
        else:
            assert after == counts
            want = fl.layer_reference(x, mask, layer.kernel_params(),
                                      num_heads=heads)
            assert torch.equal(got, want)


def _fused_int8_layer(dev, h, heads, seed):
    from simxns_tpu_torch.models import BertConfig
    from simxns_tpu_torch.models.bert import BertLayer

    cfg = BertConfig(vocab_size=64, hidden_size=h, num_layers=1,
                     num_heads=heads, intermediate_size=2 * h,
                     max_position_embeddings=2048, dtype=torch.bfloat16,
                     layer_impl="fused_int8")
    layer = BertLayer(cfg).to(dev)
    with torch.no_grad():
        for i, (name, p) in enumerate(layer.named_parameters()):
            p.copy_(_randn(dev, *p.shape, scale=0.05, seed=seed + i))
            if "layer_norm.weight" in name:
                p.add_(1.0)
    return layer


@pytest.mark.parametrize("h,heads,s,k3", [(768, 4, 40, 0), (128, 2, 1100, 1)])
def test_fused_int8_layer_where_k3_once_refused(dev, h, heads, s, k3):
    """ROADMAP Queue 3 item 9 (a) and (b) under ``layer_impl="fused_int8"``:
    d = 192 (H = 768 over 4 heads) runs K1 and K2 with the plain attention
    on the card (no K3 launch); S = 1,100 runs K1-K3 (K3 takes it whole).
    Both against the plain int8 composition with the dispatch test's
    limits (a flipped int8 code moves an output by about one step)."""
    layer = _fused_int8_layer(dev, h, heads, seed=h + s)
    x = _randn(dev, 2, s, h, seed=s).to(torch.bfloat16)
    mask = torch.ones(2, s, dtype=torch.int32, device=dev)
    mask[1, s // 3:] = 0
    assert fl.reaches_kernels(s, h, 2 * h)
    counts = [fl.int8_linear.launches, fl.row_quant.launches,
              fl.small_s_attention.launches]
    with torch.no_grad():
        got, _ = layer(x, mask)
        want = fl.layer_int8_plain(x, mask, layer.quantized(),
                                   num_heads=heads)
    after = [fl.int8_linear.launches, fl.row_quant.launches,
             fl.small_s_attention.launches]
    assert [a - b for a, b in zip(after, counts)] == [4, 5, k3]
    d = (got.float() - want.float()).abs()
    assert float(d.max()) <= 0.0625 and float(d.mean()) <= 1e-3


@pytest.mark.parametrize("s,small_s_impl", [(256, None), (160, "group")])
def test_wide_heads_take_the_plain_attention(dev, s, small_s_impl):
    """ROADMAP Queue 3 item 9 (a) through ``flash_attention``: d = 192 (H =
    768 over 4 heads) on head views launches none of K5-K8 and computes
    the kernels' f32 function (``_group_fwd_plain``, its gradients under
    autograd) within the bf16 pair's limits: the plain attention rounds p
    to bf16 before p v."""
    b, heads, d = 2, 4, 192
    x = [_randn(dev, b, s, heads * d, seed=i).to(torch.bfloat16)
         .requires_grad_() for i in range(3)]
    q, k, v = (t.view(b, s, heads, d).transpose(1, 2) for t in x)
    mask = torch.ones(b, s, dtype=torch.int32, device=dev)
    mask[1, s // 2:] = 0
    ops.reset_launches()
    out = fa.flash_attention(q, k, v, mask, small_s_impl=small_s_impl)
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    assert not any(ops.launches().values())
    refs = [t.detach().clone().requires_grad_() for t in x]
    rq, rk, rv = (t.view(b, s, heads, d).transpose(1, 2) for t in refs)
    want = fa._group_fwd_plain(rq, rk, rv, mask)
    tol = 2.0 ** -7 * float(rv.detach().float().abs().max())
    assert float((out.detach().float() - want.float()).abs().max()) <= tol
    want.float().square().sum().backward()
    for got, ref in zip(x, refs):
        err = float((got.grad.float() - ref.grad.float()).abs().max())
        assert err <= 2.0 ** -6 * float(ref.grad.float().abs().max()), err
