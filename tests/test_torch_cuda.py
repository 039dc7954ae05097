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
kernels, at tiling and ragged shapes and under autograd; K13/K14, the int8 encode kernels, bitwise
against their plain versions at tiling and ragged shapes, in a model,
and the JAX dispatch where the shapes do not tile); what a kernel does
not take raises instead of running a plain version on the card.
"""

import pytest
import torch

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


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("s", [1, 32, 128, 160, 300, 512])
def test_small_s_attention_matches_plain(dev, s, d):
    """Every query-tile count K3 meets (S = 1 .. 512: one to eight tiles of
    64 rows, ragged last tiles), every head width, one sequence fully
    masked and one cut short. p is rounded to bf16 on both sides; the
    context may move by one bf16 step of p times |v| (<= 2^-7 max|v|)."""
    b, heads = 3, 2
    h = heads * d
    qkv = _randn(dev, b * s, 3 * h, seed=s + d).to(torch.bfloat16)
    mask = torch.ones(b, s, dtype=torch.int32, device=dev)
    mask[0] = 0
    mask[1, (s + 1) // 2:] = 0
    before = fl.small_s_attention.launches
    got = fl.small_s_attention(qkv, mask, heads)
    want = fl._small_s_attention_plain(qkv, mask, heads)
    tol = 2.0 ** -7 * float(qkv[:, 2 * h:].float().abs().max())
    assert float((got - want).abs().max()) <= tol
    assert fl.small_s_attention.launches == before + 1
    with pytest.raises(ValueError, match="S <= 512"):
        fl.small_s_attention(qkv.new_zeros(600, 3 * h),
                             mask.new_ones(1, 600), heads)


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


def test_mips_candidates_match_plain(dev):
    """int8: the same integer sums and the same two f32 products, so scores
    and ids are equal; bf16 scores agree to f32 summation order."""
    q = _randn(dev, 5, 128)
    c = _randn(dev, 3000, 128, seed=3)
    q8, qs = mk.quantize_rows(q)
    c8, cs = mk.quantize_rows(c)
    before = mk.mips_bucket_candidates.launches
    kw = dict(bucket=64, block_n=2048)
    got = mk.mips_bucket_candidates(q8, c8, 2900, query_scales=qs,
                                    row_scales=cs, **kw)
    want = mk._candidates_plain(q8, c8, 2900, 64, 4096, qs, cs)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    q16, c16 = q.to(torch.bfloat16), c.to(torch.bfloat16)
    got = mk.mips_bucket_candidates(q16, c16, 2900, **kw)
    want = mk._candidates_plain(q16, c16, 2900, 64, 4096, None, None)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-4)
    assert mk.mips_bucket_candidates.launches == before + 2


def _int8_weights(dev, o, i, seed):
    """An nn.Linear weight [o, i] and bias at a BERT layer's scale, with
    its per-channel codes and scales: (w, b, (w8, ws, b))."""
    w = _randn(dev, o, i, scale=0.02, seed=seed)
    b = _randn(dev, o, scale=0.02, seed=seed + 1)
    return w, b, (*fused_ffn.quantize_weight(w), b)


def _same_or_one_code(got, want, what):
    """K13/K14 repeat their plain versions' f32 operations in order, so
    the outputs are expected bitwise. Allowed: a code of g one step off
    (an ulp of GELU's exp across a rounding) moves its row's outputs by
    at most gs * 127 * s2 = max|g| max|w2| / 127, below one bf16 step of
    the largest |y|, on at most 1e-3 of the elements."""
    diff = (got.float() - want.float()).abs()
    tol = 2.0 ** -7 * float(want.float().abs().max())
    assert float(diff.max()) <= tol, (what, float(diff.max()), tol)
    assert float((diff > 0).float().mean()) <= 1e-3, what


@pytest.mark.parametrize("m,i,o", [(256, 768, 2304), (37, 256, 384),
                                   (1, 1024, 128), (600, 768, 768),
                                   (4000, 128, 256)])
def test_int8_dense_matches_plain(dev, m, i, o):
    """K13 against its plain version at tiling and ragged M (the kernel
    masks its edge) and every row-block size it picks; one launch."""
    x = _randn(dev, m, i, seed=m).to(torch.bfloat16)
    _, _, q = _int8_weights(dev, o, i, seed=i)
    before = fused_ffn.int8_dense_fwd.launches
    got = fused_ffn.int8_dense_fwd(x, *q)
    want = fused_ffn._int8_dense_plain(x, *q)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (m, o)
    assert torch.equal(got, want)
    assert fused_ffn.int8_dense_fwd.launches == before + 1


@pytest.mark.parametrize("m,h,f", [(64, 256, 256), (37, 768, 512),
                                   (256, 768, 3072), (33, 1024, 384),
                                   (1, 256, 128)])
def test_int8_ffn_matches_plain(dev, m, h, f):
    """K14 against its plain version at tiling and ragged M; one launch."""
    x = _randn(dev, m, h, seed=m + h).to(torch.bfloat16)
    _, _, (w1_8, s1, b1) = _int8_weights(dev, f, h, seed=1)
    _, _, (w2_8, s2, b2) = _int8_weights(dev, h, f, seed=3)
    args = (x, w1_8, s1, b1, w2_8, s2, b2)
    before = fused_ffn.int8_ffn_fwd.launches
    got = fused_ffn.int8_ffn_fwd(*args)
    want = fused_ffn._int8_ffn_plain(*args)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (m, h)
    _same_or_one_code(got, want, (m, h, f))
    assert fused_ffn.int8_ffn_fwd.launches == before + 1


def test_int8_knobs_dispatch_and_refuse(dev):
    """The public int8_ffn / int8_dense keep the JAX rule on the card:
    where the shapes do not tile they ARE the unquantized expression and
    launch nothing; where they tile, the kernel runs or raises (an f32
    CUDA tensor; H = 1152 or I = 1152, on the JAX grid but not built)."""
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
    _same_or_one_code(y.view(64, 256), fused_ffn._int8_ffn_plain(
        x64, *fused_ffn.quantize_weight(w1), b1,
        *fused_ffn.quantize_weight(w2), b2), "int8_ffn")
    w, b, q = _int8_weights(dev, 384, 256, seed=7)
    assert torch.equal(fused_ffn.int8_dense(x64, w, b),
                       fused_ffn._int8_dense_plain(x64, *q))
    assert [getattr(fused_ffn, n).launches for n in names] == [
        n + 1 for n in before]
    with pytest.raises(ValueError, match="bfloat16"):
        fused_ffn.int8_ffn(x64.float(), w1, b1, w2, b2)
    with pytest.raises(ValueError, match="bfloat16"):
        fused_ffn.int8_dense(x64.float(), w, b)
    wide = torch.zeros(64, 1152, dtype=torch.bfloat16, device=dev)
    w3, b3, _ = _int8_weights(dev, 256, 1152, seed=9)
    with pytest.raises(ValueError, match="H in"):
        fused_ffn.int8_ffn(wide, w3, b3, w3.T.contiguous(),
                           torch.zeros(1152, device=dev))
    with pytest.raises(ValueError, match="I a multiple"):
        fused_ffn.int8_dense(wide, w3, b3)
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
                                   (200, 768, 512), (96, 1024, 256)])
def test_ffn_kernels_match_plain(dev, m, h, f):
    """K9-K12 against their plain versions at tiling and ragged M (the
    kernels mask their edge), one launch each."""
    x, w1, b1, w2, b2, dy = _ffn_inputs(dev, m, h, f, seed=m + h)
    names = ("ffn_train_fwd", "ffn_fused_fwd", "ffn_bwd_dx", "ffn_bwd_dw")
    before = [getattr(fused_ffn, n).launches for n in names]
    y, hb = fused_ffn.ffn_train_fwd(x, w1, b1, w2, b2)
    y_ref, hb_ref = fused_ffn._ffn_train_fwd_plain(x, w1, b1, w2, b2)
    _close_bf16(hb, hb_ref, "hb")
    _close_bf16(y, y_ref, "y")
    _close_bf16(fused_ffn.ffn_fused_fwd(x, w1, b1, w2, b2), y_ref, "y fused")
    # the backward kernels from the plain hb, so both sides read the same
    dx, dh = fused_ffn.ffn_bwd_dx(dy, w1, w2, hb_ref)
    dx_ref, dh_ref = fused_ffn._ffn_bwd_dx_plain(dy, w1, w2, hb_ref)
    _close_bf16(dh, dh_ref, "dh")
    _close_bf16(dx, dx_ref, "dx")
    got = fused_ffn.ffn_bwd_dw(x, dy, hb_ref, dh_ref)
    want = fused_ffn._ffn_bwd_dw_plain(x, dy, hb_ref, dh_ref)
    for name, g, w in zip(("dw1", "db1", "dw2"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        _close_f32(g, w, name)
    torch.cuda.synchronize()
    assert [getattr(fused_ffn, n).launches for n in names] == [
        b + 1 for b in before]


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
    """On the card a knob launches its kernel or raises: it never gives way
    to the library composition, whatever the JAX tiling rule says."""
    x, w1, b1, w2, b2, _ = _ffn_inputs(dev, 32, 256, 256)
    with pytest.raises(ValueError, match="bfloat16"):
        fused_ffn.ffn_train_fwd(x.float(), w1.float(), b1.float(),
                                w2.float(), b2.float())
    big = torch.zeros(32, 1152, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="H in"):
        fused_ffn.ffn_fused_fwd(big, big.new_zeros(256, 1152), b1,
                                big.new_zeros(1152, 256), big.new_zeros(1152))
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
    # a width off the kernels' grid raises under both knobs
    odd = _randn(dev, 7, 96).to(torch.bfloat16)
    params = (_randn(dev, 200, 96), _randn(dev, 200), _randn(dev, 96, 200),
              _randn(dev, 96))
    for impl in ("fused", "fused_vjp"):
        with pytest.raises(ValueError, match="H in"):
            fused_ffn.ffn(odd, *params, impl)
    assert [getattr(fused_ffn, n).launches for n in names] == [
        b + 1 for b in before]


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


@pytest.mark.parametrize("b,heads,s,d", [(3, 2, 1, 64), (3, 2, 17, 32),
                                         (2, 4, 160, 64), (1, 2, 255, 128),
                                         (5, 3, 40, 128)] + GROUP_EDGES)
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


@pytest.mark.parametrize("b,heads,s,d", [(3, 2, 256, 64), (2, 2, 288, 32),
                                         (2, 3, 512, 128), (1, 2, 1024, 64),
                                         (3, 2, 300, 128), (2, 2, 17, 32)]
                         + BH_EDGES)
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
