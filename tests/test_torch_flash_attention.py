"""The attention pairs of the port (grouped K5/K6, per-(batch, head) K7/K8)
and the flash dispatch against the JAX Pallas kernels, run in interpret
mode.

On the CPU the port's wrappers run their plain versions, which keep p in
f32 as the Pallas kernels do (``_fused_attention_group``); JAX's
``flash_attention`` off the TPU returns the XLA composition instead unless
``INTERPRET`` is set, so the fixture sets it.
"""

import ctypes
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simxns_tpu.ops.flash_attention as jfa
from simxns_tpu_torch.ops import flash_attention as fa
from simxns_tpu_torch.ops.attention import multi_head_attention
from torch_parity import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _interpret():
    old = jfa.INTERPRET
    jfa.INTERPRET = True
    yield
    jfa.INTERPRET = old


def _inputs(b, h, s, d, seed):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(size=(b, h, s, d)).astype(np.float32)
                   for _ in range(4))
    lens = rng.integers(1, s + 1, b)
    lens[0] = s                                  # one row with every key
    mask = (np.arange(s)[None, :] < lens[:, None]).astype(np.int32)
    return q, k, v, do, mask


def _jax_group(q, k, v, do, mask, jdt):
    args = [jnp.asarray(x, jdt) for x in (q, k, v)]
    out, vjp = jax.vjp(
        lambda a, b, c: jfa._fused_attention_group(a, b, c,
                                                   jnp.asarray(mask)), *args)
    grads = vjp(jnp.asarray(do, jdt))
    return [np.asarray(x, np.float32) for x in (out, *grads)]


def _port(q, k, v, do, mask, dt):
    ts = [torch.from_numpy(x).to(dt).requires_grad_() for x in (q, k, v)]
    out, _ = multi_head_attention(*ts, torch.from_numpy(mask), impl="flash",
                                  small_s_impl="group")
    out.backward(torch.from_numpy(do).to(dt))
    return [t.detach().float().numpy() for t in (out, *(x.grad for x in ts))]


# (B, heads, S, d): odd B (the TPU groups batch elements in pairs, else
# one), S from 1 key to the largest the grouped kernel takes
SHAPES = [(3, 2, 1, 32), (3, 2, 17, 32), (2, 2, 160, 32), (1, 2, 255, 16)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_group_pair_matches_interpreted_kernel(shape, dtype):
    """Forward: f32 to 1e-5 absolute; bf16 to 2^-8 max|v| (the f32 results
    round to bf16 on both sides). Gradients: 1e-5 x max|ref| in f32,
    2^-7 x max|ref| in bf16."""
    jdt, dt = ((jnp.float32, torch.float32) if dtype == "f32"
               else (jnp.bfloat16, torch.bfloat16))
    q, k, v, do, mask = _inputs(*shape, seed=sum(shape))
    if dtype == "bf16":       # both sides start from the same bf16 values
        q, k, v, do = (np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
                       for x in (q, k, v, do))
    want = _jax_group(q, k, v, do, mask, jdt)
    got = _port(q, k, v, do, mask, dt)
    fwd_tol = 1e-5 if dtype == "f32" else 2.0 ** -8 * np.abs(v).max()
    assert np.abs(got[0] - want[0]).max() <= fwd_tol
    rel = 1e-5 if dtype == "f32" else 2.0 ** -7
    for g, w in zip(got[1:], want[1:]):
        assert np.abs(g - w).max() <= rel * np.abs(w).max()


def _jax_bh(q, k, v, do, mask, jdt):
    args = [jnp.asarray(x, jdt) for x in (q, k, v)]
    out, vjp = jax.vjp(
        lambda a, b, c: jfa._fused_attention(a, b, c, jnp.asarray(mask)),
        *args)
    grads = vjp(jnp.asarray(do, jdt))
    return [np.asarray(x, np.float32) for x in (out, *grads)]


def _port_bh(q, k, v, do, mask, dt):
    ts = [torch.from_numpy(x).to(dt).requires_grad_() for x in (q, k, v)]
    out = fa._FusedAttention.apply(*ts, torch.from_numpy(mask), True)
    out.backward(torch.from_numpy(do).to(dt))
    return [t.detach().float().numpy() for t in (out, *(x.grad for x in ts))]


# (B, heads, S, d): S=17 (keys past S in the last 64-key tile are padding),
# the dispatch's smallest S, and 288 (prod_kd_marcodoc's joint length, not a
# multiple of 64); B=3 rows: every key, random lengths, every key masked
BH_SHAPES = [(3, 2, 17, 16), (3, 1, 256, 16), (3, 1, 288, 32)]


@pytest.mark.parametrize("shape", BH_SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_bh_pair_matches_interpreted_kernel(shape, dtype):
    """K7/K8's plain versions through the autograd Function against
    ``_fused_attention`` (``_fwd_call`` / ``_fused_bwd``), with the
    tolerances of the grouped pair. The fully masked row gets the uniform
    softmax over its keys, as the TPU kernel's -1e9 bias gives."""
    jdt, dt = ((jnp.float32, torch.float32) if dtype == "f32"
               else (jnp.bfloat16, torch.bfloat16))
    q, k, v, do, mask = _inputs(*shape, seed=sum(shape))
    mask[2] = 0
    if dtype == "bf16":
        q, k, v, do = (np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
                       for x in (q, k, v, do))
    want = _jax_bh(q, k, v, do, mask, jdt)
    got = _port_bh(q, k, v, do, mask, dt)
    fwd_tol = 1e-5 if dtype == "f32" else 2.0 ** -8 * np.abs(v).max()
    assert np.abs(got[0] - want[0]).max() <= fwd_tol
    rel = 1e-5 if dtype == "f32" else 2.0 ** -7
    for g, w in zip(got[1:], want[1:]):
        assert np.abs(g - w).max() <= rel * np.abs(w).max()
    uniform = v[2].mean(axis=1)                      # [heads, d]
    assert np.abs(got[0][2] - uniform[:, None, :]).max() <= fwd_tol


def test_dispatch(monkeypatch):
    """256 <= S <= 1024 goes to the per-(b, h) pair (K7/K8; plain on the
    CPU, the interpreted kernel's numbers), S > 1024 to the XLA
    composition; S < 256 without "group" is the XLA composition; the mask
    defaults to ones."""
    q, k, v, do, mask = _inputs(1, 2, 256, 16, seed=5)
    jout = jfa.flash_attention(*(jnp.asarray(x) for x in (q, k, v)),
                               jnp.asarray(mask))
    out, _ = multi_head_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                  torch.from_numpy(mask), impl="flash")
    assert np.abs(out.numpy() - np.asarray(jout)).max() <= 1e-5

    calls = []
    real = fa.bh_attention_fwd

    def spy(*args):
        calls.append(args[0].shape[2])
        return real(*args)

    monkeypatch.setattr(fa, "bh_attention_fwd", spy)
    for s in (256, 1024, 1025):
        x = torch.zeros(1, 1, s, 8)
        fa.flash_attention(x, x, x)
    assert calls == [256, 1024]

    q, k, v, do, mask = _inputs(2, 2, 24, 16, seed=6)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    xla, _ = multi_head_attention(qt, kt, vt, torch.from_numpy(mask))
    assert torch.equal(fa.flash_attention(qt, kt, vt, torch.from_numpy(mask)),
                       xla)
    assert torch.equal(fa.flash_attention(qt, kt, vt, small_s_impl="group"),
                       fa._group_fwd_plain(qt, kt, vt,
                                           torch.ones(2, 24, dtype=torch.int32)))


def test_route():
    """The dispatch as a pure function of shape, dtype and device: JAX's
    (256 <= S <= 1024 the per-(b, h) pair, S < 256 the grouped pair under
    "group", else the plain attention), and on the card (``is_cuda``) the
    plain attention for heads wider than the kernels' 128 and for dtypes
    they do not take (f16); on the CPU those take the kernels' plain
    versions, the function of JAX's interpreted kernels."""
    bf16, f32, f16 = torch.bfloat16, torch.float32, torch.float16
    for cuda in (True, False):
        assert fa.route(256, 64, bf16, cuda) == "bh"
        assert fa.route(1024, 128, f32, cuda) == "bh"
        assert fa.route(160, 128, bf16, cuda, "group") == "group"
        assert fa.route(160, 64, bf16, cuda) == "plain"
        assert fa.route(1025, 64, bf16, cuda) == "plain"
        assert fa.route(17, 24, f32, cuda, "group") == "group"
    for s, impl, cpu in ((256, None, "bh"), (160, "group", "group")):
        for d in (129, 192, 256):
            assert fa.route(s, d, bf16, True, impl) == "plain"
            assert fa.route(s, d, bf16, False, impl) == cpu
        assert fa.route(s, 64, f16, True, impl) == "plain"
        assert fa.route(s, 64, f16, False, impl) == cpu
    assert fa.kernels_take_width(128) and not fa.kernels_take_width(129)


@pytest.mark.parametrize("small_s_impl,s", [(None, 256), ("group", 40)])
def test_wide_heads_match_interpreted_kernel(small_s_impl, s):
    """d = 192 (H = 768 over 4 heads), past the card kernels' widths: the
    plain attention the card routes it to (``multi_head_attention``, f32)
    and the CPU route (the fused pair's plain versions) against JAX's
    ``flash_attention`` with its Pallas kernels interpreted (which take any
    d), forward and gradients under autograd: 1e-5 absolute forward, 1e-5
    of the largest gradient (the f32 function, summed in another order)."""
    q, k, v, do, mask = _inputs(2, 4, s, 192, seed=s + 192)
    mask[-1] = 0
    jargs = [jnp.asarray(x) for x in (q, k, v)]
    out, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(
        a, b, c, jnp.asarray(mask), small_s_impl=small_s_impl), *jargs)
    want = [np.asarray(x, np.float32)
            for x in (out, *vjp(jnp.asarray(do)))]
    routes = (lambda *t: fa.flash_attention(*t, small_s_impl=small_s_impl),
              lambda *t: multi_head_attention(*t)[0])
    for attend in routes:
        ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        got = attend(*ts, torch.from_numpy(mask))
        got.backward(torch.from_numpy(do))
        assert np.abs(got.detach().numpy() - want[0]).max() <= 1e-5
        for t, w in zip(ts, want[1:]):
            assert np.abs(t.grad.numpy() - w).max() <= 1e-5 * np.abs(w).max()


# --- the algorithm of the backward kernels (K6, K8) --------------------------

_LOG2E = 1.4426950408889634


def _tiled_bwd_model(q, k, v, do, mask, tile):
    """The walks of K6 (``tile`` = 32, its resident chunks) and K8 (64,
    its ring tiles) in f32 PyTorch: log2-domain scores with the mask's
    -1e9 log2(e), -inf past S in the last tile, and 0 for every key of a
    batch element whose keys are all masked; one walk over the key tiles
    folds each row's max, sum and unnormalised rowsum(dP p); lse = m +
    log2(sum), dot = dot_u / sum; then dQ per query tile and dK, dV per key
    tile with p = 2^(s - lse). -> (dq, dk, dv) as numpy arrays."""
    q, k, v, do = (torch.from_numpy(x).float() for x in (q, k, v, do))
    b, h, s, d = q.shape
    n = -(-s // tile)
    sp = n * tile
    scale = 1.0 / np.sqrt(d)
    scale2 = torch.tensor(scale * _LOG2E, dtype=torch.float32)

    def pad(x):                      # rows past S zero-filled
        return torch.nn.functional.pad(x, (0, 0, 0, sp - s))

    q, k, v, do = (pad(x) for x in (q, k, v, do))
    real = torch.from_numpy(mask > 0)
    fill = torch.where(real, torch.tensor(np.inf),
                       torch.tensor(-1e9 * _LOG2E, dtype=torch.float32))
    fill[~real.any(dim=1)] = 0.0     # every key masked: all scores equal
    fill = torch.nn.functional.pad(fill, (0, sp - s), value=-np.inf)
    fill = fill[:, None, None, :]    # [B, 1, 1, Sp]

    def scores(qt, kt, cols):        # [B, H, rows, 64] in the log2 domain
        f = fill[..., cols]
        return torch.where(f == np.inf, (qt @ kt.transpose(-1, -2)) * scale2,
                           f.expand(-1, h, qt.shape[2], -1))

    def cols(j):
        return slice(j * tile, (j + 1) * tile)

    mx = torch.full((b, h, sp), -np.inf)
    tot = torch.zeros(b, h, sp)
    dotu = torch.zeros(b, h, sp)
    for j in range(n):
        sc = scores(q, k[:, :, cols(j)], cols(j))
        dp = do @ v[:, :, cols(j)].transpose(-1, -2)
        m_new = torch.maximum(mx, sc.amax(dim=-1))
        alpha = torch.where(mx == -np.inf, torch.zeros(()),
                            torch.exp2(mx - m_new))
        e = torch.exp2(sc - m_new[..., None])
        tot = tot * alpha + e.sum(dim=-1)
        dotu = dotu * alpha + (e * dp).sum(dim=-1)
        mx = m_new
    lse = mx + torch.log2(tot)
    dot = dotu / tot
    lse[..., s:] = 0.0               # the key pass reads zero-filled rows
    dot[..., s:] = 0.0

    dq = torch.zeros_like(q)
    for i in range(n):               # query tiles: dQ over every key tile
        rows = cols(i)
        for j in range(n):
            sc = scores(q[:, :, rows], k[:, :, cols(j)], cols(j))
            p = torch.exp2(sc - lse[:, :, rows, None])
            dp = do[:, :, rows] @ v[:, :, cols(j)].transpose(-1, -2)
            ds = p * (dp - dot[:, :, rows, None])
            dq[:, :, rows] += ds @ k[:, :, cols(j)]
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for j in range(n):               # key tiles: dK, dV over every query
        keys = cols(j)
        for i in range(n):
            rows = cols(i)
            st = scores(q[:, :, rows], k[:, :, keys], keys).transpose(-1, -2)
            pt = torch.exp2(st - lse[:, :, None, rows])
            dpt = v[:, :, keys] @ do[:, :, rows].transpose(-1, -2)
            dst = pt * (dpt - dot[:, :, None, rows])
            dv[:, :, keys] += pt @ do[:, :, rows]
            dk[:, :, keys] += dst @ q[:, :, rows]
    return [(x[:, :, :s] * m).numpy()
            for x, m in ((dq, scale), (dk, scale), (dv, 1.0))]


@pytest.mark.parametrize("s", [17, 160, 300])
@pytest.mark.parametrize("kernel", ["bwd_kernel", "bwd_kernel_group"])
def test_backward_algorithm_matches_interpreted_kernel(kernel, s):
    """The kernels' walks (log-sum-exp from one fold, p = 2^(s - lse)), as
    K8 tiles them (64 rows) against ``_fused_bwd`` (``_bwd_kernel``) and as
    K6 does (32) against ``_fused_group_bwd`` (``_bwd_kernel_group``), in
    f32, to 1e-5 of the largest gradient; batch row 2 has every key masked
    (the uniform softmax over S keys)."""
    q, k, v, do, mask = _inputs(3, 2, s, 16, seed=s + 1)
    mask[2] = 0
    if kernel == "bwd_kernel":
        want = _jax_bh(q, k, v, do, mask, jnp.float32)[1:]
        got = _tiled_bwd_model(q, k, v, do, mask, tile=64)
    else:
        want = _jax_group(q, k, v, do, mask, jnp.float32)[1:]
        got = _tiled_bwd_model(q, k, v, do, mask, tile=32)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max()


@pytest.mark.parametrize("tile", [32, 64, 128])
def test_f32_backward_tiles_match_interpreted_kernel(tile):
    """The walks of the f32 backward (csrc/attention_bwd_f32.cu) at each of
    its streamed tile widths (32 keys on K6's route, 64 and 128 from S =
    256) against ``_fused_bwd`` in f32, to 1e-5 of the largest gradient:
    the fold of the statistics does not depend on the width; S = 300 ends
    in a partial tile, batch row 2 has every key masked."""
    q, k, v, do, mask = _inputs(3, 2, 300, 16, seed=tile)
    mask[2] = 0
    want = _jax_bh(q, k, v, do, mask, jnp.float32)[1:]
    got = _tiled_bwd_model(q, k, v, do, mask, tile=tile)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max()


# --- the algorithm of the one-pass forward kernels (K5, K7) ------------------

# K5's key tiles (csrc/attention_fwd_wgmma.cu, by_length_bf16 below S =
# 256); K7's are 64 keys
GROUP_KEYS = 32


def _tiled_fwd_model(q, k, v, mask, tile):
    """The one-pass walk of K5 and K7 (csrc/attention_fwd_wgmma.cu,
    ``attend``) over key tiles of ``tile`` rows, in f32 PyTorch: scores in
    the log2 domain (scale * log2(e)), -1e9 log2(e) for a masked key and
    -inf past S in the last tile; each row keeps a running max and a sum
    of 2^(s - max), both the sum and the output accumulator rescaled by
    2^(max_old - max_new) when the max grows; one reciprocal of the sum a
    row at the end. (The kernel gives every key of a batch row with none
    real the score 0 instead of -1e9 log2(e): the same uniform softmax.)
    -> o as a numpy array."""
    q, k, v = (torch.from_numpy(x).float() for x in (q, k, v))
    b, h, s, d = q.shape
    n = -(-s // tile)
    sp = n * tile
    scale2 = torch.tensor(1.0 / np.sqrt(d) * _LOG2E, dtype=torch.float32)
    k, v = (torch.nn.functional.pad(x, (0, 0, 0, sp - s)) for x in (k, v))
    fill = torch.where(torch.from_numpy(mask > 0), torch.tensor(0.0),
                       torch.tensor(-1e9 * _LOG2E, dtype=torch.float32))
    fill = torch.nn.functional.pad(fill, (0, sp - s), value=-np.inf)
    fill = fill[:, None, None, :]    # [B, 1, 1, Sp]
    mx = torch.full((b, h, s), -np.inf)
    tot = torch.zeros(b, h, s)
    acc = torch.zeros(b, h, s, d)
    for j in range(n):
        cols = slice(j * tile, (j + 1) * tile)
        f = fill[..., cols]
        sc = torch.where(f == 0.0, (q @ k[:, :, cols].transpose(-1, -2))
                         * scale2, f.expand(-1, h, s, -1))
        m_new = torch.maximum(mx, sc.amax(dim=-1))
        alpha = torch.where(mx == -np.inf, torch.zeros(()),
                            torch.exp2(mx - m_new))
        p = torch.exp2(sc - m_new[..., None])
        tot = tot * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + p @ v[:, :, cols]
        mx = m_new
    return (acc * (1.0 / tot)[..., None]).numpy()


@pytest.mark.parametrize("kernel,s,tile",
                         [("fwd_kernel_group", s, GROUP_KEYS)
                          for s in (1, 17, 63, 64, 65, 160, 255)]
                         + [("fwd_kernel", s, 64) for s in (256, 300)])
def test_forward_algorithm_matches_interpreted_kernel(kernel, s, tile):
    """The kernels' one-pass walk, as K5 tiles the keys against
    ``_fwd_call_group`` (``_fwd_kernel_group``) and as K7 does against
    ``_fwd_call`` (``_fwd_kernel``), in f32, to 1e-5 of max|o|; batch row 2
    has every key masked (the uniform softmax over its S keys)."""
    q, k, v, _, mask = _inputs(3, 2, s, 16, seed=s + 7)
    mask[2] = 0
    call = jfa._fwd_call_group if kernel == "fwd_kernel_group" else jfa._fwd_call
    want = np.asarray(call(*(jnp.asarray(x) for x in (q, k, v)),
                           jnp.asarray(mask)), np.float32)
    got = _tiled_fwd_model(q, k, v, mask, tile)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    uniform = v[2].mean(axis=1)                      # [heads, d]
    assert np.abs(got[2] - uniform[:, None, :]).max() <= 1e-5 * np.abs(
        want).max()


# head widths off the kernels' 16 grid (up to 128), which run the next
# instance over zero-padded heads on the card
OFF_GRID = [8, 24, 40, 72, 100, 120]


@pytest.mark.parametrize("d", OFF_GRID)
def test_pad_and_slice_equals_unpadded(d):
    """The card's route for a d off the 16 grid: q, k, v (and dO)
    zero-padded along d to ``kernel_head_width(d)``, the scale 1/sqrt(d)
    of the true width, the results sliced back. Over the plain versions it
    is the unpadded function: forward and gradients within 1e-6 of the
    largest value (f32; zero columns add exact zeros, only the order of
    the sums differs)."""
    q, k, v, do, mask = (torch.from_numpy(x) for x in
                         _inputs(3, 2, 40, d, seed=d))
    assert fa.kernel_head_width(d) % 16 == 0
    assert 0 < fa.kernel_head_width(d) - d < 16
    got = fa._at_kernel_width(fa._group_fwd_plain, q, k, v, mask)
    want = fa._group_fwd_plain(q, k, v, mask)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
    grads = fa._at_kernel_width(fa._group_bwd_plain, q, k, v, mask, do)
    refs = fa._group_bwd_plain(q, k, v, mask, do)
    for g, r in zip(grads, refs):
        assert g.shape == r.shape == q.shape
        assert float((g - r).abs().max()) <= 1e-6 * float(r.abs().max())


def test_pad_and_slice_matches_the_interpreted_kernel():
    """At d=24 the padded route against the JAX Pallas pair run whole at
    d=24 (the JAX kernels take any d): the f32 tolerances of
    ``test_group_pair_matches_interpreted_kernel``."""
    q, k, v, do, mask = _inputs(3, 2, 17, 24, seed=11)
    want = _jax_group(q, k, v, do, mask, jnp.float32)
    t = [torch.from_numpy(x) for x in (q, k, v, mask, do)]
    out = fa._at_kernel_width(fa._group_fwd_plain, *t[:4])
    grads = fa._at_kernel_width(fa._group_bwd_plain, *t)
    assert np.abs(out.numpy() - want[0]).max() <= 1e-5
    for g, w in zip(grads, want[1:]):
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()


@pytest.mark.parametrize("pair", ["group", "bh"])
def test_kernels_take_every_head_width_up_to_128(pair):
    """The JAX kernels block whole (S, d) heads and take any d; the port's
    wrappers accept every d from 1 to 128 (``_check_shapes``) and refuse
    wider heads with the reason."""
    max_s, what = ((fa._MAX_GROUP_S, "group_attention") if pair == "group"
                   else (fa._MAX_BH_S, "bh_attention"))
    mask = torch.ones(2, 20, dtype=torch.int32)
    for d in range(1, 129):
        q = torch.empty(2, 3, 20, d, device="meta")
        fa._check_shapes(q, q, q, mask, max_s, what)
        assert fa.kernel_head_width(d, what) == -(-d // 16) * 16
    for d in (129, 144, 256):
        q = torch.empty(2, 3, 20, d, device="meta")
        with pytest.raises(ValueError, match="head widths 1 .. 128"):
            fa._check_shapes(q, q, q, mask, max_s, what)


# --- the f32 instances (K5-K8 on f32 q, k, v) --------------------------------

@pytest.mark.parametrize("small_s_impl,shape", [
    ("group", (3, 2, 160, 64)), ("group", (2, 2, 17, 24)),
    (None, (3, 2, 300, 32)), (None, (2, 1, 512, 16))])
def test_f32_flash_attention_matches_interpreted_kernel(small_s_impl, shape):
    """f32 q, k, v through ``flash_attention`` (the route the card sends to
    the f32 instances; the plain versions here) against JAX's
    ``flash_attention`` with its Pallas kernels interpreted, forward and
    gradients under autograd: 1e-5 absolute forward, 1e-5 of the largest
    gradient (the f32 function on both sides, summed in another order)."""
    q, k, v, do, mask = _inputs(*shape, seed=sum(shape) + 1)
    mask[-1] = 0
    jargs = [jnp.asarray(x) for x in (q, k, v)]
    out, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(
        a, b, c, jnp.asarray(mask), small_s_impl=small_s_impl), *jargs)
    want = [np.asarray(x, np.float32)
            for x in (out, *vjp(jnp.asarray(do)))]
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    got = fa.flash_attention(*ts, torch.from_numpy(mask),
                             small_s_impl=small_s_impl)
    got.backward(torch.from_numpy(do))
    assert got.dtype == torch.float32
    assert np.abs(got.detach().numpy() - want[0]).max() <= 1e-5
    for t, w in zip(ts, want[1:]):
        assert np.abs(t.grad.numpy() - w).max() <= 1e-5 * np.abs(w).max()


def _split(x):
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _mm3(a, b):
    """a @ b as the f32 instances form it: both operands as hi + lo bf16
    halves, hi hi + hi lo + lo hi in f32 (lo lo dropped)."""
    ah, al = _split(a)
    bh, bl = _split(b)
    return ah @ bh + (ah @ bl + al @ bh)


def _split_attention(q, k, v, do, mask):
    """The f32 instances' arithmetic in f32 PyTorch: every product of the
    forward and the backward through :func:`_mm3`."""
    q, k, v, do = (torch.from_numpy(x) for x in (q, k, v, do))
    scale = 1.0 / np.sqrt(q.shape[-1])
    s = _mm3(q, k.transpose(-1, -2)) * scale
    s = torch.where(torch.from_numpy(mask)[:, None, None, :] > 0, s, -1e9)
    p = torch.softmax(s, dim=-1)
    dp = _mm3(do, v.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    return [x.numpy() for x in (
        _mm3(p, v), _mm3(ds, k) * scale,
        _mm3(ds.transpose(-1, -2), q) * scale, _mm3(p.transpose(-1, -2), do))]


def _tiled_f32_fwd_model(q, k, v, mask, tile, rows):
    """The walk of the f32 forward (csrc/attention_fwd_wgmma.cu) in f32
    PyTorch: blocks of ``rows`` query rows (64 a warpgroup; rows past S
    zero-filled), key tiles of ``tile`` keys (k and v rows past S
    zero-filled), each product through :func:`_mm3` (q k^T with q and the
    tile split, p v with p split before the product); log2-domain scores
    with the backward's key fills (``bwd::key_fill``: -1e9 log2(e) for a
    masked key, -inf past S, 0 for every key of a batch row with none
    real); a running max and sum a row, the sum and the output rescaled by
    2^(max_old - max_new), one reciprocal of the sum a row at the end.
    -> o as a numpy array."""
    q, k, v = (torch.from_numpy(x).float() for x in (q, k, v))
    b, h, s, d = q.shape
    n = -(-s // tile)
    sp, nq = n * tile, -(-s // rows) * rows
    scale2 = torch.tensor(1.0 / np.sqrt(d) * _LOG2E, dtype=torch.float32)
    k, v = (torch.nn.functional.pad(x, (0, 0, 0, sp - s)) for x in (k, v))
    q = torch.nn.functional.pad(q, (0, 0, 0, nq - s))
    real = torch.from_numpy(mask > 0)
    fill = torch.where(real, torch.tensor(np.inf),
                       torch.tensor(-1e9 * _LOG2E, dtype=torch.float32))
    fill[~real.any(dim=1)] = 0.0
    fill = torch.nn.functional.pad(fill, (0, sp - s), value=-np.inf)
    fill = fill[:, None, None, :]    # [B, 1, 1, Sp]
    o = torch.zeros(b, h, nq, d)
    for r0 in range(0, nq, rows):
        qb = q[:, :, r0:r0 + rows]
        mx = torch.full((b, h, rows), -np.inf)
        tot = torch.zeros(b, h, rows)
        acc = torch.zeros(b, h, rows, d)
        for j in range(n):
            cols = slice(j * tile, (j + 1) * tile)
            f = fill[..., cols]
            sc = torch.where(f == np.inf,
                             _mm3(qb, k[:, :, cols].transpose(-1, -2))
                             * scale2, f.expand(-1, h, rows, -1))
            m_new = torch.maximum(mx, sc.amax(dim=-1))
            alpha = torch.where(mx == -np.inf, torch.zeros(()),
                                torch.exp2(mx - m_new))
            p = torch.exp2(sc - m_new[..., None])
            tot = tot * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + _mm3(p, v[:, :, cols])
            mx = m_new
        o[:, :, r0:r0 + rows] = acc * (1.0 / tot)[..., None]
    return o[:, :, :s].numpy()


@pytest.mark.parametrize("tile,rows", [(32, 64), (64, 128), (128, 128)])
@pytest.mark.parametrize("s", [1, 17, 160, 255, 256, 300])
def test_f32_forward_tiles_match_interpreted_kernel(s, tile, rows):
    """The walk of the f32 forward (csrc/attention_fwd_wgmma.cu) at each
    streamed width (32 keys on K5's route, 64 on K7's, 128) and with 64 or
    128 query rows a block, against ``_fwd_call_group`` (S < 256) or
    ``_fwd_call`` in f32 within fa.F32_FWD_TOL of max|v|, and at least
    fa.F32_VS_BF16 times closer to an f64 evaluation than the same JAX
    function on the inputs cast to bf16; batch row 2 has every key masked
    (the uniform softmax over its S keys)."""
    q, k, v, _, mask = _inputs(3, 2, s, 16, seed=s + tile)
    mask[2] = 0
    call = jfa._fwd_call_group if s < 256 else jfa._fwd_call
    want = np.asarray(call(*(jnp.asarray(x) for x in (q, k, v)),
                           jnp.asarray(mask)), np.float32)
    bf16 = np.asarray(call(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                           jnp.asarray(mask)), np.float32)
    got = _tiled_f32_fwd_model(q, k, v, mask, tile, rows)
    o64, _ = fa.attention_f64(*(torch.from_numpy(x) for x in
                                (q, k, v, mask, np.zeros_like(q))))
    vmax = np.abs(v).max()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= fa.F32_FWD_TOL * vmax
    err = np.abs(got - o64.numpy()).max() / vmax
    err_bf16 = np.abs(bf16 - o64.numpy()).max() / vmax
    assert err_bf16 >= fa.F32_VS_BF16 * err, (err_bf16, err)


@pytest.mark.parametrize("shape", [(3, 2, 160, 64), (2, 2, 300, 128),
                                   (2, 2, 64, 16)])
def test_f32_split_products_are_f32_class(shape):
    """The CPU twin of the f32 instances' arithmetic (``_mm3``): against
    JAX's interpreted f32 kernels within the card's limits (``fa.F32_*``:
    2^-12 of max|v| forward, of the largest gradient backward), and at
    least ``fa.F32_VS_BF16`` (16) times closer to an f64 evaluation than the
    same function on the inputs cast to bf16 (what the bf16 instances
    see)."""
    q, k, v, do, mask = _inputs(*shape, seed=sum(shape) + 2)
    want = _jax_bh(q, k, v, do, mask, jnp.float32)
    got = _split_attention(q, k, v, do, mask)
    o64, g64 = fa.attention_f64(*(torch.from_numpy(x)
                                  for x in (q, k, v, mask, do)))
    ref = [x.numpy() for x in (o64, *g64)]
    bf = [np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
          for x in (q, k, v, do)]
    bf16 = _jax_bh(*bf, mask, jnp.bfloat16)
    scale = [np.abs(v).max()] + [np.abs(r).max() for r in ref[1:]]
    tol = [fa.F32_FWD_TOL] + [fa.F32_BWD_TOL] * 3
    for g, w, r, b, m, t in zip(got, want, ref, bf16, scale, tol):
        assert np.abs(g - w).max() <= t * m
        err, err_bf16 = np.abs(g - r).max() / m, np.abs(b - r).max() / m
        assert err_bf16 >= fa.F32_VS_BF16 * err, (err_bf16, err)


# --- the bf16 kernels on wgmma: K7's walk and K6's ---------------------------

def _bf16_values(*xs):
    """numpy arrays rounded to bf16 (held in f32): the values both sides
    start from."""
    return [np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32) for x in xs]


def _bf16_round(x):
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("s", [1, 17, 63, 64, 65, 160, 192, 255])
def test_k5_bf16_walk_matches_interpreted_kernel(s):
    """K5's bf16 walk (csrc/attention_fwd_wgmma.cu, by_length_bf16 below S
    = 256) is the f32 forward's walk (:func:`_tiled_f32_fwd_model`) on
    bf16 values over key tiles of GROUP_KEYS and blocks of 64 query rows.
    In f32, against ``_fwd_call_group`` on the same values in f32, within
    2^-16 of max|v| (p keeps ~16 bits as hi + lo); rounded to bf16 once,
    against ``_fwd_call_group`` on bf16 inputs, within one bf16 step
    (2^-8 max|v|). Batch row 2 has every key masked (the uniform softmax
    over its S keys)."""
    q, k, v, _, mask = _inputs(3, 2, s, 16, seed=s + 9)
    mask[2] = 0
    q, k, v = _bf16_values(q, k, v)
    got = _tiled_f32_fwd_model(q, k, v, mask, tile=GROUP_KEYS, rows=64)
    vmax = np.abs(v).max()
    want = np.asarray(jfa._fwd_call_group(
        *(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(mask)), np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 2.0 ** -16 * vmax
    want16 = np.asarray(jfa._fwd_call_group(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
        jnp.asarray(mask)), np.float32)
    assert np.abs(_bf16_round(got) - want16).max() <= 2.0 ** -8 * vmax
    uniform = v[2].mean(axis=1)                      # [heads, d]
    assert np.abs(got[2] - uniform[:, None, :]).max() <= 2.0 ** -16 * vmax


@pytest.mark.parametrize("s", [256, 300, 1024])
def test_k7_bf16_walk_matches_interpreted_kernel(s):
    """K7's bf16 walk (csrc/attention_fwd_wgmma.cu, bf16 instance) is the
    f32 forward's walk (:func:`_tiled_f32_fwd_model`) on bf16 values: their
    lo halves are 0, so q k^T is one product and p v two (p as hi + lo),
    over key tiles of 64 and blocks of 128 query rows. In f32, against
    ``_fwd_call`` on the same values in f32, within 2^-16 of max|v| (p
    keeps ~16 bits as hi + lo; the walk reads ~2^-21 here, and ~2^-12 with
    p's lo half dropped); rounded to bf16 once, against ``_fwd_call`` on
    bf16 inputs, within one bf16 step (2^-8 max|v|). Batch row 2 has every
    key masked (the uniform softmax over its S keys)."""
    q, k, v, _, mask = _inputs(3, 2, s, 16, seed=s + 5)
    mask[2] = 0
    q, k, v = _bf16_values(q, k, v)
    got = _tiled_f32_fwd_model(q, k, v, mask, tile=64, rows=128)
    vmax = np.abs(v).max()
    want = np.asarray(jfa._fwd_call(*(jnp.asarray(x) for x in (q, k, v)),
                                    jnp.asarray(mask)), np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 2.0 ** -16 * vmax
    want16 = np.asarray(jfa._fwd_call(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
        jnp.asarray(mask)), np.float32)
    assert np.abs(_bf16_round(got) - want16).max() <= 2.0 ** -8 * vmax
    uniform = v[2].mean(axis=1)                      # [heads, d]
    assert np.abs(got[2] - uniform[:, None, :]).max() <= 2.0 ** -16 * vmax


def _group_bwd_walk(q, k, v, do, mask):
    """K6's one-launch walk (csrc/attention_bwd_wgmma.cu,
    ``group_attention_bwd_kernel``) in f32 PyTorch on bf16 values: R =
    ceil(S / 64) warpgroups, each owning 64 keys (rows past S zero, keys
    past S -inf, the backward's key fills); for each query tile r: each
    warpgroup's s = q_r k_j^T (log2 domain) and dP = dO_r v_j^T, its max m,
    l = sum 2^(s - m), u = sum 2^(s - m) dP; folded in warpgroup order: M =
    max m, L = sum l 2^(m - M), rowsum(dP p) = (sum u 2^(m - M)) / L, p =
    2^(s - m) 2^(m - M) / L; dS = p (dP - rowsum(dP p)); p and dS as bf16
    hi + lo: dV_j += p^T dO_r, dK_j += dS^T q_r, dQ_r += dS k_j (the
    partials summed in warpgroup order). -> (dq, dk, dv) in f32 as numpy
    arrays."""
    q, k, v, do = (torch.from_numpy(x).float() for x in (q, k, v, do))
    b, h, s, d = q.shape
    n = -(-s // 64)
    sp = 64 * n
    scale = 1.0 / np.sqrt(d)
    scale2 = torch.tensor(scale * _LOG2E, dtype=torch.float32)
    q, k, v, do = (torch.nn.functional.pad(x, (0, 0, 0, sp - s))
                   for x in (q, k, v, do))
    real = torch.from_numpy(mask > 0)
    fill = torch.where(real, torch.tensor(np.inf),
                       torch.tensor(-1e9 * _LOG2E, dtype=torch.float32))
    fill[~real.any(dim=1)] = 0.0
    fill = torch.nn.functional.pad(fill, (0, sp - s), value=-np.inf)
    fill = fill[:, None, None, :]    # [B, 1, 1, Sp]
    dq, dk, dv = (torch.zeros_like(q) for _ in range(3))

    def tile(j):
        return slice(64 * j, 64 * j + 64)

    for r in range(n):
        qr, dor = q[:, :, tile(r)], do[:, :, tile(r)]
        parts = []
        for j in range(n):
            f = fill[..., tile(j)]
            sc = torch.where(f == np.inf,
                             (qr @ k[:, :, tile(j)].transpose(-1, -2))
                             * scale2, f.expand(-1, h, 64, -1))
            dp = dor @ v[:, :, tile(j)].transpose(-1, -2)
            m = sc.amax(dim=-1)
            e = torch.exp2(sc - m[..., None])
            parts.append((m, e.sum(dim=-1), (e * dp).sum(dim=-1), e, dp))
        mx = torch.stack([x[0] for x in parts]).amax(dim=0)
        tot = sum(x[1] * torch.exp2(x[0] - mx) for x in parts)
        dot = sum(x[2] * torch.exp2(x[0] - mx) for x in parts) / tot
        dqr = []
        for j, (m, _, _, e, dp) in enumerate(parts):
            p = e * (torch.exp2(m - mx) / tot)[..., None]
            ds = p * (dp - dot[..., None])
            ph, pl = _split(p)
            sh, sl = _split(ds)
            dv[:, :, tile(j)] += (pl.transpose(-1, -2) @ dor
                                  + ph.transpose(-1, -2) @ dor)
            dk[:, :, tile(j)] += (sl.transpose(-1, -2) @ qr
                                  + sh.transpose(-1, -2) @ qr)
            dqr.append(sl @ k[:, :, tile(j)] + sh @ k[:, :, tile(j)])
        dq[:, :, tile(r)] = sum(dqr[1:], dqr[0])
    return [(x[:, :, :s] * m).numpy()
            for x, m in ((dq, scale), (dk, scale), (dv, 1.0))]


@pytest.mark.parametrize("s", [1, 17, 160, 192, 255])
def test_k6_walk_matches_interpreted_kernel(s):
    """K6's one-launch walk (:func:`_group_bwd_walk`; on the card up to S =
    192 at d <= 64, K8's two passes beyond and past d = 64) on bf16 values
    against ``_fused_group_bwd`` (``_bwd_kernel_group``): in f32 on the same
    values within fa.F32_BWD_TOL of each gradient's largest (p and dS as hi
    + lo), and rounded to bf16 against the kernel on bf16 inputs within one
    bf16 step (2^-7 of the largest). Batch row 2 has every key masked (the
    uniform softmax over S keys); at S = 1, p = 1 and dq, dk are exactly 0."""
    q, k, v, do, mask = _inputs(3, 2, s, 16, seed=s + 9)
    mask[2] = 0
    q, k, v, do = _bf16_values(q, k, v, do)
    got = _group_bwd_walk(q, k, v, do, mask)
    want = _jax_group(q, k, v, do, mask, jnp.float32)[1:]
    want16 = _jax_group(q, k, v, do, mask, jnp.bfloat16)[1:]
    for g, w, w16 in zip(got, want, want16):
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= fa.F32_BWD_TOL * np.abs(w).max()
        assert np.abs(_bf16_round(g) - w16).max() <= (
            2.0 ** -7 * np.abs(w16).max())


# --- the C prototypes behind the launchers -----------------------------------

_CSRC = Path(fa.__file__).resolve().parents[1] / "csrc"
_PROTOTYPE = re.compile(r'extern "C" int (\w+)\(([^)]*)\)', re.S)
_CTYPE_CLASS = {ctypes.c_void_p: "pointer", ctypes.c_longlong: "int64",
                ctypes.c_int: "int", ctypes.c_float: "float"}


def _c_class(param):
    """The argument class of one C parameter declaration."""
    if "*" in param:
        return "pointer"
    kind = " ".join(param.split()[:-1])
    return {"long long": "int64", "int": "int", "float": "float"}[kind]


def _prototypes():
    """symbol -> (library, argument classes) of every ``extern "C"``
    function of the port's CUDA sources."""
    out = {}
    for path in sorted(_CSRC.glob("*.cu")):
        for name, params in _PROTOTYPE.findall(path.read_text()):
            out[name] = (path.stem,
                         [_c_class(p) for p in params.split(",") if p.strip()])
    return out


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("kernel", ["_K5", "_K6", "_K7", "_K8"])
def test_attention_launchers_match_their_prototypes(kernel, dtype):
    """The ctypes argument list each attention launcher gives its C
    function (K5-K8, bf16 and f32 instances: ``_FWD_ARGS`` and
    ``_BWD_ARGS``) has the count and the pointer, 64-bit, int and float
    classes of the function's ``extern "C"`` prototype in ``csrc/``, and
    names the library whose source defines it: a list that drifted from
    its prototype would cut pointers or shift every later argument."""
    lib, symbol, args = getattr(fa, kernel).instances[dtype]
    protos = _prototypes()
    assert symbol in protos, f"{symbol} is not in {_CSRC}/*.cu"
    source, classes = protos[symbol]
    assert source == lib
    assert [_CTYPE_CLASS[a] for a in args] == classes
