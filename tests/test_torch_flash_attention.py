"""The attention pairs of the port (grouped K5/K6, per-(batch, head) K7/K8)
and the flash dispatch against the JAX Pallas kernels, run in interpret
mode.

On the CPU the port's wrappers run their plain versions, which keep p in
f32 as the Pallas kernels do (``_fused_attention_group``); JAX's
``flash_attention`` off the TPU returns the XLA composition instead unless
``INTERPRET`` is set, so the fixture sets it.
"""

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


# --- the algorithm of the one-pass forward kernels (K5, K7) ------------------

# K5's key tiles (csrc/group_attention.cu kGroupKeys); K7's are 64 keys
GROUP_KEYS = 32


def _tiled_fwd_model(q, k, v, mask, tile):
    """The one-pass walk of K5 and K7 (attention_ring.cuh's
    attend_one_pass) over key tiles of ``tile`` rows, in f32 PyTorch:
    scores in the log2 domain (scale * log2(e)), -1e9 log2(e) for a masked
    key and -inf past S in the last tile; each row keeps a running max and
    a sum of 2^(s - max), both the sum and the output accumulator rescaled
    by 2^(max_old - max_new) when the max grows; one reciprocal of the sum
    a row at the end. -> o as a numpy array."""
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
