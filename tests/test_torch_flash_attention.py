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
