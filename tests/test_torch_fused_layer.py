"""The port's int8 encoder layer (plain versions of K1-K3) vs the JAX kernel.

The JAX side runs ``simxns_tpu.ops.fused_layer`` under the Pallas
interpreter, as tests/test_fused_layer.py does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simxns_tpu.ops.fused_layer as jfl
from simxns_tpu.ops.fused_ffn import _quant_rows as jax_quant_rows
from simxns_tpu.ops.fused_ffn import _gelu_exact as jax_gelu_exact
from simxns_tpu_torch.ops import fused_layer as tfl
from simxns_tpu_torch.ops.fused_ffn import gelu_exact, quant_rows
from torch_parity import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _interpret():
    old = jfl.INTERPRET
    jfl.INTERPRET = True
    yield
    jfl.INTERPRET = old


def _params(h=128, f=256, seed=0):
    rng = np.random.default_rng(seed)

    def w(*shape):
        return rng.normal(0, 0.02, shape).astype(np.float32)

    return {"wq": w(h, h), "bq": w(h), "wk": w(h, h), "bk": w(h),
            "wv": w(h, h), "bv": w(h), "wo": w(h, h), "bo": w(h),
            "ln1_scale": 1 + w(h), "ln1_bias": w(h),
            "w1": w(h, f), "b1": w(f), "w2": w(f, h), "b2": w(h),
            "ln2_scale": 1 + w(h), "ln2_bias": w(h)}


def _port_params(p):
    """flax [in, out] kernels -> nn.Linear [out, in]."""
    return {k: torch.from_numpy(v.T.copy() if v.ndim == 2 else v.copy())
            for k, v in p.items()}


def _inputs(dtype, seed=1, b=4, s=16, h=128):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h)).astype(np.float32)
    if dtype == "bf16":
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    mask = np.ones((b, s), np.int32)
    mask[1, 10:] = 0           # a hidden tail
    mask[3, 5:] = 0
    return x, mask


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_layer_matches_jax_kernel(dtype):
    """h=128, f=256, s=16, b=4, 4 heads, masked tails. Tolerance: the two
    sides round the same values, but f32 sums in another order can flip an
    int8 code, which moves an output by about one quantization step; the
    measured effect is one bf16 ulp (2^-7 at |y| in [1, 2)) on ~1% of the
    bf16 outputs and 1.6e-4 on f32 outputs. So: max |diff| <= 2 bf16 ulps
    (2^-6) / 1e-3 in f32, a mean |diff| 100x below the int8 step, and in
    bf16 at most 2% of the outputs off by their rounding."""
    p = _params()
    x, mask = _inputs(dtype)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    want = np.asarray(jfl.fused_encoder_layer_int8(
        jnp.asarray(x, jdt), jnp.asarray(mask),
        {k: jnp.asarray(v) for k, v in p.items()}, num_heads=4), np.float32)
    got = tfl.fused_encoder_layer_int8(
        torch.from_numpy(x).to(tdt), torch.from_numpy(mask),
        _port_params(p), num_heads=4)
    assert got.dtype == tdt and got.shape == (4, 16, 128)
    diff = np.abs(got.float().numpy() - want)
    assert diff.max() <= (2.0 ** -6 if dtype == "bf16" else 1e-3), diff.max()
    assert diff.mean() <= 1e-4, diff.mean()
    if dtype == "bf16":
        assert (diff > 0).mean() <= 0.02, (diff > 0).mean()


def test_layer_plain_near_unquantized_reference():
    """The quantized layer against the f32 layer it approximates: int8
    weights and activations keep every row nearly parallel (cosine > 0.999,
    the bound tests/test_fused_layer.py sets for the JAX kernel) and the
    composed plain path equals the wrappers' CPU path exactly."""
    p = _port_params(_params(seed=3))
    x, mask = _inputs("f32", seed=4)
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    ql = tfl.quantize_layer(p)
    plain = tfl.layer_int8_plain(xt, mt, ql, num_heads=4)
    wrapped = tfl.fused_encoder_layer_int8(xt, mt, quantized=ql, num_heads=4)
    assert torch.equal(plain, wrapped)
    ref = tfl.layer_reference(xt, mt, p, num_heads=4)
    a, b = plain.reshape(-1, 128).numpy(), ref.reshape(-1, 128).numpy()
    cos = (a * b).sum(1) / (np.linalg.norm(a, axis=1)
                            * np.linalg.norm(b, axis=1))
    assert cos.min() > 0.999, cos.min()


def test_layer_reference_matches_jax_reference():
    """Unquantized f32 layers agree to f32 rounding (1e-5 absolute on
    LayerNorm outputs of unit scale)."""
    p = _params(seed=5)
    x, mask = _inputs("f32", seed=6)
    want = np.asarray(jfl.layer_reference(
        jnp.asarray(x), jnp.asarray(mask),
        {k: jnp.asarray(v) for k, v in p.items()}, num_heads=4))
    got = tfl.layer_reference(torch.from_numpy(x), torch.from_numpy(mask),
                              _port_params(p), num_heads=4).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_row_quant_and_gelu_match_jax():
    """Per-token quantization gives identical codes and scales; the A&S
    GELU agrees to f32 rounding (2e-7 relative)."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((64, 96)).astype(np.float32) * 3
    x[5] = 0.0                                   # the 1e-12 scale floor
    jq, js = jax_quant_rows(jnp.asarray(x))
    tq, ts = quant_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js)[:, 0])
    np.testing.assert_allclose(gelu_exact(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_gelu_exact(jnp.asarray(x))),
                               rtol=2e-7, atol=1e-7)
    codes, scales, y32, y16 = tfl.row_quant(
        torch.from_numpy(x), residual=torch.ones(64, 96),
        ln=(torch.ones(96), torch.zeros(96)), out_f32=True, out_bf16=True)
    assert codes.dtype == torch.int8 and scales.shape == (64,)
    assert torch.equal(y16, y32.to(torch.bfloat16))


def test_int8_linear_plain_exact_accumulator():
    """K=3072 int8 rows (sums past 2^24) dequantize like the JAX int32
    accumulator: (acc * xs) * ws + b, bit for bit."""
    rng = np.random.default_rng(8)
    a = rng.integers(-127, 128, (8, 3072)).astype(np.int8)
    w = rng.integers(-127, 128, (16, 3072)).astype(np.int8)
    a[0] = 127
    w[0] = 127
    xs = rng.random(8).astype(np.float32)
    ws = rng.random(16).astype(np.float32)
    b = rng.random(16).astype(np.float32)
    acc = jnp.dot(jnp.asarray(a), jnp.asarray(w).T,
                  preferred_element_type=jnp.int32)
    want = np.asarray(acc.astype(jnp.float32) * jnp.asarray(xs)[:, None]
                      * jnp.asarray(ws) + jnp.asarray(b))
    got = tfl.int8_linear(*(torch.from_numpy(t) for t in (a, xs, w, ws, b)))
    np.testing.assert_array_equal(got.numpy(), want)
