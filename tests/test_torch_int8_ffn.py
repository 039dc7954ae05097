"""The port's int8 encode path (``ffn_impl="int8"``, ``proj_impl="int8"``)
against the JAX package's Pallas kernels in interpret mode.

On the CPU the kernel wrappers K13 ``int8_dense_fwd`` and K14
``int8_ffn_fwd`` run their plain PyTorch versions, so these tests hold the
plain versions (what the CUDA kernels are compared with on the card) to the
TPU kernels ``int8_dense`` / ``int8_ffn``: the quantizers, both kernels at
tiling shapes, the JAX dispatch where the shapes do not tile, a bi-encoder
under ``proj_impl="int8"`` alone, the parameter tree the knobs declare and
the layer's cache of int8 weights. The bi-encoder under ``ffn_impl="int8"``
with and without ``proj_impl="int8"`` is in ``test_torch_models.py``. JAX
weights are [in, out]; the port's are ``nn.Linear`` [out, in].
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simxns_tpu.ops.fused_ffn as ff
from simxns_tpu.models.bert import BertEncoder as JaxBertEncoder
from simxns_tpu_torch.models import BertEncoder, params_from_jax
from simxns_tpu_torch.ops import fused_ffn as pf
from torch_parity import (biencoder_pair, cosine_rows, jax_bert, port_bert,
                          token_batch)
from torch_parity import one_torch_thread  # noqa: F401

_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.fixture(autouse=True)
def _interpret():
    old = ff.INTERPRET
    ff.INTERPRET = True
    yield
    ff.INTERPRET = old


def _inputs(m, i, o, seed):
    """(x [m, i], w1 [i, o], b1 [o], w2 [o, i], b2 [i]) numpy f32, JAX
    layout, at the scales of a BERT layer."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, i), dtype=np.float32),
            rng.normal(0, 0.02, (i, o)).astype(np.float32),
            rng.normal(0, 0.02, (o,)).astype(np.float32),
            rng.normal(0, 0.02, (o, i)).astype(np.float32),
            rng.normal(0, 0.02, (i,)).astype(np.float32))


def _run(kind, x, w1, b1, w2, b2, dt):
    """(port, jax) outputs as numpy f32 for ``kind`` in {ffn, dense}."""
    jx = jnp.asarray(x).astype(_JDT[dt])
    px = torch.from_numpy(x).to(dt)
    t = [torch.from_numpy(a) for a in (w1.T.copy(), b1, w2.T.copy(), b2)]
    if kind == "ffn":
        want = ff.int8_ffn(jx, w1, b1, w2, b2)
        got = pf.ffn(px, *t, "int8")
    else:
        want = ff.int8_dense(jx, w1, b1)
        got = pf.int8_dense(px, t[0], t[1])
    assert got.dtype == dt
    return got.float().numpy(), np.asarray(want, np.float32)


# (m, i, o, dtype): both tile (M a multiple of its token tile, widths of
# the 128 grid), so the JAX side runs its Pallas kernel.
KERNEL_CASES = [(64, 128, 256, torch.float32),
                (256, 256, 512, torch.bfloat16)]


@pytest.mark.parametrize("kind", ["ffn", "dense"])
@pytest.mark.parametrize("m,i,o,dt", KERNEL_CASES)
def test_int8_kernels_match_jax(kind, m, i, o, dt):
    """The plain versions of K13/K14 against the TPU kernels. f32: within
    1e-6 of the largest |y| (measured 1.7e-7: XLA divides by 127 as a
    product with the reciprocal, so a scale may sit one f32 ulp off the
    port's true quotient). bf16: a scale one ulp off can move a code by
    one step, which moves the outputs of its row by up to ``s_x max|w|``;
    every element within one bf16 step of the largest |y| (2^-7 of it;
    measured 0.50% and 0.28%), and at most 3% of elements differ at all
    (measured 0.86% and 0.42%)."""
    assert pf.int8_ffn_tile(m, i, o) and pf.int8_dense_tile(m, i, o)
    got, want = _run(kind, *_inputs(m, i, o, seed=m + i), dt)
    assert got.shape == want.shape == (m, i if kind == "ffn" else o)
    rel = np.abs(got - want).max() / np.abs(want).max()
    if dt == torch.float32:
        assert rel <= 1e-6, rel
    else:
        assert rel <= 2.0 ** -7, rel
        assert (got != want).mean() <= 0.03, (got != want).mean()


@pytest.mark.parametrize("kind,m,o", [("ffn", 40, 256), ("dense", 64, 100)])
def test_int8_knobs_take_the_unquantized_expression_off_the_tiles(kind, m,
                                                                   o):
    """M = 40 is no multiple of int8_ffn's tile (64), O = 100 is off the
    128 grid: both packages return the unquantized bf16 expression
    (``ffn_reference``, the bf16 dense), the port exactly its own. To the
    bf16-path bound of the XLA compositions: the f32 sums run in another
    order and a bf16 rounding may land one step away, 2^-7 of the
    largest |y| (measured: equal)."""
    x, w1, b1, w2, b2 = _inputs(m, 128, o, seed=3)
    dt = torch.bfloat16
    assert (pf.int8_ffn_tile(m, 128, o) if kind == "ffn"
            else pf.int8_dense_tile(m, 128, o)) is None
    got, want = _run(kind, x, w1, b1, w2, b2, dt)
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel <= 2.0 ** -7, rel
    px = torch.from_numpy(x).to(dt)
    t = [torch.from_numpy(a) for a in (w1.T.copy(), b1, w2.T.copy(), b2)]
    exact = (pf.ffn_reference(px, *t) if kind == "ffn"
             else pf.linear_dt(px, t[0], t[1], dt))
    assert np.array_equal(got, exact.float().numpy())


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_quantizers_match_jax(dt):
    """``quant_rows`` against ``_quant_rows`` on activations and
    ``quantize_weight`` against ``quantize_weight`` on an [in, out] kernel
    (per output channel, the port's weight transposed): scales within one
    f32 ulp (XLA's reciprocal product against a true division), codes
    equal but where that ulp moves a rounding, by one step there."""
    x, w, _, _, _ = _inputs(128, 256, 384, seed=5)
    x = torch.from_numpy(x).to(dt).float().numpy()
    for got, want in ((pf.quant_rows(torch.from_numpy(x).to(dt)),
                       ff._quant_rows(jnp.asarray(x).astype(_JDT[dt]))),
                      (pf.quantize_weight(torch.from_numpy(w.T.copy())),
                       [a.T for a in ff.quantize_weight(jnp.asarray(w))])):
        codes, scales = (np.asarray(a) for a in got)
        jcodes, jscales = np.asarray(want[0]), np.asarray(want[1]).ravel()
        assert codes.dtype == jcodes.dtype == np.int8
        np.testing.assert_allclose(scales, jscales, rtol=2.0 ** -23, atol=0)
        diff = np.abs(codes.astype(np.int32) - jcodes)
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


def test_proj_int8_alone_encodes_like_jax():
    """``proj_impl="int8"`` with the bf16 FFN: the port's q, k and v come
    from one int8_dense over [Wq; Wk; Wv], JAX's from three calls, with the
    same codes and scales. 2 x 32 tokens make 64 rows, which tile. To the
    bounds of the int8 knobs in test_torch_models.py (measured 0.0234 and
    a cosine of 0.99998)."""
    jmodel, params, port = biencoder_pair(
        jax_bert(dtype=jnp.bfloat16, proj_impl="int8"), seed=7)
    ids, mask = token_batch(np.random.default_rng(8), 2, 32)
    want = np.asarray(jax.jit(jmodel.apply, static_argnames="method")(
        params, ids, mask, method="encode_passage"), np.float32)
    with torch.no_grad():
        got = port.encode_passage(torch.from_numpy(ids),
                                  torch.from_numpy(mask)).float().numpy()
    assert np.abs(got - want).max() <= 0.05
    assert cosine_rows(got, want).min() >= 0.9999


def test_params_from_jax_converts_a_tree_made_under_the_int8_knobs():
    """JAX's int8 knobs declare the same ``{kernel, bias}`` leaves as
    ``nn.Dense`` (``_KernelBias``), so a tree initialised under them
    converts leaf for leaf onto the port's state_dict, under any knob."""
    cfg = jax_bert(dtype=jnp.float32, ffn_impl="int8", proj_impl="int8")
    ids = np.ones((2, 32), np.int32)
    params = JaxBertEncoder(cfg).init(jax.random.PRNGKey(3), ids, ids)
    plain = JaxBertEncoder(cfg.replace(ffn_impl="xla", proj_impl="xla")).init(
        jax.random.PRNGKey(3), ids, ids)
    assert (jax.tree_util.tree_structure(params)
            == jax.tree_util.tree_structure(plain))
    state = params_from_jax(params)
    port = BertEncoder(port_bert(cfg))
    assert set(state) == set(port.state_dict())
    port.load_state_dict(state)
    for key, val in params_from_jax(plain).items():
        assert val.shape == state[key].shape


def test_int8_weight_cache_requantizes_after_an_in_place_update():
    """The int8 knobs run on the layer's cached int8 weights; an in-place
    update of a parameter changes its version, and the next encode
    quantizes again: it matches a model built fresh from the new
    weights."""
    cfg = port_bert(jax_bert(dtype=jnp.bfloat16, ffn_impl="int8",
                             proj_impl="int8"))
    gen = torch.Generator().manual_seed(0)
    model = BertEncoder(cfg)
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.05, generator=gen)
    ids = torch.from_numpy(token_batch(np.random.default_rng(1), 2, 32)[0])
    layer = model.layers[0]
    with torch.no_grad():
        before = model(ids).last_hidden_state
        cached = layer.quantized()
        model(ids)
        assert layer.quantized() is cached        # no change, no new codes
        layer.intermediate.weight.mul_(-1.5)
        layer.attention.key.weight.add_(0.01)
        after = model(ids).last_hidden_state
        assert layer.quantized() is not cached
        fresh = BertEncoder(cfg)
        fresh.load_state_dict(model.state_dict())
        assert torch.equal(after, fresh(ids).last_hidden_state)
    assert not torch.equal(before, after)


@pytest.mark.parametrize("knob", [dict(ffn_impl="int8"),
                                  dict(proj_impl="int8")])
def test_int8_knobs_refuse_autograd(knob):
    """round() has zero gradient: a knob refuses to run while autograd
    records, and runs under torch.no_grad()."""
    enc = BertEncoder(port_bert(jax_bert(dtype=jnp.float32, **knob)))
    ids = torch.ones(2, 32, dtype=torch.long)
    with pytest.raises(ValueError, match="encode-only"):
        enc(ids)
    with torch.no_grad():
        assert enc(ids).pooled.shape == (2, 128)
