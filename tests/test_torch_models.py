"""The port's BERT encoder and dual encoder vs the JAX models, from the same
weights (converted with ``params_from_jax``)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simxns_tpu.ops.fused_ffn as jffn
import simxns_tpu.ops.fused_layer as jfl
from simxns_tpu.models.bert import BertEncoder as JaxBertEncoder
from simxns_tpu_torch.models import BertConfig, BertEncoder, params_from_jax
from torch_parity import (biencoder_pair, cosine_rows, crossencoder_pair,
                          jax_bert, port_bert, token_batch)
from torch_parity import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _interpret():
    old = jfl.INTERPRET, jffn.INTERPRET
    jfl.INTERPRET = jffn.INTERPRET = True
    yield
    jfl.INTERPRET, jffn.INTERPRET = old


def _encode(jmodel, params, port, method, ids, mask):
    fn = jax.jit(functools.partial(jmodel.apply, method=method))
    want = np.asarray(fn(params, jnp.asarray(ids), jnp.asarray(mask)),
                      np.float32)
    with torch.no_grad():
        got = getattr(port, method)(torch.from_numpy(ids),
                                    torch.from_numpy(mask)).float().numpy()
    return got, want


# (layer_impl, dtype, max |diff| bound, min cosine). f32 XLA: the same
# arithmetic up to summation order. bf16 XLA: both sides round every dense
# output and LayerNorm to bf16 (8 bits), so differences of a few bf16 ulps
# propagate through two layers. fused_int8: the int8 path matches the JAX
# kernel to one bf16 ulp per layer (test_torch_fused_layer.py), two layers.
CASES = [("xla", jnp.float32, 2e-5, 0.999999),
         ("xla", jnp.bfloat16, 0.1, 0.999),
         ("fused_int8", jnp.bfloat16, 0.1, 0.999),
         ("fused_int8", jnp.float32, 5e-3, 0.99999)]


@pytest.mark.parametrize("impl,dtype,atol,min_cos", CASES)
def test_biencoder_matches_jax(impl, dtype, atol, min_cos):
    """encode_query (S=16) and encode_passage (S=32) through separate
    towers, CLS pooling, padded tails."""
    jmodel, params, port = biencoder_pair(
        jax_bert(layer_impl=impl, dtype=dtype), seed=1)
    rng = np.random.default_rng(2)
    for method, s in (("encode_query", 16), ("encode_passage", 32)):
        ids, mask = token_batch(rng, 4, s)
        got, want = _encode(jmodel, params, port, method, ids, mask)
        assert got.shape == want.shape == (4, 128)
        assert np.abs(got - want).max() <= atol, (method,
                                                  np.abs(got - want).max())
        assert cosine_rows(got, want).min() >= min_cos


@pytest.mark.parametrize("share", [False, True])
def test_mean_pooling_and_projection_head(share):
    """Mean pooling over the mask, the RobertaDot head (Dense + LayerNorm),
    and a shared tower (only question_model in the tree): f32 to 2e-5."""
    jmodel, params, port = biencoder_pair(
        jax_bert(dtype=jnp.float32), seed=3, pooling="mean",
        projection_dim=96,
        share_weight=share)
    assert hasattr(port, "ctx_model") != share
    rng = np.random.default_rng(4)
    ids, mask = token_batch(rng, 3, 24)
    for method in ("encode_query", "encode_passage"):
        got, want = _encode(jmodel, params, port, method, ids, mask)
        assert got.shape == (3, 96)
        np.testing.assert_allclose(got, want, atol=2e-5)


def test_encoder_hidden_states_match_jax():
    """A bare BertEncoder tree converts too; every layer's output agrees in
    f32 (2e-5) and the pooled vector is the CLS row."""
    cfg = jax_bert(dtype=jnp.float32)
    jenc = JaxBertEncoder(cfg)
    rng = np.random.default_rng(5)
    ids, mask = token_batch(rng, 2, 20)
    params = jenc.init(jax.random.PRNGKey(6), ids, mask)
    out = jenc.apply(params, ids, mask, output_hidden_states=True)
    port = BertEncoder(port_bert(cfg))
    port.load_state_dict(params_from_jax(params))
    with torch.no_grad():
        got = port(torch.from_numpy(ids), torch.from_numpy(mask),
                   output_hidden_states=True)
    assert len(got.hidden_states) == 3
    for g, w in zip(got.hidden_states, out.hidden_states):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5)
    assert torch.equal(got.pooled, got.last_hidden_state[:, 0])


@pytest.mark.parametrize("knob", ["fused", "fused_vjp"])
def test_ported_ffn_knobs_encode_like_jax(knob):
    """The FFN knobs whose kernels are ported (K9-K12; their plain versions
    for CPU tensors) through a bi-encoder in bf16: 2 x 32 passage tokens
    make 64 rows, which tile, so the JAX side runs its Pallas kernel in
    interpret mode. To the bf16-path bounds above."""
    jmodel, params, port = biencoder_pair(
        jax_bert(dtype=jnp.bfloat16, ffn_impl=knob), seed=7)
    rng = np.random.default_rng(8)
    ids, mask = token_batch(rng, 2, 32)
    got, want = _encode(jmodel, params, port, "encode_passage", ids, mask)
    assert np.abs(got - want).max() <= 0.1
    assert cosine_rows(got, want).min() >= 0.999


@pytest.mark.parametrize("knob", [dict(ffn_impl="int8"),
                                  dict(ffn_impl="int8", proj_impl="int8")])
def test_int8_knobs_encode_like_jax(knob):
    """The int8 encode knobs (K14, and K13 for q, k, v as one call and the
    output projection; their plain versions for CPU tensors) through a
    bi-encoder in bf16: 2 x 32 passage tokens make 64 rows, which tile, so
    the JAX side runs its Pallas kernels in interpret mode. A code one step
    off (a scale one f32 ulp off, tests/test_torch_int8_ffn.py) moves its
    row by far less than the bf16 path's own roundings: within 0.05 and a
    cosine of 0.9999 (measured 0.0234 and 0.99998 under both)."""
    jmodel, params, port = biencoder_pair(
        jax_bert(dtype=jnp.bfloat16, **knob), seed=7)
    rng = np.random.default_rng(8)
    ids, mask = token_batch(rng, 2, 32)
    got, want = _encode(jmodel, params, port, "encode_passage", ids, mask)
    assert np.abs(got - want).max() <= 0.05
    assert cosine_rows(got, want).min() >= 0.9999


@pytest.mark.parametrize("dtype,atol", [(jnp.float32, 2e-5),
                                         (jnp.bfloat16, 0.1)])
def test_cross_encoder_matches_jax(dtype, atol):
    """A CrossEncoder tree converts leaf for leaf (the [H, 1] and [H, 2]
    head kernels to nn.Linear weights); the grouped rank logits and the
    binary logits agree to the bounds of the bi-encoder cases above."""
    jmodel, params, port = crossencoder_pair(jax_bert(dtype=dtype), seed=9,
                                             binary_head=True)
    state = params_from_jax(params)
    assert set(state) == set(port.state_dict())
    assert state["qa_classifier.weight"].shape == (1, 128)
    assert state["binary_classifier.weight"].shape == (2, 128)
    rng = np.random.default_rng(10)
    ids, mask = token_batch(rng, 6, 20)
    want = jmodel.apply(params, ids, mask, group_size=3)
    with torch.no_grad():
        got = port(torch.from_numpy(ids), torch.from_numpy(mask),
                   group_size=3)
        flat = port(torch.from_numpy(ids), torch.from_numpy(mask))
    for key, shape in (("logits", (2, 3)), ("binary_logits", (2, 3, 2))):
        g = got[key].float().numpy()
        assert g.shape == shape
        assert np.abs(g - np.asarray(want[key], np.float32)).max() <= atol
    assert torch.equal(flat["logits"], got["logits"].flatten())
    assert flat["binary_logits"].shape == (6, 2)


def test_config_guards():
    with pytest.raises(ValueError, match="tanh"):
        BertConfig(gelu="tanh", layer_impl="fused_int8")
    with pytest.raises(ValueError, match="layer_impl"):
        BertConfig(layer_impl="fused")
    enc = BertEncoder(BertConfig.tiny(hidden_size=128, layer_impl="fused_int8"))
    ids = torch.ones(1, 8, dtype=torch.long)
    with pytest.raises(ValueError, match="encode-only"):
        enc(ids)                   # autograd recording through int8
    with torch.no_grad():
        assert enc(ids).pooled.shape == (1, 128)
