"""The encoder's LEAD, MASTER and PROD features against the JAX package,
from the same weights: the cross-encoder's attention maps, per-layer
logits and hidden states, ``BertEncoder.embed``, the MLM head (tied and
untied, through ``params_from_jax``) and ``truncate_layers``.

f32 to 2e-5 (summation order; the bound of ``test_torch_models.py``),
bf16 to that file's 0.1 (bf16 roundings through two layers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simxns_tpu.models import CrossEncoder as JaxCrossEncoder
from simxns_tpu.models import CrossEncoderConfig as JaxCrossEncoderConfig
from simxns_tpu.models.bert import BertEncoder as JaxBertEncoder
from simxns_tpu.models.bert import MLMHead as JaxMLMHead
from simxns_tpu.models.bert import truncate_layers as jtruncate
from simxns_tpu_torch.models import (BertEncoder, CrossEncoder,
                                     CrossEncoderConfig, MLMHead,
                                     params_from_jax, truncate_layers)
from torch_parity import crossencoder_pair, jax_bert, port_bert, token_batch
from torch_parity import one_torch_thread  # noqa: F401

N, M, S = 2, 3, 24


@pytest.mark.parametrize("dtype,atol", [(jnp.float32, 2e-5),
                                         (jnp.bfloat16, 0.1)])
@pytest.mark.parametrize("group", [None, M])
def test_cross_encoder_lead_outputs_match_jax(dtype, atol, group):
    """``per_layer_logits`` (the qa_classifier over every layer's CLS:
    [L, N*M] or [L, N, M]), ``hidden_states`` and ``output_attentions``;
    the last layer's logits are the model's logits, and every probability
    row sums to 1 over the unmasked keys."""
    bert = jax_bert(dtype=dtype)
    _, params, plain = crossencoder_pair(bert, seed=51)
    jmodel = JaxCrossEncoder(JaxCrossEncoderConfig(bert=bert,
                                                   per_layer_logits=True))
    port = CrossEncoder(CrossEncoderConfig(bert=port_bert(bert),
                                           per_layer_logits=True))
    port.load_state_dict(plain.state_dict())
    ids, mask = token_batch(np.random.default_rng(52), N * M, S)
    want = jmodel.apply(params, ids, mask, group_size=group,
                        output_attentions=True)
    with torch.no_grad():
        got = port(torch.from_numpy(ids), torch.from_numpy(mask),
                   group_size=group, output_attentions=True)
    assert set(got) == set(want)
    lead = (2, N, M) if group else (2, N * M)
    assert got["per_layer_logits"].shape == lead
    assert torch.equal(got["per_layer_logits"][-1], got["logits"])
    for key in ("logits", "per_layer_logits"):
        np.testing.assert_allclose(got[key].float().numpy(),
                                   np.asarray(want[key], np.float32),
                                   atol=atol, err_msg=key)
    assert len(got["hidden_states"]) == 3 and len(got["attentions"]) == 2
    for key in ("hidden_states", "attentions"):
        for g, w in zip(got[key], want[key]):
            np.testing.assert_allclose(g.float().numpy(),
                                       np.asarray(w, np.float32),
                                       atol=atol, err_msg=key)
    for p in got["attentions"]:
        assert p.shape == (N * M, 4, S, S) and p.dtype == torch.float32
        rows = (p * torch.from_numpy(mask)[:, None, None, :]).sum(-1)
        torch.testing.assert_close(rows, torch.ones_like(rows))


def test_embed_matches_jax():
    """The embedding sublayer alone (MASTER's Condenser input)."""
    cfg = jax_bert(dtype=jnp.float32)
    ids, mask = token_batch(np.random.default_rng(53), 3, 20)
    jenc = JaxBertEncoder(cfg)
    params = jenc.init(jax.random.PRNGKey(54), ids, mask)
    types = (ids % 2).astype(np.int32)
    want = jenc.apply(params, ids, types, method="embed")
    port = BertEncoder(port_bert(cfg))
    port.load_state_dict(params_from_jax(params))
    with torch.no_grad():
        got = port.embed(torch.from_numpy(ids).long(),
                         torch.from_numpy(types).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("dtype,atol", [(jnp.float32, 2e-5),
                                         (jnp.bfloat16, 0.1)])
@pytest.mark.parametrize("tied", [True, False])
def test_mlm_head_matches_jax(tied, dtype, atol):
    """Dense transform, exact GELU, LayerNorm, then the vocab projection:
    tied (against the word table, f32 accumulation, plus ``bias``) or the
    untied ``decoder``. f32 logits, and the gradients of a loss over them
    agree too."""
    cfg = jax_bert(dtype=dtype)
    rng = np.random.default_rng(55)
    hidden = rng.normal(size=(2, 8, 128)).astype(np.float32)
    table = (0.02 * rng.normal(size=(1024, 128))).astype(np.float32)
    shared = jnp.asarray(table) if tied else None
    head = JaxMLMHead(cfg)
    params = head.init(jax.random.PRNGKey(56), hidden, shared)
    params = jax.tree.map(
        lambda x: x + jnp.asarray(0.05 * rng.normal(size=x.shape),
                                  jnp.float32), params)
    want, vjp = jax.vjp(lambda p: head.apply(p, hidden, shared), params)
    port = MLMHead(port_bert(cfg), tied=tied)
    state = params_from_jax(params)
    assert set(state) == set(port.state_dict())
    port.load_state_dict(state)
    got = port(torch.from_numpy(hidden),
               torch.from_numpy(table) if tied else None)
    assert got.dtype == torch.float32 and got.shape == (2, 8, 1024)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol)
    if dtype == jnp.float32:
        cot = rng.normal(size=got.shape).astype(np.float32)
        (jgrads,) = vjp(jnp.asarray(cot))
        got.backward(torch.from_numpy(cot))
        for name, w in params_from_jax(jgrads).items():
            g = dict(port.named_parameters())[name].grad
            scale = float(w.abs().max())
            assert float((g - w).abs().max()) <= 1e-4 * scale, name
    with pytest.raises(ValueError, match="tied"):
        port(torch.from_numpy(hidden), None if tied else
             torch.from_numpy(table))


def test_truncate_layers_matches_jax():
    """The PROD student init: a 4-layer encoder's first 2 layers. JAX's
    ``truncate_layers`` then the conversion equals the port's
    ``truncate_layers`` of the converted 4-layer state_dict, and both load
    into a 2-layer model that encodes like JAX's."""
    deep = jax_bert(dtype=jnp.float32, num_layers=4)
    ids, mask = token_batch(np.random.default_rng(57), 2, 16)
    params = JaxBertEncoder(deep).init(jax.random.PRNGKey(58), ids, mask)
    cut = jtruncate(params["params"], 2)
    assert sorted(cut) == ["embeddings", "layer_0", "layer_1"]
    want = JaxBertEncoder(deep.replace(num_layers=2)).apply(
        {"params": cut}, ids, mask).last_hidden_state

    port_deep = BertEncoder(port_bert(deep))
    port_deep.load_state_dict(params_from_jax(params))
    mine = truncate_layers(port_deep.state_dict(), 2)
    theirs = params_from_jax(cut)
    assert sorted(mine) == sorted(theirs)
    for key, val in theirs.items():
        assert torch.equal(mine[key], val), key
    # nested names too: a CrossEncoder's encoder.layers.{i}
    nested = truncate_layers({"encoder.layers.3.x": 1, "encoder.layers.1.x": 2,
                              "qa_classifier.bias": 3}, 2)
    assert nested == {"encoder.layers.1.x": 2, "qa_classifier.bias": 3}

    student = BertEncoder(port_bert(deep.replace(num_layers=2)))
    student.load_state_dict(mine)
    with torch.no_grad():
        got = student(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(got.last_hidden_state.numpy(),
                               np.asarray(want), atol=2e-5)
