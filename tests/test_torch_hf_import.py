"""The port's HF importers (``simxns_tpu_torch.models.hf_import``) against
the JAX package's (``simxns_tpu.models.hf_import``), case for case with
``tests/test_hf_import.py``.

Every HF model is a random-init ``transformers`` model (seed 0). Each
converted state_dict must equal ``params_from_jax`` of the JAX converter's
tree bit for bit (the same f32 numbers, ``nn.Linear``'s layout), and the
port's encoder must reproduce the HF model's hidden states within the JAX
test's tolerance (atol 2e-4, rtol 2e-3; the MLM logits 5e-4 / 5e-3): both
run f32 on the CPU, so they differ by the order of f32 sums.
"""

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from simxns_tpu.models import hf_import as jhf
from simxns_tpu_torch.models import (BertConfig, BertEncoder, BiEncoder,
                                     BiEncoderConfig, MLMHead,
                                     params_from_jax)
from simxns_tpu_torch.models import hf_import as hf_import
from tests.torch_parity import one_torch_thread  # noqa: F401

ATOL, RTOL = 2e-4, 2e-3


def _bitwise(port_sd, jax_tree):
    """The port's converted state_dict is params_from_jax(JAX's tree)."""
    want = params_from_jax(jax_tree)
    assert sorted(port_sd) == sorted(want)
    for k, v in want.items():
        assert port_sd[k].dtype == torch.float32, k
        assert torch.equal(port_sd[k], v), k


def _hf_bert(num_layers=2, mlm=False):
    cfg = transformers.BertConfig(
        vocab_size=500, hidden_size=64, num_hidden_layers=num_layers,
        num_attention_heads=4, intermediate_size=128,
        max_position_embeddings=64, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0)
    torch.manual_seed(0)
    cls = transformers.BertForMaskedLM if mlm else transformers.BertModel
    return cls(cfg).eval(), cfg


def _port_cfg(hf_cfg, num_layers=None, **kw):
    base = dict(
        vocab_size=hf_cfg.vocab_size, hidden_size=hf_cfg.hidden_size,
        num_layers=num_layers or hf_cfg.num_hidden_layers,
        num_heads=hf_cfg.num_attention_heads,
        intermediate_size=hf_cfg.intermediate_size,
        max_position_embeddings=hf_cfg.max_position_embeddings,
        hidden_dropout=0.0, attention_dropout=0.0, dtype=torch.float32)
    base.update(kw)
    return BertConfig(**base)


def _encode(cfg, sd, ids, mask):
    enc = BertEncoder(cfg)
    enc.load_state_dict(sd)
    with torch.no_grad():
        return enc(torch.tensor(ids), torch.tensor(mask)
                   ).last_hidden_state.numpy()


def test_encoder_matches_torch():
    hf, hf_cfg = _hf_bert()
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 500, size=(3, 16)).astype(np.int64)
    mask = np.ones_like(ids)
    mask[:, 12:] = 0
    with torch.no_grad():
        want = hf(input_ids=torch.tensor(ids),
                  attention_mask=torch.tensor(mask)).last_hidden_state.numpy()
    sd, mlm = hf_import.convert_hf_bert(hf.state_dict())
    jparams, jmlm = jhf.convert_hf_bert(hf.state_dict())
    assert mlm is None and jmlm is None
    _bitwise(sd, jparams)
    got = _encode(_port_cfg(hf_cfg), sd, ids, mask)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_truncated_import():
    hf, hf_cfg = _hf_bert(num_layers=4)
    sd, _ = hf_import.convert_hf_bert(hf.state_dict(), num_layers=2)
    _bitwise(sd, jhf.convert_hf_bert(hf.state_dict(), num_layers=2)[0])
    assert any(k.startswith("layers.1.") for k in sd)
    assert not any(k.startswith("layers.2.") for k in sd)
    enc = BertEncoder(_port_cfg(hf_cfg, num_layers=2))
    enc.load_state_dict(sd)
    ids = torch.ones(1, 8, dtype=torch.long)
    assert enc(ids, torch.ones_like(ids)).pooled.shape == (1, 64)


def test_mlm_head_import_matches_torch():
    hf, hf_cfg = _hf_bert(mlm=True)
    rng = np.random.default_rng(1)
    ids = rng.integers(1, 500, size=(2, 12)).astype(np.int64)
    mask = np.ones_like(ids)
    with torch.no_grad():
        want = hf(input_ids=torch.tensor(ids),
                  attention_mask=torch.tensor(mask)).logits.numpy()
    sd, mlm = hf_import.convert_hf_bert(hf.state_dict())
    jparams, jmlm = jhf.convert_hf_bert(hf.state_dict())
    _bitwise(sd, jparams)
    _bitwise(mlm, jmlm)
    cfg = _port_cfg(hf_cfg)
    hidden = torch.from_numpy(_encode(cfg, sd, ids, mask))
    head = MLMHead(cfg)
    head.load_state_dict(mlm)
    with torch.no_grad():
        logits = head(hidden, sd["embeddings.word_embeddings.weight"])
    np.testing.assert_allclose(logits.numpy(), want, atol=5e-4, rtol=5e-3)


def test_biencoder_wrapping():
    hf, hf_cfg = _hf_bert()
    sd, _ = hf_import.convert_hf_bert(hf.state_dict())
    tree = hf_import.as_biencoder_params(sd, share_weight=False)
    _bitwise(tree, jhf.as_biencoder_params(
        jhf.convert_hf_bert(hf.state_dict())[0], share_weight=False))
    model = BiEncoder(BiEncoderConfig(bert=_port_cfg(hf_cfg)))
    model.load_state_dict(tree)
    ids = torch.ones(2, 8, dtype=torch.long)
    with torch.no_grad():
        q, c = model(ids, torch.ones_like(ids), ids, torch.ones_like(ids))
    np.testing.assert_allclose(q.numpy(), c.numpy(), atol=1e-6)
    shared = hf_import.as_biencoder_params(sd, share_weight=True)
    assert not any(k.startswith("ctx_model.") for k in shared)


def test_roberta_matches_torch():
    """The RobertaDot warm start: the converted encoder with
    position_style="roberta" reproduces RobertaModel at non-pad rows."""
    cfg = transformers.RobertaConfig(
        vocab_size=500, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=128,
        max_position_embeddings=66, type_vocab_size=1, pad_token_id=1,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    torch.manual_seed(0)
    hf = transformers.RobertaModel(cfg, add_pooling_layer=False).eval()
    rng = np.random.default_rng(0)
    ids = rng.integers(2, 500, size=(3, 16)).astype(np.int64)
    ids[:, 13:] = 1
    mask = (ids != 1).astype(np.int64)
    with torch.no_grad():
        want = hf(input_ids=torch.tensor(ids),
                  attention_mask=torch.tensor(mask)).last_hidden_state.numpy()
    sd, mlm = hf_import.convert_hf_roberta(hf.state_dict())
    assert mlm is None
    _bitwise(sd, jhf.convert_hf_roberta(hf.state_dict())[0])
    ours = hf_import.config_from_hf_params(sd, "roberta", BertConfig(
        num_heads=4, hidden_dropout=0.0, attention_dropout=0.0,
        dtype=torch.float32))
    assert (ours.position_style, ours.pad_token_id, ours.type_vocab_size,
            ours.max_position_embeddings) == ("roberta", 1, 1, 66)
    got = _encode(ours, sd, ids, mask)
    np.testing.assert_allclose(got[:, :13], want[:, :13], atol=ATOL,
                               rtol=RTOL)


def test_roberta_mlm_head_is_bitwise():
    cfg = transformers.RobertaConfig(
        vocab_size=200, hidden_size=32, num_hidden_layers=1,
        num_attention_heads=2, intermediate_size=64,
        max_position_embeddings=40, type_vocab_size=1, pad_token_id=1)
    torch.manual_seed(0)
    sd = transformers.RobertaForMaskedLM(cfg).state_dict()
    enc, mlm = hf_import.convert_hf_roberta(sd)
    jenc, jmlm = jhf.convert_hf_roberta(sd)
    _bitwise(enc, jenc)
    _bitwise(mlm, jmlm)
    assert hf_import.sniff_hf_family(sd) == "roberta"


def test_robertadot_projection_head():
    h = 8
    gen = torch.Generator().manual_seed(0)
    sd = {"embeddingHead.weight": torch.randn(h, h, generator=gen),
          "embeddingHead.bias": torch.randn(h, generator=gen),
          "norm.weight": torch.ones(h), "norm.bias": torch.zeros(h)}
    proj = hf_import.robertadot_projection(sd)
    _bitwise(proj, jhf.robertadot_projection(sd))
    assert proj["project.weight"].shape == (h, h)
    assert torch.equal(proj["project.weight"], sd["embeddingHead.weight"])
    assert hf_import.robertadot_projection({}) is None


def test_electra_matches_torch():
    """The MASTER reranker's warm start: the discriminator encoder with the
    small variant's embeddings_project reproduces ElectraModel."""
    cfg = transformers.ElectraConfig(
        vocab_size=500, embedding_size=32, hidden_size=64,
        num_hidden_layers=2, num_attention_heads=4, intermediate_size=128,
        max_position_embeddings=64, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0)
    torch.manual_seed(0)
    hf = transformers.ElectraModel(cfg).eval()
    rng = np.random.default_rng(2)
    ids = rng.integers(1, 500, size=(2, 12)).astype(np.int64)
    mask = np.ones_like(ids)
    mask[:, 10:] = 0
    with torch.no_grad():
        want = hf(input_ids=torch.tensor(ids),
                  attention_mask=torch.tensor(mask)).last_hidden_state.numpy()
    sd, mlm = hf_import.convert_hf_electra(hf.state_dict())
    assert mlm is None and "embeddings.embeddings_project.weight" in sd
    _bitwise(sd, jhf.convert_hf_electra(hf.state_dict())[0])
    ours = hf_import.config_from_hf_params(sd, "electra", BertConfig(
        num_heads=4, hidden_dropout=0.0, attention_dropout=0.0,
        dtype=torch.float32))
    assert (ours.embedding_size, ours.hidden_size) == (32, 64)
    got = _encode(ours, sd, ids, mask)
    np.testing.assert_allclose(got[:, :10], want[:, :10], atol=ATOL,
                               rtol=RTOL)


def test_distilbert_matches_torch():
    """The LEAD student's warm start: q/k/v/out_lin, sa_layer_norm and ffn
    reproduce DistilBertModel (no token types)."""
    cfg = transformers.DistilBertConfig(
        vocab_size=500, dim=64, n_layers=2, n_heads=4, hidden_dim=128,
        max_position_embeddings=64, dropout=0.0, attention_dropout=0.0)
    torch.manual_seed(0)
    hf = transformers.DistilBertModel(cfg).eval()
    rng = np.random.default_rng(3)
    ids = rng.integers(1, 500, size=(3, 16)).astype(np.int64)
    mask = np.ones_like(ids)
    mask[:, 14:] = 0
    with torch.no_grad():
        want = hf(input_ids=torch.tensor(ids),
                  attention_mask=torch.tensor(mask)).last_hidden_state.numpy()
    sd, _ = hf_import.convert_hf_distilbert(hf.state_dict())
    assert "embeddings.token_type_embeddings.weight" not in sd
    _bitwise(sd, jhf.convert_hf_distilbert(hf.state_dict())[0])
    ours = hf_import.config_from_hf_params(sd, "distilbert", BertConfig(
        num_heads=4, hidden_dropout=0.0, attention_dropout=0.0,
        dtype=torch.float32))
    assert ours.type_vocab_size == 0 and ours.num_layers == 2
    got = _encode(ours, sd, ids, mask)
    np.testing.assert_allclose(got[:, :14], want[:, :14], atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("keys,family", [
    (["roberta.embeddings.word_embeddings.weight"], "roberta"),
    (["electra.embeddings.word_embeddings.weight"], "electra"),
    (["distilbert.embeddings.word_embeddings.weight"], "distilbert"),
    (["transformer.layer.0.attention.q_lin.weight"], "distilbert"),
    (["embeddings.word_embeddings.weight", "lm_head.layer_norm.weight"],
     "roberta"),
    (["bert.embeddings.word_embeddings.weight"], "bert"),
    (["encoder.block.0.layer.0.SelfAttention.q.weight"], "t5")])
def test_family_sniffing(keys, family):
    sd = dict.fromkeys(keys, 0)
    assert hf_import.sniff_hf_family(sd) == jhf.sniff_hf_family(sd) == family


def test_auto_refuses_t5_with_jax_message():
    sd = {"encoder.block.0.layer.0.SelfAttention.q.weight": torch.zeros(2, 2)}
    with pytest.raises(ValueError) as port:
        hf_import.convert_hf_auto(sd)
    with pytest.raises(ValueError) as jax_err:
        jhf.convert_hf_auto(sd)
    assert str(port.value) == str(jax_err.value)


def test_auto_dispatch_and_config_match_jax():
    """convert_hf_auto and config_from_hf_params on a BERT MLM artifact:
    the same family, the same numbers, the same config fields as JAX's."""
    hf, hf_cfg = _hf_bert(mlm=True)
    family, sd, mlm = hf_import.convert_hf_auto(hf.state_dict())
    jfamily, jparams, jmlm = jhf.convert_hf_auto(hf.state_dict())
    assert family == jfamily == "bert"
    _bitwise(sd, jparams)
    _bitwise(mlm, jmlm)
    ours = hf_import.config_from_hf_params(sd, family)
    want = jhf.config_from_hf_params(jparams, jfamily)
    for f in ("vocab_size", "hidden_size", "embedding_size", "num_layers",
              "intermediate_size", "max_position_embeddings",
              "type_vocab_size", "position_style", "pad_token_id"):
        assert getattr(ours, f) == getattr(want, f), f


def test_truncated_distilbert_and_electra():
    """num_layers cuts every family's converter."""
    cfg = transformers.DistilBertConfig(
        vocab_size=128, dim=32, n_layers=4, n_heads=2, hidden_dim=64,
        max_position_embeddings=64, dropout=0.0, attention_dropout=0.0)
    torch.manual_seed(0)
    sd = transformers.DistilBertModel(cfg).state_dict()
    params, _ = hf_import.convert_hf_distilbert(sd, num_layers=2)
    _bitwise(params, jhf.convert_hf_distilbert(sd, num_layers=2)[0])
    assert hf_import.config_from_hf_params(params, "distilbert"
                                           ).num_layers == 2
    ecfg = transformers.ElectraConfig(
        vocab_size=128, embedding_size=32, hidden_size=32,
        num_hidden_layers=4, num_attention_heads=2, intermediate_size=64,
        max_position_embeddings=64)
    esd = transformers.ElectraModel(ecfg).state_dict()
    eparams, _ = hf_import.convert_hf_electra(esd, num_layers=2)
    _bitwise(eparams, jhf.convert_hf_electra(esd, num_layers=2)[0])
    assert not any(k.startswith("layers.2.") for k in eparams)


def test_gamma_beta_and_prefixed_mlm_import(tmp_path):
    """Original-format checkpoints (LayerNorm gamma/beta), and an explicit
    prefix="bert." still finds the cls.predictions.* head outside it; the
    same from a pytorch_model.bin through load_hf_bert_encoder."""
    hf, hf_cfg = _hf_bert()
    old = {}
    for k, v in hf.state_dict().items():
        old["bert." + k.replace("LayerNorm.weight", "LayerNorm.gamma")
            .replace("LayerNorm.bias", "LayerNorm.beta")] = v
    h, v = hf_cfg.hidden_size, hf_cfg.vocab_size
    old["cls.predictions.transform.dense.weight"] = torch.zeros(h, h)
    old["cls.predictions.transform.dense.bias"] = torch.zeros(h)
    old["cls.predictions.transform.LayerNorm.gamma"] = torch.ones(h)
    old["cls.predictions.transform.LayerNorm.beta"] = torch.zeros(h)
    old["cls.predictions.bias"] = torch.zeros(v)
    sd, mlm = hf_import.convert_hf_bert(old, prefix="bert.")
    jparams, jmlm = jhf.convert_hf_bert(old, prefix="bert.")
    assert mlm is not None and mlm["bias"].shape == (v,)
    _bitwise(sd, jparams)
    _bitwise(mlm, jmlm)
    ref, _ = hf_import.convert_hf_bert(hf.state_dict())
    assert torch.equal(sd["embeddings.layer_norm.weight"],
                       ref["embeddings.layer_norm.weight"])
    path = tmp_path / "pytorch_model.bin"
    torch.save(hf.state_dict(), path)
    loaded, _ = hf_import.load_hf_bert_encoder(str(path))
    assert sorted(loaded) == sorted(ref)
    assert all(torch.equal(loaded[k], ref[k]) for k in ref)
