"""The port's Seq2Seq (``simxns_tpu_torch/models/seq2seq.py``) against the
JAX package's on the same weights (f32): the teacher-forcing logits within
1e-5 of the largest |logit| and causal; ``seq2seq_lm_loss`` and one
step's gradients against ``jax.grad`` (every gradient within 1e-5 of its
largest entry; ~1e-7 measured); greedy ``generate`` giving JAX's tokens;
``queries_to_tsv`` byte for byte JAX's."""

import jax
import numpy as np
import pytest
import torch

from simxns_tpu.models import BertConfig as JBertConfig
from simxns_tpu.models import seq2seq as js2s
from simxns_tpu_torch.models import params_from_jax
from simxns_tpu_torch.models import seq2seq as ps2s
from torch_parity import one_torch_thread, port_bert  # noqa: F401

TOL = 1e-5
JCFG = js2s.Seq2SeqConfig(
    bert=JBertConfig.tiny(vocab_size=64, max_position_embeddings=32),
    max_target_length=8, bos_id=1, eos_id=2, pad_id=0)


# flax's init op by op takes ~8 s on the CPU; compiled, ~1 s
_init = jax.jit(js2s.Seq2Seq(JCFG).init)


def _pair(seed=0):
    """(JAX model, JAX params, port model); LayerNorm scales and biases
    jittered off 1 and 0, so a misplaced one shows, and the position
    tables at unit scale, so greedy tokens vary along a row (with the tied
    table at 0.02 each position would predict its own token)."""
    jmodel = js2s.Seq2Seq(JCFG)
    enc = np.ones((2, 6), np.int32) * 5
    dec = np.ones((2, 4), np.int32)
    params = jax.device_get(_init(jax.random.PRNGKey(seed), enc,
                                  np.ones_like(enc), dec, np.ones_like(dec)))
    rng = np.random.default_rng(seed + 100)
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: (
            x + rng.normal(0, 0.1, x.shape).astype(np.float32)
            if path[-1].key in ("scale", "bias") else
            rng.normal(0, 1.0, x.shape).astype(np.float32)
            if path[-2].key in ("enc_pos", "dec_pos") else x), params)
    port = ps2s.Seq2Seq(ps2s.Seq2SeqConfig(
        bert=port_bert(JCFG.bert), max_target_length=8))
    port.load_state_dict(params_from_jax(params))
    return jmodel, params, port.eval()


def _batch(rng):
    enc = rng.integers(3, 64, (3, 6)).astype(np.int32)
    enc_mask = np.ones_like(enc)
    enc_mask[1, 4:] = 0
    dec = rng.integers(3, 64, (3, 5)).astype(np.int32)
    dec_mask = np.ones_like(dec)
    dec_mask[2, 3:] = 0
    return enc, enc_mask, dec, dec_mask


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


def test_forward_matches_jax_and_is_causal():
    jmodel, params, port = _pair()
    enc, enc_mask, dec, dec_mask = _batch(np.random.default_rng(0))
    want = jmodel.apply(params, enc, enc_mask, dec, dec_mask)
    with torch.no_grad():
        got = port(*[torch.from_numpy(x)
                     for x in (enc, enc_mask, dec, dec_mask)])
    assert got.dtype == torch.float32 and got.shape == (3, 5, 64)
    _close(got.numpy(), want)
    # changing tokens after position 2 leaves the logits up to 2
    dec2 = dec.copy()
    dec2[:, 3:] = (dec2[:, 3:] + 7) % 60 + 3
    with torch.no_grad():
        got2 = port(*[torch.from_numpy(x)
                      for x in (enc, enc_mask, dec2, np.ones_like(dec2))])
        got1 = port(*[torch.from_numpy(x)
                      for x in (enc, enc_mask, dec, np.ones_like(dec))])
    np.testing.assert_allclose(got2[:, :3].numpy(), got1[:, :3].numpy(),
                               atol=1e-5)
    assert not np.allclose(got2[:, 4].numpy(), got1[:, 4].numpy())


def test_lm_loss_and_gradients_match_jax():
    jmodel, params, port = _pair(seed=1)
    rng = np.random.default_rng(2)
    enc, enc_mask, dec, dec_mask = _batch(rng)
    labels = rng.integers(0, 64, dec.shape).astype(np.int32)
    lab_mask = dec_mask.copy()
    lab_mask[0, -1] = 0

    def jloss(p):
        logits = jmodel.apply(p, enc, enc_mask, dec, dec_mask)
        return js2s.seq2seq_lm_loss(logits, labels, lab_mask)

    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(params)
    want_grads = params_from_jax(jax.device_get(want_grads))
    logits = port(*[torch.from_numpy(x)
                    for x in (enc, enc_mask, dec, dec_mask)])
    loss = ps2s.seq2seq_lm_loss(logits, torch.from_numpy(labels),
                                torch.from_numpy(lab_mask))
    loss.backward()
    assert abs(float(loss) - float(want_loss)) <= TOL * abs(float(want_loss))
    grads = dict(port.named_parameters())
    assert sorted(grads) == sorted(want_grads)
    for name, want in want_grads.items():
        got = grads[name].grad
        assert got is not None, name
        scale = max(float(want.abs().max()), 1e-12)
        err = float((got - want).abs().max()) / scale
        assert err <= TOL or float((got - want).abs().max()) <= 1e-9, (name,
                                                                       err)
    # the pad-ignoring mean (tests/test_seq2seq.py:54-59)
    z = torch.zeros(2, 3, 5)
    got = ps2s.seq2seq_lm_loss(z, torch.tensor([[1, 2, 0], [3, 0, 0]]),
                               torch.tensor([[1, 1, 0], [1, 0, 0]]))
    assert abs(float(got) - np.log(5)) <= 1e-6


def test_greedy_generate_gives_jax_tokens():
    jmodel, params, port = _pair(seed=3)
    rng = np.random.default_rng(4)
    enc = rng.integers(3, 64, (3, 6)).astype(np.int32)
    enc_mask = np.ones_like(enc)
    enc_mask[2, 4:] = 0
    want = np.asarray(js2s.generate(jmodel, params, enc, enc_mask,
                                    jax.random.PRNGKey(0), top_k=1,
                                    num_return_sequences=2))
    got = ps2s.generate(port, enc, enc_mask, 0, top_k=1,
                        num_return_sequences=2)
    assert got.dtype == torch.int32 and got.shape == (3, 2, 8)
    assert (got[:, :, 0] == 1).all()
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want[:, :, 1:])) > 1
    # sampled: the top-k set, then PAD after EOS
    toks = ps2s.generate(port, enc, enc_mask, 5, top_k=10,
                         num_return_sequences=4, temperature=0.7)
    assert toks.shape == (3, 4, 8) and int(toks.min()) >= 0
    for row in toks.reshape(-1, 8).tolist():
        if 2 in row[1:]:
            assert all(t == 0 for t in row[row.index(2, 1) + 1:])


@pytest.mark.parametrize("queries", [
    [["what is a", "b?"], ["c d", "e  f"]],
    [["  lead and trail  ", "tab\\tinside"], ["x\ny", ""]]])
def test_queries_to_tsv_bytes_equal_jax(tmp_path, queries):
    js2s.queries_to_tsv(str(tmp_path / "jax.tsv"), [0, 17], queries)
    ps2s.queries_to_tsv(str(tmp_path / "port.tsv"), [0, 17], queries)
    assert ((tmp_path / "port.tsv").read_bytes()
            == (tmp_path / "jax.tsv").read_bytes())
