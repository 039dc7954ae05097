"""The port's T5 (``simxns_tpu_torch/models/t5.py``) and its importers
against the JAX package's T5 and ``transformers``' on random weights:
the relative-position buckets bitwise; the teacher-forcing logits, tied
and untied, within 1e-5 of the largest |logit| of JAX's on the same
parameters (f32; the two differ by summation order, ~3e-7 measured) and
of HF's through ``convert_hf_t5``; the converter bitwise
``params_from_jax`` of JAX's; greedy generation giving JAX's tokens; the
sampling contract; the incremental decoder's step logits within 1e-5 of
the re-run decoder's; ``doc2query_tsv`` at ``top_k=1`` byte for byte
JAX's TSV."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simxns_tpu.models import hf_import as jhf
from simxns_tpu.models import t5 as jt5
from simxns_tpu_torch.models import hf_import as phf
from simxns_tpu_torch.models import params_from_jax
from simxns_tpu_torch.models import t5 as pt5
from torch_parity import one_torch_thread  # noqa: F401

TOL = 1e-5
SMALL = dict(vocab_size=128, d_model=32, d_kv=8, d_ff=64, num_layers=2,
             num_heads=4, relative_attention_num_buckets=8,
             relative_attention_max_distance=16, dropout_rate=0.0)


def _pair(tie=True, seed=0, **kw):
    """(JAX model, JAX params, port model) on the same weights; the RMS
    scales jittered off 1, so a misplaced one shows."""
    fields = dict(SMALL, tie_word_embeddings=tie, **kw)
    jmodel = jt5.T5(jt5.T5Config(**fields))
    ones = np.ones((1, 8), np.int32)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(seed), ones, ones,
                                        ones[:, :4], ones[:, :4]))
    rng = np.random.default_rng(seed + 100)
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: (x * rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
                         if path[-1].key == "weight" else x), params)
    port = pt5.T5(pt5.T5Config(**fields))
    port.load_state_dict(params_from_jax(params))
    return jmodel, params, port.eval()


def _batch(rng, b=3, s=12, t=7, vocab=128):
    enc = rng.integers(2, vocab, (b, s)).astype(np.int32)
    enc_mask = np.ones_like(enc)
    enc_mask[:, 9:] = 0
    enc_mask[1, 5:] = 0
    dec = rng.integers(2, vocab, (b, t)).astype(np.int32)
    dec[:, 0] = 0                               # decoding starts from PAD
    dec_mask = np.ones_like(dec)
    dec_mask[2, 5:] = 0
    return enc, enc_mask, dec, dec_mask


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


@pytest.mark.parametrize("buckets,max_distance", [(8, 16), (16, 16),
                                                  (32, 128), (8, 128)])
@pytest.mark.parametrize("bidirectional", [True, False])
def test_relative_position_bucket_bitwise(buckets, max_distance,
                                          bidirectional):
    """Every relative position in -1024..1024 (the edges of the
    log-spaced buckets fall where an f64 log would move them)."""
    rp = np.arange(-1024, 1025, dtype=np.int32)
    want = np.asarray(jt5.relative_position_bucket(
        jnp.asarray(rp), bidirectional, buckets, max_distance))
    got = pt5.relative_position_bucket(torch.from_numpy(rp), bidirectional,
                                       buckets, max_distance)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("tie", [True, False])
def test_encode_decode_match_jax(tie):
    jmodel, params, port = _pair(tie=tie)
    enc, enc_mask, dec, dec_mask = _batch(np.random.default_rng(1))
    want_h = jmodel.apply(params, enc, enc_mask, method="encode")
    want = jmodel.apply(params, enc, enc_mask, dec, dec_mask)
    with torch.no_grad():
        t = [torch.from_numpy(x) for x in (enc, enc_mask, dec, dec_mask)]
        got_h = port.encode(t[0], t[1])
        got = port(*t)
    assert got.dtype == torch.float32 and got.shape == (3, 7, 128)
    _close(got_h.numpy(), want_h)
    _close(got.numpy(), want)


def _hf_t5(tie=True, num_layers=2):
    transformers = pytest.importorskip("transformers")
    cfg = transformers.T5Config(
        vocab_size=128, d_model=32, d_kv=8, d_ff=64, num_layers=num_layers,
        num_decoder_layers=num_layers, num_heads=4,
        relative_attention_num_buckets=8, relative_attention_max_distance=16,
        dropout_rate=0.0, feed_forward_proj="relu", tie_word_embeddings=tie)
    torch.manual_seed(0)
    return transformers.T5ForConditionalGeneration(cfg).eval()


@pytest.mark.parametrize("tie", [True, False])
def test_convert_hf_t5_matches_transformers_and_jax(tie):
    """``tests/test_t5.py:22-70``'s method: a random-init HF model, its
    state_dict converted; the logits against HF's own, the state_dict
    bitwise ``params_from_jax`` of the JAX converter's tree."""
    hf = _hf_t5(tie=tie)
    sd = hf.state_dict()
    got_sd = phf.convert_hf_t5(sd)
    want_sd = params_from_jax(jhf.convert_hf_t5(sd))
    assert sorted(got_sd) == sorted(want_sd)
    assert all(torch.equal(got_sd[k], want_sd[k]) for k in want_sd)
    assert ("lm_head.weight" in got_sd) is (not tie)
    cfg = phf.t5_config_from_state_dict(
        sd, base=pt5.T5Config(relative_attention_max_distance=16)).replace(
            dropout_rate=0.0)
    assert cfg.tie_word_embeddings is tie
    model = pt5.T5(cfg)
    model.load_state_dict(got_sd)
    enc, enc_mask, dec, dec_mask = _batch(np.random.default_rng(0))
    with torch.no_grad():
        want = hf(input_ids=torch.tensor(enc, dtype=torch.long),
                  attention_mask=torch.tensor(enc_mask),
                  decoder_input_ids=torch.tensor(dec, dtype=torch.long),
                  decoder_attention_mask=torch.tensor(dec_mask)).logits
        got = model(*[torch.from_numpy(x)
                      for x in (enc, enc_mask, dec, dec_mask)])
    _close(got.numpy(), want.numpy())


def test_t5_config_derivation_and_auto_refusal():
    hf = _hf_t5(num_layers=3)
    sd = hf.state_dict()
    assert phf.sniff_hf_family(sd) == "t5"
    got = phf.t5_config_from_state_dict(sd)
    want = jhf.t5_config_from_state_dict(sd)
    for field in ("vocab_size", "d_model", "d_kv", "d_ff", "num_layers",
                  "num_decoder_layers", "num_heads",
                  "relative_attention_num_buckets",
                  "relative_attention_max_distance", "tie_word_embeddings"):
        assert getattr(got, field) == getattr(want, field), field
    assert (got.num_layers, got.n_dec, got.d_kv) == (3, 3, 8)
    with pytest.raises(ValueError, match="encoder-DECODER"):
        phf.convert_hf_auto(sd)


def test_init_scales_follow_jax():
    """``T5(cfg, generator)`` draws JAX's initializers: every tensor's
    spread within 15% of the JAX tree's (different streams)."""
    cfg = dict(SMALL, tie_word_embeddings=False, d_model=64, d_ff=128,
               vocab_size=512)
    ones = np.ones((1, 8), np.int32)
    jtree = params_from_jax(jax.device_get(jt5.T5(jt5.T5Config(**cfg)).init(
        jax.random.PRNGKey(0), ones, ones, ones, ones)))
    port = pt5.T5(pt5.T5Config(**cfg),
                  generator=torch.Generator().manual_seed(0)).state_dict()
    assert sorted(port) == sorted(jtree)
    for k, want in jtree.items():
        if k.endswith("norm.weight"):
            assert torch.equal(port[k], want), k
        elif want.numel() >= 256:
            ratio = float(port[k].std() / want.std())
            assert 0.85 <= ratio <= 1.15, (k, ratio)


@pytest.mark.parametrize("tie", [True, False])
def test_incremental_decode_matches_rerun(tie):
    """The cached decoder's logits at each position against the
    teacher-forcing decoder over the same tokens (``t5.py:313-342``'s
    re-run), with padded encoder rows; the cache is written and read at
    full length, the keys past the position masked."""
    _, _, port = _pair(tie=tie, seed=3)
    enc, enc_mask, dec, _ = _batch(np.random.default_rng(4), t=9)
    t = dec.shape[1]
    with torch.no_grad():
        hidden = port.encode(torch.from_numpy(enc), torch.from_numpy(enc_mask))
        cache = port.start_decode(hidden, torch.from_numpy(enc_mask), t)
        for pos in range(t):
            mask = (np.arange(t) <= pos).astype(np.int32)[None].repeat(3, 0)
            want = port.decode(torch.from_numpy(dec), torch.from_numpy(mask),
                               hidden, torch.from_numpy(enc_mask))[:, pos]
            # the position as an int and as the 0-d tensor a graph replays
            at = pos if pos % 2 else torch.tensor(pos)
            got = port.decode_step(torch.from_numpy(dec[:, pos]), at, cache)
            _close(got.numpy(), want.numpy())


@pytest.mark.parametrize("tie", [True, False])
def test_greedy_generate_gives_jax_tokens(tie):
    jmodel, params, port = _pair(tie=tie, seed=5)
    rng = np.random.default_rng(6)
    enc = rng.integers(2, 128, (2, 10)).astype(np.int32)
    enc_mask = np.ones_like(enc)
    enc_mask[1, 7:] = 0
    want = np.asarray(jt5.generate(jmodel, params, enc, enc_mask,
                                   jax.random.PRNGKey(0), max_length=8,
                                   top_k=1, num_return_sequences=3))
    got = pt5.generate(port, enc, enc_mask, 0, max_length=8, top_k=1,
                       num_return_sequences=3)
    assert got.dtype == torch.int32 and got.shape == (2, 3, 8)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want[:, :, 1:])) > 1


def test_sampling_contract():
    """[B, N, T] with PAD first; every sampled token inside its step's
    top-k set (the teacher-forcing logits over the sampled prefix); PAD
    after EOS; the same seed gives the same samples."""
    _, _, port = _pair(tie=False, seed=7)
    rng = np.random.default_rng(8)
    enc = rng.integers(2, 128, (2, 10)).astype(np.int32)
    enc_mask = np.ones_like(enc)
    b, n, t_max, k = 2, 4, 12, 5
    # EOS's head row along the decoder's mean output: EOS among the likely
    # tokens, so rows end and PAD follows
    seen = []
    hook = port.dec_final_norm.register_forward_hook(
        lambda mod, args, out: seen.append(out))
    with torch.no_grad():
        ids = torch.from_numpy(enc)
        port(ids, ids > 0, ids[:, :6], torch.ones_like(ids[:, :6]))
        hook.remove()
        mean = seen[0].reshape(-1, seen[0].shape[-1]).mean(0)
        w = port.lm_head.weight
        w[1] = mean / mean.norm() * w.norm(dim=1).mean() * 2.0
    toks = pt5.generate(port, enc, enc_mask, 11, max_length=t_max, top_k=k,
                        num_return_sequences=n)
    assert toks.shape == (b, n, t_max)
    assert torch.equal(toks, pt5.generate(port, enc, enc_mask, 11,
                                          max_length=t_max, top_k=k,
                                          num_return_sequences=n))
    flat = toks.reshape(b * n, t_max)
    assert (flat[:, 0] == 0).all()
    with torch.no_grad():
        enc_r = torch.from_numpy(enc).repeat_interleave(n, 0)
        mask_r = torch.from_numpy(enc_mask).repeat_interleave(n, 0)
        logits = port(enc_r, mask_r, flat, torch.ones_like(flat))
    top = torch.topk(logits, k, dim=-1).indices
    eos_seen = 0
    for row in range(b * n):
        done = False
        for pos in range(t_max - 1):
            tok = int(flat[row, pos + 1])
            if done:
                assert tok == 0
                continue
            assert tok in top[row, pos].tolist()
            done = tok == 1
        eos_seen += done
    assert 0 < eos_seen


class _ToyTok:
    """A decodable toy tokenizer (``tests/test_t5.py:135-145``)."""

    def encode(self, text, max_length=None, truncation=None):
        ids = [min(2 + (hash(w) % 120), 127) for w in text.split()]
        return ids[:max_length] if max_length else ids

    def decode(self, ids):
        return " ".join(f"w{i}" for i in ids if i > 1)


def test_doc2query_tsv_top1_equals_jax(tmp_path):
    jmodel, params, port = _pair(seed=9, d_model=16, d_kv=4, d_ff=32,
                                 num_layers=1)
    passages = [(i, f"passage number {i} about topic {i % 3}")
                for i in range(5)]
    kw = dict(num_queries=3, max_src_length=8, max_length=5, top_k=1,
              batch_size=2, seed=0)
    jt5.doc2query_tsv(jmodel, params, _ToyTok(), passages,
                      str(tmp_path / "jax.tsv"), **kw)
    pt5.doc2query_tsv(port, _ToyTok(), passages, str(tmp_path / "port.tsv"),
                      **kw)
    want = (tmp_path / "jax.tsv").read_bytes()
    assert (tmp_path / "port.tsv").read_bytes() == want
    assert len(want.decode().splitlines()) == 5
