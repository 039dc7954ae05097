"""MASTER in the port against the JAX package: the collator (its numpy and
native paths, each bitwise the JAX collator's from the same seed and
examples), the native core (the correctness cases of
``tests/test_native_collator.py``), the Condenser, its two steps and the
encoder-only export (the cases of ``tests/test_master.py``), on tiny f32
configs from identical weights.

Tolerances: losses within 1e-5 relative on the same inputs (1e-4 over the
steps), parameters within 1e-5 after 2 AdamW steps at eps=1e-3
(``test_torch_train.py`` explains the eps), batches and replaced ids
equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simxns_tpu.data import CondenserCollator as JCollator
from simxns_tpu.data import HashTokenizer as JHashTokenizer
from simxns_tpu.data import TokenMeta as JTokenMeta
from simxns_tpu.data import native as jnative
from simxns_tpu.models import BertConfig as JBertConfig
from simxns_tpu.models import Condenser as JCondenser
from simxns_tpu.models import CondenserConfig as JCondenserConfig
from simxns_tpu.models import cocondenser_span_loss as jspan_loss
from simxns_tpu.models import mlm_loss_from_logits as jmlm_loss
from simxns_tpu.models.condenser import generate_replaced_ids as jreplace
from simxns_tpu.models.condenser import in_batch_nearest as jnearest
from simxns_tpu.parallel import create_mesh
from simxns_tpu.train import TrainState as JTrainState
from simxns_tpu.train import make_adamw as jmake_adamw
from simxns_tpu.train import make_condenser_step as jmake_condenser
from simxns_tpu.train import make_electra_step as jmake_electra
from simxns_tpu_torch.data import (CondenserCollator, HashTokenizer,
                                   TokenMeta, native)
from simxns_tpu_torch.data.collator import IGNORE_INDEX
from simxns_tpu_torch.io import encoder_into, export_encoder_only
from simxns_tpu_torch.models import (BiEncoder, BiEncoderConfig, Condenser,
                                     CondenserConfig, cocondenser_span_loss,
                                     mlm_loss_from_logits, params_from_jax)
from simxns_tpu_torch.models.condenser import (HEAD_NAMES,
                                               generate_replaced_ids,
                                               in_batch_nearest)
from simxns_tpu_torch.train import (TrainState, make_adamw,
                                    make_condenser_step, make_electra_step)
from torch_parity import port_bert
from torch_parity import one_torch_thread  # noqa: F401

JCFG = JBertConfig.tiny(vocab_size=256, max_position_embeddings=64)
T = torch.from_numpy
needs_gxx = pytest.mark.skipif(not native.available(),
                               reason="g++ cannot build the native core")


def _meta(freq=None, vocab=256):
    return TokenMeta.for_hash_tokenizer(HashTokenizer(vocab_size=vocab),
                                        frequency=freq)


def _jmeta(freq=None, vocab=256):
    return JTokenMeta.for_hash_tokenizer(JHashTokenizer(vocab_size=vocab),
                                         frequency=freq)


def _examples(rng, n=4, text_len=30, vocab=250):
    return [{"text": rng.integers(5, vocab, size=text_len).tolist(),
             "queries": [rng.integers(5, vocab, size=6).tolist(),
                         rng.integers(5, vocab, size=5).tolist()],
             "next": [rng.integers(5, vocab, size=20).tolist()]}
            for _ in range(n)]


# --- the collator ---------------------------------------------------------------

@pytest.mark.parametrize("use_native", [False, True])
def test_collator_is_bitwise_jax(use_native):
    """Three batches in a row from the same seed and examples (ragged
    texts, one past the sequence so truncation draws, a keyword frequency
    table), on each path: every array equal, dtype included."""
    if use_native and not native.available():
        pytest.skip("g++ cannot build the native core")
    freq = {t: 1.0 + (t % 7) for t in range(256)}
    coll = CondenserCollator(_meta(freq), max_seq_length=32, seed=1,
                             use_native=use_native)
    jcoll = JCollator(_jmeta(freq), max_seq_length=32, seed=1,
                      use_native=use_native)
    assert coll.path == ("native" if use_native else "numpy")
    rng = np.random.default_rng(0)
    for lens in ((30, 12, 40, 5), (31, 31, 31, 31), (50, 8, 20, 29)):
        exs = [e for n in lens
               for e in _examples(rng, n=1, text_len=n)]
        exs[-1]["queries"] = []
        got, want = coll(exs), jcoll(exs)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_collator_streams():
    """``tests/test_master.py``: every stream [B, S]; labels only where
    masked; [CLS] never masked; the keyword stream at ~50%; the overlap
    masks disjoint."""
    coll = CondenserCollator(_meta(), max_seq_length=32, seed=1)
    batch = coll(_examples(np.random.default_rng(0)))
    assert len(batch) == 21
    for k, v in batch.items():
        assert v.shape == (4, 32), k
    meta = _meta()
    assert (batch["labels"] != IGNORE_INDEX).sum() > 0
    assert (batch["labels"][:, 0] == IGNORE_INDEX).all()
    assert (batch["input_ids"][:, 0] == meta.cls_id).all()
    assert ((batch["decoder_labels"] != IGNORE_INDEX).sum(1) >= 10).all()
    enc_m = batch["overlap_encoder_labels"] != IGNORE_INDEX
    dec_m = batch["overlap_decoder_labels"] != IGNORE_INDEX
    assert (enc_m & dec_m).sum() == 0


def test_collator_corruption_stats():
    """80/10/10: most masked positions become [MASK]."""
    meta = _meta()
    coll = CondenserCollator(meta, max_seq_length=64, seed=3,
                             mlm_probability=0.5)
    batch = coll(_examples(np.random.default_rng(2), n=32, text_len=60))
    masked = batch["labels"] != IGNORE_INDEX
    assert 0.7 < (batch["input_ids"][masked] == meta.mask_id).mean() < 0.9


# --- the native core (tests/test_native_collator.py) ------------------------------

@needs_gxx
def test_native_whole_word_mask_counts_and_matches_jax():
    rng = np.random.default_rng(0)
    ids = np.asarray(rng.integers(5, 500, size=100), np.int32)
    special = np.zeros(100, np.uint8)
    contin = np.zeros(100, np.uint8)
    mask = native.whole_word_mask(ids, special, contin, 0.3, seed=7)
    assert mask.sum() == 30
    np.testing.assert_array_equal(
        mask, jnative.whole_word_mask(ids, special, contin, 0.3, seed=7))
    mask2 = native.whole_word_mask(ids, special, contin, 0.3, seed=8)
    assert mask2.sum() == 30 and not np.array_equal(mask, mask2)
    special[:10] = 1
    assert native.whole_word_mask(ids, special, contin, 0.3,
                                  seed=7)[:10].sum() == 0


@needs_gxx
def test_native_keyword_mask_prefers_rare():
    ids = np.asarray(list(range(5, 55)), np.int32)
    special = np.zeros(50, np.uint8)
    contin = np.zeros(50, np.uint8)
    weights = np.ones(50)
    weights[:25] = 0.01
    counts = np.zeros(50)
    for s in range(200):
        m = native.keyword_mask(ids, special, contin, weights, 0.3, seed=s)
        if s < 3:
            np.testing.assert_array_equal(m, jnative.keyword_mask(
                ids, special, contin, weights, 0.3, seed=s))
        counts += m
    assert counts[25:].sum() > counts[:25].sum() * 3


@needs_gxx
def test_native_mask_tokens_distribution():
    rng = np.random.default_rng(1)
    inputs = rng.integers(5, 500, size=(64, 128)).astype(np.int32)
    mask = (rng.random((64, 128)) < 0.5).astype(np.int8)
    out, labels = native.mask_tokens(inputs, mask, mask_id=511,
                                     vocab_size=512, seed=3)
    jout, jlabels = jnative.mask_tokens(inputs, mask, 511, 512, 3)
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_array_equal(labels, jlabels)
    masked = mask == 1
    assert (labels[~masked] == IGNORE_INDEX).all()
    np.testing.assert_array_equal(labels[masked], inputs[masked])
    assert 0.75 < (out[masked] == 511).mean() < 0.85
    np.testing.assert_array_equal(out[~masked], inputs[~masked])


@needs_gxx
def test_native_collator_output_matches_numpy_statistics():
    """The native and numpy paths: the same keys and shapes, the same mask
    budget per stream and row, the same attention masks."""
    exs = _examples(np.random.default_rng(2), 16, text_len=60, vocab=500)
    fast = CondenserCollator(_meta(vocab=512), max_seq_length=64, seed=3,
                             use_native=True)
    slow = CondenserCollator(_meta(vocab=512), max_seq_length=64, seed=3,
                             use_native=False)
    b_fast, b_slow = fast(exs), slow(exs)
    assert set(b_fast) == set(b_slow)
    for k in b_fast:
        assert b_fast[k].shape == b_slow[k].shape, k
    for k in ("labels", "decoder_labels", "next_encoder_labels",
              "next_decoder_labels", "query_labels", "gpt_labels",
              "overlap_encoder_labels", "overlap_decoder_labels"):
        np.testing.assert_array_equal(
            (b_fast[k] != IGNORE_INDEX).sum(1),
            (b_slow[k] != IGNORE_INDEX).sum(1), err_msg=k)
    np.testing.assert_array_equal(b_fast["attention_mask"],
                                  b_slow["attention_mask"])


@needs_gxx
def test_native_word_groups_join_across_specials():
    ids = np.asarray([10, 11, 3, 12, 20, 30], np.int32)
    special = np.asarray([0, 0, 1, 0, 0, 0], np.uint8)
    contin = np.asarray([0, 1, 0, 1, 0, 0], np.uint8)
    for seed in range(20):
        m = native.whole_word_mask(ids, special, contin, 0.5, seed=seed)
        assert m[2] == 0
        assert m[0] == m[1] == m[3], m


def test_native_builds_into_the_port_not_native_dir():
    """The port's library lives in ``simxns_tpu_torch/_build/``; the JAX
    package's build target (``native/``) is not the port's."""
    path = native._lib_path()
    assert "/simxns_tpu_torch/_build/" in path
    assert native._SRC.endswith("native/fast_collator.cc")
    assert native.ABI_VERSION == jnative.ABI_VERSION


# --- the model ------------------------------------------------------------------

def _pair(batch, seed=0, n_head_layers=1):
    jmodel = JCondenser(JCondenserConfig(bert=JCFG,
                                         n_head_layers=n_head_layers))
    params = jmodel.init(jax.random.PRNGKey(seed),
                         {k: v[:2] for k, v in batch.items()})
    port = Condenser(CondenserConfig(bert=port_bert(JCFG),
                                     n_head_layers=n_head_layers))
    port.load_state_dict(params_from_jax(jax.device_get(params)))
    return jmodel, params, port


def _tbatch(batch):
    return {k: T(v).long() for k, v in batch.items()}


def test_mlm_loss_ignore_index_matches_jax():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(2, 3, 5)).astype(np.float32)
    labels = np.asarray([[1, IGNORE_INDEX, 2], [IGNORE_INDEX, 4, 0]])
    np.testing.assert_allclose(float(mlm_loss_from_logits(T(logits),
                                                          T(labels))),
                               float(jmlm_loss(logits, labels)), rtol=1e-6)
    zeros = np.zeros((2, 3, 5), np.float32)
    np.testing.assert_allclose(
        float(mlm_loss_from_logits(T(zeros), T(labels))), np.log(5),
        rtol=1e-6)
    assert np.isfinite(float(mlm_loss_from_logits(
        T(zeros), torch.full((2, 3), IGNORE_INDEX))))


@pytest.mark.parametrize("electra", [False, True])
def test_condenser_forward_matches_jax(electra):
    """The 8-loss objective (and the 4-loss ELECTRA variant): the total
    and every part."""
    batch = CondenserCollator(_meta(), max_seq_length=32, seed=5)(
        _examples(np.random.default_rng(4), n=4))
    jmodel, params, port = _pair(batch)
    method = "electra_forward" if electra else "__call__"
    jtotal, jparts = jmodel.apply(params, batch, method=method)
    with torch.no_grad():
        total, parts = (port.electra_forward if electra else port)(
            _tbatch(batch))
    assert set(parts) == set(jparts) == (
        {"mlm", "c_head", "next", "overlap"} if electra else
        {"mlm", "c_head", "query", "gpt", "next_encoder", "next",
         "overlap_encoder", "overlap"})
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)
    for k in parts:
        np.testing.assert_allclose(float(parts[k]), float(jparts[k]),
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(total),
                               sum(float(v) for v in parts.values()),
                               rtol=1e-6)


def test_replaced_ids_and_nearest_match_jax():
    """``generate_replaced_ids`` (the c_head's argmax at [MASK], given the
    in-batch nearest example's CLS) as JAX's; ``in_batch_nearest`` zeroes
    the diagonal (a row picks itself when every other dot is negative)."""
    meta = _meta()
    batch = CondenserCollator(meta, max_seq_length=32, seed=8)(
        _examples(np.random.default_rng(7), n=4))
    jmodel, params, port = _pair(batch, seed=1)
    jd, ji = jreplace(jmodel, params, batch, meta.mask_id)
    d, i = generate_replaced_ids(port, _tbatch(batch), meta.mask_id)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    dec = batch["decoder_input_ids"]
    np.testing.assert_array_equal(d.numpy()[dec != meta.mask_id],
                                  dec[dec != meta.mask_id])
    cls = np.random.default_rng(8).normal(size=(6, 8)).astype(np.float32)
    cls[5] = -10 * cls[:5].sum(0)    # every dot of row 5 below 0
    np.testing.assert_array_equal(in_batch_nearest(T(cls)).numpy(),
                                  np.asarray(jnearest(jnp.asarray(cls))))


def test_cocondenser_span_loss_matches_jax():
    h = np.random.default_rng(6).normal(size=(8, 16)).astype(np.float32)
    paired = h.copy()
    paired[1::2] = paired[0::2]
    for x in (h, 10 * paired):
        np.testing.assert_allclose(float(cocondenser_span_loss(T(x))),
                                   float(jspan_loss(jnp.asarray(x))),
                                   rtol=1e-5)
    assert float(cocondenser_span_loss(T(10 * paired))) < float(
        cocondenser_span_loss(T(h)))


def _tx():
    kw = dict(lr=5e-4, total_steps=0, eps=1e-3)
    return jmake_adamw(**kw), make_adamw(**kw)


@pytest.mark.parametrize("electra", [False, True])
def test_pretrain_steps_match_jax(electra):
    """``make_condenser_step`` / ``make_electra_step`` against JAX's: 2 steps
    from the same weights on the collator's batches, every metric and the
    parameters after them."""
    meta = _meta()
    coll = CondenserCollator(meta, max_seq_length=32, seed=10)
    rng = np.random.default_rng(9)
    batches = [coll(_examples(rng, n=4)) for _ in range(2)]
    jmodel, params, port = _pair(batches[0], seed=2)
    jtx, tx = _tx()
    mesh = create_mesh(n_data=1)
    if electra:
        jstep = jmake_electra(jmodel, jtx, mesh, mask_id=meta.mask_id)
        step = make_electra_step(tx, meta.mask_id, device="cpu")
    else:
        jstep = jmake_condenser(jmodel, jtx, mesh)
        step = make_condenser_step(tx, device="cpu")
    jstate = JTrainState.create(jax.tree.map(jnp.copy, params), jtx)
    state = TrainState.create(port, tx)
    for b in batches:
        jstate, jm = jstep(jstate, b)
        state, m = step(state, b)
        assert set(m) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4,
                                       err_msg=k)
    want = params_from_jax(jax.device_get(jstate.params))
    for name, p in port.named_parameters():
        err = float((p.detach() - want[name]).abs().max())
        assert err <= 1e-5, (name, err)


def test_condenser_step_trains():
    """``tests/test_master.py``: 6 steps on one batch, the loss falls."""
    coll = CondenserCollator(_meta(), max_seq_length=32, seed=5)
    batch = coll(_examples(np.random.default_rng(4), n=8))
    port = Condenser(CondenserConfig(bert=port_bert(JCFG), n_head_layers=1),
                     generator=torch.Generator().manual_seed(0))
    tx = make_adamw(5e-4, total_steps=0)
    state = TrainState.create(port, tx)
    step = make_condenser_step(tx, device="cpu")
    losses = []
    for _ in range(6):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]


def test_export_drops_heads_and_loads_into_a_biencoder():
    """The encoder-only export keeps ``encoder`` and ``mlm``, drops the
    five heads (JAX's ``export_encoder_only`` over the flax tree keeps the
    same weights), and its encoder loads into a ``BiEncoder`` tower."""
    from simxns_tpu.io import export_encoder_only as jexport

    batch = CondenserCollator(_meta(), max_seq_length=32, seed=6)(
        _examples(np.random.default_rng(5), n=2))
    _, params, port = _pair(batch)
    exported = export_encoder_only({"params": dict(port.state_dict())})
    assert not any(k.startswith(HEAD_NAMES) for k in exported)
    assert any(k.startswith("encoder.") for k in exported)
    assert any(k.startswith("mlm.") for k in exported)
    want = params_from_jax(jax.device_get(jexport(params["params"])))
    assert set(exported) == set(want)
    bi = BiEncoder(BiEncoderConfig(bert=port_bert(JCFG)))
    encoder_into(exported, bi.question_model)
    for name, p in bi.question_model.encoder.state_dict().items():
        assert torch.equal(p, exported["encoder." + name])
