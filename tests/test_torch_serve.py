"""The serving slice as a whole: JAX ``DenseRetriever`` vs the port's, on the
CPU, from the same weights; plus the tokenizer the two share by copy."""

import numpy as np
import pytest
import torch

import simxns_tpu.ops.fused_layer as jfl
import simxns_tpu.ops.mips_kernel as jmk
from simxns_tpu.data import HashTokenizer as JaxHashTokenizer
from simxns_tpu.data.tokenization import pad_to as jax_pad_to
from simxns_tpu.parallel import create_mesh
from simxns_tpu.serve import DenseRetriever as JaxDenseRetriever
from simxns_tpu_torch.data import HashTokenizer, pad_to
from simxns_tpu_torch.serve import DenseRetriever
from torch_parity import biencoder_pair, jax_bert

import jax.numpy as jnp
from torch_parity import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _interpret():
    old = jfl.INTERPRET, jmk.INTERPRET
    jfl.INTERPRET = jmk.INTERPRET = True
    yield
    jfl.INTERPRET, jmk.INTERPRET = old


TEXTS = ["Who wrote Hamlet?", "naïve café — ünïcode, punctuation!!",
         "", "MixedCASE tokens and 1234 numbers", "a " * 80]


@pytest.mark.parametrize("max_length", [None, 8, 64])
def test_hash_tokenizer_ids_match_jax(max_length):
    """Singles, pairs and truncation give the JAX tokenizer's ids."""
    ours, theirs = HashTokenizer(vocab_size=1024), JaxHashTokenizer(
        vocab_size=1024)
    for text in TEXTS:
        for pair in (None, "a title, with words"):
            got = ours.encode(text, text_pair=pair, max_length=max_length)
            assert got == theirs.encode(text, text_pair=pair,
                                        max_length=max_length)
            assert pad_to(got, 16) == jax_pad_to(got, 16)


def _corpus(tok):
    """64 topics of 11 passages (ids g + 64 j, so no two passages of a topic
    share a candidate bucket): the topic word alone (the anchor, j=0), the
    topic word 10 times with 2 of the passage's own word (j=1..9), and the
    passage's own word alone (j=10). Every word has its own token id."""
    seen, words = {tok.pad_token_id}, []
    for i in range(10000):
        if tok._token_id(f"w{i}") not in seen:
            seen.add(tok._token_id(f"w{i}"))
            words.append(f"w{i}")
    passages = {}
    for g in range(64):
        for j in range(11):
            i = g + 64 * j
            text = ([words[g]] * 12 if j == 0 else
                    [words[g]] * 10 + [words[64 + i]] * 2 if j < 10 else
                    [words[64 + i]] * 12)
            passages[i] = (" ".join(text), f"t{i}")
    return passages, words


def test_dense_retriever_matches_jax():
    """The tiny fused_int8 BiEncoder (2 layers, H=128, 4 heads, F=256, vocab
    1024), an int8 store, mode fused, 704 passages (>= 64 * k, so the fused
    kernel and not the exact fallback searches), 16 queries of 8, k=10.

    With random weights the embeddings of unrelated texts nearly coincide,
    so the corpus is built for clear answers (shared, mean-pooled tower): a
    topic query's top-10 is its anchor first, then its 9 mixed passages,
    each boundary several times the port-vs-JAX score noise (measured 0.4%
    relative) away from the next score. Tolerance: the encoders agree to
    about one bf16 ulp per layer (test_torch_models.py), which moves an
    int8 code by a step now and then: top-1 ids equal, top-10 overlap >=
    0.98, scores of the shared ids within 2e-2 relative."""
    jmodel, params, port = biencoder_pair(
        jax_bert(layer_impl="fused_int8", dtype=jnp.bfloat16), seed=11,
        share_weight=True, pooling="mean")
    tok = HashTokenizer(vocab_size=1024)
    passages, words = _corpus(tok)
    topics = np.random.default_rng(12).choice(64, 16, replace=False)
    queries = [" ".join([words[int(g)]] * 3) for g in topics]
    kw = dict(max_q_length=16, max_ctx_length=32, index_mode="fused",
              block_size=256, encode_chunk=256, query_batch=8)
    jr = JaxDenseRetriever(jmodel, params, JaxHashTokenizer(vocab_size=1024),
                           create_mesh(n_data=1), store_dtype=jnp.int8, **kw)
    tr = DenseRetriever(port, tok, device="cpu", store_dtype=torch.int8, **kw)
    assert jr.index_corpus(passages) == tr.index_corpus(passages) == 704
    want = jr.search(queries, k=10)
    got = tr.search(queries, k=10)
    assert len(got) == 16 and all(len(h) == 10 for h in got)
    overlap = []
    for g, w, topic in zip(got, want, topics):
        assert g[0].passage_id == w[0].passage_id == topic
        assert (g[0].text, g[0].title) == passages[int(topic)]
        g_by_id = {h.passage_id: h.score for h in g}
        shared = [h for h in w if h.passage_id in g_by_id]
        overlap.append(len(shared) / 10)
        for h in shared:
            assert abs(g_by_id[h.passage_id] - h.score) <= 2e-2 * abs(h.score)
    assert np.mean(overlap) >= 0.98, overlap

    # encode_queries gives the JAX query embeddings (bf16 outputs: 0.1)
    np.testing.assert_allclose(tr.encode_queries(queries[:3]),
                               jr.encode_queries(queries[:3]), atol=0.1)


def test_search_before_index_raises():
    _, _, port = biencoder_pair(jax_bert(dtype=jnp.float32), seed=13,
                                share_weight=True)
    r = DenseRetriever(port, HashTokenizer(vocab_size=1024), device="cpu")
    with pytest.raises(RuntimeError, match="index not built"):
        r.search(["anything"], k=3)


def test_from_checkpoint_roundtrip(tmp_path):
    """``tests/test_serve.py:70`` on both packages: the tiny shared-tower
    BiEncoder's TrainState (JAX PRNGKey(3) weights, the same in both) saved
    at step 7, ``from_checkpoint`` into a zeroed model, 20 passages, exact
    f32 search: the port's hits equal the same retriever built from the
    weights in memory (ids and scores bitwise) and the JAX retriever's
    (ids; scores within 1e-4 relative: f32 encoders, summation order)."""
    import jax

    from simxns_tpu.io import save_checkpoint as jax_save
    from simxns_tpu.train import TrainState as JaxTrainState
    from simxns_tpu.train import make_adamw as jax_adamw
    from simxns_tpu_torch.io import save_checkpoint
    from simxns_tpu_torch.models import BiEncoder, BiEncoderConfig
    from simxns_tpu_torch.train import TrainState, make_adamw

    from simxns_tpu.models import BertConfig as JaxBertConfig
    from simxns_tpu.models import BiEncoder as JaxBiEncoder
    from simxns_tpu.models import BiEncoderConfig as JaxBiEncoderConfig
    from simxns_tpu_torch.models import params_from_jax
    from torch_parity import port_bert

    bert = JaxBertConfig.tiny(vocab_size=512)
    jmodel = JaxBiEncoder(JaxBiEncoderConfig(bert=bert, share_weight=True))
    dummy = np.ones((2, 8), np.int32)
    params = jmodel.init(jax.random.PRNGKey(3), dummy, dummy, dummy, dummy)
    port = BiEncoder(BiEncoderConfig(bert=port_bert(bert), share_weight=True))
    port.load_state_dict(params_from_jax(jax.device_get(params)))
    jtx = jax_adamw(1e-3, total_steps=0)
    jax_save(str(tmp_path / "jax"), JaxTrainState.create(params, jtx), 7)
    save_checkpoint(str(tmp_path / "port"),
                    TrainState.create(port, make_adamw(1e-3)).state_dict(),
                    7, name="retriever_state")
    kw = dict(max_q_length=12, max_ctx_length=24, block_size=16,
              encode_chunk=16, index_mode="exact")
    zero = JaxTrainState.create(jax.tree.map(jnp.zeros_like, params), jtx)
    jr = JaxDenseRetriever.from_checkpoint(
        str(tmp_path / "jax"), 7, jmodel, JaxHashTokenizer(vocab_size=512),
        zero, mesh=create_mesh(n_data=1), **kw)
    jr.index.store_dtype = jnp.float32
    fresh = BiEncoder(BiEncoderConfig(bert=port.cfg.bert, share_weight=True))
    with torch.no_grad():
        for p in fresh.parameters():
            p.zero_()
    tok = HashTokenizer(vocab_size=512)
    tr = DenseRetriever.from_checkpoint(
        str(tmp_path / "port"), 7, fresh, tok, name="retriever_state",
        device="cpu", store_dtype=torch.float32, **kw)
    mem = DenseRetriever(port, tok, device="cpu", store_dtype=torch.float32,
                         **kw)
    passages = {i: (f"body token{i}", f"t{i}") for i in range(20)}
    for r in (jr, tr, mem):
        r.index_corpus(passages)
    queries = ["t 4 body token4", "t 11 body token11"]
    want, got, ref = (r.search(queries, k=3) for r in (jr, tr, mem))
    assert got[0][0].passage_id == 4
    for g, w, m in zip(got, want, ref):
        assert [h.passage_id for h in g] == [h.passage_id for h in m]
        assert [h.score for h in g] == [h.score for h in m]
        assert [h.passage_id for h in g] == [h.passage_id for h in w]
        for a, b in zip(g, w):
            assert abs(a.score - b.score) <= 1e-4 * abs(b.score)
