"""The port's data contracts (``simxns_tpu_torch.data.datasets`` and
``tokenization.pack_joint``) against the JAX package's, case for case with
``tests/test_data.py:79, 100, 110, 129, 142, 206``: the same files and the
same numpy seeds give the same examples and bitwise the same batches
(host numpy code on both sides: no tolerance)."""

import json

import numpy as np
import pytest

from simxns_tpu.data import datasets as jds
from simxns_tpu.data import tokenization as jtok
from simxns_tpu_torch.data import datasets as pds
from simxns_tpu_torch.data import tokenization as ptok
from torch_parity import one_torch_thread  # noqa: F401


def _example(mod, i, n_negs=8):
    return mod.RetrievalExample(
        q_id=str(i), question=f"who wrote book {i}?", answers=[f"author{i}"],
        positives=[mod.Passage(100 + i, 8.0, f"title{i}",
                               f"text about author{i}")],
        negatives=[mod.Passage(200 + j, 7.0 - 0.1 * j, f"nt{j}",
                               f"neg text {j}") for j in range(n_negs)])


def _same_batch(got, want):
    assert sorted(got) == sorted(want)
    for key, val in want.items():
        if key == "answers":
            assert got[key] == val
        else:
            assert got[key].dtype == val.dtype, key
            np.testing.assert_array_equal(got[key], val, err_msg=key)


def _collators(**kw):
    return (pds.RetrievalCollator(tokenizer=ptok.HashTokenizer(1000), **kw),
            jds.RetrievalCollator(tokenizer=jtok.HashTokenizer(1000), **kw))


@pytest.mark.parametrize("kw", [
    dict(num_negatives=3, max_q_length=16, max_ctx_length=32,
         max_joint_length=48),
    dict(num_negatives=2, max_q_length=8, max_ctx_length=16,
         max_joint_length=24, simans_mode=None, neg_type="descend",
         shuffle_positives=True),
    dict(num_negatives=3, max_q_length=16, max_ctx_length=32,
         max_joint_length=48, is_training=False)])
def test_collator_batches_are_jax_bitwise(kw):
    """``tests/test_data.py:79``: shapes and the positive's layout, and the
    whole batch (SimANS draws, the negatives' shuffle, the joint rows)
    bitwise JAX's from the same Generator seed."""
    coll, jcoll = _collators(**kw)
    got = coll([_example(pds, i) for i in range(4)],
               np.random.default_rng(0))
    want = jcoll([_example(jds, i) for i in range(4)],
                 np.random.default_rng(0))
    _same_batch(got, want)
    m = 1 + kw["num_negatives"]
    assert got["ctx_ids"].shape == (4 * m, kw["max_ctx_length"])
    np.testing.assert_array_equal(got["positive_idx"], np.arange(4) * m)
    tok = ptok.HashTokenizer(1000)
    row = tok.encode("title0", text_pair="text about author0",
                     max_length=kw["max_ctx_length"])
    np.testing.assert_array_equal(got["ctx_ids"][0, :len(row)], row)


def test_dataset_epochs_are_jax_bitwise():
    """``tests/test_data.py:100``: two epochs of 4-example batches (drop
    last) from seed 0, every batch bitwise JAX's."""
    coll, jcoll = _collators(num_negatives=2, max_q_length=8,
                             max_ctx_length=16, max_joint_length=24)
    ds = pds.RetrievalDataset([_example(pds, i) for i in range(10)], coll,
                              seed=0)
    jds_ = jds.RetrievalDataset([_example(jds, i) for i in range(10)], jcoll,
                                seed=0)
    assert len(ds) == len(jds_) == 10
    for _ in range(2):
        got, want = list(ds.batches(4)), list(jds_.batches(4))
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            _same_batch(g, w)
    g = list(ds.batches(4, shuffle=False, drop_last=False))
    w = list(jds_.batches(4, shuffle=False, drop_last=False))
    assert [b["q_ids"].shape[0] for b in g] == [4, 4, 2]
    for a, b in zip(g, w):
        _same_batch(a, b)


def test_wiki_json_loader(tmp_path):
    """``tests/test_data.py:110``: the reference's filtering (no positive,
    or no hard negative when required), ids and scores as numbers, a
    positive without passage_id as -1."""
    data = [
        {"q_id": "1", "question": "q?", "answers": ["a"],
         "positive_ctxs": [{"title": "t", "text": "x", "passage_id": "5",
                            "score": "3.5"},
                           {"title": "g", "text": "gold"}],
         "hard_negative_ctxs": [{"title": "n", "text": "y", "passage_id": "6",
                                 "score": "2.0"}],
         "negative_ctxs": []},
        {"q_id": "2", "question": "dropped", "answers": [],
         "positive_ctxs": [], "hard_negative_ctxs": []},
        {"id": "3", "question": "no negatives", "answers": ["b"],
         "positive_ctxs": [{"title": "t3", "text": "z", "passage_id": 9}]},
    ]
    p = tmp_path / "train.json"
    p.write_text(json.dumps(data))
    for require in (True, False):
        got = pds.load_wiki_json(str(p), require_negatives=require)
        want = jds.load_wiki_json(str(p), require_negatives=require)
        assert ([vars(e) | {"positives": [vars(x) for x in e.positives],
                            "negatives": [vars(x) for x in e.negatives]}
                 for e in got] ==
                [vars(e) | {"positives": [vars(x) for x in e.positives],
                            "negatives": [vars(x) for x in e.negatives]}
                 for e in want])
    exs = pds.load_wiki_json(str(p))
    assert len(exs) == 1 and exs[0].positives[0].passage_id == 5
    assert exs[0].positives[0].score == 3.5
    assert exs[0].positives[1].passage_id == -1
    assert len(pds.load_wiki_json(str(p), require_negatives=False)) == 2


def test_marco_tsv_loader(tmp_path):
    """``tests/test_data.py:129``: positives and negatives with their
    scores, the title default "-"."""
    corpus = {1: "text one", 2: "text two", 3: "text three"}
    titles = {1: "T1"}
    p = tmp_path / "train.tsv"
    p.write_text("q1\thello query\t1 9.0\t2 5.5,3 4.0\n"
                 "bad line\n"
                 "q2\tsecond\t3\t1 1.0,\n")
    got = pds.load_marco_tsv(str(p), corpus, titles)
    want = jds.load_marco_tsv(str(p), corpus, titles)
    assert [(e.q_id, e.question, [vars(x) for x in e.positives],
             [vars(x) for x in e.negatives]) for e in got] == \
        [(e.q_id, e.question, [vars(x) for x in e.positives],
          [vars(x) for x in e.negatives]) for e in want]
    assert len(got) == 2 and got[0].negatives[0].title == "-"
    assert got[1].positives[0].score == 0.0


def test_corpus_qa_qrels_and_msdoc_loaders(tmp_path):
    """``tests/test_data.py:142``: passages (the id - 1 convention), the
    ``*.qa.csv`` answers, ``para.txt``; and the TREC qrels and MS-Doc files
    of the same module."""
    p = tmp_path / "psgs.tsv"
    p.write_text("id\ttext\ttitle\n1\thello world\tGreeting\n2\tbye\n")
    assert (pds.load_passages_tsv(str(p)) == jds.load_passages_tsv(str(p))
            == [(0, "hello world", "Greeting"), (1, "bye", "")])
    assert pds.load_passages_tsv(str(p), id_minus_one=False)[0][0] == 1
    q = tmp_path / "dev.qa.csv"
    q.write_text("who?\t\"['Alice', 'Bob']\"\nwhat?\t['x']\n")
    assert (pds.load_qa_csv(str(q)) == jds.load_qa_csv(str(q))
            == [("who?", ["Alice", "Bob"]), ("what?", ["x"])])
    t = tmp_path / "para.txt"
    t.write_text("7\tsome passage\n\n8\tother\twith tab\n")
    assert pds.load_id_text(str(t)) == jds.load_id_text(str(t))
    r = tmp_path / "qrels.trec"
    r.write_text("q1 0 7 2\nq1\t0\t8\t0\nq2 0 9 1\nq3\n")
    assert (pds.load_trec_qrels(str(r)) == jds.load_trec_qrels(str(r))
            == {"q1": {7: 2, 8: 0}, "q2": {9: 1}})
    assert pds.load_qrels(str(r)) == jds.load_qrels(str(r))
    d = tmp_path / "msmarco-docs.tsv"
    d.write_text("D12\thttp://a\tTitle A\tbody a\n34\thttp://b\tB\tbody b\n"
                 "D5\tonly\n")
    assert (pds.load_msdoc_tsv(str(d)) == jds.load_msdoc_tsv(str(d))
            == [(12, "http://a<sep>Title A<sep>body a"),
                (34, "http://b<sep>B<sep>body b")])
    assert (pds.pack_msdoc_text("u", "t", "b", sep="|")
            == jds.pack_msdoc_text("u", "t", "b", sep="|") == "u|t|b")
    for qtext in ("who?", "what", "??"):
        assert (pds.normalize_question(qtext)
                == jds.normalize_question(qtext))


@pytest.mark.parametrize("q,ctx,max_length", [
    ([101, 5, 6, 102], [101, 7, 8, 9, 102], 16),
    ([101, 5, 6, 102], [101, 7, 8, 9, 102], 6),
    ([101, 5, 6, 102], [101, 7, 8], 16),
    ([101, 5, 102], [102, 7, 102], 16),
    ([101, 5, 102], [], 16)])
def test_pack_joint_strips_ctx_specials(q, ctx, max_length):
    """``tests/test_data.py:206``: the passage's leading CLS and trailing
    SEP go, the cut adds no SEP; equal to JAX's on every case."""
    got = ptok.pack_joint(q, ctx, sep_token_id=102, max_length=max_length)
    assert got == jtok.pack_joint(q, ctx, 102, max_length)
    assert len(got) <= max_length


def test_load_hf_tokenizer_from_a_local_path(tmp_path):
    """``load_hf_tokenizer`` reads a tokenizer saved on disk (a word-piece
    vocabulary written here, no hub) and encodes as JAX's wrapper."""
    transformers = pytest.importorskip("transformers")
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "who", "wrote",
             "the", "book", "?", "a", "passage"]
    (tmp_path / "vocab.txt").write_text("\n".join(vocab) + "\n")
    transformers.BertTokenizerFast(
        vocab_file=str(tmp_path / "vocab.txt")).save_pretrained(
            str(tmp_path / "tok"))
    got = ptok.load_hf_tokenizer(str(tmp_path / "tok"))
    want = jtok.load_hf_tokenizer(str(tmp_path / "tok"))
    assert (got.pad_token_id, got.cls_token_id, got.sep_token_id) == (
        want.pad_token_id, want.cls_token_id, want.sep_token_id) == (0, 2, 3)
    args = ("who wrote the book?", "a passage")
    assert got.encode(*args) == want.encode(*args)
    assert got.encode(*args, max_length=6) == want.encode(*args,
                                                          max_length=6)
    assert (got.encode_batch(["who", "the book"], ["a", "passage"])
            == want.encode_batch(["who", "the book"], ["a", "passage"]))
