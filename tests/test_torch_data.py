"""The host data path of the port against the JAX package: the SimANS
sampler and PROD selection, ``MinedDataset`` batches, and the launcher's
synthetic corpora, for the same numpy seeds; and every recipe of the
config, field by field."""

import dataclasses

import numpy as np
import pytest
import torch

from simxns_tpu import run as jrun
from simxns_tpu.config import RECIPES as JRECIPES
from simxns_tpu.data import mined as jmined
from simxns_tpu.data import sampling as jsampling
from simxns_tpu_torch import run as prun
from simxns_tpu_torch.config import RECIPES
from simxns_tpu_torch.data import mined as pmined
from simxns_tpu_torch.data import sampling as psampling
from torch_parity import _DTYPES
from torch_parity import one_torch_thread  # noqa: F401

# BertConfig fields the port has not taken yet (dropout, remat)
_UNPORTED_BERT = {"hidden_dropout", "attention_dropout"}


def _cases():
    rng = np.random.default_rng(0)
    ids = list(range(100, 140))
    scores = rng.normal(size=40).tolist()
    return [
        (ids, scores, 0.7, 15),         # the usual draw
        (ids[:5], scores[:5], 0.7, 15),  # fewer candidates than k: cycle
        (ids, scores, 0.0, 15),         # no positive score: the last k
        (ids, [s + 400.0 for s in scores], 0.5, 15),  # weights underflow
        (ids, scores, 0.2, 40),         # k = every candidate
        ([], [], 0.3, 4),
    ]


@pytest.mark.parametrize("mode", ["quadratic", "abs"])
def test_simans_sampler_matches(mode):
    for ids, scores, pos, k in _cases():
        np.testing.assert_array_equal(
            psampling.simans_weights(np.array(scores), pos, mode, 0.5, 1.0),
            jsampling.simans_weights(np.array(scores), pos, mode, 0.5, 1.0))
        got = psampling.sample_hard_negatives(
            ids, scores, pos, k, np.random.default_rng(7), mode=mode, b=1.0)
        want = jsampling.sample_hard_negatives(
            ids, scores, pos, k, np.random.default_rng(7), mode=mode, b=1.0)
        assert got == want


@pytest.mark.parametrize("neg_type", ["random", "descend", "rand_pool"])
def test_select_negatives_matches(neg_type):
    for ids, scores, _, k in _cases():
        assert psampling.select_negatives(
            ids, scores, k, np.random.default_rng(3), neg_type) == \
            jsampling.select_negatives(ids, scores, k,
                                       np.random.default_rng(3), neg_type)
    with pytest.raises(ValueError):
        psampling.select_negatives([1, 2], [0.1, 0.2], 1,
                                   np.random.default_rng(0), "other")


@pytest.mark.parametrize("simans_mode", ["quadratic", "abs", None])
def test_mined_dataset_batches_match(simans_mode):
    rng = np.random.default_rng(5)
    n, q, k, lc, lq = 60, 14, 12, 20, 8
    corpus = rng.integers(5, 500, (n, lc)).astype(np.int32)
    corpus[:, 0] = 1
    lens = rng.integers(6, lc + 1, n)
    corpus[np.arange(lc)[None, :] >= lens[:, None]] = 0
    corpus[np.arange(n), lens - 1] = 2                  # trailing SEP
    queries = rng.integers(5, 500, (q, lq)).astype(np.int32)
    queries[:, 0] = 1
    queries[3, 5:] = 0
    topk_ids = np.stack([rng.permutation(n)[:k] for _ in range(q)])
    topk_scores = np.sort(rng.normal(size=(q, k)), 1)[:, ::-1].astype(
        np.float32)
    hits = rng.random((q, k)) < 0.25
    hits[0] = False                                     # no positive
    kw = dict(corpus_ids=corpus, query_ids=queries, topk_ids=topk_ids,
              topk_scores=topk_scores, hit_mask=hits, num_negatives=4,
              max_joint_length=24, simans_mode=simans_mode, simans_b=1.0,
              seed=11)
    got, want = pmined.MinedDataset(**kw), jmined.MinedDataset(**kw)
    assert len(got) == len(want)
    for with_joint in (True, False):
        for bg, bw in zip(got.batches(4, with_joint=with_joint),
                          want.batches(4, with_joint=with_joint),
                          strict=True):
            assert bg.keys() == bw.keys()
            for key in bg:
                np.testing.assert_array_equal(bg[key], bw[key])


@pytest.mark.parametrize("recipe,size", [("nq_ar2_simans", 64),
                                         ("msdoc_ar2_simans", 20_001)])
def test_synthetic_corpora_match(recipe, size):
    """``_synthesize`` (HashTokenizer text, <= 20,000 passages) and
    ``_synthesize_vectorized`` (the recipe's token lengths) give the JAX
    launcher's corpora for the same --seed."""
    argv = ["--recipe", recipe, "--synthetic", "--corpus-size", str(size),
            "--num-queries", "24", "--seed", "3"]
    got = prun._synthesize(prun.build_parser().parse_args(argv),
                           RECIPES[recipe].data)
    want = jrun._synthesize(jrun.build_parser().parse_args(argv),
                            JRECIPES[recipe].data)
    for key in ("corpus_ids", "query_ids"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key))
    for key in ("questions", "answers", "vocab_size", "sep_id",
                "positive_rows"):
        assert getattr(got, key) == getattr(want, key)
    for i in (0, 7, size - 1):
        assert got.passages.get(i) == want.passages.get(i)
    if size > 20_000:
        assert got.corpus_ids.shape[1] == RECIPES[recipe].data.max_ctx_length


def _same_config(got, want, path):
    if dataclasses.is_dataclass(got):
        assert type(got).__name__ == type(want).__name__, path
        mine = {f.name for f in dataclasses.fields(got)}
        theirs = {f.name for f in dataclasses.fields(want)}
        left = _UNPORTED_BERT if type(got).__name__ == "BertConfig" else set()
        assert theirs - mine == left and mine <= theirs, path
        for name in mine:
            _same_config(getattr(got, name), getattr(want, name),
                         f"{path}.{name}")
    elif isinstance(got, torch.dtype):
        assert got == _DTYPES[want], path
    else:
        assert got == want, path


@pytest.mark.parametrize("recipe", sorted(JRECIPES))
def test_recipes_match_jax(recipe):
    """Every recipe of the port's config is the JAX package's, field by
    field (the port's BertConfig lacks only dropout)."""
    assert sorted(RECIPES) == sorted(JRECIPES)
    _same_config(RECIPES[recipe], JRECIPES[recipe], recipe)
