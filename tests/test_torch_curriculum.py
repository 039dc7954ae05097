"""The port's CAPSTONE curriculum (``simxns_tpu_torch/data/curriculum.py``)
against the JAX package's: the metrics and the schedule over a grid, the
TSV reader, every selection mode drawing from one numpy seed (the same
choices: the draws are the same calls in the same order), and the
expanded strings. Host numpy on both sides: exact equality."""

import numpy as np
import pytest

from simxns_tpu.data import curriculum as jcur
from simxns_tpu_torch.data import curriculum as pcur
from torch_parity import one_torch_thread  # noqa: F401

PAIRS = [("the cat sat on the mat", "the cat sat on the mat"),
         ("the cat", "entirely different words"),
         ("a b c d", "a c d e"),
         ("who wrote hamlet and why", "who wrote the play hamlet"),
         ("one two three four five six", "two three four five"),
         ("repeat repeat repeat", "repeat repeat"),
         ("", "anything at all"),
         ("Mixed CASE words", "mixed case WORDS here")]


@pytest.mark.parametrize("ref,cand", PAIRS)
def test_metrics_equal_jax(ref, cand):
    assert pcur.rouge_l_f1(ref, cand) == jcur.rouge_l_f1(ref, cand)
    for n in (1, 2, 4):
        assert pcur.bleu(ref, cand, max_n=n) == jcur.bleu(ref, cand, max_n=n)


@pytest.mark.parametrize("mode", ["gradual", "gradual-gold"])
def test_gradual_bucket_grid_equals_jax(mode):
    for max_steps in (1, 3, 7, 12, 100, 20_000):
        for parts in (1, 2, 3, 5):
            for step in sorted({0, 1, max_steps // 2, max_steps - 1,
                                max_steps, *range(0, max_steps, max(
                                    1, max_steps // 9))}):
                assert (pcur.gradual_bucket(step, max_steps, parts, mode)
                        == jcur.gradual_bucket(step, max_steps, parts, mode))
    with pytest.raises(ValueError, match="unknown curriculum mode"):
        pcur.gradual_bucket(0, 10, 3, "linear")


def test_from_tsv_equals_jax(tmp_path):
    path = tmp_path / "doc2query.tsv"
    path.write_text("0\tq zero a\tq zero b\n"
                    "1\tonly one\n"
                    "not a row\n"
                    "7\t" + "\t".join(f"q{i}" for i in range(100)) + "\n"
                    "3\tdup\tdup\tother\n", encoding="utf-8")
    for max_query in (80, 2):
        got = pcur.QueryExpander.from_tsv(str(path), max_query=max_query,
                                          total_part=3, delimiter=" [SEP] ")
        want = jcur.QueryExpander.from_tsv(str(path), max_query=max_query,
                                           total_part=3, delimiter=" [SEP] ")
        assert got.queries == want.queries
        assert (got.total_part, got.delimiter) == (3, " [SEP] ")


def _queries():
    gold = [f"who wrote hamlet {i}" for i in range(6)]
    queries = {
        0: ["who wrote hamlet 0", "what is hamlet about",
            "completely unrelated query", "hamlet author name",
            "who wrote", "wrote hamlet 0 who"],
        1: ["who wrote hamlet 1"],                 # only the gold: dropped
        2: ["a", "b", "a", "who wrote hamlet", "hamlet 2"],
        3: [f"candidate {j} hamlet {'who ' * (j % 3)}" for j in range(9)],
        4: ["who wrote hamlet four", "who wrote hamlet 4 exactly",
            "hamlet"],
    }
    return queries, gold


MODES = ["first", "random", "top-1", "top-3", "bottom-2", "1-th", "2-th",
         "9-th", "1-part", "2-part", "3-part", "batch-uniform",
         "batch-uniform-gold"]


@pytest.mark.parametrize("metric", ["rouge", "bleu"])
@pytest.mark.parametrize("threshold", [1.0, 0.5])
def test_select_query_same_choices_as_jax(metric, threshold):
    """Every mode, with and without a gold-query probability, over passages
    with duplicates, the gold among the candidates, a single candidate and
    none: one numpy stream each side, the same picks in the same order."""
    queries, gold = _queries()
    kw = dict(queries=queries, total_part=3, filter_threshold=threshold,
              metric=metric)
    got_ex, want_ex = pcur.QueryExpander(**kw), jcur.QueryExpander(**kw)
    rng_g, rng_w = np.random.default_rng(7), np.random.default_rng(7)
    n_picks = 0
    for mode in MODES:
        for prob in (0.0, 0.3):
            for index in range(4):
                for pid in range(6):
                    got = got_ex.select_query(pid, gold[pid], mode, rng_g,
                                              gold_query_prob=prob,
                                              index=index)
                    want = want_ex.select_query(pid, gold[pid], mode, rng_w,
                                                gold_query_prob=prob,
                                                index=index)
                    assert got == want, (mode, prob, index, pid)
                    n_picks += 1
    assert n_picks == len(MODES) * 2 * 4 * 6
    # both streams were drawn the same number of times
    assert rng_g.random() == rng_w.random()
    with pytest.raises(ValueError, match="unknown selection mode"):
        got_ex.select_query(0, gold[0], "middle", rng_g)


@pytest.mark.parametrize("delimiter", [" ", " [SEP] "])
def test_expanded_strings_equal_jax(delimiter):
    queries, gold = _queries()
    got_ex = pcur.QueryExpander(queries=queries, delimiter=delimiter)
    want_ex = jcur.QueryExpander(queries=queries, delimiter=delimiter)
    for pid in range(6):
        for q in (None, "", gold[pid], "some query"):
            assert (got_ex.expand_passage(f"text {pid}", q)
                    == want_ex.expand_passage(f"text {pid}", q))
        for k in (1, 2, 3, 7):
            assert (got_ex.expand_corpus_entry(pid, f"text {pid}", k)
                    == want_ex.expand_corpus_entry(pid, f"text {pid}", k))
    # the corpus entry repeats a short list to k (util.py:256-258)
    assert got_ex.expand_corpus_entry(1, "t", 3) == delimiter.join(
        ["t"] + ["who wrote hamlet 1"] * 3)
