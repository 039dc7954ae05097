"""The plain reference against the program at tiny sizes on the CPU
(the test imports both; the reference itself imports neither the program
nor JAX)."""

import numpy as np
import pytest
import torch

from benchmark import build, data, weights
from benchmark.reference import bert
from benchmark.reference.train import Batches, batch_differences
from benchmark.tests import tiny

SEED = 2 ** 31 + 77


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tokens(cfg, n, width, seed=1):
    tok = cfg["tokens"]
    ids = data.token_rows(np.random.default_rng(seed), n, width, 4, width,
                          tok)
    t = torch.as_tensor(ids).long()
    return t, (t != tok["pad_id"]).long()


@pytest.mark.parametrize("name", ["nq_ar2", "msdoc_ar2"])
def test_towers_match_the_program(name):
    cfg = tiny.config(name)
    de, ce = build.models(cfg, "cpu")
    w_de = build.initial_weights(cfg, SEED, "cpu", "retriever")
    w_ce = build.initial_weights(cfg, SEED, "cpu", "reranker")
    weights.load_into(de, w_de)
    weights.load_into(ce, w_ce)
    ids, mask = _tokens(cfg, 6, cfg["lengths"]["passage"])
    with torch.no_grad():
        got = de.encode_passage(ids, mask).float()
        want = bert.tower(w_de, "ctx_model.", ids, mask,
                          cfg["retriever"]).float()
        gl = ce(ids, mask)["logits"].float()
        wl = bert.cross_logits(w_ce, ids, mask, cfg["reranker"])
    assert (got - want).norm() / want.norm() < 2e-2
    assert (gl - wl).abs().max() < 2e-2 * wl.abs().max() + 1e-3


def test_int8_encoder_matches_the_program():
    from simxns_tpu_torch.models import cross_encoder, dual_encoder

    cfg = tiny.config("nq_ar2")
    de, ce = build.models(cfg, "cpu")
    w_de = build.initial_weights(cfg, SEED, "cpu", "retriever")
    w_ce = build.initial_weights(cfg, SEED, "cpu", "reranker")
    weights.load_into(de, w_de)
    weights.load_into(ce, w_ce)
    ids, mask = _tokens(cfg, 6, cfg["lengths"]["joint"])
    with torch.no_grad():
        got = dual_encoder.int8_view(de).encode_passage(ids, mask).float()
        want = bert.int8_tower(w_de, "ctx_model.", ids, mask,
                               cfg["retriever"]).float()
        gl = cross_encoder.int8_view(ce)(ids, mask)["logits"].float()
        wl = bert.int8_cross_logits(w_ce, ids, mask, cfg["reranker"])
    assert (got - want).norm() / want.norm() < 1e-2
    assert (gl - wl).abs().max() < 1e-2 * wl.abs().max() + 1e-3


@pytest.mark.parametrize("name", ["nq_ar2.cotrain", "msdoc_ar2.cotrain"])
def test_batches_match_the_data_layer_exactly(name):
    from simxns_tpu_torch.data.mined import MinedDataset

    c = tiny.cell(name)
    cfg = c.config
    tok, lengths, r = cfg["tokens"], cfg["lengths"], cfg["recipe"]
    mined = data.mined_set(c.seed, c.params["mined"], tok, lengths["query"],
                           lengths["passage"])
    seed = build.seeds(c.seed)["dataset"]
    ds = MinedDataset(**mined, pad_id=tok["pad_id"], sep_id=tok["sep_id"],
                      num_negatives=r["num_negatives"],
                      max_joint_length=lengths["joint"],
                      simans_mode=r["simans_mode"], simans_a=r["simans_a"],
                      simans_b=r["simans_b"], simans_tau=r["simans_tau"],
                      seed=seed)
    recipe = dict(r, pad_id=tok["pad_id"], sep_id=tok["sep_id"],
                  max_joint_length=lengths["joint"])
    ref = Batches(mined, recipe, seed)
    for _ in range(2):          # two epochs: the generator's state carries
        for got, want in zip(ds.batches(4), ref.epoch(4)):
            assert batch_differences(got, want) == 0


def test_mined_set_is_a_function_of_the_seed():
    p = tiny.params("nq_ar2.cotrain")["mined"]
    tok = tiny.config("nq_ar2")["tokens"]
    a = data.mined_set(5, p, tok, 8, 24)
    b = data.mined_set(5, p, tok, 8, 24)
    c = data.mined_set(6, p, tok, 8, 24)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["corpus_ids"], c["corpus_ids"])
    hits = a["hit_mask"]
    assert hits.any(1).all() and ((~hits).sum(1) >= 15).all()
    assert all(len(set(r)) == len(r) for r in a["topk_ids"].tolist())


def test_weights_are_a_function_of_the_seed():
    cfg = tiny.config("nq_ar2")
    spec = weights.retriever_spec(cfg["retriever"])
    a = weights.make(spec, weights.mix(2 ** 32 + 5, 1), "cpu")
    b = weights.make(spec, weights.mix(2 ** 32 + 5, 1), "cpu")
    c = weights.make(spec, weights.mix(-7, 1), "cpu")
    name = "ctx_model.encoder.layers.0.attention.query.weight"
    assert torch.equal(a[name], b[name]) and not torch.equal(a[name], c[name])
    assert float(a["ctx_model.encoder.layers.0.output_layer_norm.weight"]
                 .min()) == 1.0


@pytest.mark.parametrize("name", ["nq_ar2.cotrain", "msdoc_ar2.cotrain",
                                  "nq_ar2.encode"])
def test_tiny_cell_is_correct(name):
    out = tiny.run(name)
    assert out["correct"], out["compared"]


@pytest.mark.parametrize("kinds,lengths", [
    (["reranker", "retriever", "retriever"], [2, 1]),
    (["reranker", "reranker", "retriever"], [1, 2]),
    (["retriever", "retriever", "retriever"], [1, 2]),
    (["reranker", "retriever"], [2])])
def test_segments_end_before_a_second_step(kinds, lengths):
    from benchmark.drivers.cotrain import segments

    assert segments(kinds) == lengths


def test_first_steps_run_with_the_window_settings():
    """Set-up drives the compared steps through ``AR2CoTrainer.run`` as the
    window does: nothing logged, so no per-step synchronisation."""
    from benchmark import harness

    c = tiny.cell("nq_ar2.cotrain")
    state = harness.driver("cotrain").setup(c)
    trainer = state["trainer"]
    assert trainer.history == [] and trainer.cfg.log_every >= 2 ** 62
    assert trainer.global_step == c.config["recipe"]["iteration_step"]
    assert set(state["first_grad"]) == {"reranker", "retriever"}
