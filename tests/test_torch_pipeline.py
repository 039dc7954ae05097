"""The port's PROD pipeline (``train/pipeline.py``) against the JAX
package's, stage for stage: warm up the dual encoder, refresh (encode the
corpus, build the index, mine, rebuild the dataset), distil from a CE
teacher, then divide the queries. The JAX end-to-end test
(``tests/test_pipeline.py:24``) builds its data with ``RetrievalCollator``
(ROADMAP.md Queue 1 item 14); here both sides build the same examples
through ``from_mining_result``. The same weights (``params_from_jax``) and
token arrays go through both: each stage's loss within 1e-4 relative
(f32 tiny models, AdamW at eps=1e-3 as ``test_torch_train.py`` explains),
the mine's top-k ids, records and top-1 equal (the records' scores within
1e-4 relative), the division's selection equal.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

from simxns_tpu.data import from_mining_result as jfrom_mining
from simxns_tpu.index import CorpusEncoder as JaxCorpusEncoder
from simxns_tpu.index import MIPSIndex as JaxIndex
from simxns_tpu.index import RetrievalEngine as JaxEngine
from simxns_tpu.parallel import create_mesh
from simxns_tpu.train import Pipeline as JaxPipeline
from simxns_tpu.train import TrainState as JaxTrainState
from simxns_tpu.train import division_stage as jdivision_stage
from simxns_tpu.train import make_adamw as jmake_adamw
from simxns_tpu.train import make_biencoder_step as jmake_de
from simxns_tpu.train import make_kd_step as jmake_kd
from simxns_tpu.train import refresh_stage as jrefresh_stage
from simxns_tpu.train import train_stage as jtrain_stage
from simxns_tpu_torch.data import from_mining_result
from simxns_tpu_torch.index import CorpusEncoder, MIPSIndex, RetrievalEngine
from simxns_tpu_torch.train import (Pipeline, TrainState, division_stage,
                                    make_adamw, make_biencoder_step,
                                    make_kd_step, refresh_stage, train_stage)
from torch_parity import biencoder_pair, crossencoder_pair, jax_bert
from torch_parity import one_torch_thread  # noqa: F401

F32 = jnp.float32
TX = dict(lr=3e-3, total_steps=0, eps=1e-3)
N_CORPUS, N_Q, LC, LQ, NEGS = 48, 16, 16, 10, 2
DS = dict(num_negatives=NEGS, max_joint_length=LQ + LC, sep_id=3,
          simans_mode=None)


def _data():
    """Passages whose text names their answer, queries that share their
    passage's tokens (clear answers under mean pooling)."""
    rng = np.random.default_rng(0)
    corpus = rng.integers(20, 1000, (N_CORPUS, LC)).astype(np.int32)
    corpus[:, 0], corpus[:, -1] = 1, 3
    queries = np.zeros((N_Q, LQ), np.int32)
    queries[:, 0], queries[:, 1:LQ - 1] = 1, corpus[:N_Q, 1:LQ - 1]
    queries[:, LQ - 1] = 3
    passages = {i: (f"body {i} ans{i} end", f"t{i}")
                for i in range(N_CORPUS)}
    questions = [f"body {i} ans{i}" for i in range(N_Q)]
    answers = [[f"ans{i}"] for i in range(N_Q)]
    k = NEGS + 3
    first = types.SimpleNamespace(
        topk_ids=np.stack([np.r_[i, (np.arange(1, k) * 5 + i) % N_CORPUS]
                           for i in range(N_Q)]),
        topk_scores=np.tile(np.linspace(5, 1, k, dtype=np.float32),
                            (N_Q, 1)),
        hits=[[j == 0 for j in range(k)] for _ in range(N_Q)])
    return corpus, queries, passages, questions, answers, first


def _stages(side, de_step, kd_step, encode_corpus, encode_queries, data):
    """The three stages of one side (``"jax"`` or ``"port"``)."""
    corpus, queries, _, questions, answers, _ = data
    train, refresh, mining = ((jtrain_stage, jrefresh_stage, jfrom_mining)
                              if side == "jax" else
                              (train_stage, refresh_stage,
                               from_mining_result))

    def de_batches(ctx):
        for b in ctx["dataset"].batches(batch_size=8):
            yield {k: v for k, v in b.items() if not k.startswith("joint")}

    def kd_batches(ctx):
        yield from ctx["dataset"].batches(batch_size=8)

    def rebuild(ctx, res):
        return mining(corpus, queries, res, seed=1, **DS)

    return [train("warmup_de", "de", de_step, de_batches, num_steps=4),
            refresh("mine_refresh", encode_corpus, encode_queries, questions,
                    answers, k=6, build_dataset=rebuild),
            train("kd_ce_teacher", "de", kd_step, kd_batches, num_steps=3,
                  teacher_keys=["ce"])]


def test_pipeline_stages_match_jax():
    data = _data()
    corpus, queries, passages, _, _, first = data
    mask_c = (corpus != 0).astype(np.int32)
    mask_q = (queries != 0).astype(np.int32)
    jmodel, params, port = biencoder_pair(jax_bert(dtype=F32), seed=3,
                                          pooling="mean")
    jce, ce_params, pce = crossencoder_pair(jax_bert(dtype=F32), seed=4)
    kd_kw = dict(kd_type="KD_softmax", ce_weight=1.0, kd_weight=0.5)

    mesh = create_mesh(n_data=1)
    jtx = jmake_adamw(**TX)
    enc_p = JaxCorpusEncoder(
        lambda p, i, m: jmodel.apply(p, i, m, method="encode_passage"),
        mesh, chunk_size=32)
    enc_q = JaxCorpusEncoder(
        lambda p, i, m: jmodel.apply(p, i, m, method="encode_query"),
        mesh, chunk_size=32)
    jindex = JaxIndex(mesh, block_size=16, store_dtype=jnp.float32)
    jctx = {"mesh": mesh, "index": jindex,
            "engine": JaxEngine(jindex, passages),
            "de": JaxTrainState.create(jax.tree.map(jnp.copy, params), jtx),
            "ce": ce_params,
            "dataset": jfrom_mining(corpus, queries, first, seed=0, **DS)}
    jout = JaxPipeline(_stages(
        "jax", jmake_de(jmodel, jtx, mesh),
        jmake_kd(jmodel, jtx, mesh, "cross_encoder", ce_teacher_model=jce,
                 **kd_kw),
        lambda c: enc_p(c["de"].params, corpus, mask_c),
        lambda c: enc_q(c["de"].params, queries, mask_q), data),
        ctx=jctx).run()

    tx = make_adamw(**TX)
    index = MIPSIndex("cpu", block_size=16, store_dtype=torch.float32)
    p_enc = CorpusEncoder(port.encode_passage, "cpu", chunk_size=32)
    q_enc = CorpusEncoder(port.encode_query, "cpu", chunk_size=32)
    ctx = {"index": index, "engine": RetrievalEngine(index, passages),
           "de": TrainState.create(port, tx), "ce": pce,
           "dataset": from_mining_result(corpus, queries, first, seed=0,
                                         **DS)}
    out = Pipeline(_stages(
        "port", make_biencoder_step(tx, device="cpu"),
        make_kd_step(tx, "cross_encoder", device="cpu", **kd_kw),
        lambda c: p_enc(corpus, mask_c), lambda c: q_enc(queries, mask_q),
        data), ctx=ctx).run()

    assert [h["stage"] for h in out["history"]] == [
        h["stage"] for h in jout["history"]] == ["warmup_de", "mine_refresh",
                                                  "kd_ce_teacher"]
    for got, want in zip(out["history"], jout["history"]):
        for key in ("loss", "top1", "mined", "steps"):
            if key in want:
                np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                           err_msg=f"{got['stage']} {key}")
    res, jres = ctx["last_mining"], jctx["last_mining"]
    np.testing.assert_array_equal(res.topk_ids, np.asarray(jres.topk_ids))
    _same_records(res.train_examples, jres.train_examples)
    assert out["history"][1]["mined"] == N_Q
    assert out["history"][1]["top1"] > 0.2    # the warm-up retrieves

    # the division stage over the mined ranking against a teacher's
    ranked = {str(i): [int(x) for x in res.topk_ids[i]] for i in range(N_Q)}
    teacher = {str(i): [i] + ranked[str(i)] for i in range(N_Q)}
    qrels = {str(i): [i] for i in range(N_Q)}
    got = Pipeline([division_stage("div", "s", "t", qrels)],
                   ctx={"s": ranked, "t": teacher}).run()
    want = JaxPipeline([jdivision_stage("div", "s", "t", qrels)],
                       ctx={"s": ranked, "t": teacher}).run()
    assert got["lwf_qids"] == want["lwf_qids"]
    assert got["history"][0]["selected"] == want["history"][0]["selected"]


def _same_records(got, want):
    """The mined train records equal but for their score strings, which
    agree within 1e-4 relative (f32 encoders)."""
    def split(records):
        scores, plain = [], []
        for rec in records:
            rec = dict(rec)
            for key in ("positive_ctxs", "hard_negative_ctxs"):
                ctxs = [dict(c) for c in rec.get(key, [])]
                scores += [float(c.pop("score")) for c in ctxs]
                rec[key] = ctxs
            plain.append(rec)
        return plain, scores

    (g, gs), (w, ws) = split(got), split(want)
    assert g == w
    np.testing.assert_allclose(gs, ws, rtol=1e-4)


def test_division_stage_matches_jax():
    """``tests/test_pipeline.py::test_division_stage``."""
    qrels = {"a": [1], "b": [1]}
    for make in (division_stage, jdivision_stage):
        ctx = {"student_rank": {"a": [9, 1], "b": [1, 9]},
               "teacher_rank": {"a": [1, 9], "b": [1, 9]}}
        metrics = make("div", "student_rank", "teacher_rank", qrels).run(ctx)
        assert ctx["lwf_qids"] == {"a"} and metrics["selected"] == 1
