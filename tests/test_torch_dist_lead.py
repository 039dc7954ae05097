"""LEAD's joint step and MASTER's two pre-training steps over gloo ranks
(``tests/torch_dist.py``) against the JAX steps on ``create_mesh(n_data=
2)``, from the same weights and global batches, 2 steps: every metric
within 1e-4 relative, the parameters within 1e-5 (AdamW at eps=1e-3, as
``test_torch_train.py`` explains), every rank's parameters bitwise equal.
Under a group each rank's loss is its share of the global objective: the
joint step gathers every model's outputs over the group; the Condenser's
parts weigh a rank's mean by its share of the masked positions; the
ELECTRA corruption pairs each row with its nearest row of the whole
batch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from simxns_tpu.data import CondenserCollator as JCollator
from simxns_tpu.data import HashTokenizer as JHashTokenizer
from simxns_tpu.data import TokenMeta as JTokenMeta
from simxns_tpu.models import BertConfig as JBertConfig
from simxns_tpu.models import BiEncoder as JBiEncoder
from simxns_tpu.models import BiEncoderConfig as JBiEncoderConfig
from simxns_tpu.models import ColBERT as JColBERT
from simxns_tpu.models import ColBERTConfig as JColBERTConfig
from simxns_tpu.models import Condenser as JCondenser
from simxns_tpu.models import CondenserConfig as JCondenserConfig
from simxns_tpu.models import CrossEncoder as JCrossEncoder
from simxns_tpu.models import CrossEncoderConfig as JCrossEncoderConfig
from simxns_tpu.parallel import create_mesh, shard_batch
from simxns_tpu.train import LeadConfig as JLeadConfig
from simxns_tpu.train import TrainState as JTrainState
from simxns_tpu.train import make_adamw as jmake_adamw
from simxns_tpu.train import make_condenser_step as jmake_condenser
from simxns_tpu.train import make_electra_step as jmake_electra
from simxns_tpu.train import make_lead_step as jmake_lead
from simxns_tpu_torch.models import (BiEncoderConfig, ColBERTConfig,
                                     CondenserConfig, CrossEncoderConfig,
                                     params_from_jax)
import torch_dist
from torch_parity import DIST_TX, dist_batch, jax_bert, port_bert
from torch_parity import one_torch_thread  # noqa: F401

F32 = jnp.float32
W = 2


@pytest.fixture(scope="module")
def pool():
    p = torch_dist.Pool(W)
    yield p
    p.close()


def _check(got, jmetrics, want):
    """Every rank's metrics against JAX's, its parameters against ``want``
    (name -> numpy) and rank 0's bits."""
    bits = got[0][1]
    for metrics, params in got:
        for step, jm in zip(metrics, jmetrics):
            assert set(step) == set(jm)
            for key, value in jm.items():
                np.testing.assert_allclose(step[key], float(value),
                                           rtol=1e-4, atol=1e-6,
                                           err_msg=key)
        assert set(params) == set(want)
        for name, p in params.items():
            err = float(np.abs(p - want[name]).max())
            assert err <= 1e-5, (name, err)
            np.testing.assert_array_equal(p, bits[name], err_msg=name)


def test_lead_step_matches_jax_mesh(pool):
    """db and the CE trained, ColBERT frozen; layer scores and the CE
    attention-map KL on: the joint step at W=2."""
    bert = jax_bert(dtype=F32)
    d = np.ones((2, 8), np.int32)
    specs = {
        "db": (JBiEncoder(JBiEncoderConfig(bert=bert.replace(num_layers=1))),
               BiEncoderConfig(bert=port_bert(bert.replace(num_layers=1))),
               (d, d, d, d)),
        "col": (JColBERT(JColBERTConfig(bert=bert.replace(num_layers=1),
                                        dim=16)),
                ColBERTConfig(bert=port_bert(bert.replace(num_layers=1)),
                              dim=16), (d, d, d, d)),
        "ce": (JCrossEncoder(JCrossEncoderConfig(bert=bert,
                                                 per_layer_logits=True)),
               CrossEncoderConfig(bert=port_bert(bert),
                                  per_layer_logits=True), (d, d))}
    params = {k: jm.init(jax.random.PRNGKey(i), *args)
              for i, (k, (jm, _, args)) in enumerate(specs.items())}
    cfg = dict(distill_db=True, distill_de=False, distill_col=True,
               distill_ce=True, train_db=True, train_ce=True,
               layer_score=True, attention=True)
    batches = [dist_batch(60 + s) for s in range(2)]
    sels = [([0], [1]), ([0], [0])]
    mesh = create_mesh(n_data=W)
    jtx = jmake_adamw(**DIST_TX)
    jstep = jmake_lead(
        {k: v[0] for k, v in specs.items()}, {k: jtx for k in specs}, mesh,
        JLeadConfig(**cfg), num_distill_layers=1)
    states = {k: JTrainState.create(jax.tree.map(jnp.copy, p), jtx)
              for k, p in params.items()}
    jmetrics = []
    for b, (s, t) in zip(batches, sels):
        states, m = jstep(states, shard_batch(b, mesh),
                          jnp.asarray(s, jnp.int32), jnp.asarray(t, jnp.int32))
        jmetrics.append(jax.device_get(m))
    want = {f"{k}.{n}": v.numpy() for k in specs
            for n, v in params_from_jax(jax.device_get(
                states[k].params)).items()}
    models = {k: (specs[k][1], {n: v.numpy() for n, v in params_from_jax(
        jax.device_get(p)).items()}) for k, p in params.items()}
    got = pool.run(torch_dist.lead_steps, models, batches, sels, DIST_TX,
                   cfg, world=W)
    _check(got, jmetrics, want)


def _meta():
    return JTokenMeta.for_hash_tokenizer(JHashTokenizer(vocab_size=256))


@pytest.mark.parametrize("electra", [False, True])
def test_pretrain_steps_match_jax_mesh(pool, electra):
    """The Condenser's 8-loss step and the ELECTRA step at W=2 over the
    collator's batches (4 rows, ragged texts: the ranks' masked counts
    differ)."""
    bert = JBertConfig.tiny(vocab_size=256, max_position_embeddings=64)
    coll = JCollator(_meta(), max_seq_length=32, seed=3)
    rng = np.random.default_rng(2)
    batches = [coll([{"text": rng.integers(5, 250, size=n).tolist(),
                      "queries": [rng.integers(5, 250, size=5).tolist()],
                      "next": [rng.integers(5, 250, size=12).tolist()]}
                     for n in (30, 9, 25, 14)]) for _ in range(2)]
    jmodel = JCondenser(JCondenserConfig(bert=bert, n_head_layers=1))
    params = jmodel.init(jax.random.PRNGKey(4),
                         {k: v[:2] for k, v in batches[0].items()})
    mesh = create_mesh(n_data=W)
    jtx = jmake_adamw(**DIST_TX)
    mask_id = _meta().mask_id
    jstep = (jmake_electra(jmodel, jtx, mesh, mask_id=mask_id) if electra
             else jmake_condenser(jmodel, jtx, mesh))
    state = JTrainState.create(jax.tree.map(jnp.copy, params), jtx)
    jmetrics = []
    for b in batches:
        state, m = jstep(state, shard_batch(b, mesh))
        jmetrics.append(jax.device_get(m))
    want = {n: v.numpy() for n, v in params_from_jax(
        jax.device_get(state.params)).items()}
    cfg = CondenserConfig(bert=port_bert(bert), n_head_layers=1)
    start = {n: v.numpy() for n, v in params_from_jax(
        jax.device_get(params)).items()}
    got = pool.run(torch_dist.pretrain_steps, cfg, start, batches, DIST_TX,
                   mask_id if electra else None, world=W)
    _check(got, jmetrics, want)


def _logged(directory, phase):
    import json
    import os

    with open(os.path.join(directory, "metrics.jsonl"), encoding="utf-8") as f:
        return [(r["step"], r["loss"]) for r in map(json.loads, f)
                if r.get("phase") == phase]


@pytest.mark.parametrize("recipe,phase,extra,rtol", [
    ("lead_ms_distill", "lead", ["--steps", "8", "--batch", "8",
                                 "--corpus-size", "48", "--num-queries",
                                 "16"], 5e-3),
    ("master_pretrain", "pretrain", ["--steps", "4", "--batch", "8"], 1e-5),
    ("capstone_curriculum", "curriculum", [
        "--steps", "6", "--batch", "8", "--corpus-size", "48",
        "--num-queries", "16"], 1e-5)])
def test_w2_launcher_matches_w1(pool, tmp_path, recipe, phase, extra, rtol):
    """``run_lead``, ``run_pretrain`` and ``run_capstone`` on two ranks
    (each steps on its half of the same global batches) against the same
    run at world 1: every logged loss within ``rtol`` (LEAD: after 60
    warm-up steps of f32 AdamW at eps=1e-8, whose noise-level updates the
    joint losses inherit, as in ``test_torch_run_lead.py``: 1.9e-3
    measured on the CPU; MASTER and CAPSTONE: the same batches, exact
    shares; CAPSTONE 1.2e-6 measured)."""
    from simxns_tpu_torch import run as prun

    argv = ["--recipe", recipe, "--synthetic", *extra, "--device", "cpu"]
    want = prun.main(argv + ["--output-dir", str(tmp_path / "w1")])
    got = pool.run(torch_dist.run_launcher,
                   argv + ["--output-dir", str(tmp_path / "w2")])
    assert [o["world_size"] for o in got] == [W] * W
    assert want["world_size"] == 1
    lw, lg = _logged(tmp_path / "w1", phase), _logged(tmp_path / "w2", phase)
    assert [s for s, _ in lg] == [s for s, _ in lw] and lw
    for (step, g), (_, w) in zip(lg, lw):
        assert abs(g - w) <= rtol * abs(w), (step, g, w)
    for o in got:
        assert abs(o["final_loss"] - want["final_loss"]) <= rtol * abs(
            want["final_loss"])
