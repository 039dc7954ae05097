"""The port's PROD distillation steps against the JAX package's
(``simxns_tpu/train/kd.py``), on the cases of ``tests/test_kd.py``, the
ColBERT teacher's included: the same weights
(``params_from_jax``) and numpy batches through both, 2 steps each, the
metrics within 1e-4 relative and the parameters within 1e-5 after the
steps. AdamW runs at eps=1e-3, as ``test_torch_train.py`` explains (at
1e-8 a gradient of pure rounding noise moves a parameter by +-lr). The
int8-view teacher runs JAX's Pallas layer in interpret mode. Then the
dataset division against ``simxns_tpu/data/division.py``."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import simxns_tpu.ops.fused_layer as jfl
from simxns_tpu.data import division as jdiv
from simxns_tpu.parallel import create_mesh
from simxns_tpu.train import TrainState as JaxTrainState
from simxns_tpu.train import make_adamw as jmake_adamw
from simxns_tpu.train import make_ce_kd_step as jmake_ce_kd
from simxns_tpu.train import make_kd_step as jmake_kd
from simxns_tpu_torch.data import division
from simxns_tpu_torch.models import int8_view, params_from_jax
from simxns_tpu_torch.train import (TrainState, make_adamw, make_ce_kd_step,
                                    make_kd_step)
from torch_parity import biencoder_pair, crossencoder_pair, jax_bert
from torch_parity import one_torch_thread  # noqa: F401

F32 = jnp.float32
N, M = 4, 3
TX = dict(lr=1e-3, total_steps=0, eps=1e-3)


@pytest.fixture(autouse=True)
def _interpret():
    old = jfl.INTERPRET
    jfl.INTERPRET = True
    yield
    jfl.INTERPRET = old


def _batch(seed, n=N, m=M, vocab=1024):
    """``tests/test_kd.py:_batch``: each query's first tokens shared with
    its positive passage."""
    rng = np.random.default_rng(seed)
    q = rng.integers(4, vocab, size=(n, 8)).astype(np.int32)
    ctx = rng.integers(4, vocab, size=(n * m, 12)).astype(np.int32)
    for i in range(n):
        ctx[i * m, :4] = q[i, :4]
    return {"q_ids": q, "q_mask": np.ones_like(q), "ctx_ids": ctx,
            "ctx_mask": np.ones_like(ctx),
            "positive_idx": (np.arange(n) * m).astype(np.int32),
            "joint_ids": rng.integers(4, vocab,
                                      size=(n, m, 16)).astype(np.int32),
            "joint_mask": np.ones((n, m, 16), np.int32)}


def _check(metrics, jmetrics):
    for got, want in zip(metrics, jmetrics):
        assert set(got) == set(want)
        for key, value in want.items():
            np.testing.assert_allclose(float(got[key]), float(value),
                                       rtol=1e-4, atol=1e-6, err_msg=key)


def _check_params(module, jparams):
    want = params_from_jax(jax.device_get(jparams))
    for name, p in module.named_parameters():
        err = float((p.detach() - want[name]).abs().max())
        assert err <= 1e-5, (name, err)


def _steps(jstep, step, jparams, port, jteachers, teachers, batches):
    """2 steps of each side from the same weights; -> (port metrics, JAX
    metrics, JAX params)."""
    jstate = JaxTrainState.create(jax.tree.map(jnp.copy, jparams),
                                  jmake_adamw(**TX))
    state = TrainState.create(port, make_adamw(**TX))
    metrics, jmetrics = [], []
    for b in batches:
        jstate, jm = jstep(jstate, jteachers, b)
        state, m = step(state, teachers, b)
        jmetrics.append(jax.device_get(jm))
        metrics.append(m)
    return metrics, jmetrics, jstate.params


def _models(seed):
    """(student pair, DE-teacher pair, CE-teacher pair): each a (JAX
    model, JAX params, port model)."""
    return (biencoder_pair(jax_bert(dtype=F32), seed=seed),
            biencoder_pair(jax_bert(dtype=F32), seed=seed + 1),
            crossencoder_pair(jax_bert(dtype=F32), seed=seed + 2))


@pytest.mark.parametrize("kd_type", ["KD_softmax", "KD_logit", "DKD",
                                     "Bi_logit"])
def test_de_teacher_kd_step_matches_jax(kd_type):
    (jmodel, params, port), (jde, de_params, pde), _ = _models(60)
    kw = dict(kd_type=kd_type, ce_weight=1.0, kd_weight=1.0,
              temperature=2.0)
    jstep = jmake_kd(jmodel, jmake_adamw(**TX), create_mesh(n_data=1),
                     "dual_encoder", de_teacher_model=jde, **kw)
    step = make_kd_step(make_adamw(**TX), "dual_encoder", device="cpu",
                        **kw)
    batches = [{k: v for k, v in _batch(s).items()
                if not k.startswith("joint")} for s in (1, 2)]
    metrics, jmetrics, jp = _steps(jstep, step, params, port,
                                   {"de": de_params}, {"de": pde}, batches)
    _check(metrics, jmetrics)
    _check_params(port, jp)


@pytest.mark.parametrize("kd_type", ["KD_softmax", "prob_loss"])
def test_ce_teacher_kd_with_lwf_matches_jax(kd_type):
    """The CE teacher with the LwF term against a frozen copy of the
    student at init."""
    (jmodel, params, port), _, (jce, ce_params, pce) = _models(70)
    init = copy.deepcopy(port)
    kw = dict(kd_type=kd_type, ce_weight=1.0, kd_weight=1.0,
              lwf_weight=0.5)
    jstep = jmake_kd(jmodel, jmake_adamw(**TX), create_mesh(n_data=1),
                     "cross_encoder", ce_teacher_model=jce, **kw)
    step = make_kd_step(make_adamw(**TX), "cross_encoder", device="cpu",
                        **kw)
    metrics, jmetrics, jp = _steps(
        jstep, step, params, port,
        {"ce": ce_params, "student_init": jax.tree.map(jnp.copy, params)},
        {"ce": pce, "student_init": init}, [_batch(3), _batch(4)])
    _check(metrics, jmetrics)
    assert float(metrics[1]["lwf_loss"]) > 0.0
    _check_params(port, jp)


def test_ce_teacher_kd_with_int8_teacher_view_matches_jax():
    """``--fast-teacher``: the CE teacher's forward through the fused-int8
    layer (JAX: ``layer_impl="fused_int8"`` interpreted; the port: its
    ``int8_view``, the plain int8 composition on the CPU)."""
    from simxns_tpu.models import CrossEncoder as JaxCrossEncoder
    from simxns_tpu.models import CrossEncoderConfig as JaxCrossEncoderConfig

    (jmodel, params, port), _, (_, ce_params, pce) = _models(80)
    jview = JaxCrossEncoder(JaxCrossEncoderConfig(
        bert=jax_bert(dtype=F32, layer_impl="fused_int8")))
    kw = dict(kd_type="KD_softmax", ce_weight=1.0, kd_weight=1.0)
    jstep = jmake_kd(jmodel, jmake_adamw(**TX), create_mesh(n_data=1),
                     "cross_encoder", ce_teacher_model=jview, **kw)
    step = make_kd_step(make_adamw(**TX), "cross_encoder", device="cpu",
                        **kw)
    metrics, jmetrics, jp = _steps(jstep, step, params, port,
                                   {"ce": ce_params}, {"ce": int8_view(pce)},
                                   [_batch(5), _batch(6)])
    _check(metrics, jmetrics)
    _check_params(port, jp)


def test_double_teacher_takes_max_matches_jax():
    (jmodel, params, port), (jde, de_params, pde), (jce, ce_params, pce) = \
        _models(90)
    kw = dict(kd_type="KD_softmax", ce_weight=1.0, kd_weight=1.0)
    jstep = jmake_kd(jmodel, jmake_adamw(**TX), create_mesh(n_data=1),
                     "double", de_teacher_model=jde, ce_teacher_model=jce,
                     **kw)
    step = make_kd_step(make_adamw(**TX), "double", device="cpu", **kw)
    metrics, jmetrics, jp = _steps(
        jstep, step, params, port, {"de": de_params, "ce": ce_params},
        {"de": pde, "ce": pce}, [_batch(7), _batch(8)])
    _check(metrics, jmetrics)
    _check_params(port, jp)


def test_colbert_teacher_waits_for_lead():
    """LEAD's ColBERT is ported (ROADMAP.md Queue 1 item 12): the
    ``colbert`` teacher type builds a step; an unknown type still
    raises."""
    assert callable(make_kd_step(make_adamw(**TX), "colbert", device="cpu"))
    with pytest.raises(ValueError, match="teacher_type"):
        make_kd_step(make_adamw(**TX), "triple", device="cpu")


@pytest.mark.parametrize("kd_type", ["KD_softmax", "DKD"])
def test_colbert_teacher_kd_step_matches_jax(kd_type):
    """``tests/test_kd.py:131``: a 2-layer ColBERT teacher (dim 16): its
    full-cross MaxSim scores over the in-batch [Q, C] matrix, the hard
    in-batch NLL beside the soft KD; the passage padding of one batch at
    -9999 in the teacher's scores."""
    from simxns_tpu.models import ColBERT as JColBERT
    from simxns_tpu.models import ColBERTConfig as JColBERTConfig
    from simxns_tpu_torch.models import ColBERT, ColBERTConfig
    from torch_parity import port_bert

    (jmodel, params, port), _, _ = _models(110)
    bert = jax_bert(dtype=F32)
    jcol = JColBERT(JColBERTConfig(bert=bert, dim=16))
    d = np.ones((2, 8), np.int32)
    c_params = jcol.init(jax.random.PRNGKey(4), d, d, d, d)
    col = ColBERT(ColBERTConfig(bert=port_bert(bert), dim=16))
    col.load_state_dict(params_from_jax(jax.device_get(c_params)))
    kw = dict(kd_type=kd_type, ce_weight=1.0, kd_weight=1.0,
              temperature=2.0)
    jstep = jmake_kd(jmodel, jmake_adamw(**TX), create_mesh(n_data=1),
                     "colbert", colbert_teacher_model=jcol, **kw)
    step = make_kd_step(make_adamw(**TX), "colbert", device="cpu", **kw)
    batches = [{k: v for k, v in _batch(s).items()
                if not k.startswith("joint")} for s in (11, 12)]
    batches[1]["ctx_mask"][:, 9:] = 0
    metrics, jmetrics, jp = _steps(jstep, step, params, port,
                                   {"colbert": c_params},
                                   {"colbert": col.eval()}, batches)
    _check(metrics, jmetrics)
    _check_params(port, jp)


def test_ce_to_ce_distillation_matches_jax():
    """Cross2Cross: a 1-layer CE student distils a 2-layer CE teacher."""
    jteacher, t_params, pteacher = crossencoder_pair(jax_bert(dtype=F32),
                                                     seed=100)
    jstudent, s_params, pstudent = crossencoder_pair(
        jax_bert(dtype=F32, num_layers=1), seed=101)
    jstep = jmake_ce_kd(jstudent, jmake_adamw(**TX), create_mesh(n_data=1),
                        teacher_ce=jteacher)
    step = make_ce_kd_step(make_adamw(**TX), device="cpu")
    batches = [{k: v for k, v in _batch(s).items() if k.startswith("joint")}
               for s in (9, 10)]
    metrics, jmetrics, jp = _steps(jstep, step, s_params, pstudent,
                                   t_params, pteacher, batches)
    _check(metrics, jmetrics)
    _check_params(pstudent, jp)


def test_division_matches_jax():
    """``tests/test_kd.py::test_division_buckets`` and
    ``::test_teacher_better_selection``, and a random ranking, against
    the JAX module."""
    ranked = {"a": [1, 2, 3], "b": [9, 1, 3], "c": list(range(100, 160)),
              "d": [7, 8, 9]}
    qrels = {"a": [1], "b": [1], "c": [155], "d": [1000]}
    rng = np.random.default_rng(0)
    for i in range(40):
        ranked[f"r{i}"] = [int(x) for x in rng.permutation(300)[:150]]
        qrels[f"r{i}"] = [int(x) for x in rng.integers(0, 300, 2)]
    got, want = division.divide_data(ranked, qrels), jdiv.divide_data(
        ranked, qrels)
    assert got == want
    assert got["top1"] >= {"a"} and "b" in got["2ti"] and "c" in \
        got["51t100"]
    assert all("d" not in s for s in got.values())
    assert division.first_relevant_rank([5, 6, 7], [7]) == 2
    assert division.first_relevant_rank([5, 6], [9]) == -1
    student = {"q1": [9, 1], "q2": [1, 9], "q3": [9, 8, 1]}
    teacher = {"q1": [1, 9], "q2": [1, 9], "q3": [1, 9]}
    rel = {"q1": [1], "q2": [1], "q3": [1]}
    assert division.teacher_better_qids(student, teacher, rel) == \
        jdiv.teacher_better_qids(student, teacher, rel) == {"q1", "q3"}

    class Ex:
        def __init__(self, q_id):
            self.q_id = q_id

    exs = [Ex(1), Ex("2"), Ex(3)]
    assert ([e.q_id for e in division.select_examples(exs, {"1", 2})]
            == [e.q_id for e in jdiv.select_examples(exs, {"1", 2})]
            == [1, "2"])
