"""LEAD in the port against the JAX package: the losses
(``losses/lead.py``), ColBERT and its step, the dual encoder's hidden
states, and the joint step (``train/lead.py``), on tiny f32 configs from
identical weights (the cases of ``tests/test_lead.py``,
``tests/test_models.py:110`` and ``tests/test_train.py:310``).

Tolerances: losses and metrics within 1e-4 relative (1e-5 for the loss
functions alone, on the same inputs); parameters within 1e-5 after 2 AdamW
steps at eps=1e-3 (``test_torch_train.py`` explains the eps); the layer
draws equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simxns_tpu.losses.lead as jl
import simxns_tpu.ops.fused_layer as jfl
from simxns_tpu.models import BiEncoder as JBiEncoder
from simxns_tpu.models import BiEncoderConfig as JBiEncoderConfig
from simxns_tpu.models import ColBERT as JColBERT
from simxns_tpu.models import ColBERTConfig as JColBERTConfig
from simxns_tpu.models import CrossEncoder as JCrossEncoder
from simxns_tpu.models import CrossEncoderConfig as JCrossEncoderConfig
from simxns_tpu.models.colbert import maxsim_score as jmaxsim
from simxns_tpu.models.colbert import maxsim_score_paired as jmaxsim_paired
from simxns_tpu.parallel import create_mesh
from simxns_tpu.train import LeadConfig as JLeadConfig
from simxns_tpu.train import TrainState as JTrainState
from simxns_tpu.train import make_adamw as jmake_adamw
from simxns_tpu.train import make_lead_step as jmake_lead_step
from simxns_tpu.train.lead import ce_attention_targets as jce_targets
from simxns_tpu_torch.losses import lead as pl
from simxns_tpu_torch.models import (BiEncoder, BiEncoderConfig, ColBERT,
                                     ColBERTConfig, CrossEncoder,
                                     CrossEncoderConfig, int8_view,
                                     maxsim_score, maxsim_score_paired,
                                     params_from_jax)
from simxns_tpu_torch.train import (LeadConfig, TrainState, make_adamw,
                                    make_colbert_step, make_lead_step)
from simxns_tpu_torch.train.lead import ce_attention_targets
from torch_parity import jax_bert, port_bert, token_batch
from torch_parity import one_torch_thread  # noqa: F401

F32 = jnp.float32
T = torch.from_numpy


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


# --- the losses ---------------------------------------------------------------

def test_batchmean_kl_and_pair_kl_match_jax_and_torch():
    """``batchmean_kl`` is torch's ``kl_div(reduction='batchmean')``;
    ``pair_kl`` scales the teacher side only."""
    rng = np.random.default_rng(0)
    s = rng.normal(size=(4, 6)).astype(np.float32)
    t = rng.normal(size=(4, 6)).astype(np.float32)
    log_s = torch.log_softmax(T(s), -1)
    p_t = torch.softmax(T(t), -1)
    got = pl.batchmean_kl(log_s, p_t)
    _close(got, torch.nn.functional.kl_div(log_s, p_t,
                                           reduction="batchmean"))
    _close(got, jl.batchmean_kl(jnp.asarray(log_s.numpy()),
                                jnp.asarray(p_t.numpy())))
    _close(pl.pair_kl(T(s), T(t), 2.0), jl.pair_kl(s, t, 2.0))


def test_grouped_slice_matches_jax():
    scores = np.arange(3 * 2 * 6, dtype=np.float32).reshape(3, 2, 6)
    np.testing.assert_array_equal(pl.grouped_slice(T(scores[0]), 3).numpy(),
                                  [[0, 1, 2], [9, 10, 11]])
    want = jax.vmap(jl.grouped_slice, in_axes=(0, None))(scores, 3)
    np.testing.assert_array_equal(pl.grouped_slice(T(scores), 3).numpy(),
                                  np.asarray(want))


@pytest.mark.parametrize("reweight,layer_t", [(True, 0.1), (True, 1.0),
                                              (False, 1.0)])
def test_layer_score_distill_loss_matches_jax(reweight, layer_t):
    """The reweighting of ``tests/test_lead.py``: a confident correct
    teacher layer and a noise layer; the loss, the per-layer KL and no
    gradient to the teacher."""
    rng = np.random.default_rng(1)
    q, c = 8, 4
    good = np.full((q, c), -3.0)
    good[:, 0] = 3.0
    t_scores = np.stack([good, rng.normal(size=(q, c)) * 0.1]).astype(
        np.float32)
    s_scores = rng.normal(size=(2, q, c)).astype(np.float32)
    target = np.zeros(q, np.int32)
    want = jl.layer_score_distill_loss(t_scores, s_scores, target, 1.0,
                                       layer_t, reweight, 0.7)
    tt = T(t_scores).requires_grad_()
    ss = T(s_scores).requires_grad_()
    got = pl.layer_score_distill_loss(tt, ss, T(target), 1.0, layer_t,
                                      reweight, 0.7)
    _close(got[0].detach(), want[0])
    _close(got[1].detach(), want[1])
    got[0].backward()
    assert tt.grad is None and float(ss.grad.abs().max()) > 0


def test_attention_maps_virt_and_map_kl_match_jax():
    rng = np.random.default_rng(2)
    L, Q, D, Sq, Sd, H = 2, 2, 3, 4, 5, 8
    qh = rng.normal(size=(L, Q, Sq, H)).astype(np.float32)
    dh = rng.normal(size=(L, D, Sd, H)).astype(np.float32)
    q_len, d_len = np.asarray([2, 4]), np.asarray([5, 3, 1])
    maps = pl.query_doc_attention_maps(T(qh), T(dh), T(q_len), T(d_len))
    _close(maps, jl.query_doc_attention_maps(qh, dh, q_len, d_len))
    # rows past q_len are uniform for any hiddens: 0 to the virt MSE
    qh2 = qh.copy()
    qh2[:, 0, 3] = 123.0
    maps2 = pl.query_doc_attention_maps(T(qh2), T(dh), T(q_len), T(d_len))
    assert float(pl.virt_loss(maps, maps2)) < 1e-10
    delta = maps + 0.01
    _close(pl.virt_loss(maps, delta, 2.0),
           jl.virt_loss(maps.numpy(), delta.numpy(), 2.0))
    s = rng.normal(size=(3, Sq, Sd)).astype(np.float32)
    t = rng.normal(size=(3, Sq, Sd)).astype(np.float32)
    qv = (np.arange(Sq)[None] < np.asarray([1, 3, 4])[:, None])
    dv = (np.arange(Sd)[None] < np.asarray([5, 2, 0])[:, None])
    _close(pl.attention_map_kl(T(s), T(t), T(qv), T(dv)),
           jl.attention_map_kl(s, t, qv, dv))


@pytest.mark.parametrize("mode", ["random", "last", "skip"])
def test_select_layers_draws_the_jax_layers(mode):
    """The same numpy Generator draws the JAX run's layers, draw after
    draw (the re-draw every save_steps replays on a resume)."""
    a, b = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(4):
        assert pl.select_layers(a, 6, 12, 4, mode) == jl.select_layers(
            b, 6, 12, 4, mode)
    s, t = pl.select_layers(a, 6, 12, 5, mode)
    assert len(s) == len(t) == 5 and s == sorted(s)
    with pytest.raises(ValueError, match="unknown layer selection"):
        pl.select_layers(a, 6, 12, 2, "middle")


def test_ce_attention_targets_match_jax():
    """The (row, col) contract: teacher row 1+i, column q_len+j, valid
    region the content tokens; heads averaged."""
    rng = np.random.default_rng(4)
    att = rng.random((2, 4, 3, 12, 12)).astype(np.float32)
    q_len = np.asarray([4, 6], np.int32)
    d_len = np.asarray([5, 3, 9, 2], np.int32)
    got = ce_attention_targets(T(att), T(q_len), T(d_len), 5, 7)
    want = jce_targets(jnp.asarray(att), jnp.asarray(q_len),
                       jnp.asarray(d_len), 5, 7)
    _close(got[0], want[0], rtol=1e-6, atol=0)    # the head mean's rounding
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# --- the models ---------------------------------------------------------------

def _colbert_pair(bert, seed, **kw):
    jmodel = JColBERT(JColBERTConfig(bert=bert, **kw))
    d = np.ones((2, 8), np.int32)
    params = jmodel.init(jax.random.PRNGKey(seed), d, d, d, d)
    port = ColBERT(ColBERTConfig(bert=port_bert(bert), **kw))
    port.load_state_dict(params_from_jax(jax.device_get(params)))
    return jmodel, params, port.eval()


@pytest.mark.parametrize("similarity,share", [("cosine", True),
                                              ("l2", False)])
def test_colbert_maxsim_matches_jax(similarity, share):
    """``tests/test_models.py:110``: query tokens unit-norm at every
    position, padding included (the reference's unmasked query side), doc
    padding zero; MaxSim and its paired form; both metrics, with and
    without a shared tower (``doc_encoder``)."""
    jmodel, params, port = _colbert_pair(jax_bert(dtype=F32), 15, dim=32,
                                         similarity=similarity,
                                         share_weight=share)
    assert hasattr(port, "doc_encoder") is not share
    rng = np.random.default_rng(5)
    ids, mask = token_batch(rng, 4, 16)
    mask[:, 8:] = 0
    ids = ids * mask
    jq, jd = jmodel.apply(params, ids, mask, ids, mask)
    with torch.no_grad():
        q, d = port(T(ids).long(), T(mask), T(ids).long(), T(mask))
    _close(q, jq)
    _close(d, jd)
    if similarity == "cosine":
        _close(q.norm(dim=-1), np.ones((4, 16)), atol=1e-3)
        _close(d.norm(dim=-1)[:, 8:], np.zeros((4, 8)))
    scores = maxsim_score(q, d, similarity)
    _close(scores, jmaxsim(jq, jd, similarity), rtol=1e-5, atol=1e-4)
    _close(maxsim_score_paired(q, d, similarity),
           jmaxsim_paired(jq, jd, similarity), rtol=1e-5, atol=1e-4)
    _close(torch.diagonal(scores), maxsim_score_paired(q, d, similarity),
           atol=1e-4)


def test_biencoder_hidden_states_match_jax():
    """``encode_query``/``encode_passage(output_hidden_states=True)`` ->
    (embedding, encoder output): every layer's hiddens, the embeddings'
    first."""
    bert = jax_bert(dtype=F32)
    jmodel = JBiEncoder(JBiEncoderConfig(bert=bert))
    d = np.ones((2, 8), np.int32)
    params = jmodel.init(jax.random.PRNGKey(6), d, d, d, d)
    port = BiEncoder(BiEncoderConfig(bert=port_bert(bert)))
    port.load_state_dict(params_from_jax(jax.device_get(params)))
    ids, mask = token_batch(np.random.default_rng(6), 3, 10)
    for method in ("encode_query", "encode_passage"):
        jemb, jout = jmodel.apply(params, ids, mask, method=method,
                                  output_hidden_states=True)
        with torch.no_grad():
            emb, out = getattr(port, method)(T(ids).long(), T(mask),
                                             output_hidden_states=True)
            plain = getattr(port, method)(T(ids).long(), T(mask))
        _close(emb, jemb)
        assert torch.equal(emb, plain)
        assert len(out.hidden_states) == len(jout.hidden_states) == 3
        for h, jh in zip(out.hidden_states, jout.hidden_states):
            _close(h, jh, atol=1e-5)


def _tx():
    kw = dict(lr=1e-3, total_steps=0, eps=1e-3)
    return jmake_adamw(**kw), make_adamw(**kw)


def _check_params(module, jparams, tol=1e-5):
    want = params_from_jax(jax.device_get(jparams))
    for name, p in module.named_parameters():
        err = float((p.detach() - want[name]).abs().max())
        assert err <= tol, (name, err)


def test_colbert_step_matches_jax_and_trains():
    """``tests/test_train.py:310``: 8 in-batch MaxSim steps from the same
    weights: each loss and ``correct`` as JAX's, the parameters after
    them, and the loss falls."""
    from simxns_tpu.train import make_colbert_step as jmake_colbert

    jmodel, params, port = _colbert_pair(jax_bert(dtype=F32), 0, dim=16)
    rng = np.random.default_rng(11)
    n, m = 16, 2
    q = rng.integers(4, 512, size=(n, 8)).astype(np.int32)
    ctx = rng.integers(4, 512, size=(n * m, 10)).astype(np.int32)
    for i in range(n):
        ctx[i * m, :4] = q[i, :4]
    batch = {"q_ids": q, "q_mask": np.ones_like(q), "ctx_ids": ctx,
             "ctx_mask": np.ones_like(ctx)}
    jtx, tx = _tx()
    jstate = JTrainState.create(jax.tree.map(jnp.copy, params), jtx)
    jstep = jmake_colbert(jmodel, jtx, create_mesh(n_data=1), group_size=m)
    state = TrainState.create(port.train(), tx)
    step = make_colbert_step(tx, device="cpu", group_size=m)
    losses = []
    for _ in range(8):
        jstate, jm = jstep(jstate, batch)
        state, tm = step(state, batch)
        _close(tm["loss"], jm["loss"], rtol=1e-4)
        assert int(tm["correct"]) == int(jm["correct"])
        losses.append(float(tm["loss"]))
    _check_params(port, jstate.params)
    assert losses[-1] < losses[0]
    assert int(tm["correct"]) >= 12


# --- the joint step -------------------------------------------------------------

def _lead_batch(seed, n=4, m=2):
    rng = np.random.default_rng(seed)
    q_ids, q_mask = token_batch(rng, n, 8)
    ctx_ids, ctx_mask = token_batch(rng, n * m, 10)
    for i in range(n):
        ctx_ids[i * m, 1:4] = q_ids[i, 1:4]
        ctx_mask[i * m, :4] = 1
    joint_ids, joint_mask = token_batch(rng, n * m, 14)
    return {"q_ids": q_ids, "q_mask": q_mask, "ctx_ids": ctx_ids,
            "ctx_mask": ctx_mask,
            "positive_idx": (np.arange(n) * m).astype(np.int32),
            "joint_ids": joint_ids.reshape(n, m, 14),
            "joint_mask": joint_mask.reshape(n, m, 14)}


def _lead_models(names, seed=0):
    """{name: (jax model, jax params, port model)} with identical weights:
    db a 1-layer dual encoder, de a 2-layer one, col a 1-layer ColBERT
    (dim 16), ce a 2-layer CE with per-layer logits."""
    bert = jax_bert(dtype=F32)
    d = np.ones((2, 8), np.int32)
    out = {}
    for i, name in enumerate(names):
        key = jax.random.PRNGKey(seed + i)
        if name in ("db", "de"):
            b = bert.replace(num_layers=1) if name == "db" else bert
            jm = JBiEncoder(JBiEncoderConfig(bert=b))
            params = jm.init(key, d, d, d, d)
            port = BiEncoder(BiEncoderConfig(bert=port_bert(b)))
        elif name == "col":
            b = bert.replace(num_layers=1)
            jm = JColBERT(JColBERTConfig(bert=b, dim=16))
            params = jm.init(key, d, d, d, d)
            port = ColBERT(ColBERTConfig(bert=port_bert(b), dim=16))
        else:
            jm = JCrossEncoder(JCrossEncoderConfig(bert=bert,
                                                   per_layer_logits=True))
            params = jm.init(key, d, d)
            port = CrossEncoder(CrossEncoderConfig(bert=port_bert(bert),
                                                   per_layer_logits=True))
        port.load_state_dict(params_from_jax(jax.device_get(params)))
        out[name] = (jm, params, port)
    return out


def _run_both(models, cfg, batches, sels, frozen=None, jfrozen=None,
              losses=None):
    """The JAX and the port joint steps over ``batches`` with the layer
    selections ``sels``: each step's metrics within 1e-4 relative; ->
    (jax states, port states, the port's last metrics)."""
    jtx, tx = _tx()
    jstates = {k: JTrainState.create(jax.tree.map(jnp.copy, p), jtx)
               for k, (_, p, _) in models.items()}
    states = {k: TrainState.create(port, tx)
              for k, (_, _, port) in models.items()}
    jstep = jmake_lead_step({k: jm for k, (jm, _, _) in models.items()},
                            {k: jtx for k in models}, create_mesh(n_data=1),
                            JLeadConfig(**cfg), num_distill_layers=1,
                            frozen_views=jfrozen)
    step = make_lead_step({k: port for k, (_, _, port) in models.items()},
                          {k: tx for k in models}, LeadConfig(**cfg),
                          frozen_views=frozen,
                          device="cpu")
    for b, (sel_s, sel_t) in zip(batches, sels):
        jstates, jm = jstep(jstates, b, jnp.asarray(sel_s, jnp.int32),
                            jnp.asarray(sel_t, jnp.int32))
        states, tm = step(states, b, sel_s, sel_t)
        if losses is not None:
            losses.append(float(tm["loss"]))
        assert set(tm) == set(jm)
        for key in jm:
            _close(tm[key], jm[key], rtol=1e-4, atol=1e-6)
    return jstates, states, tm


def test_lead_step_four_models_matches_jax():
    """``tests/test_lead.py:158``: db, de, col and ce, db and de trained,
    every loss term on (layer scores, VIRT maps, the CE attention-map KL):
    every metric of 2 steps, the trained parameters after them, and the
    frozen ones untouched."""
    models = _lead_models(("db", "de", "col", "ce"))
    cfg = dict(distill_db=True, distill_de=True, distill_col=True,
               distill_ce=True, train_db=True, train_de=True,
               layer_score=True, attention=True)
    frozen_before = {k: {n: p.detach().clone() for n, p in
                         models[k][2].named_parameters()}
                     for k in ("col", "ce")}
    jstates, states, metrics = _run_both(
        models, cfg, [_lead_batch(7), _lead_batch(8)],
        [([0], [1]), ([0], [0])])
    for key in ("loss_db", "loss_de", "loss_de_db_dis", "loss_db_de_dis",
                "loss_ce_db_dis", "loss_col_db_dis", "loss_de_db_layer_dis",
                "loss_ce_db_layer_dis", "loss_de_db_attention",
                "loss_ce_db_attention_map"):
        assert key in metrics, key
    for k in ("db", "de"):
        assert states[k].step == 2 and int(jstates[k].step) == 2
        _check_params(models[k][2], jstates[k].params)
    for k in ("col", "ce"):
        assert states[k].step == 0
        for n, p in models[k][2].named_parameters():
            assert torch.equal(p.detach(), frozen_before[k][n])


def test_lead_step_layer_redraw_without_rebuilding():
    """``tests/test_lead.py:205``: one step object across the selections
    [0], [1], [0] (the re-draw is data: no rebuild), each step's loss as
    JAX's; the two draws give different losses."""
    models = _lead_models(("db", "de"), seed=3)
    losses = []
    jstates, _, _ = _run_both(
        models, dict(train_db=True, layer_score=True), [_lead_batch(9)] * 3,
        [([0], [0]), ([0], [1]), ([0], [0])], losses=losses)
    _check_params(models["db"][2], jstates["db"].params)
    assert len(losses) == 3 and losses[1] != losses[0]


def test_frozen_ce_int8_view_gives_every_layer_logit():
    """A frozen CE with per-layer logits through its fused-int8 view
    (``run_lead --freeze-teachers --fast-teacher``) against JAX's view run
    in interpret mode: the joint step's metrics, the per-layer logits of
    the view; a view of a TRAINED model is refused with JAX's message."""
    old = jfl.INTERPRET
    jfl.INTERPRET = True
    try:
        models = _lead_models(("db", "ce"), seed=5)
        jce, jparams, ce = models["ce"]
        view = int8_view(ce)
        jview = JCrossEncoder(JCrossEncoderConfig(
            bert=jce.cfg.bert.replace(layer_impl="fused_int8"),
            per_layer_logits=True))
        b = _lead_batch(10)
        n, m, lj = b["joint_ids"].shape
        ids, mask = (b[k].reshape(n * m, lj) for k in ("joint_ids",
                                                       "joint_mask"))
        want = jview.apply(jparams, ids, mask, group_size=m)
        with torch.no_grad():
            got = view(T(ids).long(), T(mask), group_size=m)
        _close(got["per_layer_logits"], want["per_layer_logits"],
               rtol=1e-4, atol=1e-5)
        _close(got["logits"], got["per_layer_logits"][-1])
        _run_both(models, dict(distill_ce=True, distill_de=False,
                               train_db=True, layer_score=True),
                  [b, _lead_batch(11)], [([0], [1]), ([0], [0])],
                  frozen={"ce": view}, jfrozen={"ce": jview})
    finally:
        jfl.INTERPRET = old
    with pytest.raises(ValueError, match="model is TRAINED"):
        make_lead_step({"db": models["db"][2], "ce": ce}, {},
                       LeadConfig(distill_ce=True, train_ce=True),
                       frozen_views={"ce": view}, device="cpu")
