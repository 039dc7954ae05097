"""Train mode (dropout) of the port against the JAX package: the three step
factories with ``dropout=True``, from identical weights and identical masks.

Both packages get the same masks in call order: the JAX package's
``jax.random.bernoulli`` (flax ``Dropout`` and the probabilities' dropout
of ``ops/attention.py``) and the port's one mask function
(``simxns_tpu_torch.ops.dropout.keep_mask``) are replaced, inside the test,
by draws from two numpy streams at the same seed. The masks' shapes, in
call order, must agree too. Tolerances as ``test_torch_train.py``:
gradients to 1e-4 of the largest one (f32 rounding), losses to 1e-4
relative, parameters after one AdamW step (eps=1e-3) to 1e-5.

Then the port alone: masks replay under ``remat=True`` (both policies),
steps are reproducible from their seed, and the attention kernels run
exactly where JAX runs its attention kernels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simxns_tpu.ops.flash_attention as jfa
from simxns_tpu.losses.contrastive import grouped_nll as jgrouped
from simxns_tpu.losses.contrastive import in_batch_nll as jin_batch
from simxns_tpu.losses.distill import ar2_retriever_loss as jar2
from simxns_tpu.parallel import create_mesh
from simxns_tpu.train import TrainState as JaxTrainState
from simxns_tpu.train import make_adamw as jmake_adamw
from simxns_tpu.train import make_ar2_retriever_step as jmake_ar2
from simxns_tpu.train import make_biencoder_step as jmake_de
from simxns_tpu.train import make_reranker_step as jmake_ce
from simxns_tpu_torch.models import int8_view, params_from_jax
from simxns_tpu_torch.ops import dropout as pdrop
from simxns_tpu_torch.ops import flash_attention as pfa
from simxns_tpu_torch.train import (TrainState, make_adamw,
                                    make_ar2_retriever_step,
                                    make_biencoder_step, make_reranker_step)
from simxns_tpu_torch.train import steps
from torch_parity import (biencoder_pair, crossencoder_pair, jax_bert,
                          token_batch)
from torch_parity import one_torch_thread  # noqa: F401

N, M = 2, 3
F32 = jnp.float32
DROP = dict(hidden_dropout=0.1, attention_dropout=0.1)


@pytest.fixture(autouse=True)
def _interpret():
    old = jfa.INTERPRET
    jfa.INTERPRET = True
    yield
    jfa.INTERPRET = old


class SharedMasks:
    """Replaces both packages' mask draws by two numpy streams at one seed
    (:meth:`reset`); records the shapes each side asked for."""

    def __init__(self, monkeypatch):
        self.monkeypatch = monkeypatch

    def reset(self, seed):
        jrng, prng = np.random.default_rng(seed), np.random.default_rng(seed)
        self.jax_shapes, self.port_shapes = [], []

        def bernoulli(key, p=0.5, shape=None):
            self.jax_shapes.append(tuple(shape))
            return jrng.random(tuple(shape)) < p

        def keep_mask(gen, keep_prob, shape, device):
            assert isinstance(gen, torch.Generator)
            self.port_shapes.append(tuple(shape))
            return torch.from_numpy(prng.random(tuple(shape)) < keep_prob)

        self.monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
        self.monkeypatch.setattr(pdrop, "keep_mask", keep_mask)

    def check(self, count):
        assert self.jax_shapes == self.port_shapes
        assert len(self.port_shapes) == count


@pytest.fixture
def masks(monkeypatch):
    return SharedMasks(monkeypatch)


def _batch(seed):
    rng = np.random.default_rng(seed)
    q_ids, q_mask = token_batch(rng, N, 8)
    ctx_ids, ctx_mask = token_batch(rng, N * M, 12)
    joint_ids, joint_mask = token_batch(rng, N * M, 20)
    return {"q_ids": q_ids, "q_mask": q_mask, "ctx_ids": ctx_ids,
            "ctx_mask": ctx_mask,
            "positive_idx": (np.arange(N) * M).astype(np.int32),
            "joint_ids": joint_ids.reshape(N, M, 20),
            "joint_mask": joint_mask.reshape(N, M, 20)}


def _check_grads(port_grads, jax_grads, rel=1e-4):
    want = params_from_jax(jax.device_get(jax_grads))
    assert set(want) == set(port_grads)
    scale = max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        g = port_grads[name]
        g = torch.zeros_like(w) if g is None else g.float()
        err = float((g - w).abs().max())
        assert err <= rel * scale, (name, err)


def _check_step(masks, count, jstep, tstep, jstate, tstate, batch,
                jextra=(), textra=()):
    masks.reset(7)
    jstate, jm = jstep(jstate, *jextra, batch)
    tstate, tm = tstep(tstate, *textra, batch)
    masks.check(count)
    got, want = float(tm["loss"]), float(jm["loss"])
    assert abs(got - want) <= 1e-4 * abs(want)
    want_p = params_from_jax(jax.device_get(jstate.params))
    for name, p in tstate.module.named_parameters():
        err = float((p.detach() - want_p[name]).abs().max())
        assert err <= 1e-5, (name, err)


def _tx():
    kw = dict(lr=1e-3, total_steps=0, eps=1e-3)
    return jmake_adamw(**kw), make_adamw(**kw)


RNGS = {"dropout": jax.random.PRNGKey(0)}


def test_biencoder_step_with_dropout_matches_jax(masks):
    """Question tower, then context tower: the embeddings' mask and each
    layer's three (probabilities, attention output, FFN output)."""
    jmodel, params, port = biencoder_pair(jax_bert(dtype=F32, **DROP),
                                          seed=31)
    b0 = _batch(0)

    def jloss(p):
        q, c = jmodel.apply(p, b0["q_ids"], b0["q_mask"], b0["ctx_ids"],
                            b0["ctx_mask"], deterministic=False, rngs=RNGS)
        return jin_batch(q, c, jnp.asarray(b0["positive_idx"]),
                         score_scale=2.0)[0]

    masks.reset(3)
    want = jax.grad(jloss)(params)
    loss, _ = steps.biencoder_loss(port, steps.to_device(b0, "cpu"),
                                   score_scale=2.0,
                                   generator=torch.Generator())
    _check_grads(steps.gradients(port, loss), want)
    masks.check(2 * (1 + 3 * 2))

    jtx, tx = _tx()
    jstate = JaxTrainState.create(jax.tree.map(jnp.copy, params), jtx)
    _check_step(masks, 14,
                jmake_de(jmodel, jtx, create_mesh(n_data=1), score_scale=2.0,
                         dropout=True),
                make_biencoder_step(tx, device="cpu", score_scale=2.0,
                                    dropout=True),
                jstate, TrainState.create(port, tx), b0)


@pytest.mark.parametrize("rates,group", [((0.1, 0.1), None),
                                         ((0.1, 0.0), "group")])
def test_reranker_step_with_dropout_matches_jax(masks, rates, group):
    """With attention dropout both sides take the plain attention; with
    only hidden dropout the grouped attention still runs (JAX: its kernel
    in interpret mode; the port: K5/K6's plain versions), and no mask is
    drawn for the probabilities."""
    cfg = jax_bert(dtype=F32, small_s_attn=group, hidden_dropout=rates[0],
                   attention_dropout=rates[1])
    jmodel, params, port = crossencoder_pair(cfg, seed=32)
    b0 = _batch(1)
    per_layer = 3 if rates[1] else 2

    def jloss(p):
        logits = jmodel.apply(p, b0["joint_ids"].reshape(N * M, -1),
                              b0["joint_mask"].reshape(N * M, -1),
                              group_size=M, deterministic=False,
                              rngs=RNGS)["logits"]
        return jgrouped(logits)

    masks.reset(4)
    want = jax.grad(jloss)(params)
    loss, _ = steps.reranker_loss(port, steps.to_device(b0, "cpu"),
                                  generator=torch.Generator())
    _check_grads(steps.gradients(port, loss), want)
    masks.check(1 + per_layer * 2)

    jtx, tx = _tx()
    jstate = JaxTrainState.create(jax.tree.map(jnp.copy, params), jtx)
    _check_step(masks, 1 + per_layer * 2,
                jmake_ce(jmodel, jtx, create_mesh(n_data=1), group_size=M,
                         dropout=True),
                make_reranker_step(tx, device="cpu", dropout=True),
                jstate, TrainState.create(port, tx), b0)


def test_retriever_step_with_dropout_matches_jax(masks):
    """The retriever trains in train mode; the frozen teacher draws no
    mask (eval mode on both sides)."""
    jde, de_params, port_de = biencoder_pair(jax_bert(dtype=F32, **DROP),
                                             seed=33)
    jce, ce_params, port_ce = crossencoder_pair(jax_bert(dtype=F32, **DROP),
                                                seed=34)
    b0 = _batch(2)
    kw = dict(temperature=0.8, adv_lambda=0.0)

    def jloss(p):
        q, c = jde.apply(p, b0["q_ids"], b0["q_mask"], b0["ctx_ids"],
                         b0["ctx_mask"], deterministic=False, rngs=RNGS)
        scores = jnp.einsum("bh,bmh->bm", q, c.reshape(N, M, -1))
        logits = jce.apply(ce_params, b0["joint_ids"].reshape(N * M, -1),
                           b0["joint_mask"].reshape(N * M, -1),
                           group_size=M)["logits"]
        return jar2(scores, logits, **kw)[0]

    masks.reset(5)
    want = jax.grad(jloss)(de_params)
    loss, _ = steps.retriever_loss(port_de, port_ce,
                                   steps.to_device(b0, "cpu"), **kw,
                                   generator=torch.Generator())
    _check_grads(steps.gradients(port_de, loss), want)
    masks.check(14)

    jtx, tx = _tx()
    jstate = JaxTrainState.create(jax.tree.map(jnp.copy, de_params), jtx)
    _check_step(masks, 14,
                jmake_ar2(jde, jce, jtx, create_mesh(n_data=1), dropout=True,
                          **kw),
                make_ar2_retriever_step(tx, device="cpu", dropout=True, **kw),
                jstate, TrainState.create(port_de, tx), b0,
                jextra=(ce_params,), textra=(port_ce,))


def _flat_grads(model, batch, gen):
    loss, _ = steps.reranker_loss(model, batch, generator=gen)
    grads = steps.gradients(model, loss)
    return float(loss.detach()), torch.cat(
        [g.flatten() for g in grads.values() if g is not None])


@pytest.mark.parametrize("policy", [None, "dots"])
def test_masks_replay_under_remat(policy):
    """A checkpointed layer builds its generator from its seed inside the
    recomputed function, so the recompute draws the masks of the forward:
    the loss and every gradient equal those without remat, exactly."""
    _, _, port = crossencoder_pair(jax_bert(dtype=F32, **DROP), seed=35)
    remat = crossencoder_pair(jax_bert(dtype=F32, remat=True,
                                       remat_policy=policy, **DROP),
                              seed=35)[2]
    batch = steps.to_device(_batch(3), "cpu")
    loss, grads = _flat_grads(port, batch, torch.Generator().manual_seed(9))
    loss_r, grads_r = _flat_grads(remat, batch,
                                  torch.Generator().manual_seed(9))
    assert loss == loss_r
    assert torch.equal(grads, grads_r)
    # and the masks matter: another seed moves the loss
    assert _flat_grads(port, batch,
                       torch.Generator().manual_seed(10))[0] != loss


def test_step_masks_come_from_seed_and_step():
    """Two runs of the factory at one seed give the same losses; each step
    draws fresh masks (the generator is a function of (seed, step))."""
    losses = []
    for _ in range(2):
        _, _, port = crossencoder_pair(jax_bert(dtype=F32, **DROP), seed=36)
        tx = make_adamw(0.0, total_steps=0)
        state = TrainState.create(port, tx)
        step = make_reranker_step(tx, device="cpu", dropout=True,
                                  dropout_seed=5)
        losses.append([float(step(state, _batch(4))[1]["loss"])
                       for _ in range(3)])
    assert losses[0] == losses[1]
    assert len(set(losses[0])) == 3          # lr 0: only the masks change
    g1 = steps.dropout_generator(True, 5, 1)
    g2 = steps.dropout_generator(True, 5, 1)
    assert torch.equal(torch.rand(4, generator=g1), torch.rand(4, generator=g2))
    assert steps.dropout_generator(False, 5, 1) is None


def test_dropout_seed_step_and_rank_each_change_the_masks():
    """The step's generator depends on the seed (ROADMAP.md Queue 3 item 6:
    the CPU generator keeps only the low 32 bits of its seed, and
    ``(seed << 32) + step`` lost the seed): the step kinds' seeds (0, 1,
    2) draw different masks at one step, and seed, step and rank each
    change them; rank 0 draws the single-device masks."""
    def draw(seed, step, rank=0):
        return tuple(torch.rand(16, generator=steps.dropout_generator(
            True, seed, step, rank)).tolist())

    assert len({draw(seed, 7) for seed in (0, 1, 2)}) == 3
    base = draw(5, 3)
    for other in (draw(6, 3), draw(5 + (1 << 32), 3), draw(5, 4),
                  draw(5, 3, 1)):
        assert other != base
    assert draw(5, 3, 0) == base == draw(5, 3)
    # through a model: two seeds, one step, different train-mode outputs
    _, _, port = crossencoder_pair(jax_bert(dtype=F32, **DROP), seed=36)
    b = steps.to_device(_batch(4), "cpu")
    n, m, lj = b["joint_ids"].shape
    out = [port(b["joint_ids"].reshape(n * m, lj),
                b["joint_mask"].reshape(n * m, lj),
                generator=steps.dropout_generator(True, seed, 0))["logits"]
           for seed in (1, 2)]
    assert not torch.equal(out[0], out[1])


def test_attention_kernels_run_where_jax_runs_them(monkeypatch):
    """Train mode with attention dropout takes the plain attention (flash
    never materialises p); with hidden dropout alone, and in eval mode,
    the grouped attention runs. A fused-int8 view gives way to the
    standard composition in train mode (a call with a generator)."""
    calls = []
    flash = pfa.flash_attention

    def counting(*args, **kw):
        calls.append(1)
        return flash(*args, **kw)

    monkeypatch.setattr(pfa, "flash_attention", counting)
    batch = _batch(5)
    ids = torch.from_numpy(batch["joint_ids"].reshape(N * M, -1))
    mask = torch.from_numpy(batch["joint_mask"].reshape(N * M, -1))
    for rates, want in (((0.1, 0.1), 0), ((0.1, 0.0), 2)):
        _, _, port = crossencoder_pair(jax_bert(
            dtype=F32, small_s_attn="group", hidden_dropout=rates[0],
            attention_dropout=rates[1]), seed=37)
        calls.clear()
        port(ids, mask, generator=torch.Generator())
        assert len(calls) == want
        calls.clear()
        port(ids, mask)
        assert len(calls) == 2
    _, _, port = crossencoder_pair(jax_bert(dtype=F32), seed=38)
    view = int8_view(port)
    with torch.no_grad():
        got = view(ids, mask, generator=torch.Generator())["logits"]
        assert torch.equal(got, port(ids, mask)["logits"])
        assert not torch.equal(view(ids, mask)["logits"], got)
