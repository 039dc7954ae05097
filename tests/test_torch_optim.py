"""The port's AdamW, LAMB, schedule and decay mask against the JAX package
(optax), fed identical gradients."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simxns_tpu.train.optim import _decay_mask as jdecay_mask
from simxns_tpu.train.optim import linear_warmup_schedule as jschedule
from simxns_tpu.train.optim import make_adamw as jmake_adamw
from simxns_tpu.train.optim import make_lamb as jmake_lamb
from simxns_tpu_torch.models import params_from_jax
from simxns_tpu_torch.train import (linear_warmup_schedule, make_adamw,
                                    make_lamb)
from simxns_tpu_torch.train.optim import _decay_mask
from torch_parity import biencoder_pair, crossencoder_pair, jax_bert
from torch_parity import one_torch_thread  # noqa: F401


def test_schedule_matches_jax():
    for args in ((1.0, 10, 110), (3e-5, 0, 100), (1e-3, 7, 7)):
        want, got = jschedule(*args), linear_warmup_schedule(*args)
        for step in (0, 1, 5, 6, 7, 10, 60, 109, 110, 150):
            assert got(step) == pytest.approx(float(want(step)), rel=1e-6,
                                              abs=1e-12), (args, step)


@pytest.mark.parametrize("kind", ["biencoder", "crossencoder"])
def test_decay_mask_matches_jax(kind):
    """Leaf for leaf on converted trees: no decay for biases and LayerNorm
    parameters, decay for kernels and embedding tables."""
    if kind == "biencoder":
        _, params, port = biencoder_pair(jax_bert(), projection_dim=32)
    else:
        _, params, port = crossencoder_pair(jax_bert(), binary_head=True)
    want = {n: bool(v) for n, v in
            params_from_jax(jdecay_mask(params["params"])).items()}
    got = _decay_mask(n for n, _ in port.named_parameters())
    assert got == want
    assert not all(want.values()) and any(want.values())


def _tree():
    """Names as the port writes them, values from a seed; one leaf of each
    kind the decay mask tells apart."""
    rng = np.random.default_rng(0)
    shapes = {"enc.layers.0.attention.query.weight": (6, 5),
              "enc.layers.0.attention.query.bias": (6,),
              "enc.layers.0.attention.output_layer_norm.weight": (5,),
              "enc.embeddings.word_embeddings.weight": (9, 5),
              "qa_classifier.weight": (1, 5)}
    return {n: rng.normal(size=s).astype(np.float32)
            for n, s in shapes.items()}


def _nest(flat):
    """The flat dotted names as the nested tree the JAX mask walks."""
    tree = {}
    for name, val in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = val
    return tree


@pytest.mark.parametrize("warmup,total,grad_scale", [
    (0, 0, 0.1),        # constant lr, norm < 1: no clipping
    (0, 0, 3.0),        # clipping active every step
    (2, 6, 1.0),        # warmup: the first update is exactly 0
])
def test_adamw_matches_optax(warmup, total, grad_scale):
    """Five updates from the same gradients: rtol 1e-5, atol 1e-7."""
    params = _tree()
    rng = np.random.default_rng(1)
    grads = [{n: (rng.normal(size=p.shape) * grad_scale).astype(np.float32)
              for n, p in params.items()} for _ in range(5)]
    jtx = jmake_adamw(2e-2, warmup_steps=warmup, total_steps=total,
                      weight_decay=0.1)
    jparams = _nest({n: jnp.asarray(p) for n, p in params.items()})
    jstate = jtx.init(jparams)
    tx = make_adamw(2e-2, warmup_steps=warmup, total_steps=total,
                    weight_decay=0.1)
    tparams = {n: torch.from_numpy(p.copy()) for n, p in params.items()}
    tstate = tx.init(tparams)
    for i, g in enumerate(grads):
        upd, jstate = jtx.update(
            _nest({n: jnp.asarray(x) for n, x in g.items()}), jstate, jparams)
        jparams = jax.tree.map(jnp.add, jparams, upd)
        tx.update_(tparams, {n: torch.from_numpy(x) for n, x in g.items()},
                   tstate)
        for n in params:
            want = functools.reduce(lambda t, k: t[k], n.split("."), jparams)
            np.testing.assert_allclose(tparams[n].numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-7,
                                       err_msg=f"step {i} {n}")
        if i == 0 and warmup:
            assert all(np.array_equal(tparams[n].numpy(), params[n])
                       for n in params)
    assert tstate["count"] == 5


def test_missing_gradient_is_zero():
    """A parameter the loss does not reach still decays, as with JAX's
    dense zero gradient."""
    params = _tree()
    tx = make_adamw(1e-2, total_steps=0, weight_decay=0.5)
    tparams = {n: torch.from_numpy(p.copy()) for n, p in params.items()}
    state = tx.init(tparams)
    tx.update_(tparams, {}, state)
    name = "qa_classifier.weight"
    np.testing.assert_allclose(tparams[name].numpy(),
                               params[name] * (1 - 1e-2 * 0.5), rtol=1e-6)
    bias = "enc.layers.0.attention.query.bias"
    assert np.array_equal(tparams[bias].numpy(), params[bias])


@pytest.mark.parametrize("warmup,total,grad_scale", [(0, 0, 0.1),
                                                     (1, 6, 3.0)])
def test_lamb_matches_optax(warmup, total, grad_scale):
    """Three updates of ``make_lamb`` from the same gradients (rtol 1e-5,
    atol 1e-7): the clipping, ``optax.lamb``'s eps and trust ratio, the
    decay mask, and a leaf whose parameter and gradient are zero (both
    norms 0: trust ratio 1, it stays 0)."""
    params = _tree()
    params["enc.layers.0.attention.key.bias"] = np.zeros(6, np.float32)
    rng = np.random.default_rng(2)
    grads = [{n: (rng.normal(size=p.shape) * grad_scale).astype(np.float32)
              for n, p in params.items()} for _ in range(3)]
    for g in grads:
        g["enc.layers.0.attention.key.bias"][:] = 0.0
    jtx = jmake_lamb(2e-2, warmup_steps=warmup, total_steps=total,
                     weight_decay=0.1)
    jparams = _nest({n: jnp.asarray(p) for n, p in params.items()})
    jstate = jtx.init(jparams)
    tx = make_lamb(2e-2, warmup_steps=warmup, total_steps=total,
                   weight_decay=0.1)
    tparams = {n: torch.from_numpy(p.copy()) for n, p in params.items()}
    tstate = tx.init(tparams)
    for i, g in enumerate(grads):
        upd, jstate = jtx.update(
            _nest({n: jnp.asarray(x) for n, x in g.items()}), jstate, jparams)
        jparams = jax.tree.map(jnp.add, jparams, upd)
        tx.update_(tparams, {n: torch.from_numpy(x) for n, x in g.items()},
                   tstate)
        for n in params:
            want = functools.reduce(lambda t, k: t[k], n.split("."), jparams)
            np.testing.assert_allclose(tparams[n].numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-7,
                                       err_msg=f"step {i} {n}")
    assert not tparams["enc.layers.0.attention.key.bias"].any()
    moved = [n for n in params if not np.array_equal(tparams[n].numpy(),
                                                     params[n])]
    assert len(moved) == len(params) - 1
