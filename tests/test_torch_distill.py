"""The port's PROD distillation losses against the JAX package's
(``simxns_tpu/losses/distill.py:62-183``), on the inputs and properties of
``tests/test_losses.py:80-159``: the same numpy inputs through both, each
value within 1e-6 relative (f32) and each student gradient within 1e-6 of
the largest (plus 1e-7 absolute: at the teacher itself the gradient is f32
noise near 1e-9); the teachers get no gradient on either side."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simxns_tpu.losses import distill as jd
from simxns_tpu_torch.losses import distill as pd
from torch_parity import one_torch_thread  # noqa: F401

EPS = 1e-7


def _softmax(x, axis=-1):
    e = np.exp(x - x.max(axis=axis, keepdims=True))
    return e / e.sum(axis=axis, keepdims=True)


def _both(name, *arrays, **kw):
    """(port value, JAX value, port d/d first input, JAX d/d first input)
    of loss ``name`` (its scalar, or the first output's)."""
    def first(out):
        return out[0] if isinstance(out, tuple) else out

    t = [torch.tensor(a, requires_grad=(i == 0)) for i, a in
         enumerate(arrays)]
    got = first(getattr(pd, name)(*t, **kw))
    got.backward()
    jf = lambda x, *rest: first(getattr(jd, name)(x, *rest, **kw))  # noqa
    want = jf(*map(jnp.asarray, arrays))
    jgrad = jax.grad(jf)(*map(jnp.asarray, arrays))
    return (float(got.detach()), float(want), t[0].grad.numpy(),
            np.asarray(jgrad))


def _check(name, *arrays, **kw):
    got, want, g, jg = _both(name, *arrays, **kw)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7,
                               err_msg=name)
    # f32 noise floor: at the teacher itself the gradient is ~1e-9 noise
    assert float(np.abs(g - jg).max()) <= 1e-6 * float(np.abs(jg).max()
                                                       ) + 1e-7, name
    return got


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_kd_softmax_matches_jax():
    """``tests/test_losses.py::test_kd_softmax_properties``: zero for the
    teacher itself and for a constant shift, positive for a bumped logit,
    smaller at T=4 than at T=1; each value the JAX one's."""
    t = _normal(4, 5, 7)
    assert _check("kd_softmax_loss", t, t, temperature=2.0) < 1e-6
    assert _check("kd_softmax_loss", t + 1.0, t) < 1e-6
    s2 = t.copy()
    s2[:, 0] += 3.0
    l1 = _check("kd_softmax_loss", s2, t, temperature=1.0)
    l4 = _check("kd_softmax_loss", s2, t, temperature=4.0)
    assert l1 > 0.01 and l1 > l4


def test_logit_embedding_and_mixed_mse_match_jax():
    a, b = np.ones((2, 3), np.float32), np.zeros((2, 3), np.float32)
    assert _check("kd_logit_mse_loss", a, b) == 0.5
    assert _check("embedding_mse_loss", a, b) == 0.5
    s, t = _normal(1, 4, 5), _normal(2, 4, 5)
    _check("kd_logit_mse_loss", s, t)
    _check("embedding_mse_loss", s, t)
    got = pd.mixed_kd_loss(torch.tensor(2.0), torch.tensor(3.0), 0.5, 0.5)
    assert float(got) == float(jd.mixed_kd_loss(jnp.asarray(2.0),
                                                jnp.asarray(3.0), 0.5,
                                                0.5)) == 2.5


def test_bi_logit_and_prob_loss_match_jax():
    a, b = np.ones((2, 3), np.float32), np.zeros((2, 3), np.float32)
    assert _check("bi_logit_loss", a, a, b, b) == 1.0
    _check("bi_logit_loss", _normal(3, 4, 6), _normal(4, 8, 6),
           _normal(5, 4, 6), _normal(6, 8, 6))
    rng = np.random.default_rng(6)
    s = rng.normal(size=(4, 5)).astype(np.float32)
    t = rng.normal(size=(4, 5)).astype(np.float32)
    want = float((-_softmax(t / 2.0, 1) * np.log(_softmax(s, 1) + EPS)
                  ).sum() / 4)
    np.testing.assert_allclose(_check("prob_loss", s, t, temperature=2.0),
                               want, rtol=1e-5)


def test_colbert_teacher_scores_match_jax():
    rng = np.random.default_rng(7)
    q = rng.normal(size=(2, 3, 4)).astype(np.float32)
    d = rng.normal(size=(5, 6, 4)).astype(np.float32)
    mask = np.ones((5, 6), np.int32)
    mask[:, 4:] = 0
    got = pd.colbert_teacher_scores(torch.from_numpy(q), torch.from_numpy(d),
                                    torch.from_numpy(mask))
    want = np.asarray(jd.colbert_teacher_scores(jnp.asarray(q),
                                                jnp.asarray(d),
                                                jnp.asarray(mask)))
    assert got.shape == (2, 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    oracle = sum(np.max(q[0, i] @ d[1, :4].T) for i in range(3))
    np.testing.assert_allclose(float(got[0, 1]), oracle, rtol=1e-5)


@pytest.mark.parametrize("alpha,beta,temperature", [(1.0, 1.0, 1.0),
                                                     (0.5, 2.0, 3.0)])
def test_dkd_matches_jax(alpha, beta, temperature):
    rng = np.random.default_rng(5)
    t = rng.normal(size=(4, 6)).astype(np.float32)
    tgt = np.array([0, 2, 5, 1], np.int32)
    kw = dict(alpha=alpha, beta=beta, temperature=temperature)
    got = pd.dkd_loss(torch.from_numpy(t), torch.from_numpy(t),
                      torch.from_numpy(tgt), **kw)
    assert float(got) < 1e-5
    s = t + rng.normal(size=(4, 6)).astype(np.float32)
    ts = torch.tensor(s, requires_grad=True)
    tt = torch.tensor(t, requires_grad=True)
    got = pd.dkd_loss(ts, tt, torch.from_numpy(tgt), **kw)
    got.backward()
    want = jd.dkd_loss(jnp.asarray(s), jnp.asarray(t), jnp.asarray(tgt), **kw)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    assert float(got.detach()) > 0.0
    jg = np.asarray(jax.grad(lambda x: jd.dkd_loss(
        x, jnp.asarray(t), jnp.asarray(tgt), **kw))(jnp.asarray(s)))
    assert float(np.abs(ts.grad.numpy() - jg).max()) <= 1e-6 * float(
        np.abs(jg).max())
    assert tt.grad is None                   # no gradient into the teacher


def test_multi_teacher_matches_jax():
    rng = np.random.default_rng(8)
    s, de, c12, c24 = (rng.normal(size=(4, 6)).astype(np.float32)
                       for _ in range(4))
    teachers = [torch.tensor(x, requires_grad=True) for x in (de, c12, c24)]
    ts = torch.tensor(s, requires_grad=True)
    loss, aux = pd.multi_teacher_kd_loss(ts, *teachers, temperature=1.0)
    loss.backward()
    jloss, jaux = jd.multi_teacher_kd_loss(*map(jnp.asarray, (s, de, c12,
                                                              c24)),
                                           temperature=1.0)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-6)
    for key in jaux:
        np.testing.assert_allclose(aux[key].detach().numpy(),
                                   np.asarray(jaux[key]), rtol=1e-6,
                                   err_msg=key)
    np.testing.assert_allclose(float(aux["teacher_losses"][0]),
                               -_softmax(de)[:, 0].mean(), rtol=1e-5)
    jg = np.asarray(jax.grad(lambda x: jd.multi_teacher_kd_loss(
        x, *map(jnp.asarray, (de, c12, c24)))[0])(jnp.asarray(s)))
    assert float(np.abs(ts.grad.numpy() - jg).max()) <= 1e-6 * float(
        np.abs(jg).max())
    assert all(t.grad is None or float(t.grad.abs().max()) == 0.0
               for t in teachers)
