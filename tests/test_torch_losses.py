"""The port's contrastive and AR2 losses against the JAX package: values and
gradients from the same numpy inputs, f32, to rtol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simxns_tpu.losses.contrastive import grouped_nll as jgrouped
from simxns_tpu.losses.contrastive import in_batch_nll as jin_batch
from simxns_tpu.losses.distill import ar2_retriever_loss as jar2
from simxns_tpu_torch.losses import (ar2_retriever_loss, grouped_nll,
                                     in_batch_nll)
from torch_parity import one_torch_thread  # noqa: F401


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _grad(fn, *xs):
    ts = [torch.from_numpy(x).requires_grad_() for x in xs]
    out = fn(*ts)
    out.backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_in_batch_nll(reduction):
    rng = np.random.default_rng(0)
    q = rng.normal(size=(6, 16)).astype(np.float32)
    c = rng.normal(size=(12, 16)).astype(np.float32)
    pos = (np.arange(6) * 2).astype(np.int32)
    pos[3] = 11
    (want, correct), jg = jax.value_and_grad(
        lambda a, b: jin_batch(a, b, jnp.asarray(pos), 20.0, reduction),
        argnums=(0, 1), has_aux=True)(q, c)
    got, tg = _grad(lambda a, b: in_batch_nll(
        a, b, torch.from_numpy(pos), 20.0, reduction)[0], q, c)
    _close(got, want)
    for g, w in zip(tg, jg):
        _close(g, w)
    t_correct = in_batch_nll(torch.from_numpy(q), torch.from_numpy(c),
                             torch.from_numpy(pos), 20.0)[1]
    assert int(t_correct) == int(correct)
    per_row, _ = in_batch_nll(torch.from_numpy(q), torch.from_numpy(c),
                              torch.from_numpy(pos), reduction="none")
    _close(per_row, jin_batch(q, c, jnp.asarray(pos), reduction="none")[0])


def test_grouped_nll():
    """Positive at column 0 (the reranker) and at an index per row; bf16
    logits are upcast before the softmax."""
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(5, 4)).astype(np.float32) * 3
    want, jg = jax.value_and_grad(jgrouped)(logits)
    got, (tg,) = _grad(grouped_nll, logits)
    _close(got, want)
    _close(tg, jg)
    col = np.array([0, 3, 1, 2, 3], np.int32)
    _close(grouped_nll(torch.from_numpy(logits), torch.from_numpy(col), "sum"),
           jgrouped(logits, jnp.asarray(col), "sum"))
    lb = np.asarray(jnp.asarray(logits, jnp.bfloat16), np.float32)
    _close(grouped_nll(torch.from_numpy(lb).to(torch.bfloat16)),
           jgrouped(jnp.asarray(lb, jnp.bfloat16)))


@pytest.mark.parametrize("adv_lambda,scale", [(0.0, None), (0.5, None),
                                              (0.5, 1 / 8.0)])
def test_ar2_retriever_loss(adv_lambda, scale):
    """Values of the loss and both terms, and the gradient of the scores;
    the reranker logits get none."""
    rng = np.random.default_rng(2)
    scores = rng.normal(size=(4, 6)).astype(np.float32) * 4
    logits = rng.normal(size=(4, 6)).astype(np.float32) * 2

    def jloss(s, lg):
        return jar2(s, lg, temperature=0.7, adv_lambda=adv_lambda,
                    scale_scores=scale)

    (want, aux), (jg, jlg) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(scores, logits)
    st = torch.from_numpy(scores).requires_grad_()
    lt = torch.from_numpy(logits).requires_grad_()
    got, taux = ar2_retriever_loss(st, lt, temperature=0.7,
                                   adv_lambda=adv_lambda, scale_scores=scale)
    got.backward()
    _close(got.detach(), want)
    for key in ("normal_loss", "adv_loss"):
        _close(taux[key].detach(), aux[key])
    _close(st.grad, jg)
    assert lt.grad is None and not np.asarray(jlg).any()
