"""The port's DPR span reader (``simxns_tpu_torch.models.reader``) against
the JAX package's, case for case with ``tests/test_reader.py:10, 22, 67``:
the same weights (``params_from_jax``) and the same numpy inputs.

Tolerances: both sides run f32 on the CPU and differ by the order of f32
sums, ~1e-6 of the values: the logits within 1e-5 absolute, the losses
within 1e-5 relative, the gradients within 1e-4 of the largest one (some,
exactly 0 in exact arithmetic, are f32 noise of 1e-8)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simxns_tpu.models import BertConfig as JBertConfig
from simxns_tpu.models import Reader as JReader
from simxns_tpu.models import ReaderConfig as JReaderConfig
from simxns_tpu.models import reader_loss as jreader_loss
from simxns_tpu_torch.models import (Reader, ReaderConfig, params_from_jax,
                                     reader_loss)
from simxns_tpu_torch.train import TrainState, make_adamw
from torch_parity import one_torch_thread, port_bert  # noqa: F401

CFG = JBertConfig.tiny(vocab_size=256)


def _pair(ids, mask, seed=0):
    jmodel = JReader(JReaderConfig(bert=CFG))
    params = jmodel.init(jax.random.PRNGKey(seed), ids, mask)
    port = Reader(ReaderConfig(bert=port_bert(CFG)))
    port.load_state_dict(params_from_jax(jax.device_get(params)))
    return jmodel, params, port


def _spans(n, m, l, a):
    sp = np.full((n, m, a), l, np.int32)
    ep = np.full((n, m, a), l, np.int32)
    am = np.zeros((n, m, a), np.int32)
    sp[:, 0, 0], ep[:, 0, 0], am[:, 0, 0] = 2, 3, 1
    if a > 1:
        sp[0, 0, 1], ep[0, 0, 1], am[0, 0, 1] = 5, 5, 1
        sp[-1, 0, 1], ep[-1, 0, 1], am[-1, 0, 1] = l + 3, 1, 1  # clamped
    return sp, ep, am


def test_reader_outputs_match_jax():
    """``tests/test_reader.py:10``: start, end [N, M, L] and rank [N, M]
    in f32, equal to JAX's on the same weights and a padded mask."""
    rng = np.random.default_rng(0)
    n, m, l = 2, 3, 16
    ids = rng.integers(4, 256, size=(n, m, l)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[:, 1:, 12:] = 0
    jmodel, params, port = _pair(ids, mask)
    want = jmodel.apply(params, ids, mask)
    with torch.no_grad():
        got = port(torch.from_numpy(ids), torch.from_numpy(mask))
    for g, w, shape in zip(got, want, [(n, m, l), (n, m, l), (n, m)]):
        assert g.shape == shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def _oracle(start_logits, end_logits, rel, sp, ep, am):
    """A literal numpy transcription of compute_loss / _calc_mml."""
    n, m, l = start_logits.shape

    def softmax(x):
        e = np.exp(x - x.max(-1, keepdims=True))
        return e / e.sum(-1, keepdims=True)

    def ce(logits, pos):
        pos = min(max(pos, 0), l)
        return 0.0 if pos >= l else -np.log(softmax(logits))[pos]

    switch = -np.log(softmax(rel))[:, 0].sum()
    lt = np.zeros(am.shape)
    for i, j, k in np.ndindex(*am.shape):
        if am[i, j, k]:
            lt[i, j, k] = (ce(start_logits[i, j], sp[i, j, k])
                           + ce(end_logits[i, j], ep[i, j, k]))
    lt = lt.max(axis=1)
    marg = np.sum(np.exp(-lt - 1e10 * (lt == 0)), axis=1)
    return -np.sum(np.log(marg + (marg == 0))), switch


@pytest.mark.parametrize("a", [1, 2])
def test_reader_loss_matches_jax_and_oracle(a):
    """``tests/test_reader.py:22``: the switch loss, the span loss (with a
    position past L clamped to the ignore index) and their sum, against
    JAX's ``reader_loss`` and the numpy oracle."""
    rng = np.random.default_rng(1)
    n, m, l = 3, 2, 8
    s = rng.normal(size=(n, m, l)).astype(np.float32)
    e = rng.normal(size=(n, m, l)).astype(np.float32)
    rel = rng.normal(size=(n, m)).astype(np.float32)
    sp, ep, am = _spans(n, m, l, a)
    total, parts = reader_loss(*map(torch.from_numpy, (s, e, rel, sp, ep,
                                                       am)))
    jtotal, jparts = jreader_loss(*map(jnp.asarray, (s, e, rel, sp, ep, am)))
    span, switch = _oracle(s, e, rel, sp, ep, am)
    for got, want in ((parts["switch_loss"], jparts["switch_loss"]),
                      (parts["span_loss"], jparts["span_loss"]),
                      (total, jtotal)):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(parts["switch_loss"]), switch, rtol=1e-5)
    np.testing.assert_allclose(float(parts["span_loss"]), span, rtol=1e-5)


def _train_inputs():
    rng = np.random.default_rng(2)
    n, m, l, a = 4, 2, 12, 1
    ids = rng.integers(4, 256, size=(n, m, l)).astype(np.int32)
    ids[:, 0, 5] = 7          # the answer's marker in the positives
    mask = np.ones_like(ids)
    sp = np.full((n, m, a), l, np.int32)
    sp[:, 0, 0] = 5
    ep = sp.copy()
    am = np.zeros((n, m, a), np.int32)
    am[:, 0, 0] = 1
    return ids, mask, sp, ep, am


def test_reader_gradients_match_jax():
    """The first training step's loss and gradients against JAX's."""
    ids, mask, sp, ep, am = _train_inputs()
    jmodel, params, port = _pair(ids, mask)

    def jloss(p):
        s, e, r = jmodel.apply(p, ids, mask)
        return jreader_loss(s, e, r, sp, ep, am)[0]

    jl, jg = jax.value_and_grad(jloss)(params)
    want = params_from_jax(jax.device_get(jg))
    s, e, r = port(torch.from_numpy(ids), torch.from_numpy(mask))
    loss, _ = reader_loss(s, e, r, *map(torch.from_numpy, (sp, ep, am)))
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    largest = max(float(w.abs().max()) for w in want.values())
    for name, p in port.named_parameters():
        err = float((p.grad - want[name]).abs().max())
        assert err <= 1e-4 * largest, (name, err)


def test_reader_trains():
    """``tests/test_reader.py:67``: 10 AdamW steps at 3e-3 lower the loss
    and the start prediction lands on the answer's position."""
    ids, mask, sp, ep, am = _train_inputs()
    _, _, port = _pair(ids, mask)
    tx = make_adamw(3e-3, total_steps=0, weight_decay=0.0)
    state = TrainState.create(port, tx)
    t_ids, t_mask = torch.from_numpy(ids), torch.from_numpy(mask)
    targets = [torch.from_numpy(x) for x in (sp, ep, am)]
    losses = []
    for _ in range(10):
        loss, _ = reader_loss(*port(t_ids, t_mask), *targets)
        grads = torch.autograd.grad(loss, list(port.parameters()))
        state.apply_gradients(
            dict(zip([n for n, _ in port.named_parameters()], grads)), tx)
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    with torch.no_grad():
        s, _, _ = port(t_ids, t_mask)
    assert (s[:, 0].argmax(-1) == 5).float().mean() >= 0.75
