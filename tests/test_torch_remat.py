"""``remat_policy="dots"`` of the port: selective checkpointing that keeps
the dense products' outputs (``aten.mm``/``aten.addmm``) and recomputes
the rest, JAX's ``dots_with_no_batch_dims_saveable``.

Gradients equal those without remat exactly, and JAX's ``"dots"``
gradients from the same weights to 1e-4 of the largest one (the f32
rounding bound of ``test_torch_train.py``). A dispatch-mode count of the
backward shows that the recompute runs no dense product under ``"dots"``
and runs them under full remat.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from simxns_tpu.losses.contrastive import grouped_nll as jgrouped
from simxns_tpu_torch.models import (CrossEncoder, CrossEncoderConfig,
                                     params_from_jax)
from simxns_tpu_torch.train import steps
from torch_parity import crossencoder_pair, jax_bert, token_batch
from torch_parity import one_torch_thread  # noqa: F401

N, M, S = 2, 4, 16
DENSE = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


class CountDense(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.count += func in DENSE
        return func(*args, **(kwargs or {}))


def _batch():
    rng = np.random.default_rng(0)
    ids, mask = token_batch(rng, N * M, S)
    return {"joint_ids": torch.from_numpy(ids).long().reshape(N, M, S),
            "joint_mask": torch.from_numpy(mask).reshape(N, M, S)}


def _backward(port, batch):
    """(loss, gradients by name, dense products run by the backward)."""
    loss, _ = steps.reranker_loss(port, batch)
    for p in port.parameters():
        p.grad = None
    with CountDense() as mode:
        loss.backward()
    return (float(loss.detach()),
            {n: p.grad.clone() for n, p in port.named_parameters()},
            mode.count)


@pytest.mark.parametrize("ffn_impl", ["xla", "fused_vjp"])
def test_dots_gradients_equal_no_remat_and_jax(ffn_impl):
    """H=128, F=256 and 2 x 4 x 16 tokens tile, so ``fused_vjp`` runs its
    autograd Function (K9-K11's plain versions on the CPU)."""
    runs = {}
    for remat, policy in ((False, None), (True, None), (True, "dots")):
        cfg = jax_bert(dtype=jnp.float32, ffn_impl=ffn_impl, remat=remat,
                       remat_policy=policy)
        jmodel, params, port = crossencoder_pair(cfg, seed=41)
        runs[remat, policy] = _backward(port, _batch())
    loss, grads, dense = runs[False, None]
    for key in ((True, None), (True, "dots")):
        assert runs[key][0] == loss
        for name, g in grads.items():
            assert torch.equal(runs[key][1][name], g), (key, name)
    # dots: the backward's dense products are the gradients' alone
    assert runs[True, "dots"][2] == dense
    assert runs[True, None][2] > dense

    b = _batch()

    def jloss(p):
        logits = jmodel.apply(p, b["joint_ids"].numpy().reshape(N * M, S),
                              b["joint_mask"].numpy().reshape(N * M, S),
                              group_size=M)["logits"]
        return jgrouped(logits)

    want = params_from_jax(jax.device_get(jax.grad(jloss)(params)))
    got = runs[True, "dots"][1]
    scale = max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        assert float((got[name] - w).abs().max()) <= 1e-4 * scale, name


def test_remat_skips_attention_maps_and_refuses_unknown_policies():
    """A call that asks for attention maps runs without checkpoints (as
    JAX's ``run_layers``); an unknown policy raises, as in JAX."""
    _, _, port = crossencoder_pair(jax_bert(dtype=jnp.float32, remat=True,
                                            remat_policy="dots"), seed=42)
    b = _batch()
    ids, mask = b["joint_ids"].reshape(N * M, S), b["joint_mask"].reshape(
        N * M, S)
    out = port(ids, mask, output_attentions=True)
    assert len(out["attentions"]) == 2
    assert out["attentions"][0].shape == (N * M, 4, S, S)
    bad = CrossEncoder(CrossEncoderConfig(
        bert=port.cfg.bert.replace(remat_policy="nope")))
    with pytest.raises(ValueError, match="unknown remat_policy"):
        bad(ids, mask)
