"""The port's three AR2 training steps against the JAX steps, from identical
weights, on tiny configs.

Order of the checks, so a failure points at its layer: the gradients of
step 1, then the loss of each step, then the parameters after step 3. The
cross-encoder runs the grouped attention (``small_s_attn="group"``): the
JAX side in interpret mode (``flash_attention.INTERPRET``), the port
through its plain K5/K6. The retriever step's teacher is the
``fused_int8`` view (JAX: ``fused_layer.INTERPRET``).

The parameters are compared after three AdamW steps with ``eps=1e-3``.
At the recipe's 1e-8, an element whose gradient is rounding noise (the
key projection's bias, whose gradient is zero in exact arithmetic, or an
embedding row whose terms cancel) moves by +-lr on the sign of that
noise; a larger eps makes every update a smooth function of its gradient.
The optimizer itself is held to optax at the recipe's eps in
``test_torch_optim.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simxns_tpu.ops.flash_attention as jfa
import simxns_tpu.ops.fused_layer as jfl
from simxns_tpu.losses.contrastive import grouped_nll as jgrouped
from simxns_tpu.losses.contrastive import in_batch_nll as jin_batch
from simxns_tpu.models import CrossEncoder as JaxCrossEncoder
from simxns_tpu.models import CrossEncoderConfig as JaxCrossEncoderConfig
from simxns_tpu.parallel import create_mesh
from simxns_tpu.train import TrainState as JaxTrainState
from simxns_tpu.train import make_adamw as jmake_adamw
from simxns_tpu.train import make_ar2_retriever_step as jmake_ar2
from simxns_tpu.train import make_biencoder_step as jmake_de
from simxns_tpu.train import make_reranker_step as jmake_ce
from simxns_tpu_torch.models import int8_view, params_from_jax
from simxns_tpu_torch.train import (TrainState, make_adamw,
                                    make_ar2_retriever_step,
                                    make_biencoder_step, make_reranker_step)
from simxns_tpu_torch.train import steps
from torch_parity import (biencoder_pair, crossencoder_pair, jax_bert,
                          token_batch)
from torch_parity import one_torch_thread  # noqa: F401

N, M = 2, 3             # queries, passages per query
F32 = jnp.float32


@pytest.fixture(autouse=True)
def _interpret():
    old = jfa.INTERPRET, jfl.INTERPRET
    jfa.INTERPRET = jfl.INTERPRET = True
    yield
    jfa.INTERPRET, jfl.INTERPRET = old


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
    """Each gradient to ``rel`` of the largest one. f32 rounding alone moves
    them that far: the JAX package's own two attention paths (XLA and the
    interpreted kernel) differ by 2.5e-5 of the largest gradient on the
    bi-encoder input here, jit against eager by 1.4e-5."""
    want = params_from_jax(jax.device_get(jax_grads))
    assert set(want) == set(port_grads)
    scale = max(float(w.abs().max()) for w in want.values())   # max|g|
    for name, w in want.items():
        g = port_grads[name]
        g = torch.zeros_like(w) if g is None else g.float()
        err = float((g - w).abs().max())
        assert err <= rel * scale, (name, err)


def _check_params(module, jparams):
    want = params_from_jax(jax.device_get(jparams))
    for name, p in module.named_parameters():
        err = float((p.detach() - want[name]).abs().max())
        assert err <= 1e-5, (name, err)


def _run(jstep, tstep, jstate, tstate, batches, jextra=(), textra=()):
    losses = []
    for b in batches:
        jstate, jm = jstep(jstate, *jextra, b)
        tstate, tm = tstep(tstate, *textra, b)
        losses.append((float(tm["loss"]), float(jm["loss"])))
        for key in jm:
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-4, atol=1e-6, err_msg=key)
    for got, want in losses:
        assert abs(got - want) <= 1e-4 * abs(want)
    return jstate, tstate


def _tx():
    kw = dict(lr=1e-4, total_steps=0, eps=1e-3)
    return jmake_adamw(**kw), make_adamw(**kw)


def test_biencoder_step_matches_jax():
    jmodel, params, port = biencoder_pair(jax_bert(dtype=F32), seed=11)
    batches = [_batch(s) for s in range(3)]
    b0 = batches[0]

    def jloss(p):
        q, c = jmodel.apply(p, b0["q_ids"], b0["q_mask"], b0["ctx_ids"],
                            b0["ctx_mask"])
        return jin_batch(q, c, jnp.asarray(b0["positive_idx"]))[0]

    loss, _ = steps.biencoder_loss(port, steps.to_device(b0, "cpu"))
    _check_grads(steps.gradients(port, loss), jax.grad(jloss)(params))

    jtx, tx = _tx()
    mesh = create_mesh(n_data=1)
    jstate = JaxTrainState.create(jax.tree.map(jnp.copy, params), jtx)
    jstate, _ = _run(jmake_de(jmodel, jtx, mesh), make_biencoder_step(
        tx, device="cpu"), jstate, TrainState.create(port, tx), batches)
    _check_params(port, jstate.params)


def test_reranker_step_matches_jax():
    jmodel, params, port = crossencoder_pair(
        jax_bert(small_s_attn="group", dtype=F32), seed=12)
    batches = [_batch(10 + s) for s in range(3)]
    b0 = batches[0]

    def jloss(p):
        logits = jmodel.apply(p, b0["joint_ids"].reshape(N * M, -1),
                              b0["joint_mask"].reshape(N * M, -1),
                              group_size=M)["logits"]
        return jgrouped(logits)

    loss, _ = steps.reranker_loss(port, steps.to_device(b0, "cpu"))
    _check_grads(steps.gradients(port, loss), jax.grad(jloss)(params))

    jtx, tx = _tx()
    jstate = JaxTrainState.create(jax.tree.map(jnp.copy, params), jtx)
    jstate, _ = _run(jmake_ce(jmodel, jtx, create_mesh(n_data=1),
                              group_size=M),
                     make_reranker_step(tx, device="cpu"), jstate,
                     TrainState.create(port, tx), batches)
    _check_params(port, jstate.params)


def test_ar2_retriever_step_with_int8_teacher_matches_jax():
    """adv_lambda=0.5 and scale_scores set; the teacher is the fused-int8
    view of the reranker on both sides."""
    jde, de_params, port_de = biencoder_pair(jax_bert(dtype=F32), seed=13)
    ce_cfg = jax_bert(small_s_attn="group", dtype=F32)
    _, ce_params, port_ce = crossencoder_pair(ce_cfg, seed=14)
    jteacher = JaxCrossEncoder(JaxCrossEncoderConfig(bert=ce_cfg.replace(
        layer_impl="fused_int8", ffn_impl="xla", proj_impl="xla")))
    teacher = int8_view(port_ce)
    batches = [_batch(20 + s) for s in range(3)]
    kw = dict(temperature=0.8, adv_lambda=0.5, scale_scores=0.25)
    b0 = batches[0]

    from simxns_tpu.losses.distill import ar2_retriever_loss as jar2

    def jloss(p):
        q, c = jde.apply(p, b0["q_ids"], b0["q_mask"], b0["ctx_ids"],
                         b0["ctx_mask"])
        scores = jnp.einsum("bh,bmh->bm", q, c.reshape(N, M, -1))
        logits = jteacher.apply(ce_params, b0["joint_ids"].reshape(N * M, -1),
                                b0["joint_mask"].reshape(N * M, -1),
                                group_size=M)["logits"]
        _, aux = jar2(scores, logits, **kw)
        return 0.5 * aux["adv_loss"] + 0.5 * aux["normal_loss"]

    loss, _ = steps.retriever_loss(port_de, teacher,
                                   steps.to_device(b0, "cpu"), **kw)
    # the two terms of this loss cancel in its gradient (its largest
    # element is 50x smaller than the bi-encoder step's): the JAX package's
    # own two attention paths differ by 3.1e-4 of it here
    _check_grads(steps.gradients(port_de, loss), jax.grad(jloss)(de_params),
                 rel=1e-3)

    jtx, tx = _tx()
    jstate = JaxTrainState.create(jax.tree.map(jnp.copy, de_params), jtx)
    jstate, _ = _run(jmake_ar2(jde, jteacher, jtx, create_mesh(n_data=1),
                               **kw),
                     make_ar2_retriever_step(tx, device="cpu", **kw), jstate,
                     TrainState.create(port_de, tx), batches,
                     jextra=(ce_params,), textra=(teacher,))
    _check_params(port_de, jstate.params)


def test_reranker_bf16_forward_backward():
    """bf16 activations. The loss agrees to 1e-2 relative. The gradients
    round at other places on the two sides: JAX transposes its products
    and reduces its bias gradients in bf16, the port's CPU products upcast
    to f32. So each side is held to the f32 gradient of the same weights
    (flattened, by cosine): the port's at least as close as JAX's less
    0.005, and the two within a cosine of 0.9 of each other (measured:
    port 0.982, JAX 0.960, port against JAX 0.953)."""
    b0 = _batch(30)
    flat = {}
    for dt in (jnp.bfloat16, F32):
        jmodel, params, port = crossencoder_pair(
            jax_bert(small_s_attn="group", dtype=dt), seed=15)

        def jloss(p):
            logits = jmodel.apply(p, b0["joint_ids"].reshape(N * M, -1),
                                  b0["joint_mask"].reshape(N * M, -1),
                                  group_size=M)["logits"]
            return jgrouped(logits)

        want, jg = jax.value_and_grad(jloss)(params)
        loss, _ = steps.reranker_loss(port, steps.to_device(b0, "cpu"))
        grads = steps.gradients(port, loss)
        assert abs(float(loss.detach()) - float(want)) <= 1e-2 * abs(
            float(want))
        ref = params_from_jax(jax.device_get(jg))
        names = sorted(ref)
        flat[dt] = (torch.cat([grads[n].float().flatten() for n in names]),
                    torch.cat([ref[n].flatten() for n in names]))

    def cos(a, b):
        return float(torch.nn.functional.cosine_similarity(a, b, dim=0))

    (port16, jax16), (_, jax32) = flat[jnp.bfloat16], flat[F32]
    assert cos(port16, jax32) >= cos(jax16, jax32) - 0.005
    assert cos(port16, jax16) >= 0.9


def test_int8_view_follows_the_live_weights():
    """The view shares the reranker's Parameters; after a reranker step
    changed them in place, its logits equal a freshly built view's (the
    cached int8 weights were quantized again)."""
    _, _, ce = crossencoder_pair(
        jax_bert(small_s_attn="group", dtype=F32), seed=16)
    view = int8_view(ce)
    assert all(a is b for a, b in zip(view.parameters(), ce.parameters()))
    b0 = steps.to_device(_batch(40), "cpu")
    joint = b0["joint_ids"].reshape(N * M, -1), b0["joint_mask"].reshape(
        N * M, -1)
    with torch.no_grad():
        before = view(*joint)["logits"]
    tx = make_adamw(1e-2, total_steps=0)
    make_reranker_step(tx, device="cpu")(TrainState.create(ce, tx), b0)
    with torch.no_grad():
        after = view(*joint)["logits"]
        fresh = int8_view(ce)(*joint)["logits"]
    assert torch.equal(after, fresh)
    assert not torch.equal(after, before)
    with pytest.raises(ValueError, match="encode-only"):
        view(*joint)                 # autograd recording through int8
