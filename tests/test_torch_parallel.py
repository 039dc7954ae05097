"""The port's data parallelism (gloo ranks) against the JAX package's mesh.

One module-scoped pool of 4 gloo ranks (``torch_dist.Pool``) serves every
test, at W = 2 (its first two ranks) and W = 4; the JAX side runs on
``create_mesh(n_data=W)`` over the virtual CPU devices. The same numpy
inputs and the same weights (``params_from_jax``) go through both.

- collectives: the gather order, the gradients of the two gather modes,
  the positive offsets and the global in-batch NLL
  (``tests/test_parallel.py:26,40,76,88``);
- the reranker step over 2 steps against ``make_reranker_step`` on the
  mesh: the loss and ``correct`` within 1e-4 relative, the parameters
  within 1e-5 (AdamW at eps=1e-3, as ``test_torch_train.py`` explains),
  and every rank's parameters bitwise equal (the other two step kinds are
  in ``test_torch_dist_steps.py``);
- ``with_grad_accum``: against the JAX wrapper, alone and under W = 2, and
  its guard.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from simxns_tpu.losses.contrastive import grouped_nll as jgrouped
from simxns_tpu.losses.contrastive import in_batch_nll as jin_batch
from simxns_tpu.parallel import (DATA_AXIS, all_gather_full_grad,
                                 all_gather_local_grad, create_mesh,
                                 shard_batch)
from simxns_tpu.parallel.collectives import gather_positive_offsets
from simxns_tpu.train import TrainState as JaxTrainState
from simxns_tpu.train import make_adamw as jmake_adamw
from simxns_tpu.train import make_reranker_step as jmake_ce
from simxns_tpu.train.steps import with_grad_accum as jwith_grad_accum
from simxns_tpu_torch.models import params_from_jax
from simxns_tpu_torch.train import steps
import torch_dist
from torch_parity import (DIST_M, DIST_N, DIST_TX, biencoder_pair,
                          check_ranks, crossencoder_pair, dist_batch,
                          jax_bert, jax_mesh_run)
from torch_parity import one_torch_thread  # noqa: F401

N, M = DIST_N, DIST_M
F32 = jnp.float32


@pytest.fixture(scope="module")
def pool():
    p = torch_dist.Pool(4)
    yield p
    p.close()


def _shard_map(fn, mesh, x):
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=P(DATA_AXIS),
                                 out_specs=P(DATA_AXIS)))(x)


@pytest.mark.parametrize("w", [2, 4])
def test_gather_order_and_offsets(pool, w):
    """Rank-major gather (rank 0's rows first) on every rank, as the JAX
    gather on the mesh; positive offsets ``rank * local_batch``."""
    mesh = create_mesh(n_data=w)
    want = np.asarray(_shard_map(
        lambda xs: all_gather_full_grad(xs, DATA_AXIS)[None], mesh,
        jnp.arange(16, dtype=jnp.float32).reshape(16, 1)))[:, :, 0]
    got = pool.run(torch_dist.gather_order, 16, world=w)
    for rank in range(w):
        np.testing.assert_array_equal(got[rank], want[rank])
        np.testing.assert_array_equal(got[rank], np.arange(16))
    offsets = np.concatenate(pool.run(torch_dist.positive_offsets, 2,
                                      world=w))
    want = np.asarray(_shard_map(
        lambda p: gather_positive_offsets(p, 2, DATA_AXIS), mesh,
        jnp.zeros((2 * w,), jnp.int32)))
    np.testing.assert_array_equal(offsets, want)


@pytest.mark.parametrize("w", [2, 4])
@pytest.mark.parametrize("mode", ["full", "local"])
def test_gather_gradients(pool, mode, w):
    """d/dx of the group's sum of ``sum(gather(x) * w)``: the local slice of
    w under ``local`` (only the live local slot carries a gradient), W times
    it under ``full``; equal to the JAX gradients on the mesh (exact)."""
    mesh = create_mesh(n_data=w)
    x = np.ones((16, 2), np.float32)
    wts = np.arange(32, dtype=np.float32).reshape(16, 2)
    gather = all_gather_local_grad if mode == "local" else all_gather_full_grad

    def loss(xs):
        return jax.shard_map(
            lambda s: jax.lax.psum(jnp.sum(gather(s, DATA_AXIS) * wts),
                                   DATA_AXIS),
            mesh=mesh, in_specs=P(DATA_AXIS), out_specs=P())(xs)

    want = np.asarray(jax.grad(loss)(jnp.asarray(x)))
    got = np.concatenate(pool.run(torch_dist.gather_grads, x, wts, mode,
                                  world=w))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, wts * (w if mode == "full" else 1))


@pytest.mark.parametrize("w", [2, 4])
def test_global_in_batch_nll(pool, w):
    """The sharded loss over gathered contexts == the unsharded loss (and
    the JAX sharded one), f32 within 1e-6 relative; ``correct`` exact."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((16, 8), dtype=np.float32)
    c = rng.standard_normal((16, 8), dtype=np.float32)
    pos = np.arange(16, dtype=np.int32)
    mesh = create_mesh(n_data=w)

    def sharded(qs, cs, ps):
        loss, correct = jin_batch(qs, all_gather_full_grad(cs, DATA_AXIS),
                                  ps, reduction="sum")
        return (jax.lax.psum(loss, DATA_AXIS) / 16.0,
                jax.lax.psum(correct, DATA_AXIS))

    jloss, jcorrect = jax.jit(jax.shard_map(
        sharded, mesh=mesh, in_specs=(P(DATA_AXIS),) * 3,
        out_specs=(P(), P())))(q, c, pos)
    ref_loss, ref_correct = jin_batch(jnp.asarray(q), jnp.asarray(c),
                                      jnp.asarray(pos))
    got = pool.run(torch_dist.global_in_batch_nll, q, c, pos, world=w)
    for loss, correct in got:
        np.testing.assert_allclose(loss, float(jloss), rtol=1e-6)
        np.testing.assert_allclose(loss, float(ref_loss), rtol=1e-6)
        assert correct == int(jcorrect) == int(ref_correct)


@pytest.mark.parametrize("w", [2, 4])
def test_reranker_step_matches_jax_mesh(pool, w):
    jmodel, params, port = crossencoder_pair(jax_bert(dtype=F32), seed=32)
    batches = [dist_batch(50 + s) for s in range(2)]
    mesh = create_mesh(n_data=w)
    jstep = jmake_ce(jmodel, jmake_adamw(**DIST_TX), mesh, group_size=M)
    jm, jp = jax_mesh_run(jstep, params, batches, mesh)
    got = pool.run(torch_dist.train_steps, "reranker", port.cfg,
                   torch_dist.numpy_state(port), batches, DIST_TX, {}, world=w)
    check_ranks(got, jm, jp)


def test_grad_accum_matches_jax():
    """The port's ``with_grad_accum`` on the JAX test's regression
    (``tests/test_losses.py:176``): loss and gradients of 4 slices."""
    rng = np.random.default_rng(10)
    w = rng.normal(size=(4, 3)).astype(np.float32)
    batch = {"x": rng.normal(size=(8, 4)).astype(np.float32),
             "y": rng.normal(size=(8, 3)).astype(np.float32)}

    def jloss(params, b):
        loss = jnp.mean((b["x"] @ params - b["y"]) ** 2)
        return loss, {"l": loss}

    (jl, _), jg = jwith_grad_accum(jloss, 4)(jnp.asarray(w), batch)

    class Linear(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.from_numpy(w.copy()))

    def tloss(module, b):
        loss = ((b["x"] @ module.w - b["y"]) ** 2).mean()
        return loss, {"l": loss}

    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    (tl, aux), tg = steps.with_grad_accum(tloss, 4)(Linear(), tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    np.testing.assert_allclose(float(aux["l"]), float(jl), rtol=1e-6)
    np.testing.assert_allclose(tg["w"].numpy(), np.asarray(jg), rtol=1e-5)


def test_grad_accum_guards_global_positive_idx():
    """A full-batch ``positive_idx`` under accumulation raises (the JAX
    guard on concrete batches); a slice-local one passes."""
    jmodel, params, port = biencoder_pair(jax_bert(dtype=F32), seed=35)
    b = steps.to_device(dist_batch(70), torch.device("cpu"))
    b = {k: v for k, v in b.items() if not k.startswith("joint")}
    vg = steps.with_grad_accum(steps.biencoder_loss, 2)
    with pytest.raises(ValueError, match="microbatch-LOCAL"):
        vg(port, b)
    local = dict(b, positive_idx=(torch.arange(N) % (N // 2)) * M)
    (loss, aux), grads = vg(port, local)
    assert torch.isfinite(loss) and int(aux["correct"]) >= 0
    assert all(p.grad is None for p in port.parameters())


def test_grad_accum_under_the_group_matches_jax_mesh(pool):
    """A reranker update from ``with_grad_accum(2)`` on each of 2 ranks'
    rows, the gradients summed over the group: JAX's ``with_grad_accum``
    over the global batch on a mesh of 2 (a per-example loss: the slices
    differ, the sums agree). Loss 1e-5 relative, parameters 1e-5."""
    jmodel, params, port = crossencoder_pair(jax_bert(dtype=F32), seed=36)
    batch = dist_batch(80)
    mesh = create_mesh(n_data=2)

    def jloss(p, b):
        n, m, lj = b["joint_ids"].shape
        logits = jmodel.apply(p, b["joint_ids"].reshape(n * m, lj),
                              b["joint_mask"].reshape(n * m, lj),
                              group_size=m)["logits"]
        return jgrouped(logits), {}

    jtx = jmake_adamw(**DIST_TX)

    @jax.jit
    def jstep(state, b):
        (loss, _), grads = jwith_grad_accum(jloss, 2)(state.params, b)
        return state.apply_gradients(grads, jtx), loss

    state = jax.device_put(
        JaxTrainState.create(jax.tree.map(jnp.copy, params), jtx),
        NamedSharding(mesh, P()))
    joint = {k: batch[k] for k in ("joint_ids", "joint_mask")}
    state, jl = jstep(state, shard_batch(joint, mesh))
    want = params_from_jax(jax.device_get(state.params))
    got = pool.run(torch_dist.accum_step, port.cfg,
                   torch_dist.numpy_state(port),
                   joint, 2, DIST_TX, world=2)
    for loss, p in got:
        np.testing.assert_allclose(loss, float(jl), rtol=1e-5)
        for name, value in p.items():
            err = float(np.abs(value - want[name].numpy()).max())
            assert err <= 1e-5, (name, err)
            np.testing.assert_array_equal(value, got[0][1][name])


def test_mesh_helpers(monkeypatch):
    """Without a group a mesh is a world of one that changes no batch;
    ``shard_batch`` takes rank-major contiguous rows (``P("data")``'s order)
    and ``local_batch_size`` refuses a batch W does not divide; under
    ``torchrun`` ``cuda`` means ``cuda:LOCAL_RANK`` and an explicit index
    is kept."""
    from simxns_tpu_torch.parallel import (Mesh, create_mesh,
                                           local_batch_size, shard_batch)
    from simxns_tpu_torch.parallel import mesh as pmesh

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    one = create_mesh("cpu")
    assert not one.distributed and one.world_size == 1
    batch = {"ids": np.arange(12).reshape(6, 2), "n": np.int32(3)}
    assert shard_batch(batch, one) is batch
    ranks = [Mesh(torch.device("cpu"), rank=r, world_size=3, group=object())
             for r in range(3)]
    parts = [shard_batch(batch, m) for m in ranks]
    np.testing.assert_array_equal(np.concatenate([p["ids"] for p in parts]),
                                  batch["ids"])
    assert all(p["n"] == 3 for p in parts)
    with pytest.raises(ValueError, match="not divisible by dp=3"):
        local_batch_size(8, ranks[0])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert pmesh._rank_device(None, 3) == torch.device("cuda", 3)
    assert pmesh._rank_device("cuda", 2) == torch.device("cuda", 2)
    assert pmesh._rank_device("cuda:0", 2) == torch.device("cuda", 0)
    assert pmesh._rank_device("cpu", 1) == torch.device("cpu")


def test_dropout_generator_folds_the_rank():
    """Rank 0 draws the single-device masks; other ranks draw others (the
    JAX steps fold ``axis_index`` into the dropout key)."""
    def draw(rank):
        return torch.rand(8, generator=steps.dropout_generator(
            True, 2, 5, rank))

    single = torch.rand(8, generator=steps.dropout_generator(True, 2, 5))
    assert torch.equal(draw(0), single)
    assert not torch.equal(draw(1), single)
    assert not torch.equal(draw(1), draw(2))
    assert steps.dropout_generator(False, 2, 5, 1) is None


def test_kernel_launch_runs_on_the_tensors_device(monkeypatch):
    """A kernel launch for a tensor on another card than the current one
    runs with that card current (the CUDA runtime launches on its current
    device), and costs no device switch when they agree."""
    from contextlib import contextmanager

    from simxns_tpu_torch.ops import _native

    current, seen = [0], []

    @contextmanager
    def device(index):
        before, current[0] = current[0], index
        try:
            yield
        finally:
            current[0] = before

    monkeypatch.setattr(torch.cuda, "current_device", lambda: current[0])
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(_native, "stream", lambda dev: f"stream of {dev}")

    def launcher(*args):
        seen.append((current[0], args))
        return 0

    assert _native.launch(launcher, torch.device("cuda", 1), "a", 2) == 0
    assert _native.launch(launcher, torch.device("cuda", 0), "b") == 0
    with _native.on(torch.device("cuda", 2)):      # Triton's launches
        assert current == [2]
    assert seen == [(1, ("a", 2, "stream of cuda:1")),
                    (0, ("b", "stream of cuda:0"))]
    assert current == [0]
