"""The port's tensor parallelism (``parallel/tp.py``, the steps'
``auto_state``) on 4 gloo ranks as (data 2, model 2), against the JAX
package's ``create_mesh(n_data=2, n_model=2)`` on 4 virtual devices
(``tests/test_parallel.py:120``):

- the split decisions, name for name, against ``tp_param_shardings``;
- the bi-encoder step and the AR2 retriever step with ``auto_state=True``,
  2 steps from the same weights and global batches: the metrics within
  1e-5 relative (f32), the parameters gathered over the model group
  within 1e-5 (AdamW at eps=1e-3, as ``test_torch_train.py`` explains),
  the split layout kept, and a whole parameter's gradient equal on both
  model ranks (within 1e-6 absolute: the same reductions on each);
- the split paths against the same module whole (the output within 1e-5
  of its largest magnitude, each gradient within 1e-5 of the largest
  one): heads the model size does not divide, the fused FFN knob, the
  fused-int8 view, and the vocabulary-split MLM head;
- a split state's checkpoint, whole on disk, loaded on one device and
  re-split.
The file has its own pool of ranks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simxns_tpu.models.bert import MLMHead as JaxMLMHead
from simxns_tpu.parallel import create_mesh, shard_batch
from simxns_tpu.parallel.tp import shard_params as jshard
from simxns_tpu.parallel.tp import tp_param_shardings as jspecs
from simxns_tpu.train import TrainState as JaxTrainState
from simxns_tpu.train import make_adamw as jmake_adamw
from simxns_tpu.train import make_ar2_retriever_step as jmake_ar2
from simxns_tpu.train import make_biencoder_step as jmake_de
from simxns_tpu_torch.io import restore_checkpoint
from simxns_tpu_torch.models import BiEncoder, MLMHead, params_from_jax
from simxns_tpu_torch.parallel.mesh import Mesh
from simxns_tpu_torch.parallel.tp import tp_param_shardings
from simxns_tpu_torch.train import TrainState, make_adamw
import torch_dist
from torch_parity import (DIST_TX, biencoder_pair, crossencoder_pair,
                          dist_batch, jax_bert, port_bert)
from torch_parity import one_torch_thread  # noqa: F401

F32 = jnp.float32
ND, NM = 2, 2


@pytest.fixture(scope="module")
def pool():
    p = torch_dist.Pool(4)
    yield p
    p.close()


def _jmesh():
    return create_mesh(n_data=ND, n_model=NM, devices=jax.devices()[:4])


def _port_dims(spec_tree):
    """The JAX spec tree as the port's {name: split dim}: a kernel [in,
    out] split on out is dim 0 of the port's [out, in] weight, split on
    in dim 1; a split bias dim 0."""
    names = params_from_jax(jax.tree.map(lambda s: np.zeros(1), spec_tree))
    flat = jax.tree_util.tree_flatten_with_path(spec_tree)[0]
    out = {}
    for (path, sharding), name in zip(flat, names):
        spec = tuple(sharding.spec)
        leaf = str(getattr(path[-1], "key", path[-1]))
        if "model" not in spec:
            out[name] = None
        elif leaf == "kernel":
            out[name] = 0 if spec[-1] == "model" else 1
        else:
            out[name] = 0
    return out


def test_split_names_match_jax(pool):
    """Every parameter's decision, for a bi-encoder (projection head), a
    cross-encoder (binary head) and an untied MLM head; the same layout on
    the ranks; a width the model size does not divide is refused."""
    mesh = _jmesh()
    jbi, pbi, bi = biencoder_pair(jax_bert(dtype=F32), seed=1,
                                  projection_dim=32)
    jce, pce, ce = crossencoder_pair(jax_bert(dtype=F32), seed=2,
                                     binary_head=True)
    bert = jax_bert(dtype=F32)
    jmlm = JaxMLMHead(bert).init(jax.random.PRNGKey(3),
                                 jnp.ones((1, 2, bert.hidden_size)))
    mlm = MLMHead(port_bert(bert), tied=False)
    for params, port in ((pbi, bi), (pce, ce), (jmlm, mlm)):
        want = _port_dims(jspecs(params, mesh)["params"])
        got = tp_param_shardings(port)
        assert got == want
        assert set(got.values()) == {None, 0, 1} or port is mlm
    dims = pool.run(torch_dist.tp_layout, bi.cfg, torch_dist.numpy_state(bi),
                    ND, NM)
    assert all(d == tp_param_shardings(bi) for d in dims)
    # an FFN width the model axis does not divide: JAX cannot place it
    jodd, podd, odd = biencoder_pair(jax_bert(dtype=F32,
                                              intermediate_size=255), seed=3)
    with pytest.raises(ValueError):
        jax.block_until_ready(jshard(podd, mesh))
    with pytest.raises(ValueError, match="does not divide by the model"):
        tp_param_shardings(odd, Mesh(torch.device("cpu"), model_mesh=Mesh(
            torch.device("cpu"), world_size=NM)))


def _jax_tp_run(jstep, params, batches, extra=()):
    mesh = _jmesh()
    state = JaxTrainState.create(jshard(jax.tree.map(jnp.copy, params), mesh),
                                 jmake_adamw(**DIST_TX))
    metrics = []
    for b in batches:
        state, m = jstep(state, *extra, shard_batch(b, mesh))
        metrics.append(jax.device_get(m))
    return metrics, state.params


def _check(got, jmetrics, jparams, port):
    want = params_from_jax(jax.device_get(jparams))
    split = tp_param_shardings(port)
    for rank, (metrics, full, local, worst) in enumerate(got):
        for step, jm in zip(metrics, jmetrics):
            assert set(step) == set(jm)
            for key, value in jm.items():
                np.testing.assert_allclose(step[key], float(value),
                                           rtol=1e-5, atol=1e-6,
                                           err_msg=key)
        for name, shape in local.items():         # the layout after steps
            full_shape = list(want[name].shape)
            if split[name] is not None:
                full_shape[split[name]] //= NM
            assert list(shape) == full_shape, name
        assert worst <= 1e-6, (rank, worst)
    full = got[0][1]
    for name, w in want.items():
        err = float(np.abs(full[name] - w.numpy()).max())
        assert err <= 1e-5, (name, err)


def test_tp_biencoder_step_matches_jax(pool):
    """``tests/test_parallel.py:120`` at (data 2, model 2): the TP layout
    through 2 steps and the JAX ``auto_state=True`` step's numbers."""
    jmodel, params, port = biencoder_pair(jax_bert(dtype=F32), seed=41)
    batches = [dist_batch(50 + s) for s in range(2)]
    jstep = jmake_de(jmodel, jmake_adamw(**DIST_TX), _jmesh(),
                     auto_state=True)
    jm, jp = _jax_tp_run(jstep, params, batches)
    got = pool.run(torch_dist.tp_train_steps, "biencoder", port.cfg,
                   torch_dist.numpy_state(port), batches, DIST_TX, ND, NM)
    _check(got, jm, jp, port)


def test_tp_retriever_step_matches_jax(pool):
    """The AR2 retriever step with ``auto_state=True`` (adv_lambda 0.5):
    the retriever and its CE teacher both split over the model axis."""
    jde, de_params, pde = biencoder_pair(jax_bert(dtype=F32), seed=42)
    jce, ce_params, pce = crossencoder_pair(jax_bert(dtype=F32), seed=43)
    batches = [dist_batch(60 + s) for s in range(2)]
    mesh = _jmesh()
    jstep = jmake_ar2(jde, jce, jmake_adamw(**DIST_TX), mesh,
                      auto_state=True)
    jm, jp = _jax_tp_run(jstep, de_params, batches,
                         extra=(jshard(jax.tree.map(jnp.copy, ce_params),
                                       mesh),))
    got = pool.run(torch_dist.tp_train_steps, "retriever", pde.cfg,
                   torch_dist.numpy_state(pde), batches, DIST_TX, ND, NM,
                   (pce.cfg, torch_dist.numpy_state(pce)))
    _check(got, jm, jp, pde)


def _mlm_state(bert):
    torch.manual_seed(7)
    from simxns_tpu_torch.models import BertEncoder

    enc, head = BertEncoder(bert), MLMHead(bert, tied=False)
    for p in list(enc.parameters()) + list(head.parameters()):
        torch.nn.init.normal_(p, std=0.05) if p.ndim > 1 else \
            torch.nn.init.normal_(p, mean=0.0, std=0.05)
    state = {f"enc.{k}": v.numpy() for k, v in enc.state_dict().items()}
    state.update({f"head.{k}": v.numpy()
                  for k, v in head.state_dict().items()})
    return state


@pytest.mark.parametrize("case", ["attention", "ffn_knob", "int8_view",
                                  "mlm"])
def test_split_paths_match_whole(pool, case):
    """Where JAX hands a Pallas kernel (or an odd head count) to GSPMD, the
    split module computes what the whole one does, on every rank."""
    kw = {"attention": dict(hidden_size=96, num_heads=3,
                            intermediate_size=192),
          "ffn_knob": dict(ffn_impl="fused_vjp"),
          "int8_view": {}, "mlm": dict(vocab_size=256)}[case]
    bert = jax_bert(dtype=F32, **kw)
    rng = np.random.default_rng(5)
    ids = rng.integers(4, bert.vocab_size, (8, 16)).astype(np.int32)
    batch = {"q_ids": ids, "q_mask": np.ones_like(ids)}
    if case == "mlm":
        cfg = port_bert(bert)
        state = _mlm_state(cfg)
    else:
        _, _, port = biencoder_pair(bert, seed=44)
        cfg, state = port.cfg, torch_dist.numpy_state(port)
    got = pool.run(torch_dist.tp_paths, case, cfg, state, batch, NM)
    for out_err, out_scale, grad_err, grad_scale in got:
        assert out_err <= 1e-5 * out_scale, (case, out_err, out_scale)
        assert grad_err <= 1e-5 * grad_scale, (case, grad_err, grad_scale)


def test_tp_checkpoint_loads_on_one_device(pool, tmp_path):
    """A split state's checkpoint holds full tensors: it loads into a whole
    ``TrainState`` on one device (equal to the JAX TP step's parameters)
    and re-splits into the live slices bit for bit."""
    jmodel, params, port = biencoder_pair(jax_bert(dtype=F32), seed=45)
    batch = dist_batch(70)
    jstep = jmake_de(jmodel, jmake_adamw(**DIST_TX), _jmesh(),
                     auto_state=True)
    jm, jp = _jax_tp_run(jstep, params, [batch])
    got = pool.run(torch_dist.tp_checkpoint, port.cfg,
                   torch_dist.numpy_state(port), batch, DIST_TX,
                   str(tmp_path), ND, NM)
    assert all(same for _, same in got)
    np.testing.assert_allclose([loss for loss, _ in got],
                               float(jm[0]["loss"]), rtol=1e-5)
    whole = BiEncoder(port.cfg)
    state = restore_checkpoint(str(tmp_path),
                               TrainState.create(whole, make_adamw(**DIST_TX)),
                               1, name="tp_state")
    assert state.step == 1
    want = params_from_jax(jax.device_get(jp))
    for name, p in whole.named_parameters():
        err = float((p.detach() - want[name]).abs().max())
        assert err <= 1e-5, (name, err)
