"""The port's multislice mesh (``create_multislice_mesh``, the ``replica``
axis) on 4 gloo ranks as 2 slices x 2, against the JAX package's
``create_multislice_mesh(2, devices=jax.devices()[:4])``: the four cases of
``tests/test_multislice.py`` (the mesh's shape, global-scope training
equal to the flat mesh, slice-scoped negatives against the per-slice
oracle, the index sharded within a slice); then the sharded
``DenseRetriever`` at W = 2 against world 1, and the PROD distillation
step under a data-parallel group against the JAX mesh. Metrics within
1e-4 relative and parameters within 1e-5 (AdamW at eps=1e-3, as
``test_torch_train.py`` explains); every rank's parameters bitwise equal.
The file has its own pool of ranks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simxns_tpu.parallel import create_mesh, create_multislice_mesh
from simxns_tpu.parallel import dp_axes as jdp_axes
from simxns_tpu.parallel import dp_size as jdp_size
from simxns_tpu.train import make_adamw as jmake_adamw
from simxns_tpu.train import make_biencoder_step as jmake_de
from simxns_tpu.train import make_kd_step as jmake_kd
from simxns_tpu_torch.data import HashTokenizer
from simxns_tpu_torch.serve import DenseRetriever
import torch_dist
from torch_parity import (DIST_TX, biencoder_pair, check_ranks,
                          crossencoder_pair, dist_batch, jax_bert,
                          jax_mesh_run)
from torch_parity import one_torch_thread  # noqa: F401

F32 = jnp.float32


@pytest.fixture(scope="module")
def pool():
    p = torch_dist.Pool(4)
    yield p
    p.close()


def _jmesh(flat=False):
    devs = jax.devices()[:4]
    return create_mesh(devices=devs) if flat else create_multislice_mesh(
        2, devices=devs)


def _batch(seed, n=8, s=12, v=1024):
    """``tests/test_multislice.py:_batch``: one passage per query."""
    rng = np.random.default_rng(seed)
    q = rng.integers(5, v, (n, s)).astype(np.int32)
    ctx = rng.integers(5, v, (n, s)).astype(np.int32)
    m = np.ones((n, s), np.int32)
    return {"q_ids": q, "q_mask": m, "ctx_ids": ctx, "ctx_mask": m,
            "positive_idx": np.arange(n, dtype=np.int32)}


def test_multislice_mesh_shape(pool):
    """Axis names, sizes, the data-parallel axes and size as JAX's; rank =
    (replica * n_data + data) * n_model + model; 3 slices refused."""
    jmesh = _jmesh()
    got = pool.run(torch_dist.multislice_facts)
    for rank, facts in enumerate(got):
        assert facts["axis_names"] == jmesh.axis_names
        assert facts["shape"] == dict(jmesh.shape)
        assert facts["dp_axes"] == jdp_axes(jmesh)
        assert facts["dp_size"] == jdp_size(jmesh) == 4
        assert (facts["rank"], facts["replica"], facts["slice_rank"],
                facts["slice_size"]) == (rank, rank // 2, rank % 2, 2)
        assert "not divisible by n_slices=3" in facts["error"]
    with pytest.raises(ValueError):
        create_multislice_mesh(3, devices=jax.devices()[:4])


@pytest.mark.parametrize("grad_mode", ["full", "local"])
def test_multislice_matches_flat_mesh_and_jax(pool, grad_mode):
    """Global-scope training on (2, 2, 1) equals the flat mesh of the same
    4 ranks, and both the JAX multislice run (3 steps)."""
    jmodel, params, port = biencoder_pair(jax_bert(dtype=F32), seed=21)
    batches = [_batch(s) for s in range(3)]
    jm, jp = jax_mesh_run(jmake_de(jmodel, jmake_adamw(**DIST_TX), _jmesh(),
                                   grad_mode=grad_mode),
                          params, batches, _jmesh())
    state = torch_dist.numpy_state(port)
    for flat in (False, True):
        got = pool.run(torch_dist.multislice_steps, port.cfg, state,
                       batches, DIST_TX, {"grad_mode": grad_mode}, flat)
        check_ranks(got, jm, jp)


def test_slice_scoped_negatives(pool):
    """``negatives_scope="slice"``: each slice's softmax over its own
    contexts; the loss the mean of the two halves' NLLs (the oracle of
    ``tests/test_multislice.py``), and the JAX slice-scoped step's."""
    jmodel, params, port = biencoder_pair(jax_bert(dtype=F32), seed=22)
    batch = _batch(30)
    mesh = _jmesh()
    jm, jp = jax_mesh_run(jmake_de(jmodel, jmake_adamw(**DIST_TX), mesh,
                                   negatives_scope="slice"),
                          params, [batch], mesh)
    got = pool.run(torch_dist.multislice_steps, port.cfg,
                   torch_dist.numpy_state(port), [batch], DIST_TX,
                   {"negatives_scope": "slice"}, False)
    check_ranks(got, jm, jp)
    with torch.no_grad():
        q = port.encode_query(torch.from_numpy(batch["q_ids"]).long(),
                              torch.from_numpy(batch["q_mask"]).long())
        c = port.encode_passage(torch.from_numpy(batch["ctx_ids"]).long(),
                                torch.from_numpy(batch["ctx_mask"]).long())
    q, c = q.double().numpy(), c.double().numpy()
    total = 0.0
    for half in (slice(0, 4), slice(4, 8)):
        scores = q[half] @ c[half].T
        logp = scores - np.log(np.exp(scores).sum(1, keepdims=True))
        total += -np.trace(logp)
    np.testing.assert_allclose(got[0][0][0]["loss"], total / 8, rtol=1e-5)
    with pytest.raises(ValueError, match="negatives_scope"):
        from simxns_tpu_torch.train import make_adamw, make_biencoder_step
        make_biencoder_step(make_adamw(1e-3), negatives_scope="pod")


def test_index_on_multislice_mesh(pool):
    """The index split over the data axis within a slice and replicated
    across slices: each slice's two shards hold the corpus, and every
    rank's top-k is the oracle's."""
    from simxns_tpu.index import MIPSIndex as JaxIndex

    rng = np.random.default_rng(2)
    n, h, k = 1024, 64, 5
    corpus = rng.standard_normal((n, h), dtype=np.float32)
    queries = rng.standard_normal((8, h), dtype=np.float32)
    oracle = np.argsort(-(queries @ corpus.T), axis=1)[:, :k]
    jidx = JaxIndex(_jmesh(), block_size=64, store_dtype=jnp.float32,
                    mode="exact")
    jidx.build(corpus)
    _, jids = jidx.search(queries, k)
    np.testing.assert_array_equal(jids, oracle)
    got = pool.run(torch_dist.multislice_index, corpus, queries, k, 64)
    for rank, ((scores, ids), rows, start) in enumerate(got):
        np.testing.assert_array_equal(ids, oracle)
        assert rows == n // 2 and start == (rank % 2) * (n // 2)


def _passages(n):
    """Passages whose query shares their tokens (clear answers)."""
    return {i: (f"passage {i} about fact{i} topic{i % 5}", f"title{i}")
            for i in range(n)}


def test_sharded_retriever_matches_world_one(pool):
    """``DenseRetriever(mesh=...)`` over 2 ranks: the index split in two,
    the passage chunk twice the encode chunk, and every rank the world-1
    retriever's ids (scores within f32 rounding of a split encode)."""
    _, _, port = biencoder_pair(jax_bert(dtype=F32), seed=23)
    passages = _passages(60)
    queries = [f"fact{i} topic{i % 5}" for i in range(0, 60, 7)]
    one = DenseRetriever(port, HashTokenizer(vocab_size=1024), device="cpu",
                         max_q_length=16, max_ctx_length=24,
                         index_mode="exact", block_size=16, encode_chunk=8,
                         query_batch=4)
    one.index_corpus(passages)
    want = [[(h.passage_id, h.score) for h in hits]
            for hits in one.search(queries, k=5)]
    got = pool.run(torch_dist.sharded_retriever, port.cfg,
                   torch_dist.numpy_state(port), passages, queries, 5, 16,
                   world=2)
    for hits, rows in got:
        assert rows == 32                   # 60 rows padded to 2 x 32
        assert [[i for i, _ in q] for q in hits] == [[i for i, _ in q]
                                                     for q in want]
        np.testing.assert_allclose([[s for _, s in q] for q in hits],
                                   [[s for _, s in q] for q in want],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("teacher_type", ["dual_encoder", "double"])
def test_kd_step_matches_jax_mesh(pool, teacher_type):
    """The PROD KD step at W = 2 (each rank a share of the global
    objective, the in-batch scores over the gathered contexts, ``double``
    picking by the global losses) against the JAX step on
    ``create_mesh(n_data=2)``, 2 steps."""
    jmodel, params, port = biencoder_pair(jax_bert(dtype=F32), seed=24)
    jde, de_params, pde = biencoder_pair(jax_bert(dtype=F32), seed=25)
    jce, ce_params, pce = crossencoder_pair(jax_bert(dtype=F32), seed=26)
    kw = dict(kd_type="KD_softmax", ce_weight=0.5, kd_weight=1.0,
              temperature=2.0)
    batches = [dist_batch(80 + s) for s in range(2)]
    mesh = create_mesh(n_data=2)
    jstep = jmake_kd(jmodel, jmake_adamw(**DIST_TX), mesh, teacher_type,
                     de_teacher_model=jde, ce_teacher_model=jce, **kw)
    jteachers = {"de": de_params, "ce": ce_params}
    jm, jp = jax_mesh_run(jstep, params, batches, mesh, extra=(jteachers,))
    teachers = {"de": (pde.cfg, torch_dist.numpy_state(pde)),
                "ce": (pce.cfg, torch_dist.numpy_state(pce))}
    got = pool.run(torch_dist.kd_steps, teacher_type, port.cfg,
                   torch_dist.numpy_state(port), teachers, batches, DIST_TX,
                   kw, world=2)
    check_ranks(got, jm, jp)
