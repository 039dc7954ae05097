"""The port's data-parallel AR2 retriever step (gloo ranks) against the JAX
step on ``create_mesh(n_data=W)``, W in {2, 4}, over 2 steps from the same
weights and global batches, at ``adv_lambda=0.5`` (the adversarial term
divided by the group's world size once): the metrics within 1e-4
relative, the parameters within 1e-5, every rank's parameters bitwise
equal (``torch_parity.check_ranks``). A file of its own (its own pool of 4
ranks) so that the suite's workers share the step tests out.
"""

import jax.numpy as jnp
import pytest

from simxns_tpu.parallel import create_mesh
from simxns_tpu.train import make_adamw as jmake_adamw
from simxns_tpu.train import make_ar2_retriever_step as jmake_ar2
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


@pytest.mark.parametrize("w", [2, 4])
def test_ar2_retriever_step_matches_jax_mesh(pool, w):
    """adv_lambda=0.5: the adversarial term divided by the group's world
    size once (the default ``adv_world_size``, JAX's ``dp_size``)."""
    jde, de_params, port_de = biencoder_pair(jax_bert(dtype=F32), seed=33)
    jce, ce_params, port_ce = crossencoder_pair(jax_bert(dtype=F32), seed=34)
    batches = [dist_batch(60 + s) for s in range(2)]
    kw = dict(temperature=0.8, adv_lambda=0.5, scale_scores=0.25)
    mesh = create_mesh(n_data=w)
    jstep = jmake_ar2(jde, jce, jmake_adamw(**DIST_TX), mesh, **kw)
    jm, jp = jax_mesh_run(jstep, de_params, batches, mesh,
                          extra=(ce_params,))
    got = pool.run(torch_dist.train_steps, "retriever", port_de.cfg,
                   torch_dist.numpy_state(port_de), batches, DIST_TX, kw,
                   (port_ce.cfg, torch_dist.numpy_state(port_ce)), world=w)
    check_ranks(got, jm, jp)
