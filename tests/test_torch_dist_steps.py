"""The port's data-parallel bi-encoder step (gloo ranks) against the JAX
step on ``create_mesh(n_data=W)``, W in {2, 4}, both gather modes, over 2
steps from the same weights and global batches: the metrics within 1e-4
relative, the parameters within 1e-5, every rank's parameters bitwise equal
(``torch_parity.check_ranks``). The reranker step and the collectives are
in ``test_torch_parallel.py``, the AR2 retriever step in
``test_torch_dist_ar2.py``; each file has its own pool of 4 ranks.
"""

import jax.numpy as jnp
import pytest

from simxns_tpu.parallel import create_mesh
from simxns_tpu.train import make_adamw as jmake_adamw
from simxns_tpu.train import make_biencoder_step as jmake_de
import torch_dist
from torch_parity import (DIST_TX, biencoder_pair, check_ranks, dist_batch,
                          jax_bert, jax_mesh_run)
from torch_parity import one_torch_thread  # noqa: F401

F32 = jnp.float32


@pytest.fixture(scope="module")
def pool():
    p = torch_dist.Pool(4)
    yield p
    p.close()


@pytest.mark.parametrize("w,mode", [(2, "full"), (2, "local"), (4, "full"),
                                    (4, "local")])
def test_biencoder_step_matches_jax_mesh(pool, w, mode):
    """In-batch negatives gathered over the group, ``positive_idx`` a global
    flat index, 2 steps."""
    jmodel, params, port = biencoder_pair(jax_bert(dtype=F32), seed=31)
    batches = [dist_batch(40 + s) for s in range(2)]
    mesh = create_mesh(n_data=w)
    jstep = jmake_de(jmodel, jmake_adamw(**DIST_TX), mesh, grad_mode=mode)
    jm, jp = jax_mesh_run(jstep, params, batches, mesh)
    got = pool.run(torch_dist.train_steps, "biencoder", port.cfg,
                   torch_dist.numpy_state(port), batches, DIST_TX,
                   {"grad_mode": mode}, world=w)
    check_ranks(got, jm, jp)
