"""Shared helpers of the tests that hold ``simxns_tpu_torch`` to ``simxns_tpu``.

The same inputs, made with numpy from a seed, go through the JAX function
(on the CPU, Pallas kernels in interpret mode) and its port (on the CPU,
where every kernel wrapper runs its plain PyTorch version).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simxns_tpu.models import BertConfig as JaxBertConfig
from simxns_tpu.models import BiEncoder as JaxBiEncoder
from simxns_tpu.models import BiEncoderConfig as JaxBiEncoderConfig
from simxns_tpu.models import CrossEncoder as JaxCrossEncoder
from simxns_tpu.models import CrossEncoderConfig as JaxCrossEncoderConfig
from simxns_tpu_torch.models import (BertConfig, BiEncoder, BiEncoderConfig,
                                     CrossEncoder, CrossEncoderConfig,
                                     params_from_jax)

# tests/test_star_bpe.py puts stub boto3 modules (no __spec__) into
# sys.modules while it runs; a first import of accelerate after that, which
# transformers' generation code makes (tests/test_t5.py,
# tests/test_hf_import.py), fails in the same process. Imported here, at
# collection, in every test worker, it is loaded before any stub exists,
# whatever order the test runner gives those files.
try:
    import accelerate  # noqa: F401
except ImportError:
    pass

_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}

TINY = dict(vocab_size=1024, hidden_size=128, num_layers=2, num_heads=4,
            intermediate_size=256, max_position_embeddings=128)

# the tiny co-training launcher run (the shape of tests/test_run.py:21-23)
RUN_TINY = ["--synthetic", "--steps", "12", "--batch", "8", "--corpus-size",
            "64", "--num-queries", "24", "--warm-epochs", "2"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each test of a module that imports this fixture runs the port on one
    intra-op thread. The test runner's workers share the machine's cores:
    tiny ops split over every core then wait on threads that another
    worker has descheduled (the launcher tests ran 10-50x slower so)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_bert(**kw) -> JaxBertConfig:
    base = dict(TINY, hidden_dropout=0.0, attention_dropout=0.0)
    base.update(kw)
    return JaxBertConfig(**base)


def port_bert(cfg: JaxBertConfig) -> BertConfig:
    """The port's config for a JAX ``BertConfig`` (same fields)."""
    fields = {f: getattr(cfg, f) for f in BertConfig.__dataclass_fields__}
    fields["dtype"] = _DTYPES[cfg.dtype]
    fields["param_dtype"] = _DTYPES[cfg.param_dtype]
    return BertConfig(**fields)


def biencoder_pair(bert: JaxBertConfig, seed: int = 0, **bi_kw):
    """(jax model, jax params, port model) with identical weights."""
    jcfg = JaxBiEncoderConfig(bert=bert, **bi_kw)
    jmodel = JaxBiEncoder(jcfg)
    dummy = np.ones((2, 8), np.int32)
    params = jmodel.init(jax.random.PRNGKey(seed), dummy, dummy, dummy, dummy)
    # non-trivial LayerNorm/bias values, so a misplaced one shows
    rng = np.random.default_rng(seed + 100)
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: _jitter(path, x, rng), params)
    port = BiEncoder(BiEncoderConfig(bert=port_bert(bert), **bi_kw))
    port.load_state_dict(params_from_jax(jax.device_get(params)))
    return jmodel, params, port.eval()


def crossencoder_pair(bert: JaxBertConfig, seed: int = 0,
                      binary_head: bool = False):
    """(jax model, jax params, port model) with identical weights."""
    jmodel = JaxCrossEncoder(JaxCrossEncoderConfig(bert=bert,
                                                   binary_head=binary_head))
    dummy = np.ones((2, 8), np.int32)
    params = jmodel.init(jax.random.PRNGKey(seed), dummy, dummy)
    rng = np.random.default_rng(seed + 100)
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: _jitter(path, x, rng), params)
    port = CrossEncoder(CrossEncoderConfig(bert=port_bert(bert),
                                           binary_head=binary_head))
    port.load_state_dict(params_from_jax(jax.device_get(params)))
    return jmodel, params, port.eval()


def _jitter(path, x, rng):
    name = str(path[-1].key)
    if name in ("scale", "bias"):
        noise = rng.normal(0, 0.05, x.shape).astype(np.float32)
        return x + jnp.asarray(noise)
    return x


def token_batch(rng, b: int, s: int, vocab: int = 1024, min_len: int = 4):
    """Token ids with a random-length tail of padding, and their mask."""
    ids = rng.integers(4, vocab, (b, s)).astype(np.int32)
    lens = rng.integers(min_len, s + 1, b)
    mask = (np.arange(s)[None, :] < lens[:, None]).astype(np.int32)
    ids[:, 0] = 1
    return ids * mask, mask


def run_losses(directory) -> list:
    """(step, kind, loss) of every co-training step a launcher run logged
    in ``directory/metrics.jsonl``."""
    out = []
    with open(os.path.join(directory, "metrics.jsonl"), encoding="utf-8") as f:
        for line in f:
            rec = json.loads(line)
            if rec["phase"] in ("reranker", "retriever"):
                out.append((rec["step"], rec["phase"], rec["loss"]))
    return out


def cosine_rows(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1)
                             * np.linalg.norm(b, axis=1))


# --- data parallelism: gloo ranks (tests/torch_dist.py) against the mesh ----

DIST_N, DIST_M = 4, 2       # global queries (W in {2, 4} divides it), group
DIST_TX = dict(lr=1e-4, total_steps=0, eps=1e-3)


def dist_batch(seed):
    """A global AR2 batch of ``DIST_N`` queries x ``DIST_M`` passages."""
    n, m = DIST_N, DIST_M
    rng = np.random.default_rng(seed)
    q_ids, q_mask = token_batch(rng, n, 8)
    ctx_ids, ctx_mask = token_batch(rng, n * m, 12)
    joint_ids, joint_mask = token_batch(rng, n * m, 20)
    return {"q_ids": q_ids, "q_mask": q_mask, "ctx_ids": ctx_ids,
            "ctx_mask": ctx_mask,
            "positive_idx": (np.arange(n) * m).astype(np.int32),
            "joint_ids": joint_ids.reshape(n, m, 20),
            "joint_mask": joint_mask.reshape(n, m, 20)}


def jax_mesh_run(jstep, jparams, batches, mesh, extra=()):
    """The JAX step over ``batches`` on ``mesh`` from ``jparams`` (AdamW at
    ``DIST_TX``). -> (metrics per step, the final params)."""
    from simxns_tpu.parallel import shard_batch
    from simxns_tpu.train import TrainState, make_adamw

    state = TrainState.create(jax.tree.map(jnp.copy, jparams),
                              make_adamw(**DIST_TX))
    metrics = []
    for b in batches:
        state, m = jstep(state, *extra, shard_batch(b, mesh))
        metrics.append(jax.device_get(m))
    return metrics, state.params


def check_ranks(got, jmetrics, jparams):
    """Every rank's ``(metrics per step, params)``: the JAX metrics within
    1e-4 relative, the parameters within 1e-5 (AdamW at eps=1e-3, as
    ``test_torch_train.py`` explains), and rank 0's parameter bits."""
    want = params_from_jax(jax.device_get(jparams))
    bits = got[0][1]
    for metrics, params in got:
        for step, jm in zip(metrics, jmetrics):
            assert set(step) == set(jm)
            for key, value in jm.items():
                np.testing.assert_allclose(step[key], float(value),
                                           rtol=1e-4, atol=1e-6,
                                           err_msg=key)
        for name, p in params.items():
            err = float(np.abs(p - want[name].numpy()).max())
            assert err <= 1e-5, (name, err)
            np.testing.assert_array_equal(p, bits[name], err_msg=name)
