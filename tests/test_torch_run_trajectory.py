"""The port's tiny ``nq_ar2_simans`` co-training run against the JAX
package's launcher from the same initial weights. A file of its own: the
JAX run is the slow part of the launcher tests, and a separate file lets a
test runner that splits work by file give it a worker of its own."""

import jax
import numpy as np

from simxns_tpu import run as jrun
from simxns_tpu.models import BertConfig as JaxBertConfig
from simxns_tpu.models import BiEncoder as JaxBiEncoder
from simxns_tpu.models import BiEncoderConfig as JaxBiEncoderConfig
from simxns_tpu.models import CrossEncoder as JaxCrossEncoder
from simxns_tpu.models import CrossEncoderConfig as JaxCrossEncoderConfig
from simxns_tpu_torch import run as prun
from simxns_tpu_torch.models import params_from_jax
from torch_parity import RUN_TINY, run_losses
from torch_parity import one_torch_thread  # noqa: F401


def _jax_init_models(de_cfg, ce_cfg, seed):
    """The JAX launcher's initial weights (``run.py:760-765``: de.init at
    PRNGKey(seed), ce.init at PRNGKey(seed + 1)) in the port's models."""
    bert = JaxBertConfig.tiny(vocab_size=de_cfg.bert.vocab_size,
                              max_position_embeddings=256)
    dummy = np.ones((2, 8), np.int32)
    jde = JaxBiEncoder(JaxBiEncoderConfig(bert=bert)).init(
        jax.random.PRNGKey(seed), dummy, dummy, dummy, dummy)
    jce = JaxCrossEncoder(JaxCrossEncoderConfig(bert=bert)).init(
        jax.random.PRNGKey(seed + 1), dummy, dummy)
    de, ce = prun.BiEncoder(de_cfg), prun.CrossEncoder(ce_cfg)
    de.load_state_dict(params_from_jax(jax.device_get(jde)))
    ce.load_state_dict(params_from_jax(jax.device_get(jce)))
    return de, ce


def test_trajectory_matches_jax(tmp_path, monkeypatch):
    """From the JAX run's initial weights: every top-1 reading within one
    query (1/24) and each co-training loss of the first window (steps 1-6)
    within 1e-3 relative of the JAX run's (f32 models; the JAX run on its
    8-device CPU mesh, where the full-gradient mode gathers one device's
    loss; adv_lambda=0 in this recipe)."""
    want = jrun.main(["--recipe", "nq_ar2_simans", *RUN_TINY,
                      "--output-dir", str(tmp_path / "jax")])
    monkeypatch.setattr(prun, "init_models", _jax_init_models)
    got = prun.main(["--recipe", "nq_ar2_simans", *RUN_TINY, "--device",
                     "cpu", "--output-dir", str(tmp_path / "port")])
    assert len(got["history_top1"]) == len(want["history_top1"]) == 3
    for g, w in zip(got["history_top1"] + [got["top1"]],
                    want["history_top1"] + [want["top1"]]):
        assert abs(g - w) <= 1 / 24 + 1e-9
    lg, lw = run_losses(tmp_path / "port"), run_losses(tmp_path / "jax")
    assert [x[:2] for x in lg] == [x[:2] for x in lw] and len(lg) == 12
    for (step, _, g), (_, _, w) in zip(lg, lw):
        if step <= 6:
            assert abs(g - w) <= 1e-3 * abs(w), (step, g, w)
