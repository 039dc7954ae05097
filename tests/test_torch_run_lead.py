"""The port's LEAD launcher (``run_lead``) on the CPU: the tiny
``lead_ms_distill`` runs of ``tests/test_run.py:169, 260, 351`` (outputs,
the frozen CE's int8 view, the resume) and two trajectories against the
JAX launcher's from the same initial weights (the student at
PRNGKey(seed), the CE at PRNGKey(seed + 1)): every joint step's loss
within 2e-3 relative with the CE trained, 4e-3 with it frozen behind its
int8 view (JAX's layer interpreted), and the same top-1. The
tolerances: the joint phase starts after 60 warm-up steps of f32 AdamW at
eps=1e-8, whose noise-level updates (``test_torch_train.py``) move the
joint losses by up to 4.3e-4 relative (measured on the CPU), and int8
codes near a rounding edge flip with them (up to 1.1e-3); the limits
leave about 4x for another CPU's summation order (a wrong loss term moves
them by percents)."""

import json
import os

import jax
import numpy as np
import pytest

import simxns_tpu.ops.fused_layer as jfl
from simxns_tpu import run as jrun
from simxns_tpu.models import BertConfig as JBertConfig
from simxns_tpu.models import BiEncoder as JBiEncoder
from simxns_tpu.models import BiEncoderConfig as JBiEncoderConfig
from simxns_tpu.models import CrossEncoder as JCrossEncoder
from simxns_tpu.models import CrossEncoderConfig as JCrossEncoderConfig
from simxns_tpu_torch import run as prun
from simxns_tpu_torch.models import params_from_jax
from torch_parity import one_torch_thread  # noqa: F401

LEAD_TINY = ["--recipe", "lead_ms_distill", "--synthetic", "--batch", "8",
             "--corpus-size", "48", "--num-queries", "16"]


def _losses(directory):
    with open(os.path.join(directory, "metrics.jsonl"), encoding="utf-8") as f:
        return [(r["step"], r["loss"]) for r in map(json.loads, f)
                if r.get("phase") == "lead"]


def _jax_init_models(de_cfg, ce_cfg, seed):
    """The JAX launcher's initial weights (``run.py:1494-1506``) in the
    port's shared-tower student and per-layer-logit CE."""
    bert = JBertConfig.tiny(vocab_size=de_cfg.bert.vocab_size,
                            max_position_embeddings=256)
    d = np.ones((2, 8), np.int32)
    jde = JBiEncoder(JBiEncoderConfig(
        bert=bert, share_weight=de_cfg.share_weight)).init(
            jax.random.PRNGKey(seed), d, d, d, d)
    jce = JCrossEncoder(JCrossEncoderConfig(bert=bert)).init(
        jax.random.PRNGKey(seed + 1), d, d)
    de, ce = prun.BiEncoder(de_cfg), prun.CrossEncoder(ce_cfg)
    de.load_state_dict(params_from_jax(jax.device_get(jde)))
    ce.load_state_dict(params_from_jax(jax.device_get(jce)))
    return de, ce


def test_lead_recipe_runs_joint_distillation(tmp_path):
    """``tests/test_run.py:169``: 8 joint steps, the student and the
    teacher written with eval.json."""
    out = prun.main([*LEAD_TINY, "--steps", "8", "--device", "cpu",
                     "--output-dir", str(tmp_path)])
    assert out["steps"] == 8 and np.isfinite(out["final_loss"])
    assert 0.0 <= out["top1"] <= 1.0
    names = set(os.listdir(tmp_path))
    assert {"student-8", "teacher_ce-8", "eval.json"} <= names
    assert [s for s, _ in _losses(tmp_path)] == list(range(1, 9))


def test_lead_resume_continues(tmp_path):
    """``tests/test_run.py:351``: 12 steps (the re-draw and its states at
    step 10), then a relaunch to 14 resumes at 10: steps 11-14 run again
    and the final outputs are at 14."""
    base = [*LEAD_TINY, "--device", "cpu", "--output-dir", str(tmp_path)]
    prun.main(base + ["--steps", "12"])
    names = set(os.listdir(tmp_path))
    assert {"lead_db_state-10", "lead_ce_state-10", "student-12"} <= names
    out = prun.main(base + ["--steps", "14"])
    assert out["steps"] == 14 and np.isfinite(out["final_loss"])
    assert [s for s, _ in _losses(tmp_path)][-4:] == [11, 12, 13, 14]
    assert {"student-14", "teacher_ce-14"} <= set(os.listdir(tmp_path))


@pytest.mark.parametrize("extra,rtol", [
    ((), 2e-3), (("--freeze-teachers", "--fast-teacher"), 4e-3)])
def test_lead_trajectory_matches_jax(tmp_path, monkeypatch, extra, rtol):
    """From the JAX run's initial weights, 8 joint steps: each loss within
    ``rtol`` of JAX's and the same top-1; with ``--freeze-teachers
    --fast-teacher`` (``tests/test_run.py:260``) the frozen CE runs its
    int8 view (JAX's fused layer interpreted) and stays unchanged."""
    argv = [*LEAD_TINY, "--steps", "8", *extra]
    old = jfl.INTERPRET
    jfl.INTERPRET = True
    try:
        want = jrun.main(argv + ["--output-dir", str(tmp_path / "jax")])
    finally:
        jfl.INTERPRET = old
    monkeypatch.setattr(prun, "init_models", _jax_init_models)
    got = prun.main(argv + ["--device", "cpu", "--output-dir",
                            str(tmp_path / "port")])
    lg, lw = _losses(tmp_path / "port"), _losses(tmp_path / "jax")
    assert [s for s, _ in lg] == [s for s, _ in lw] == list(range(1, 9))
    for (step, g), (_, w) in zip(lg, lw):
        assert abs(g - w) <= rtol * abs(w), (step, g, w)
    assert got["top1"] == want["top1"]
