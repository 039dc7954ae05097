"""The port's MASTER launcher (``run_pretrain``) on the CPU: the tiny
``master_pretrain`` runs of ``tests/test_run.py:78, 342`` (the encoder
export, the resume) and its trajectory against the JAX launcher's from the
same initial weights: the collator's batches are bitwise JAX's (numpy and
C++ on both sides), so each step's loss agrees within 1e-5 relative (f32
tiny models; 6e-8 measured on the CPU)."""

import json
import os

import jax
import numpy as np
import torch

from simxns_tpu import run as jrun
from simxns_tpu.data import CondenserCollator as JCollator
from simxns_tpu.data import HashTokenizer as JHashTokenizer
from simxns_tpu.data import TokenMeta as JTokenMeta
from simxns_tpu.models import BertConfig as JBertConfig
from simxns_tpu.models import Condenser as JCondenser
from simxns_tpu.models import CondenserConfig as JCondenserConfig
from simxns_tpu_torch import run as prun
from simxns_tpu_torch.io import encoder_into, restore_checkpoint
from simxns_tpu_torch.models import (BertConfig, BiEncoder, BiEncoderConfig,
                                     params_from_jax)
from torch_parity import one_torch_thread  # noqa: F401

PT_TINY = ["--recipe", "master_pretrain", "--synthetic", "--batch", "8"]


def _losses(directory):
    with open(os.path.join(directory, "metrics.jsonl"), encoding="utf-8") as f:
        return [(r["step"], r["loss"]) for r in map(json.loads, f)
                if r.get("phase") == "pretrain"]


def _jax_init_condenser(cfg, seed):
    """The JAX launcher's initial weights (``model.init(PRNGKey(seed),
    ...)``; the parameters do not depend on the init batch)."""
    bert = JBertConfig.tiny(
        vocab_size=2048,
        max_position_embeddings=cfg.bert.max_position_embeddings)
    coll = JCollator(JTokenMeta.for_hash_tokenizer(JHashTokenizer(2048)),
                     max_seq_length=32, seed=99)
    rng = np.random.default_rng(99)
    batch = coll([{"text": rng.integers(5, 2000, size=20).tolist()}
                  for _ in range(2)])
    params = JCondenser(JCondenserConfig(
        bert=bert, n_head_layers=cfg.n_head_layers)).init(
            jax.random.PRNGKey(seed), batch, deterministic=True)
    model = prun.Condenser(cfg)
    model.load_state_dict(params_from_jax(jax.device_get(params)))
    return model


def test_pretrain_recipe_exports_encoder(tmp_path):
    """``tests/test_run.py:78``: 4 steps, ``pretrain_state`` every
    steps // 5, the encoder export (no head) that loads into a
    ``BiEncoder`` tower, eval.json with the collator's path."""
    out = prun.main([*PT_TINY, "--steps", "4", "--device", "cpu",
                     "--output-dir", str(tmp_path)])
    assert np.isfinite(out["final_loss"]) and out["steps"] == 4
    names = set(os.listdir(tmp_path))
    assert {"encoder-4", "pretrain_state-4", "eval.json"} <= names
    with open(tmp_path / "eval.json", encoding="utf-8") as f:
        assert json.load(f)["collator_path"] in ("native", "numpy")
    tree = restore_checkpoint(str(tmp_path), None, 4, name="encoder")
    params = tree["params"]
    assert not any(k.startswith(("c_head", "query_head", "gpt_head",
                                 "next_head", "overlap_head"))
                   for k in params)
    bi = BiEncoder(BiEncoderConfig(bert=BertConfig.tiny(
        vocab_size=2048, max_position_embeddings=64)))
    encoder_into(params, bi.question_model)
    assert torch.equal(
        bi.question_model.encoder.embeddings.word_embeddings.weight,
        params["encoder.embeddings.word_embeddings.weight"])


def test_pretrain_resume_continues(tmp_path):
    """``tests/test_run.py:342``: 4 steps, then a relaunch to 6 resumes at
    4 (the example stream reseeded with seed + 4)."""
    base = [*PT_TINY, "--device", "cpu", "--output-dir", str(tmp_path)]
    prun.main(base + ["--steps", "4"])
    assert "pretrain_state-4" in os.listdir(tmp_path)
    out = prun.main(base + ["--steps", "6"])
    assert np.isfinite(out["final_loss"]) and out["steps"] == 6
    assert [s for s, _ in _losses(tmp_path)][-2:] == [5, 6]
    assert "encoder-6" in os.listdir(tmp_path)


def test_pretrain_trajectory_matches_jax(tmp_path, monkeypatch):
    """From the JAX run's initial weights: the loss of each of 6 steps
    within 1e-5 relative."""
    argv = [*PT_TINY, "--steps", "6"]
    want = jrun.main(argv + ["--output-dir", str(tmp_path / "jax")])
    monkeypatch.setattr(prun, "init_condenser", _jax_init_condenser)
    got = prun.main(argv + ["--device", "cpu", "--output-dir",
                            str(tmp_path / "port")])
    lg, lw = _losses(tmp_path / "port"), _losses(tmp_path / "jax")
    assert [s for s, _ in lg] == [s for s, _ in lw] == list(range(1, 7))
    for (step, g), (_, w) in zip(lg, lw):
        assert abs(g - w) <= 1e-5 * abs(w), (step, g, w)
    assert abs(got["final_loss"] - want["final_loss"]) <= 1e-5 * abs(
        want["final_loss"])
