"""The port's CAPSTONE launcher (``run_capstone``) on the CPU against the
JAX launcher's (``simxns_tpu/run.py:1678-1872``) from the same initial
dual encoder (JAX's at PRNGKey(seed), carried in with ``params_from_jax``):
the tiny ``--steps 8 --batch 8 --corpus-size 48 --num-queries 16`` run,
synthetic (with ``--qrels``) and with ``--query-tsv``: every logged loss
within 1e-5 relative of JAX's (~1e-6 measured: f32 AdamW at lr 3e-3 over
8 steps; a wrong expansion or bucket moves a loss by percents), the same
buckets, the same eval top-1 and MRR@10, and the TREC metrics' keys and
values. One JAX run per trajectory, shared through module fixtures. Then
port-only runs: a resume, a T5 ``--init-checkpoint`` with a
``--t5-tokenizer`` built here (nothing downloaded), and the refusals."""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from simxns_tpu import run as jrun
from simxns_tpu.models import BertConfig as JBertConfig
from simxns_tpu.models import BiEncoder as JBiEncoder
from simxns_tpu.models import BiEncoderConfig as JBiEncoderConfig
from simxns_tpu_torch import run as prun
from simxns_tpu_torch.models import params_from_jax
from torch_parity import one_torch_thread  # noqa: F401

RTOL = 1e-5
TINY = ["--recipe", "capstone_curriculum", "--synthetic", "--batch", "8",
        "--corpus-size", "48", "--num-queries", "16"]


def _jax_dual_encoder(cfg, seed):
    """The JAX launcher's initial dual encoder (``run.py:1782-1790``) in
    the port."""
    bert = JBertConfig.tiny(vocab_size=cfg.bert.vocab_size,
                            max_position_embeddings=256)
    d = np.ones((2, 8), np.int32)
    tree = JBiEncoder(JBiEncoderConfig(
        bert=bert, share_weight=cfg.share_weight,
        pooling=cfg.pooling)).init(jax.random.PRNGKey(seed), d, d, d, d)
    model = prun.BiEncoder(cfg)
    model.load_state_dict(params_from_jax(jax.device_get(tree)))
    return model


def _curriculum(directory):
    with open(os.path.join(directory, "metrics.jsonl"),
              encoding="utf-8") as f:
        return [(r["step"], r["loss"], r["bucket"]) for r in map(json.loads, f)
                if r.get("phase") == "curriculum"]


def _both(root, argv):
    """(JAX result, port result, JAX dir, port dir) of one tiny run."""
    want = jrun.main(argv + ["--output-dir", str(root / "jax")])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(prun, "init_dual_encoder", _jax_dual_encoder)
        got = prun.main(argv + ["--device", "cpu", "--output-dir",
                                str(root / "port")])
    return want, got, root / "jax", root / "port"


@pytest.fixture(scope="module")
def synthetic_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("capstone_synthetic")
    qrels = root / "qrels.txt"
    qrels.write_text("".join(f"{i} 0 {i} 2\n{i} 0 {(i + 5) % 48} 1\n"
                             for i in range(16)), encoding="utf-8")
    return _both(root, [*TINY, "--steps", "8", "--qrels", str(qrels)])


@pytest.fixture(scope="module")
def tsv_runs(tmp_path_factory):
    """``tests/test_run.py:204``'s TSV, with a third, mid-similar query, so
    the three buckets pick apart."""
    root = tmp_path_factory.mktemp("capstone_tsv")
    tsv = root / "doc2query.tsv"
    tsv.write_text("".join(f"{i}\tdocument {i} fact{i}\tnoise {i}\t"
                           f"what is in document {i}\n" for i in range(48)),
                   encoding="utf-8")
    return _both(root, [*TINY, "--steps", "8", "--query-tsv", str(tsv)])


@pytest.mark.parametrize("runs", ["synthetic_runs", "tsv_runs"])
def test_trajectory_matches_jax(request, runs):
    want, got, jdir, pdir = request.getfixturevalue(runs)
    lw, lg = _curriculum(jdir), _curriculum(pdir)
    assert [s for s, _, _ in lg] == [s for s, _, _ in lw] == list(range(1, 9))
    assert [b for _, _, b in lg] == [b for _, _, b in lw] == [3, 3, 2, 2,
                                                              1, 1, 1, 1]
    for (step, g, _), (_, w, _) in zip(lg, lw):
        assert abs(g - w) <= RTOL * abs(w), (step, g, w)
    assert got["steps"] == want["steps"] == 8
    assert abs(got["final_loss"] - want["final_loss"]) <= RTOL * abs(
        want["final_loss"])
    assert got["top1"] == want["top1"]
    assert got["mrr10"] == want["mrr10"]


def test_outputs_and_trec_metrics_equal_jax(synthetic_runs):
    want, got, _, pdir = synthetic_runs
    names = set(os.listdir(pdir))
    assert {f"curriculum_state-{s}" for s in range(1, 9)} <= names
    assert {"retriever-8", "eval.json", "metrics.jsonl"} <= names
    assert sorted(got["trec"]) == sorted(want["trec"])
    for key, val in want["trec"].items():
        assert abs(got["trec"][key] - val) <= 1e-9, key
    with open(os.path.join(pdir, "eval.json"), encoding="utf-8") as f:
        saved = json.load(f)
    assert saved["top1"] == got["top1"] and "trec" in saved


def test_resume_continues(tmp_path):
    """10 steps (states every 2), then a relaunch to 12 resumes at 10 and
    runs steps 11 and 12 in their buckets."""
    base = [*TINY, "--device", "cpu", "--output-dir", str(tmp_path)]
    prun.main(base + ["--steps", "10"])
    assert "curriculum_state-10" in os.listdir(tmp_path)
    out = prun.main(base + ["--steps", "12"])
    assert out["steps"] == 12 and np.isfinite(out["final_loss"])
    log = _curriculum(tmp_path)
    assert [s for s, _, _ in log][-2:] == [11, 12]
    assert [b for _, _, b in log][-2:] == [1, 1]
    assert {"curriculum_state-12", "retriever-12"} <= set(
        os.listdir(tmp_path))


def _t5_artifacts(root):
    """A random-init ``T5ForConditionalGeneration`` saved under HF's names
    and a word-level tokenizer over its vocabulary, saved as HF saves one
    (``tokenizers`` + ``PreTrainedTokenizerFast``)."""
    transformers = pytest.importorskip("transformers")
    from tokenizers import Tokenizer, models, pre_tokenizers

    words = ["<pad>", "</s>", "<unk>"] + [f"word{i}" for i in range(61)]
    tok = Tokenizer(models.WordLevel({w: i for i, w in enumerate(words)},
                                     unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    fast = transformers.PreTrainedTokenizerFast(
        tokenizer_object=tok, pad_token="<pad>", eos_token="</s>",
        unk_token="<unk>")
    fast.save_pretrained(str(root / "tokenizer"))
    cfg = transformers.T5Config(
        vocab_size=len(words), d_model=32, d_kv=8, d_ff=64, num_layers=1,
        num_decoder_layers=1, num_heads=4, relative_attention_num_buckets=8,
        dropout_rate=0.0, feed_forward_proj="relu")
    torch.manual_seed(0)
    model = transformers.T5ForConditionalGeneration(cfg)
    (root / "t5").mkdir()
    torch.save(model.state_dict(), str(root / "t5" / "pytorch_model.bin"))
    return str(root / "t5"), str(root / "tokenizer")


def test_t5_init_checkpoint_generates_the_tsv(tmp_path):
    """A T5 ``--init-checkpoint`` generates ``total_part`` = 3 queries for
    every passage inline (``run.py:1646-1675``), and the run trains on
    them to its end."""
    ckpt, tokenizer = _t5_artifacts(tmp_path)
    out_dir = tmp_path / "run"
    out = prun.main([*TINY, "--steps", "2", "--device", "cpu",
                     "--init-checkpoint", ckpt, "--t5-tokenizer", tokenizer,
                     "--output-dir", str(out_dir)])
    assert np.isfinite(out["final_loss"]) and out["steps"] == 2
    rows = (out_dir / "doc2query.tsv").read_text(
        encoding="utf-8").splitlines()
    assert len(rows) == 48
    for i, row in enumerate(rows):
        parts = row.split("\t")
        assert parts[0] == str(i) and len(parts) == 1 + 3
    assert "doc2query" in out["phase_times_s"]
    # without the tokenizer the run refuses, as JAX's
    with pytest.raises(SystemExit, match="--t5-tokenizer"):
        prun.main([*TINY, "--steps", "2", "--device", "cpu",
                   "--init-checkpoint", ckpt, "--output-dir",
                   str(tmp_path / "no_tok")])


def test_t5_tokenizer_needs_transformers(monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(SystemExit, match="transformers"):
        prun.load_t5_tokenizer("/nonexistent")


def test_t5_artifact_refused_outside_capstone(tmp_path):
    """``tests/test_t5.py:176``: a T5 artifact never warm-starts a BERT
    tower; the launcher of another recipe refuses it."""
    with pytest.raises(SystemExit, match="doc2query generator"):
        prun._init_bert_cfg({"family": "t5", "encoder": None, "mlm": None},
                            prun.BertConfig.tiny(), 128)
    ckpt, _ = _t5_artifacts(tmp_path)
    with pytest.raises(SystemExit, match="doc2query generator"):
        prun.main(["--recipe", "lead_ms_distill", "--synthetic", "--steps",
                   "1", "--batch", "8", "--corpus-size", "48",
                   "--num-queries", "16", "--device", "cpu",
                   "--init-checkpoint", ckpt])


def test_token_only_corpus_is_refused(tmp_path):
    """Above 20,000 passages the synthetic corpus is token-only, which the
    launcher cannot re-tokenize (``run.py:1707-1713``)."""
    with pytest.raises(SystemExit, match="token-only"):
        prun.main(["--recipe", "capstone_curriculum", "--synthetic",
                   "--corpus-size", "20001", "--num-queries", "8",
                   "--device", "cpu"])
