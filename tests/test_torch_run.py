"""The port's launcher end to end on the CPU: its own resume, offload and
stream-build equivalences (the twins of tests/test_run.py:280, :374 and
:400), every AR2 recipe through ``main``, real-data hit labeling, and a
runner for every recipe. The trajectory against the JAX launcher is in
tests/test_torch_run_trajectory.py."""

import json
import os
import threading

import numpy as np
import pytest

from simxns_tpu_torch import run as prun
from simxns_tpu_torch.config import RECIPES
from simxns_tpu_torch.train import driver as pdriver
from torch_parity import RUN_TINY, run_losses
from torch_parity import one_torch_thread  # noqa: F401


def _port(tmp, recipe="nq_ar2_simans", extra=()):
    return prun.main(["--recipe", recipe, *RUN_TINY, "--device", "cpu",
                      "--output-dir", str(tmp), *extra])


def test_resume_matches_uninterrupted(tmp_path, monkeypatch):
    """A run that dies right after the step-6 boundary checkpoint and is
    relaunched with the same command ends where an uninterrupted run
    does."""
    full = _port(tmp_path / "full")
    real_run = pdriver.AR2CoTrainer.run
    mode = {"die": True}

    def dying_run(self, num_steps=None):
        if mode["die"]:
            real_run(self, num_steps=6)
            raise KeyboardInterrupt("simulated crash")
        return real_run(self, num_steps)

    monkeypatch.setattr(pdriver.AR2CoTrainer, "run", dying_run)
    with pytest.raises(KeyboardInterrupt):
        _port(tmp_path / "resumed")
    # the step-6 checkpoint is written on a background thread
    for t in threading.enumerate():
        if t.name.startswith("ckpt-"):
            t.join(timeout=120)
    assert "retriever_state-6" in os.listdir(tmp_path / "resumed")
    mode["die"] = False
    resumed = _port(tmp_path / "resumed")
    assert resumed["top1"] == pytest.approx(full["top1"])
    assert resumed["mrr10"] == pytest.approx(full["mrr10"], abs=1e-6)
    late = [x for x in run_losses(tmp_path / "resumed") if x[0] > 6][-6:]
    want = [x for x in run_losses(tmp_path / "full") if x[0] > 6]
    assert [x[:2] for x in late] == [x[:2] for x in want]
    np.testing.assert_allclose([x[2] for x in late], [x[2] for x in want],
                               rtol=1e-6)
    with open(tmp_path / "resumed" / "eval.json", encoding="utf-8") as f:
        assert json.load(f)["steps"] == 12


def test_offload_modes_match(tmp_path):
    """--offload-mine off / on / overlap: the stash is data movement only,
    so the runs are identical, and overlap's boundary checkpoints (the
    reranker's from the stash handoff) are complete."""
    outs = {m: _port(tmp_path / m, extra=("--offload-mine", m))
            for m in ("off", "on", "overlap")}
    assert (outs["off"]["history_top1"] == outs["on"]["history_top1"]
            == outs["overlap"]["history_top1"])
    assert outs["off"]["mrr10"] == outs["on"]["mrr10"] == \
        outs["overlap"]["mrr10"]
    assert (run_losses(tmp_path / "off") == run_losses(tmp_path / "on")
            == run_losses(tmp_path / "overlap"))
    names = {m: sorted(n for n in os.listdir(tmp_path / m)
                       if n.endswith("_state-6") or n.endswith("_state-12"))
             for m in outs}
    assert names["overlap"] == names["on"] == names["off"] == [
        "reranker_state-12", "reranker_state-6", "retriever_state-12",
        "retriever_state-6"]


def test_stream_build_matches_host_build(tmp_path):
    a = _port(tmp_path / "a", extra=("--stream-build", "off"))
    b = _port(tmp_path / "b", extra=("--stream-build", "on"))
    assert a["history_top1"] == b["history_top1"]
    assert a["mrr10"] == b["mrr10"]
    assert run_losses(tmp_path / "a") == run_losses(tmp_path / "b")


@pytest.mark.parametrize("recipe", ["nq_ar2_simans", "marco_ar2_simans",
                                    "master_ms_ft", "tq_ar2_simans",
                                    "msdoc_ar2_simans"])
def test_ar2_recipes_run(tmp_path, recipe):
    out = prun.main(["--recipe", recipe, "--synthetic", "--steps", "4",
                     "--batch", "8", "--corpus-size", "32", "--num-queries",
                     "16", "--warm-epochs", "1", "--topk", "8",
                     "--device", "cpu", "--output-dir", str(tmp_path)])
    assert out["steps"] == 4 and 0.0 <= out["top1"] <= 1.0
    assert np.isfinite(out["mrr10"])
    assert all(np.isfinite(x[2]) for x in run_losses(tmp_path))
    names = os.listdir(tmp_path)
    for prefix in ("retriever_state-4", "reranker_state-4", "retriever-4",
                   "reranker-4", "eval.json"):
        assert prefix in names


# the JAX launcher's dispatch by config type (simxns_tpu/run.py:1979-1991)
JAX_RUNNERS = {"AR2RecipeConfig": "run_ar2", "KDRecipeConfig": "run_kd",
               "MasterPretrainConfig": "run_pretrain",
               "LeadRecipeConfig": "run_lead",
               "CapstoneRecipeConfig": "run_capstone",
               "AlliesRecipeConfig": "run_allies"}


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_every_recipe_has_a_runner(recipe):
    """Every recipe of the port's config tree has a runner, the one the
    JAX launcher dispatches its config type to (nothing is left
    unported)."""
    kind = type(RECIPES[recipe])
    runner = prun._RUNNERS[kind]
    assert callable(runner) and runner.__name__ == JAX_RUNNERS[kind.__name__]
    assert getattr(prun, runner.__name__) is runner


def _prepare_data(argv):
    import importlib.util

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "prepare_data", os.path.join(repo, "scripts", "prepare_data.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main(argv)


@pytest.mark.parametrize("labels", ["passages_tsv", "qrels"])
def test_real_data_labels_hits(tmp_path, labels):
    """--corpus/--queries from scripts/prepare_data.py with hit labels from
    the passage text (has_answer) or from qrels gold ids: mining finds
    real positives (the twins of tests/test_run.py's real-data tests)."""
    tsv = tmp_path / "psgs.tsv"
    with open(tsv, "w", encoding="utf-8") as f:
        f.write("id\ttext\ttitle\n")
        for i in range(48):
            f.write(f"{i + 1}\tdocument {i} mentions fact{i} and "
                    f"topic{i % 7}\ttitle{i}\n")
    qa = tmp_path / "q.qa.csv"
    with open(qa, "w", encoding="utf-8") as f:
        for i in range(16):
            f.write(f"document {i} fact{i}\t['fact{i}']\n")
    corpus, queries = str(tmp_path / "corpus.npz"), str(tmp_path / "q.npz")
    _prepare_data(["corpus", "--passages", str(tsv), "--out", corpus,
                   "--max-length", "32"])
    _prepare_data(["queries", "--qa", str(qa), "--out", queries,
                   "--max-length", "16"])
    if labels == "qrels":
        qrels = tmp_path / "qrels.tsv"
        with open(qrels, "w", encoding="utf-8") as f:
            for i in range(16):
                f.write(f"{i}\t{i}\n")      # qid i -> pid i (ids are id-1)
        extra = ["--recipe", "marco_ar2_simans", "--qrels", str(qrels)]
    else:
        extra = ["--recipe", "nq_ar2_simans", "--passages-tsv", str(tsv)]
    out = prun.main([*extra, "--tiny-models", "--corpus", corpus,
                     "--queries", queries, "--steps", "8", "--batch", "8",
                     "--topk", "8", "--device", "cpu",
                     "--output-dir", str(tmp_path / "run")])
    assert out["top1"] > 0.0
