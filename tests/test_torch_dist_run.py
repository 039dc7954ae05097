"""The port's co-training launcher on 2 gloo ranks against its own run on
one process (no group), which ``test_torch_run_trajectory.py`` holds to the
JAX launcher; and a resume at W = 2.

Both runs take the tiny ``nq_ar2_simans`` shape (``torch_parity.RUN_TINY``:
a global batch of 8, 4 queries a rank at W = 2). The ranks iterate the same
global batches and sum their gradients, so the trajectory is the W = 1
trajectory up to f32 summation order: every co-training loss within 1e-4
relative (measured: at most 4.0e-5), the top-1 history within one query
(1/24), the same checkpoint names. One module-scoped pool of 2 ranks
(their group is the run's).
"""

import json
import os

import numpy as np
import pytest
import torch

from simxns_tpu_torch import run as prun
import torch_dist
from torch_parity import RUN_TINY, run_losses
from torch_parity import one_torch_thread  # noqa: F401

ARGV = ["--recipe", "nq_ar2_simans", *RUN_TINY, "--device", "cpu"]


@pytest.fixture(scope="module")
def pool():
    p = torch_dist.Pool(2)
    yield p
    p.close()


@pytest.fixture(scope="module")
def runs(pool, tmp_path_factory):
    """The uninterrupted run at W = 2 (on the pool) and at W = 1 (here,
    meanwhile). -> {world: (output dir, result)}."""
    root = tmp_path_factory.mktemp("dist_run")
    wait = pool.submit(torch_dist.run_launcher,
                       ARGV + ["--output-dir", str(root / "w2")])
    # a module fixture runs before the per-test one_torch_thread
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = prun.main(ARGV + ["--output-dir", str(root / "w1")])
    finally:
        torch.set_num_threads(threads)
    two = wait()
    return {1: (root / "w1", one), 2: (root / "w2", two[0], two[1])}


def test_w2_run_matches_w1(runs):
    (d1, one), (d2, two, other) = runs[1], runs[2]
    keys = ("top1", "top5", "mrr10", "history_top1")
    assert [other[k] for k in keys] == [two[k] for k in keys]   # every rank
    assert two["world_size"] == 2 and one["world_size"] == 1
    assert len(two["history_top1"]) == len(one["history_top1"]) == 3
    for g, w in zip(two["history_top1"] + [two["top1"]],
                    one["history_top1"] + [one["top1"]]):
        assert abs(g - w) <= 1 / 24 + 1e-9
    l2, l1 = run_losses(d2), run_losses(d1)
    assert [x[:2] for x in l2] == [x[:2] for x in l1] and len(l1) == 12
    np.testing.assert_allclose([x[2] for x in l2], [x[2] for x in l1],
                               rtol=1e-4)
    assert sorted(os.listdir(d2)) == sorted(os.listdir(d1))
    for name in ("retriever_state-6", "reranker_state-12", "retriever-12"):
        assert name in os.listdir(d2)


def test_w2_resume_matches_uninterrupted(pool, runs, tmp_path):
    """A W = 2 run that dies right after the step-6 boundary checkpoint,
    relaunched at W = 2 with the same command: every rank restores step 6
    and the run ends where the uninterrupted W = 2 run does (losses within
    1e-6 relative, as ``test_torch_run.py``'s single-process resume)."""
    d2, full, _ = runs[2]
    argv = ARGV + ["--output-dir", str(tmp_path / "resumed")]
    pool.run(torch_dist.run_launcher, argv, 6)
    assert "retriever_state-6" in os.listdir(tmp_path / "resumed")
    resumed = pool.run(torch_dist.run_launcher, argv)
    assert resumed[0]["history_top1"] == resumed[1]["history_top1"]
    assert resumed[0]["top1"] == pytest.approx(full["top1"])
    assert resumed[0]["mrr10"] == pytest.approx(full["mrr10"], abs=1e-6)
    late = [x for x in run_losses(tmp_path / "resumed") if x[0] > 6][-6:]
    want = [x for x in run_losses(d2) if x[0] > 6]
    assert [x[:2] for x in late] == [x[:2] for x in want]
    np.testing.assert_allclose([x[2] for x in late], [x[2] for x in want],
                               rtol=1e-6)
    with open(tmp_path / "resumed" / "metrics.jsonl", encoding="utf-8") as f:
        evals = [json.loads(line) for line in f if '"resume_eval"' in line]
    assert [e["step"] for e in evals] == [6]
    with open(tmp_path / "resumed" / "eval.json", encoding="utf-8") as f:
        assert json.load(f)["steps"] == 12


def test_w2_run_refuses_a_batch_off_the_world(pool, tmp_path):
    """A global batch that 2 ranks cannot split raises on every rank."""
    argv = ["--recipe", "nq_ar2_simans", "--synthetic", "--steps", "2",
            "--batch", "7", "--corpus-size", "64", "--num-queries", "24",
            "--device", "cpu", "--output-dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="not divisible by dp=2"):
        pool.run(torch_dist.run_launcher, argv)
