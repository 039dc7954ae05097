"""The co-training driver of the port against the JAX package: the flag
machine and the order of window-boundary calls, ``RecallGuard`` and
``check_teacher_warmth``; and the port's own host stash and checkpoint
round trips (bit-identical)."""

import json
import os
import types

import numpy as np
import pytest
import torch

from simxns_tpu.parallel import create_mesh
from simxns_tpu.train import driver as jdriver
from simxns_tpu_torch.io import (MetricLogger, latest_step,
                                 restore_checkpoint, save_checkpoint)
from simxns_tpu_torch.models import (BertConfig, CrossEncoder,
                                     CrossEncoderConfig, int8_view)
from simxns_tpu_torch.models.bert import BertLayer
from simxns_tpu_torch.parallel.offload import HostStash, host_copy
from simxns_tpu_torch.train import TrainState, make_adamw, make_reranker_step
from simxns_tpu_torch.train import driver as pdriver
from torch_parity import one_torch_thread  # noqa: F401


def _drive(module, iteration, reranker, port):
    """Run a trainer with stub steps; -> the sequence of step kinds and
    boundary calls with their global steps."""
    events = []
    batch = {"x": np.zeros((8, 2), np.float32)}

    def c_step(state, b):
        events.append(("reranker", trainer.global_step))
        return state, {"loss": 0.0}

    def r_step(state, teacher, b):
        events.append(("retriever", trainer.global_step))
        return state, {"loss": 0.0}

    def checkpoint(de, ce, gstep):
        events.append(("checkpoint", gstep))

    def refresh(de, gstep):
        events.append(("refresh", gstep))
        # a new (shorter) dataset after the first boundary only
        return (lambda: iter([batch] * 5)) if gstep == iteration else None

    cfg = module.AR2Config(iteration_step=iteration,
                           iteration_reranker_step=reranker,
                           max_steps=2 * iteration + 3, log_every=10**9)
    batches = lambda: iter([batch] * 3)  # noqa: E731
    if port:
        state = types.SimpleNamespace(module=torch.nn.Linear(1, 1))
        trainer = module.AR2CoTrainer(cfg, state, state, r_step, c_step,
                                      batches, refresh_fn=refresh,
                                      checkpoint_fn=checkpoint)
    else:
        state = types.SimpleNamespace(params=None)
        trainer = module.AR2CoTrainer(create_mesh(), cfg, None, state,
                                      lambda d, p, b: r_step(d, p, b),
                                      c_step, batches, refresh_fn=refresh,
                                      checkpoint_fn=checkpoint)
    out = trainer.run()
    return events, out["global_step"]


@pytest.mark.parametrize("iteration,reranker", [(4, 1), (10, 4),
                                                (2000, 500)])
def test_flag_machine_and_boundaries_match(iteration, reranker):
    got = _drive(pdriver, iteration, reranker, port=True)
    want = _drive(jdriver, iteration, reranker, port=False)
    assert got == want
    # the reference's extra reranker step at the == boundary
    kinds = [k for k, s in got[0] if k in ("reranker", "retriever")]
    assert kinds[:iteration].count("reranker") == reranker + 1


def test_recall_guard_and_teacher_warmth_match():
    for trajectory in ([0.5, 0.45, 0.38, 0.2, 0.6], [0.0, 0.1], [0.3],
                       [0.4, 0.5, 0.41]):
        g, w = pdriver.RecallGuard(), jdriver.RecallGuard()
        assert g.start == w.start
        for r in trajectory:
            assert g.update(r) == w.update(r)
        assert (g.ok(), g.trajectory, g.start) == (w.ok(), w.trajectory,
                                                   w.start)
    for steps, floor in ((10, 48), (48, 48), (100, 200)):
        assert (pdriver.check_teacher_warmth(steps, floor)
                == jdriver.check_teacher_warmth(steps, floor))


def _trained_state(seed=0):
    """A tiny reranker state after one AdamW step (non-zero moments)."""
    bert = BertConfig.tiny(num_layers=2)
    model = CrossEncoder(CrossEncoderConfig(bert=bert),
                         generator=torch.Generator().manual_seed(seed))
    tx = make_adamw(1e-3, total_steps=0)
    state = TrainState.create(model, tx)
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, 1000, (2, 3, 12)).astype(np.int32)
    state, _ = make_reranker_step(tx, "cpu")(
        state, {"joint_ids": ids, "joint_mask": np.ones_like(ids)})
    return state, ids.reshape(6, 12)


def _snapshot(state):
    return host_copy(state.state_dict(), torch.device("cpu"))


def _assert_same(tree, state):
    now = state.state_dict()
    assert now["step"] == tree["step"]
    assert now["opt_state"]["count"] == tree["opt_state"]["count"]
    for group in ("mu", "nu"):
        for n, t in tree["opt_state"][group].items():
            assert torch.equal(now["opt_state"][group][n], t), n
    for n, t in tree["params"].items():
        assert torch.equal(now["params"][n], t), n


def test_host_stash_round_trip():
    """Parameters and AdamW state come back bit-identical into the same
    Parameter objects; the shared int8 view drops its cached weights with
    the stash and afterwards encodes like a fresh view."""
    state, ids = _trained_state()
    before = _snapshot(state)
    params = list(state.module.parameters())
    view = int8_view(state.module)
    mask = torch.ones(6, 12, dtype=torch.int32)
    with torch.no_grad():
        logits = view(torch.from_numpy(ids).long(), mask)["logits"]
    layers = [m for m in view.modules() if isinstance(m, BertLayer)]
    assert all(m._qbox for m in layers)

    stash = HostStash(state)
    assert not any(m._qbox for m in layers)      # cached int8 weights freed
    tree = stash.state_dict()
    assert stash.nbytes == 3 * sum(p.numel() * 4 for p in params)
    restored = stash.restore()
    assert restored is state
    assert list(state.module.parameters()) == params   # same objects
    _assert_same(before, state)
    _assert_same(before, types.SimpleNamespace(state_dict=lambda: tree))
    with pytest.raises(RuntimeError):
        stash.restore()
    with pytest.raises(RuntimeError):
        stash.state_dict()
    with torch.no_grad():
        again = view(torch.from_numpy(ids).long(), mask)["logits"]
        fresh = int8_view(state.module)(torch.from_numpy(ids).long(),
                                        mask)["logits"]
    assert torch.equal(again, fresh) and torch.equal(again, logits)


def test_checkpoint_round_trip(tmp_path):
    state, _ = _trained_state(seed=1)
    tree = _snapshot(state)
    save_checkpoint(str(tmp_path), tree, 3, name="reranker_state")
    save_checkpoint(str(tmp_path), tree, 7, name="reranker_state")
    save_checkpoint(str(tmp_path), tree, 7, name="reranker_state")  # again
    os.makedirs(tmp_path / "reranker_state-9.tmp-1-2")     # a torn write
    assert latest_step(str(tmp_path), name="reranker_state") == 7
    assert latest_step(str(tmp_path), name="retriever_state") is None
    assert latest_step(str(tmp_path / "absent")) is None

    other, _ = _trained_state(seed=2)
    other.step, other.opt_state["count"] = 0, 0
    out = restore_checkpoint(str(tmp_path), other, 7, name="reranker_state")
    assert out is other
    _assert_same(tree, other)
    raw = restore_checkpoint(str(tmp_path), None, 3, name="reranker_state")
    assert raw["step"] == tree["step"]


def test_metric_logger(tmp_path):
    """JSON lines, phase timers that add up (a phase that raises still
    counts), and a torch.profiler trace on disk."""
    log = MetricLogger(str(tmp_path))
    log.log(3, {"loss": 0.5}, phase="reranker")
    for _ in range(2):
        with log.timed("search"):
            pass
    with pytest.raises(RuntimeError):
        with log.timed("encode_corpus"):
            raise RuntimeError("stalled")
    with log.trace("step"):
        torch.ones(4).sum()
    log.close()
    assert set(log.phase_times) == {"search", "encode_corpus"}
    with open(tmp_path / "metrics.jsonl", encoding="utf-8") as f:
        recs = [json.loads(line) for line in f]
    assert recs[0]["phase"] == "reranker" and recs[0]["loss"] == 0.5
    assert [r["phase"] for r in recs[1:]] == [
        "timer/search", "timer/search", "timer/encode_corpus"]
    assert os.path.getsize(tmp_path / "traces" / "step.json") > 0
