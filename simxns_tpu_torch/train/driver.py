"""AR2 co-training driver: the outer loop as one object (port of
``simxns_tpu/train/driver.py``).

Replaces the reference's bash relaunch pipeline (``SimANS/train_NQ_AR2.sh:
15-50``) and its in-process ``train_flag`` machine
(``co_training_wiki_train.py:294-306``):

- within each ``iteration_step`` window the first
  ``iteration_reranker_step`` (+1, see :meth:`AR2CoTrainer._flag`) global
  steps train the reranker, the rest the retriever;
- at each window boundary: checkpoint, mine again (re-encode the corpus,
  search, relabel hits), rebuild the training set, continue.

Under data parallelism every rank runs its own trainer over the same
global batches: the steps shard them and sum over the group, the mine
returns the same records on every rank, so :meth:`AR2CoTrainer._flag`
and :class:`RecallGuard` decide the same everywhere and every rank reaches
the same collectives in the same order. Each rank stashes its own
reranker state (``HostStash``); the checkpoint callback writes from rank 0.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
from typing import Callable, Dict, List, Optional

from simxns_tpu_torch.parallel.offload import HostStash
from simxns_tpu_torch.parallel.sync import force_sync

logger = logging.getLogger("simxns_tpu_torch.train")


@dataclasses.dataclass
class AR2Config:
    iteration_step: int = 2000          # window between mining phases
    iteration_reranker_step: int = 500  # reranker steps per window
    max_steps: int = 30_000
    batch_size: int = 64
    log_every: int = 100


MIN_TEACHER_WARM_STEPS = 48


def check_teacher_warmth(ce_warm_steps: int,
                         min_steps: int = MIN_TEACHER_WARM_STEPS) -> bool:
    """Warn (and return False) when the CE teacher warmed for fewer than
    ``min_steps``: AR2's KL toward an undertrained reranker collapses the
    retriever (the JAX package measured 8 warm steps taking recall@1
    0.30 -> 0.00 within one window; >= ~48 trains stably)."""
    if ce_warm_steps >= min_steps:
        return True
    logger.warning(
        "CE teacher warmed for only %d steps (< %d, the measured adequacy "
        "floor): AR2's KL-to-reranker can collapse the retriever. Warm the "
        "reranker longer or load a finetuned checkpoint (the reference "
        "loads checkpoint-reranker26000).", ce_warm_steps, min_steps)
    return False


class RecallGuard:
    """Watch the co-training recall trajectory; make a collapse loud.

    ``update`` warns on the first reading below ``warn_ratio * start`` and
    returns False (collapse) below ``collapse_ratio * start``; ``ok()`` is
    the end-of-run check that recall did not end below its start.
    """

    def __init__(self, warn_ratio: float = 0.8, collapse_ratio: float = 0.5):
        self.warn_ratio = warn_ratio
        self.collapse_ratio = collapse_ratio
        self.trajectory: List[float] = []
        self._warned = False

    @property
    def start(self) -> Optional[float]:
        return self.trajectory[0] if self.trajectory else None

    def update(self, recall: float) -> bool:
        self.trajectory.append(float(recall))
        start = self.trajectory[0]
        if start <= 0:
            return True
        if recall < self.collapse_ratio * start:
            logger.error(
                "co-training recall COLLAPSED: %.3f -> %.3f (trajectory "
                "%s). Likely cause: undertrained CE teacher (see "
                "check_teacher_warmth).", start, recall,
                [round(r, 3) for r in self.trajectory])
            return False
        if not self._warned and recall < self.warn_ratio * start:
            self._warned = True
            logger.warning(
                "co-training recall dropping: %.3f -> %.3f; watch the "
                "trajectory (collapse threshold %.3f).", start, recall,
                self.collapse_ratio * start)
        return True

    def ok(self) -> bool:
        if len(self.trajectory) < 2 or self.trajectory[0] <= 0:
            return True
        return self.trajectory[-1] >= self.trajectory[0]


class AR2CoTrainer:
    """Alternating retriever/reranker trainer with periodic mining.

    Parameters
    ----------
    retriever_step: ``(de_state, teacher, batch) -> (de_state, metrics)``
    reranker_step:  ``(ce_state, batch) -> (ce_state, metrics)``
    batches:        callable yielding host batches (one epoch; re-invoked)
    teacher:        the module the retriever step distills from: the live
                    reranker (default ``ce_state.module``) or its
                    ``int8_view``, which shares its Parameters
    refresh_fn:     ``(de_state, global_step) -> batches or None``, called
                    at each window boundary (mine + rebuild the data)
    checkpoint_fn:  ``(de_state, ce_like, global_step) -> None``;
                    ``ce_like`` is the reranker state, or with
                    ``offload_refresh`` the :class:`HostStash` holding it
                    (its ``state_dict()`` is the host tree to save)
    offload_refresh: stash the reranker state in host memory for the
                    duration of each ``refresh_fn`` call
    """

    def __init__(self, cfg: AR2Config, de_state, ce_state,
                 retriever_step: Callable, reranker_step: Callable,
                 batches: Callable, teacher=None,
                 refresh_fn: Optional[Callable] = None,
                 checkpoint_fn: Optional[Callable] = None,
                 metric_logger=None, offload_refresh: bool = False):
        self.cfg = cfg
        self.de_state = de_state
        self.ce_state = ce_state
        self.retriever_step = retriever_step
        self.reranker_step = reranker_step
        self.batches = batches
        self.teacher = teacher if teacher is not None else ce_state.module
        self.refresh_fn = refresh_fn
        self.checkpoint_fn = checkpoint_fn
        self.metric_logger = metric_logger
        self.offload_refresh = offload_refresh
        self.global_step = 0
        self.history: List[Dict] = []
        self.batches_dirty = False  # set when a refresh swapped `batches`

    def _flag(self) -> int:
        """1 = train reranker, 0 = train retriever (reference flag values).

        Step s runs under the flag set after step s-1, which is 1 iff
        ``(s-1) % iteration_step <= iteration_reranker_step``, including the
        reference's extra reranker step at the == boundary, where it leaves
        the flag unchanged.
        """
        r = self.global_step % self.cfg.iteration_step
        return 1 if r <= self.cfg.iteration_reranker_step else 0

    def run(self, num_steps: Optional[int] = None) -> Dict:
        cfg = self.cfg
        target = min(cfg.max_steps,
                     self.global_step + (num_steps if num_steps is not None
                                         else cfg.max_steps))
        it = iter(self.batches())
        t0 = time.time()
        while self.global_step < target:
            try:
                batch = next(it)
            except StopIteration:
                it = iter(self.batches())
                try:
                    batch = next(it)
                except StopIteration:
                    raise RuntimeError(
                        "AR2CoTrainer: batches() yielded no batches "
                        "(mined dataset too small for the batch size)"
                    ) from None
            if self._flag() == 1:
                self.ce_state, metrics = self.reranker_step(self.ce_state,
                                                            batch)
                which = "reranker"
            else:
                self.de_state, metrics = self.retriever_step(
                    self.de_state, self.teacher, batch)
                which = "retriever"
            self.global_step += 1

            if self.global_step % cfg.log_every == 0:
                rec = {"step": self.global_step, "mode": which,
                       "loss": float(metrics["loss"]),
                       "sec": time.time() - t0}
                self.history.append(rec)
                logger.info("%s", rec)
                if self.metric_logger is not None:
                    self.metric_logger.log(self.global_step,
                                           {"loss": rec["loss"]}, phase=which)

            if self.global_step % cfg.iteration_step == 0:
                self._window_boundary()
                if self.batches_dirty:
                    it = iter(self.batches())
                    self.batches_dirty = False
        return {"global_step": self.global_step, "history": self.history}

    def _timed(self, phase: str):
        if self.metric_logger is not None:
            return self.metric_logger.timed(phase)
        return contextlib.nullcontext()

    def _window_boundary(self) -> None:
        """Drain the window's queued steps, stash the reranker (with
        ``offload_refresh``), checkpoint, refresh, restore the stash: the
        stash's host copy doubles as the checkpoint's, so the state crosses
        to the host once per boundary."""
        if self.checkpoint_fn is None and self.refresh_fn is None:
            return
        with self._timed("train_drain"):
            force_sync(next(self.de_state.module.parameters()).device)
        stash = None
        if self.offload_refresh and self.refresh_fn is not None:
            with self._timed("offload_stash"):
                stash = HostStash(self.ce_state)
        if self.checkpoint_fn is not None:
            self.checkpoint_fn(self.de_state,
                               stash if stash is not None else self.ce_state,
                               self.global_step)
        if self.refresh_fn is not None:
            new_batches = self.refresh_fn(self.de_state, self.global_step)
            if stash is not None:
                with self._timed("offload_restore"):
                    self.ce_state = stash.restore()
            if new_batches is not None:
                self.batches = new_batches
                self.batches_dirty = True
