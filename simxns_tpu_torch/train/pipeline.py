"""Multi-stage training pipelines (port of ``simxns_tpu/train/pipeline.py``):
PROD progressive distillation as host-level stages.

The reference runs these as hand-executed sequences of shell commands
(``PROD/README.md:69-399``: warm-up DE -> inference and data refresh -> CE
training -> KD stage 1 -> rerank refresh -> KD stage 2 -> dataset division
-> LwF round). Here a pipeline is a list of :class:`Stage` objects run in
one process over a shared context (states, datasets, the device index and
the mesh), with no relaunch and no embeddings on disk.

A stage is ``run(ctx) -> metrics``; the constructors cover the recurring
phases:

- :func:`train_stage`: N steps of a ``(state, batch) -> (state, m)`` step
  (or ``(state, teachers, batch)`` with teacher modules from the context);
- :func:`refresh_stage`: encode the corpus, build the index, mine the
  top-k and rebuild the dataset from the mined examples;
- :func:`division_stage`: PROD's teacher-good / student-bad selection.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Dict, List, Optional

from simxns_tpu_torch.data.division import teacher_better_qids
from simxns_tpu_torch.parallel.mesh import shard_batch

logger = logging.getLogger("simxns_tpu_torch.pipeline")


@dataclasses.dataclass
class Stage:
    name: str
    run: Callable[[Dict[str, Any]], Dict[str, Any]]


class Pipeline:
    """Run stages in order over a shared mutable context; each stage's
    numeric and string metrics, with its seconds, go to ``history``."""

    def __init__(self, stages: List[Stage], ctx: Optional[Dict] = None):
        self.stages = stages
        self.ctx: Dict[str, Any] = ctx or {}
        self.history: List[Dict] = []

    def run(self) -> Dict[str, Any]:
        for stage in self.stages:
            t0 = time.time()
            metrics = stage.run(self.ctx) or {}
            rec = {"stage": stage.name, "seconds": time.time() - t0,
                   **{k: v for k, v in metrics.items()
                      if isinstance(v, (int, float, str))}}
            self.history.append(rec)
            logger.info("%s", rec)
        self.ctx["history"] = self.history
        return self.ctx


def _host_batch(batch: dict, mesh) -> dict:
    """A host batch without its ``answers``, this rank's rows of it (the
    steps move it to their device)."""
    return shard_batch({k: v for k, v in batch.items() if k != "answers"},
                       mesh)


def train_stage(name: str, state_key: str, step_fn: Callable,
                batches: Callable, num_steps: int,
                teacher_keys: Optional[List[str]] = None,
                device_batch: Optional[Callable] = None) -> Stage:
    """``num_steps`` of ``step_fn`` on ``ctx[state_key]``, cycling over
    ``batches(ctx)``. ``teacher_keys`` picks frozen modules from the
    context as the step's teacher dict (KD steps); ``device_batch`` maps a
    host batch (default: this rank's rows of ``ctx.get("mesh")``, without
    ``answers``)."""

    def run(ctx):
        put = device_batch or (lambda b: _host_batch(b, ctx.get("mesh")))
        state = ctx[state_key]
        it = iter(batches(ctx))
        last = {}
        for _ in range(num_steps):
            try:
                batch = next(it)
            except StopIteration:
                it = iter(batches(ctx))
                batch = next(it)
            if teacher_keys:
                teachers = {k: ctx[k] for k in teacher_keys}
                state, last = step_fn(state, teachers, put(batch))
            else:
                state, last = step_fn(state, put(batch))
        ctx[state_key] = state
        return {"steps": num_steps,
                "loss": float(last.get("loss", float("nan")))}

    return Stage(name, run)


def refresh_stage(name: str, encode_corpus: Callable,
                  encode_queries: Callable, questions, answers, k: int = 100,
                  dataset_key: str = "dataset",
                  build_dataset: Optional[Callable] = None) -> Stage:
    """Encode -> build the index -> mine -> rebuild the dataset (the
    generate phase). ``ctx["engine"]`` is a ``RetrievalEngine`` over
    ``ctx["index"]``; the mining result lands in ``ctx["last_mining"]``."""

    def run(ctx):
        engine = ctx["engine"]
        ctx["index"].build(encode_corpus(ctx))
        res = engine.mine(encode_queries(ctx), questions, answers, k=k)
        ctx["last_mining"] = res
        if build_dataset is not None:
            ctx[dataset_key] = build_dataset(ctx, res)
        return {"top1": res.top_k_hits[0] if res.top_k_hits else 0.0,
                "mined": len(res.train_examples)}

    return Stage(name, run)


def division_stage(name: str, student_ranked_key: str,
                   teacher_ranked_key: str, qrels, out_key: str = "lwf_qids",
                   student_bucket: str = "2t15",
                   teacher_bucket: str = "top1") -> Stage:
    """PROD dataset division: the teacher-good / student-bad queries into
    ``ctx[out_key]``."""

    def run(ctx):
        qids = teacher_better_qids(ctx[student_ranked_key],
                                   ctx[teacher_ranked_key], qrels,
                                   student_bucket, teacher_bucket)
        ctx[out_key] = qids
        return {"selected": len(qids)}

    return Stage(name, run)
