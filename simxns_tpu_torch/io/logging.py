"""Metric logging: JSON lines and wall-clock phase timers (port of
``simxns_tpu/io/logging.py``).

:class:`MetricLogger` appends one JSON record per call to
``output_dir/metrics.jsonl``; :meth:`MetricLogger.timed` adds a phase's
wall time to ``phase_times`` (the per-phase split of a co-training run);
:meth:`MetricLogger.trace` records a ``torch.profiler`` trace of the card
and the host. Under data parallelism only rank 0 writes (``rank``); every
rank keeps its own phase times.
"""

from __future__ import annotations

import json
import logging
import os
import time
from contextlib import contextmanager
from typing import Dict, Optional

import torch

logger = logging.getLogger("simxns_tpu_torch")


class MetricLogger:
    def __init__(self, output_dir: Optional[str] = None, rank: int = 0):
        """``rank`` != 0: records phase times but writes nothing."""
        self.rank = rank
        self.output_dir = output_dir if rank == 0 else None
        self._fh = None
        if self.output_dir:
            os.makedirs(output_dir, exist_ok=True)
            self._fh = open(os.path.join(output_dir, "metrics.jsonl"), "a",
                            encoding="utf-8")
        self.phase_times: Dict[str, float] = {}

    def log(self, step: int, scalars: Dict[str, float], phase: str = "train"):
        rec = {"step": step, "phase": phase, "time": time.time(), **scalars}
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        if self.rank == 0:
            logger.info("%s", rec)

    @contextmanager
    def timed(self, phase: str):
        """Wall-clock phase timer; a phase that raises still records its
        time. The caller synchronizes the card inside the phase where the
        timer must charge device work to it."""
        t0 = time.time()
        try:
            yield
        finally:
            dt = time.time() - t0
            self.phase_times[phase] = self.phase_times.get(phase, 0.0) + dt
            self.log(0, {"seconds": dt}, phase=f"timer/{phase}")

    @contextmanager
    def trace(self, name: str = "trace"):
        """``torch.profiler`` scope (host and, when there is one, the card)
        writing a Chrome trace to ``output_dir/traces/<name>.json``."""
        from torch.profiler import ProfilerActivity, profile

        if self.rank != 0:
            yield None
            return
        if not self.output_dir:
            raise ValueError("trace() needs MetricLogger(output_dir=...)")
        path = os.path.join(self.output_dir, "traces")
        os.makedirs(path, exist_ok=True)
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            yield prof
        out = os.path.join(path, f"{name}.json")
        prof.export_chrome_trace(out)
        logger.info("profiler trace written to %s", out)

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None
