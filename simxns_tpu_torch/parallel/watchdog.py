"""Stall watchdog: bound device-sync waits, re-issue on a stall, then raise.

Own copy of ``simxns_tpu.parallel.watchdog``. :func:`run_with_deadline`
runs the waiting call on a disposable worker thread and the caller waits
with a deadline; a stalled attempt is abandoned and the call re-issued, and
when every attempt stalls :class:`StallError` is raised with the phase's
description. Retried callables must be idempotent reads (a synchronize, a
result copy to the host). :func:`retry_on_stall` re-runs a whole phase
(an index build, a search) when it raises :class:`StallError`.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Callable, Optional

__all__ = ["StallError", "retry_on_stall", "run_with_deadline"]


class StallError(RuntimeError):
    """Every bounded attempt at a device sync stalled past its deadline."""

    def __init__(self, desc: str, deadline_s: float, attempts: int):
        self.desc = desc
        self.deadline_s = deadline_s
        self.attempts = attempts
        super().__init__(
            f"{desc}: stalled past {deadline_s:.0f}s deadline on all "
            f"{attempts} attempt(s) — device presumed wedged")


def run_with_deadline(
    fn: Callable,
    deadline_s: Optional[float],
    desc: str = "device sync",
    retries: int = 2,
    backoff_s: float = 1.0,
):
    """Run ``fn()`` bounded by a wall deadline; re-issue it on a stall.

    ``deadline_s=None`` calls ``fn`` directly. Exceptions raised by ``fn``
    propagate unchanged; only a wall-clock stall triggers a retry.
    """
    if deadline_s is None:
        return fn()
    for attempt in range(retries + 1):
        box: dict = {}

        def work():
            try:
                box["value"] = fn()
            except BaseException as e:  # noqa: BLE001 — relayed to caller
                box["error"] = e

        t = threading.Thread(
            target=work, name=f"watchdog:{desc}", daemon=True)
        t.start()
        t.join(deadline_s)
        if not t.is_alive():
            if "error" in box:
                raise box["error"]
            return box.get("value")
        print(
            f"[watchdog] {desc}: no completion in {deadline_s:.0f}s "
            f"(attempt {attempt + 1}/{retries + 1})"
            + (" — re-issuing" if attempt < retries else ""),
            file=sys.stderr, flush=True)
        if backoff_s and attempt < retries:
            time.sleep(backoff_s)
    raise StallError(desc, deadline_s, retries + 1)


def retry_on_stall(fn: Callable, attempts: int = 2, desc: str = "phase",
                   cleanup: Optional[Callable] = None):
    """Re-run a whole phase when it raises :class:`StallError`.

    ``fn`` rebuilds its own state from scratch, so it need not be a pure
    read, only safe to run again after ``cleanup()``. The last attempt's
    StallError propagates.
    """
    for attempt in range(attempts):
        try:
            return fn()
        except StallError as e:
            print(f"[watchdog] {desc}: attempt {attempt + 1}/{attempts} "
                  f"aborted ({e})", file=sys.stderr, flush=True)
            if cleanup is not None:
                cleanup()
            if attempt == attempts - 1:
                raise
