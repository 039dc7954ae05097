"""One run of one cell: set-up, the measured window, the check against
the plain reference, and the result line.

Everything that belongs to a configuration, a traffic kind or a
per-layer metric is found by name: ``configs/<config>.json``,
``workloads/<cell>.json`` (its traffic kind, parameters and limits),
``drivers/<kind>.py`` and ``metrics/<metric>.py``. A driver module has
``setup(cell)``, ``window(cell, state, seconds)`` and ``check(cell,
state)``; a metric module has ``read(view)``, which returns a number or
None where the run has nothing for it to read.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "simxns_tpu")


def steady_environment() -> None:
    """Before torch or numpy is imported: the kernel caches in fixed
    directories of the checkout (``benchmark/.cache``), one thread in the
    OpenMP and BLAS pools (the host's work is the program's Python
    dispatch, and idle pool threads only take cores from it), and no JAX
    behind ``transformers``."""
    cache = HERE / ".cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")
    for k in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[k] = "1"
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(kind: str):
    return load_module(HERE / "drivers" / f"{kind}.py",
                       "benchmark_driver_" + kind.replace(".", "_"))


def metric_reader(name: str):
    return load_module(HERE / "metrics" / f"{name}.py",
                       "benchmark_metric_" + name.replace(".", "_"))


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`,
    compared whole (``simxns_tpu_torch`` is not ``simxns_tpu``)."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


@dataclasses.dataclass
class Cell:
    """What a driver is given: the cell's entry and files, the seed, the
    device, the spans it records, and (for the tests' planted faults) a
    set of fault names."""
    name: str
    entry: dict
    params: dict
    config: dict
    seed: int
    device: Any
    trace: bool = False
    faults: frozenset = frozenset()
    spans: Any = None
    t_start: float = dataclasses.field(default_factory=time.perf_counter)

    def say(self, what: str) -> None:
        """A line on standard error, stamped with the seconds since the
        run began."""
        print(f"[{self.name} {time.perf_counter() - self.t_start:.1f} s] "
              f"{what}", file=sys.stderr, flush=True)


def make_cell(name: str, seed: int, device, trace: bool = False,
              faults=(), bench: Optional[dict] = None,
              params: Optional[dict] = None,
              config: Optional[dict] = None) -> Cell:
    """The cell ``name`` of ``bench`` (BENCHMARK.json by default), with its
    files read by name unless ``params``/``config`` are given."""
    from benchmark.trace import Spans

    bench = bench if bench is not None else manifest()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    if params is None:
        params = load_json(HERE / "workloads" / f"{name}.json")
    if config is None:
        config = load_json(HERE / "configs" / f"{entry['config']}.json")
    return Cell(name=name, entry=entry, params=params, config=config,
                seed=seed, device=device, trace=trace,
                faults=frozenset(faults), spans=Spans())


class MetricView:
    """What a per-layer metric reads: the trace summary (None without a
    card trace), the benchmark's spans, the driver's work counts, the
    window's length and the cell."""

    def __init__(self, cell: Cell, result: dict, trace: Optional[dict]):
        self.cell = cell
        self.trace = trace
        self.spans = cell.spans
        self.work = result.get("work", {})
        self.window_s = result["window_s"]
        self.e2e = result["e2e"]

    def idle_percent(self) -> Optional[float]:
        """Share of the traced window in which no kernel, copy or set ran
        on the card: the window less the union of the device's intervals;
        None without a card trace."""
        if not self.trace or self.trace["busy_s"] <= 0:
            return None
        return 100.0 * max(0.0, 1.0 - self.trace["busy_s"] / self.window_s)

    def peak_percent(self) -> Optional[float]:
        """The least time of the window's counted model operations
        (``work["ops"]``: bf16 at 989 TFLOP/s, int8 at 1,979 TOP/s) over
        the window's wall time; None without a card trace."""
        from benchmark import work

        ops = self.work.get("ops")
        if not self.trace or self.trace["busy_s"] <= 0 or not ops:
            return None
        least = ops["bf16"] / work.PEAK_BF16 + ops["int8"] / work.PEAK_INT8
        return 100.0 * least / self.window_s

    def kernel_seconds(self, match) -> Optional[float]:
        """Device seconds of the kernels whose names ``match(name)``
        accepts; None without a trace or where none ran."""
        if not self.trace:
            return None
        hits = [s for n, s in self.trace["kernels"].items() if match(n)]
        return sum(hits) if hits else None


def cell_metrics(bench: dict, cell: str, section: str) -> List[dict]:
    """The metrics of ``section`` that ``cell`` reports: those that list
    it, and those without a list whose ``moves`` metric it reports."""
    e2e = {m["name"] for m in cell_metrics(bench, cell, "end_to_end")} \
        if section == "per_layer" else None
    out = []
    for m in bench[section]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif section == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def power_limit() -> Optional[str]:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=20)
        return r.stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def run_cell(cell: Cell, seconds: float, t_start: float,
             bench: Optional[dict] = None) -> dict:
    """Set-up, window, check. -> the result line as a dict (its
    ``compared`` entry last)."""
    import torch

    bench = bench if bench is not None else manifest()
    cell.t_start = t_start
    drv = driver(cell.entry["traffic"])
    state = drv.setup(cell)
    on_card = torch.device(cell.device).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    cell.spans.clear()
    # what set-up left is not the window's to collect
    gc.collect()
    gc.freeze()
    prof = None
    if cell.trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CUDA] if on_card else [
            ProfilerActivity.CPU]
        with profile(activities=acts) as prof:
            res = drv.window(cell, state, seconds)
    else:
        res = drv.window(cell, state, seconds)
    gc.unfreeze()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    trace = None
    if prof is not None:
        from benchmark.trace import read_profile
        trace = read_profile(prof, res["window_s"])
        del prof
    cell.say(f"window of {res['window_s']:.1f} s closed")
    compared = drv.check(cell, state)
    cell.say("check done")
    del state
    correct = all(c["value"] <= c["limit"] for c in compared) and \
        res["attempted"] > 0 and res["failed"] == 0

    metrics: Dict[str, dict] = {}
    if cell.trace:
        view = MetricView(cell, res, trace)
        for m in cell_metrics(bench, cell.name, "per_layer"):
            v = metric_reader(m["name"]).read(view)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell_metrics(bench, cell.name, "end_to_end"):
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": "s"}
            elif m["name"] in res["e2e"]:
                metrics[m["name"]] = {"value": res["e2e"][m["name"]],
                                      "unit": m["unit"]}
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": (torch.cuda.get_device_name(cell.device) if on_card
                       else "cpu"),
              "count": 1, "memory_peak_bytes": int(peak)}
    if on_card:
        device["power_limit"] = power_limit()
    out = {"correct": bool(correct), "attempted": int(res["attempted"]),
           "failed": int(res["failed"]), "metrics": metrics,
           "device": device}
    if trace is not None:
        device["busy_s"] = trace["busy_s"]
        device["window_s"] = trace["window_s"]
        out["breakdown"] = {"device_ops": trace["device_ops"],
                            "idle_gaps": trace["idle_gaps"]}
    out["compared"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                       for c in compared}
    return out


def print_result(out: dict) -> None:
    """The compared numbers as the last lines of standard error, the
    result as the last line of standard output."""
    sys.stdout.flush()
    for name, c in out["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
