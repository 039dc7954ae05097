"""The result line's keys, and the runs that must print no result."""

import json
import os
import shutil
import subprocess
import sys
import types

import pytest

from benchmark import harness
from benchmark.tests import tiny

ROOT = harness.ROOT


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_has_exactly_the_contract_keys(trace, capsys):
    out = tiny.run("nq_ar2.encode", trace=bool(trace))
    harness.print_result(out)
    captured = capsys.readouterr()
    line = json.loads(captured.out.strip().splitlines()[-1])
    want = ["correct", "attempted", "failed", "metrics", "device"]
    want += ["breakdown"] if trace else []
    assert list(line) == want + ["compared"]
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == {"setup_s", "encode_passages_per_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    # the compared numbers are the last lines of standard error
    err = captured.err.strip().splitlines()
    assert err[-len(line["compared"]):] == [
        f"compared {k} {v['value']!r} limit {v['limit']!r}"
        for k, v in line["compared"].items()]


def _run(cwd, *extra):
    env = dict(os.environ)
    env.pop("BENCH_RUN", None)
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "nq_ar2.encode",
         "--seed", str(2 ** 31 + 9), "--seconds", "1", "--trace", "0",
         *extra], cwd=cwd, capture_output=True, text=True, timeout=300,
        env=env)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    r = _run(ROOT)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_benchmark_alone_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    r = _run(tmp_path)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    assert "simxns_tpu_torch" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "simxns_tpu_torch_extra",
                        types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "simxns_tpu.ops", types.ModuleType("x"))
    assert harness.forbidden_modules() == ["simxns_tpu"]
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("x"))
    assert harness.forbidden_modules() == ["jaxlib", "simxns_tpu"]
