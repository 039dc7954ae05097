"""A later change adds a cell, a configuration, a traffic kind and a
per-layer metric by new files and new entries in BENCHMARK.json, with no
file that exists edited: the harness finds them all by name."""

import hashlib
import json
import shutil
import subprocess
import sys

from benchmark import harness

DRIVER = '''
import time


def setup(cell):
    return {"n": cell.params["work_items"]}


def window(cell, state, seconds):
    t0 = time.perf_counter()
    total = sum(range(state["n"]))
    wall = max(time.perf_counter() - t0, 1e-9)
    state["total"] = total
    return {"window_s": wall, "attempted": state["n"], "failed": 0,
            "e2e": {"items_per_s": state["n"] / wall}, "work": {}}


def check(cell, state):
    want = state["n"] * (state["n"] - 1) // 2
    return [{"name": "sum", "value": float(abs(state["total"] - want)),
             "limit": 0}]


def control(cell, state):
    return {"sum": 1.0}
'''

METRIC = '''
def read(view):
    return 100.0 * view.window_s / max(view.window_s, 1e-9)
'''


def _digest(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts and ".cache" not in p.parts}


def test_new_cell_config_kind_and_metric_by_new_files(tmp_path):
    root = harness.ROOT
    shutil.copytree(root / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(root / "BENCHMARK.json", tmp_path)
    before = _digest(tmp_path / "benchmark")
    b = tmp_path / "benchmark"
    cfg = json.loads((b / "configs" / "nq_ar2.json").read_text())
    cfg.update(name="toy_cfg", reduced=[])
    (b / "configs" / "toy_cfg.json").write_text(json.dumps(cfg))
    (b / "drivers" / "toykind.py").write_text(DRIVER)
    (b / "metrics" / "toy_share.py").write_text(METRIC)
    (b / "workloads" / "toy_cfg.toykind.json").write_text(json.dumps({
        "config": "toy_cfg", "traffic": "toykind", "chips": 1,
        "why": "toy", "work_items": 1000, "limits": {"sum": 0}}))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy_cfg", "source": "https://x.org",
                             "file": "benchmark/configs/toy_cfg.json",
                             "reduced": [], "why": "toy"})
    bench["workloads"].append({"name": "toy_cfg.toykind",
                               "config": "toy_cfg", "traffic": "toykind",
                               "chips": 1, "why": "toy"})
    bench["end_to_end"].append({"name": "items_per_s", "unit": "items/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["toy_cfg.toykind"]})
    bench["per_layer"].append({"name": "toy_share", "unit": "%",
                               "better": "higher", "source": "host_clock",
                               "layer": "device", "moves": "items_per_s",
                               "workloads": ["toy_cfg.toykind"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digest(b)
    assert all(after[k] == v for k, v in before.items())   # nothing edited

    prog = (
        "import sys, json, time\nsys.path.insert(0, '.')\n"
        "from benchmark import harness\n"
        "out = {}\n"
        "for trace in (False, True):\n"
        "    c = harness.make_cell('toy_cfg.toykind', 3, 'cpu', trace=trace)\n"
        "    out[trace] = harness.run_cell(c, 0.1, time.perf_counter())\n"
        "print(json.dumps([out[False], out[True]]))\n")
    r = subprocess.run([sys.executable, "-c", prog], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    plain, traced = json.loads(r.stdout.strip().splitlines()[-1])
    assert plain["correct"] and traced["correct"]
    assert set(plain["metrics"]) == {"items_per_s", "setup_s"}
    assert set(traced["metrics"]) == {"toy_share"}
