"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""

import json
import re

import pytest

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TEXT = re.compile(r"^[^\t\n\r]{1,200}$")

BENCH = harness.manifest()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)


def test_paths_and_command():
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
        assert (harness.ROOT / p).is_dir()
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32
    for word in cmd:
        assert TEXT.match(word) and not word.startswith("/")
        assert ".." not in word
    files = [w for w in cmd if "/" in w]
    assert files and all(any(f.startswith(p + "/") for p in BENCH["paths"])
                         for f in files)


def test_names_units_and_keys():
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [
        m["name"] for m in METRICS]
    for n in names:
        assert NAME.match(n), n
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        assert len({g["name"] for g in group}) == len(group)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert not any(k.endswith(("_dim", "_rank", "_size")) or "hidden" in k
                       or "head" in k for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and TEXT.match(w["why"])
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert TEXT.match(m["layer"])
        if m["name"].startswith("roofline.") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_setup_bound_and_four_chip_share():
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] <= 0.25 and "workloads" not in setup
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    w = next(x for x in BENCH["workloads"] if x["name"] == cell)
    params = harness.load_json(harness.HERE / "workloads" / f"{cell}.json")
    assert params["config"] == w["config"] and params["traffic"] == \
        w["traffic"] and params["chips"] == w["chips"] and \
        params["why"] == w["why"]
    assert (harness.HERE / "drivers" / f"{w['traffic']}.py").is_file()
    drv = harness.driver(w["traffic"])
    for fn in ("setup", "window", "check", "control"):
        assert callable(getattr(drv, fn))
    conf = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    assert conf["file"] == f"benchmark/configs/{w['config']}.json"
    cfg = harness.load_json(harness.ROOT / conf["file"])
    assert cfg["name"] == conf["name"] and cfg["source"] == conf["source"]
    assert cfg["reduced"] == conf["reduced"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    e2e = {m["name"] for m in harness.cell_metrics(BENCH, cell, "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.cell_metrics(BENCH, cell, "per_layer")


def test_every_config_is_used():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_moves_what_its_cells_report(metric):
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    assert (harness.HERE / "metrics" / f"{metric}.py").is_file()
    assert callable(harness.metric_reader(metric).read)
    for cell in m.get("workloads", CELLS):
        assert cell in CELLS
        e2e = {x["name"] for x in
               harness.cell_metrics(BENCH, cell, "end_to_end")}
        assert m["moves"] in e2e, (metric, cell)


def test_one_layer_name_per_layer():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers <= {"serve", "index", "train", "data", "models", "ops",
                      "device"}
