"""What the harness, its drivers, its metrics and its reference load, in
a fresh interpreter: no module whose top-level name is jax, jaxlib, flax
or simxns_tpu (compared whole: simxns_tpu_torch passes), and nothing of
the program in the reference."""

import json
import subprocess
import sys

from benchmark import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "simxns_tpu"}


def _tops(code: str) -> set:
    prog = ("import sys, json\nsys.path.insert(0, %r)\n" % str(harness.ROOT)
            + code + "\nprint(json.dumps(sorted({m.split('.', 1)[0] "
            "for m in sys.modules})))")
    r = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                       text=True, timeout=600, cwd=harness.ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    return set(json.loads(r.stdout.strip().splitlines()[-1]))


def test_harness_drivers_metrics_and_a_run_load_no_jax():
    tops = _tops(
        "from benchmark import harness\n"
        "b = harness.manifest()\n"
        "[harness.driver(w['traffic']) for w in b['workloads']]\n"
        "[harness.metric_reader(m['name']) for m in b['per_layer']]\n"
        "import benchmark.reference.bert, benchmark.reference.train\n"
        "from benchmark.tests import tiny\n"
        "tiny.run('nq_ar2.encode', trace=True)\n"
        "tiny.run('nq_ar2.cotrain')\n")
    assert "simxns_tpu_torch" in tops      # the program did run
    assert not tops & FORBIDDEN, tops & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    tops = _tops("import benchmark.reference.bert, "
                 "benchmark.reference.train\n")
    assert not tops & (FORBIDDEN | {"simxns_tpu_torch"})
