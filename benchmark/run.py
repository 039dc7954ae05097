"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the card(s) the cell asks
for. Set-up (weights and traffic from the seed, the kernels' build, the
warm-up of the cell's shapes) is timed from process start; then the
window measures for ``--seconds``; then the run is checked against the
plain reference, and the last line of standard output is the result:
``{"correct", "attempted", "failed", "metrics", "device", ["breakdown"],
"compared"}``. ``--trace 1`` runs the window under the profiler and
reports the cell's per-layer metrics instead of its end-to-end ones.

Without a card, with fewer cards than the cell asks for, or with JAX or
the JAX package loaded in the process, it prints no result and exits 2.
Build and kernel caches stay in fixed directories of the checkout. The
process keeps to one CPU thread beside the program's own (no OpenMP or
BLAS pool), so that the host's work is steady from run to run.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

harness.steady_environment()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = harness.manifest()
    entry = next((w for w in bench["workloads"]
                  if w["name"] == args.workload), None)
    if entry is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    import torch

    print(f"[{args.workload} {time.perf_counter() - T_START:.1f} s] torch "
          "imported", file=sys.stderr, flush=True)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count()}: no result",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    torch.empty(1, device="cuda")
    print(f"[{args.workload} {time.perf_counter() - T_START:.1f} s] card "
          "ready", file=sys.stderr, flush=True)
    cell = harness.make_cell(args.workload, args.seed,
                             torch.device("cuda", 0), trace=bool(args.trace),
                             bench=bench)
    out = harness.run_cell(cell, args.seconds, T_START, bench)
    bad = harness.forbidden_modules()
    if bad:
        print(f"modules of {bad} were loaded in this process: no result",
              file=sys.stderr)
        return 2
    harness.print_result(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
