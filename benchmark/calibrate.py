"""Readings that the limits of a cell's comparison are set from.

    python3 benchmark/calibrate.py --workload <cell> --seeds <n> [<n> ...]
        [--controls <k>] [--faults <k>] [--fault-kinds NAME ...] [--out FILE]

In one process, for each seed: the cell's set-up and one step of its
window, then its check (the program against the reference: the lower
readings); on the first ``--controls`` seeds the driver's control (the
reference computed one precision lower in the program's place: the upper
readings); on the first ``--faults`` seeds each planted fault the cell
can have (by traffic kind, :data:`FAULTS`; ``--fault-kinds`` names
fewer). Prints one JSON line per
reading and, last, the largest program reading and the smallest control
and fault readings of each number. Runs on the card only.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

harness.steady_environment()

FAULTS = {"cotrain": ("half_batch", "alter_token"),
          "encode": ("half_batch", "alter_answer")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--fault-kinds", nargs="+", default=None)
    ap.add_argument("--window", type=float, default=0.0,
                    help="seconds of window before each check (0: one step "
                         "cycle or one build)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate runs on a CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    dev = torch.device("cuda", 0)
    lines = []

    def emit(**rec):
        lines.append(rec)
        print(json.dumps(rec), flush=True)

    def one(seed, faults=()):
        cell = harness.make_cell(args.workload, seed, dev, faults=faults)
        drv = harness.driver(cell.entry["traffic"])
        state = drv.setup(cell)
        drv.window(cell, state, args.window)
        nums = {c["name"]: c["value"] for c in drv.check(cell, state)}
        return cell, drv, state, nums

    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        cell, drv, state, nums = one(seed)
        emit(kind="program", seed=seed, numbers=nums,
             seconds=time.perf_counter() - t0)
        if hasattr(drv, "details"):
            emit(kind="details", seed=seed, of="program",
                 details=drv.details(state))
        if i < args.controls:
            emit(kind="control", seed=seed, numbers=drv.control(cell, state))
            if "control_details" in state:
                emit(kind="details", seed=seed, of="control",
                     details=state["control_details"])
        del state
        if i < args.faults:
            for fault in args.fault_kinds or FAULTS[cell.entry["traffic"]]:
                _, _, _, nums = one(seed, (fault,))
                emit(kind=fault, seed=seed, numbers=nums)
        torch.cuda.empty_cache()
    summary = {}
    for rec in lines:
        for name, v in rec.get("numbers", {}).items():
            s = summary.setdefault(name, {})
            if rec["kind"] == "program":
                s["lower"] = max(s.get("lower", 0.0), v)
            else:
                s[rec["kind"]] = min(s.get(rec["kind"], float("inf")), v)
    print(json.dumps({"summary": summary}), flush=True)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            for rec in lines + [{"summary": summary}]:
                f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
