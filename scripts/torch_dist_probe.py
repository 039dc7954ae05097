#!/usr/bin/env python3
"""Readings behind the port's data-parallel phase (``chip_smoke.py`` 17), on
the card.

    python3 scripts/torch_dist_probe.py probe
    python3 scripts/torch_dist_probe.py co_training [--repo DIR] [--runs 2]

``probe``: which collectives the ``gloo`` backend takes on CUDA tensors
(two ranks sharing ``cuda:0``) and NCCL at world 1, gloo's all-reduce time
for the CE-large gradient (1.34 GB of f32), the CE-large model's init time,
and whether a full-width DE and reranker gradient repeats bit for bit, with
and without ``torch.use_deterministic_algorithms``.

``co_training``: ``chip_smoke.py`` phase 7's nq co-training run (its flags
and cuts, no group) ``--runs`` times in one process with
``simxns_tpu_torch`` imported from ``--repo`` (a checkout unpacked with
``git archive``); one JSON line a run with its wall time and the mine's
encode rate. Run it per checkout, in turns, in one call.
"""

import argparse
import json
import os
import socket
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _gloo_rank(rank, world, port, queue):
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    x = torch.arange(6, dtype=torch.float32, device="cuda").reshape(3, 2)
    out = {}
    for name, fn in [
            ("all_gather", lambda: dist.all_gather(
                [torch.empty_like(x) for _ in range(world)], x)),
            ("reduce_scatter", lambda: dist.reduce_scatter(
                torch.empty_like(x), [x.clone() for _ in range(world)])),
            ("all_reduce_f64", lambda: dist.all_reduce(
                torch.ones(3, dtype=torch.float64, device="cuda"))),
            ("all_gather_i64", lambda: dist.all_gather(
                [torch.empty(1, dtype=torch.int64, device="cuda")
                 for _ in range(world)],
                torch.ones(1, dtype=torch.int64, device="cuda")))]:
        try:
            fn()
            torch.cuda.synchronize()
            out[name] = "ok"
        except RuntimeError as e:
            out[name] = f"refused: {str(e)[:200]}"
    big = torch.ones(335_000_000, device="cuda")
    dist.barrier()
    t0 = time.perf_counter()
    dist.all_reduce(big)
    torch.cuda.synchronize()
    out["all_reduce_1.34GB_s"] = time.perf_counter() - t0
    if rank == 0:
        queue.put(out)
    dist.destroy_process_group()


def probe():
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from simxns_tpu_torch.ops import _native
    from simxns_tpu_torch.train import steps

    smi = cs.nvidia_smi()
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = _port()
    procs = [ctx.Process(target=_gloo_rank, args=(r, 2, port, queue))
             for r in range(2)]
    for p in procs:
        p.start()
    gloo = queue.get(timeout=600)
    for p in procs:
        p.join(timeout=120)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", rank=0, world_size=1,
                            init_method=f"tcp://localhost:{_port()}")
    x = torch.ones(3, 2, device="cuda")
    dist.all_gather([torch.empty_like(x)], x)
    dist.reduce_scatter(torch.empty_like(x), [x.clone()])
    dist.all_reduce(x)
    torch.cuda.synchronize()
    dist.destroy_process_group()
    _native.build()
    de, ce, init_s = cs._full_models(torch, "xla")
    batch = steps.to_device(cs._train_batch(np, 0), torch.device("cuda"))

    def grads(model, loss_fn, det):
        torch.use_deterministic_algorithms(det, warn_only=True)
        try:
            loss, _ = loss_fn(model, batch)
            g = steps.gradients(model, loss)
            out = {n: v.detach().clone() for n, v in g.items()
                   if v is not None}
            for p in model.parameters():
                p.grad = None
            return float(loss.detach()), out
        finally:
            torch.use_deterministic_algorithms(False)

    repeat = {}
    for name, model, loss_fn in (("biencoder", de, steps.biencoder_loss),
                                 ("reranker", ce, steps.reranker_loss)):
        for det in (False, True):
            (l1, g1), (l2, g2) = (grads(model, loss_fn, det),
                                  grads(model, loss_fn, det))
            repeat[f"{name}{'_deterministic' if det else ''}"] = {
                "loss_equal": l1 == l2,
                "gradients_differing": [n for n in g1
                                        if not torch.equal(g1[n], g2[n])]}
    print(json.dumps({"nvidia_smi": smi, "torch": torch.__version__,
                      "gloo_cuda": gloo, "nccl_world_1": "ok",
                      "ce_large_init_s": init_s,
                      "gradients_repeat": repeat}), flush=True)


def co_training(repo, runs):
    import dataclasses
    import shutil
    import tempfile

    sys.path.insert(0, repo)
    os.chdir(repo)
    import torch

    import chip_smoke as cs
    from simxns_tpu_torch import run
    from simxns_tpu_torch.config import RECIPES
    from simxns_tpu_torch.ops import _native

    _native.build()
    flags = ["--synthetic", "--full-size", "--fast-encode", "--fast-teacher",
             "--int8-index", "--batch", "8", "--steps", "8",
             "--warm-epochs", "1", "--corpus-size", str(cs.MINE_ROWS),
             "--num-queries", str(cs.MINE_Q)]
    for i in range(runs):
        out_dir = tempfile.mkdtemp(prefix="torch_dist_probe_")
        try:
            args = run.build_parser().parse_args(
                ["--recipe", "nq_ar2_simans", *flags, "--output-dir",
                 out_dir])
            cfg = dataclasses.replace(RECIPES["nq_ar2_simans"],
                                      iteration_step=4,
                                      iteration_reranker_step=1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run.run_ar2("nq_ar2_simans", cfg, args)
            torch.cuda.synchronize()
            enc = out["phase_times_s"]["encode_corpus"]
            print(json.dumps({
                "repo": repo, "run": i, "nvidia_smi": cs.nvidia_smi(),
                "wall_s": time.perf_counter() - t0,
                "mine_encode_passages_per_s": 4 * cs.MINE_ROWS / enc,
                "phase_times_s": out["phase_times_s"]}), flush=True)
        finally:
            shutil.rmtree(out_dir, ignore_errors=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("what", choices=["probe", "co_training"])
    ap.add_argument("--repo", default=REPO)
    ap.add_argument("--runs", type=int, default=2)
    args = ap.parse_args()
    if args.what == "probe":
        probe()
    else:
        co_training(os.path.abspath(args.repo), args.runs)


if __name__ == "__main__":
    main()
