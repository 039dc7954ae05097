#!/usr/bin/env python3
"""Time the port's attention backward kernels on one CUDA card.

    python3 scripts/torch_attention_bwd_bench.py [--repo DIR] [--reps N]

K6 ``group_attention_bwd`` at the nq reranker step's shape (128 joint rows x
16 heads x S=160 x d=64) and K8 ``bh_attention_bwd`` at the msdoc reranker
step's (128 x 12 heads x S=512 x d=64), bf16 head views of [B, S, H]
projections with random key lengths (from seed 0), as ``chip_smoke.py``
feeds them. K8's two launches also run on K6's inputs. ``--repo`` imports
``simxns_tpu_torch`` from another checkout (the parent commit unpacked with
``git archive``, say), so that two versions are timed in one run on one
card. One JSON line per (kernel, shape): the CUDA-event ms per call, the
profiler's device ms per launch of each CUDA kernel of the call, SDPA's
backward ms (the yardstick) and the card's name and power limit.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repo", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, args.repo)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from simxns_tpu_torch.ops import _native
    from simxns_tpu_torch.ops import flash_attention as fa

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    _native.build(["group_attention", "bh_attention"])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def inputs(b, s, heads, d, min_len):
        def head(x):
            return x.view(b, s, heads, d).transpose(1, 2)
        q, k, v, do = (head(torch.randn(b, s, heads * d, device=dev,
                                        generator=gen).to(torch.bfloat16))
                       for _ in range(4))
        mask = torch.ones(b, s, dtype=torch.int32, device=dev)
        lens = torch.randint(min_len, s + 1, (b,), device=dev, generator=gen)
        mask[torch.arange(s, device=dev)[None, :] >= lens[:, None]] = 0
        return q, k, v, do, mask

    def event_ms(fn):
        fn()
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(args.reps):
            fn()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / args.reps

    def device_ms(fn):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        by_name = {}
        for ev in prof.events():   # "void (anonymous namespace)::name<64>(..."
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                name = ev.name.split("<")[0].split("::")[-1]
                by_name.setdefault(name, []).append(
                    ev.time_range.elapsed_us())
        return {n: sum(us) / 1e3 / len(us) for n, us in by_name.items()}

    def sdpa_bwd_ms(q, k, v, do, mask):
        keep = (mask > 0)[:, None, None, :]
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        out = torch.nn.functional.scaled_dot_product_attention(
            qg, kg, vg, attn_mask=keep)
        return event_ms(lambda: torch.autograd.grad(
            out, (qg, kg, vg), do, retain_graph=True))

    cases = [("group_attention_bwd", fa.group_attention_bwd,
              (128, 160, 16, 64, 100)),
             ("bh_attention_bwd", fa.bh_attention_bwd,
              (128, 160, 16, 64, 100)),
             ("bh_attention_bwd", fa.bh_attention_bwd,
              (128, 512, 12, 64, 300))]
    for name, fn, shape in cases:
        q, k, v, do, mask = inputs(*shape)
        call = lambda: fn(q, k, v, mask, do)  # noqa: E731
        print(json.dumps({
            "kernel": name, "shape": [shape[0], shape[2], shape[1], shape[3]],
            "repo": args.repo, "ms": event_ms(call),
            "device_ms": device_ms(call),
            "sdpa_bwd_ms": sdpa_bwd_ms(q, k, v, do, mask),
            "nvidia_smi": smi}), flush=True)
        del q, k, v, do, mask
    return 0


if __name__ == "__main__":
    sys.exit(main())
