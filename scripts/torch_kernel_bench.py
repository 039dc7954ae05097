#!/usr/bin/env python3
"""Time the port's redesigned kernels on one CUDA card, one checkout at a time.

    python3 scripts/torch_kernel_bench.py [--repo DIR] [--cases NAME,...]

Each case runs ``chip_smoke.py``'s check of its kernels (the same inputs,
plain-version gate, timers, yardstick and bound) and prints its records as
one JSON line, with the card's name and power limit:

- ``int8_linear:chunk|teacher|query|request``: K1 on the four GEMMs of a
  layer (qkv to bf16, out, ffn_in with GELU and ffn_out to f32) at a
  BERT-base encode chunk (131,072 tokens), the CE-large int8 teacher
  (20,480 tokens, H=1024, F=4096), the mine's queries (64 x 32 = 2,048
  tokens) and a request (256 tokens); bitwise against the plain version;
- ``group_attention``: K5 and K6 at the nq reranker step's shape (128 joint
  rows x 16 heads x S=160 x d=64), SDPA's forward and backward, and K8's
  two launches on K6's inputs;
- ``bh_attention``: K7 and K8 at the msdoc reranker step's shape (128 x 12
  heads x S=512 x d=64).

``--repo`` imports ``simxns_tpu_torch`` from another checkout (the parent
commit unpacked with ``git archive``, say) while the checks and timers stay
this checkout's, so that two versions run the same measurement; run it once
per checkout, in turns, in one call to the card.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# case -> (libraries to build, the check: (torch, chip_smoke, randn, gen)
# -> {kernel: record})
CASES = {
    **{f"int8_linear:{label}": (["int8_linear"], (
        lambda torch, cs, randn, gen, m=m, h=h, f=f: {
            "int8_linear": cs._check_int8_linear(torch, randn, m, h, f)}))
       for label, m, h, f in (("chunk", 1024 * 128, 768, 3072),
                              ("teacher", 128 * 160, 1024, 4096),
                              ("query", 64 * 32, 768, 3072),
                              ("request", 256, 768, 3072))},
    "group_attention": (["group_attention", "bh_attention"], (
        lambda torch, cs, randn, gen: dict(zip(
            ("group_attention_fwd", "group_attention_bwd"),
            cs._check_group_attention(torch, randn, gen))))),
    "bh_attention": (["bh_attention"], (
        lambda torch, cs, randn, gen: {
            "bh_attention": cs._check_bh_attention(
                torch, randn, gen, 128, cs.MS_S, 64, 300, True)})),
}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repo", default=str(ROOT))
    ap.add_argument("--cases", default=",".join(CASES))
    args = ap.parse_args()
    cases = args.cases.split(",")
    unknown = set(cases) - set(CASES)
    if unknown:
        ap.error(f"unknown cases {sorted(unknown)}; known: {list(CASES)}")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    sys.path.insert(0, args.repo)      # simxns_tpu_torch from --repo
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    import simxns_tpu_torch
    from simxns_tpu_torch.ops import _native

    smi = cs.nvidia_smi()
    build_s = _native.build(sorted({lib for c in cases
                                    for lib in CASES[c][0]}))
    dev = torch.device("cuda")
    for case in cases:
        gen = torch.Generator(device=dev).manual_seed(0)

        def randn(*shape, scale=1.0):
            return torch.randn(*shape, device=dev, generator=gen) * scale

        for kernel, rec in CASES[case][1](torch, cs, randn, gen).items():
            print(json.dumps({
                "case": case, "kernel": kernel,
                "package": str(Path(simxns_tpu_torch.__file__).parent),
                "nvidia_smi": smi, "nvcc_s_by_source": build_s, **rec}),
                flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
