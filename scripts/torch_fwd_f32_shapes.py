#!/usr/bin/env python3
"""Time variants of the f32 attention forward's shape rule on one CUDA card.

    python3 scripts/torch_fwd_f32_shapes.py [--variants NAME,...]

``csrc/attention_fwd_wgmma.cu`` picks its f32 instance's block shape in
``by_length``: the
keys a streamed tile (N), the warpgroups a block (WG) and the blocks an SM
its launch bounds ask for (MIN), one rule below S = 256 (K5's route) and
one from 256 (K7's). Each variant below rewrites that rule in a copy of the
source (the key fills sized for S = 1024 whatever WG is, the shared-memory
asserts dropped), builds it with the package's nvcc flags into
``simxns_tpu_torch/_build/shapes/`` and calls its ``sx_attention_fwd_f32``
on phase 23's inputs (head views of [b, s, 8d] f32 projections, key lengths
s/2..s, the last batch row all masked) at K7's and K5's shapes and widths.
It prints one JSON line per variant (ptxas registers and spills) and per
shape: each variant's CUDA-event ms over 20 calls, the profiler's device ms
and its error against f64 of max|v|, with the bf16 instance's event ms
beside, and the card's name and power limit.
"""

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# name -> (the rule from S = 256, the rule below), each "N, WG, MIN"
VARIANTS = {
    "chosen": ("64, 2, DP <= 64 ? 2 : 1", "32, 1, DP <= 64 ? 4 : 2"),
    "one_block": ("64, 2, 1", "32, 1, DP <= 64 ? 4 : 2"),
    "keys128": ("DP <= 64 ? 128 : 64, 2, 1", "64, 1, DP <= 64 ? 2 : 1"),
    "one_warpgroup": ("64, 1, DP <= 64 ? 2 : 1", "32, 1, 2"),
    "keys32": ("32, 2, DP <= 64 ? 2 : 1", "32, 2, 1"),
}
# (batch, S, d): K7's and K5's phase 23 shapes at each width (24 runs the
# 32 instance), then the forward's edges
SHAPES = [(16, 512, 64), (64, 160, 64), (16, 512, 128), (64, 160, 128),
          (16, 512, 16), (64, 160, 16), (16, 512, 32), (64, 160, 32),
          (4, 1024, 128), (16, 255, 64), (16, 256, 64)]
_RULE = re.compile(r"template <int DP>\ncudaError_t by_length\("
                   r"const Args<float>& a\) \{.*?\n\}\n", re.S)


def build(native, names):
    """name -> the typed sx_attention_fwd_f32 of each variant's library."""
    src = (native.CSRC / "attention_fwd_wgmma.cu").read_text()
    out = native.BUILD_DIR / "shapes"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        bh, group = VARIANTS[name]
        # one_warpgroup runs one warpgroup from S = 256: fills for every S
        text = src.replace("kMaxKeys = WG == 1 ? 256 : kMaxS",
                           "kMaxKeys = kMaxS")
        if text == src:
            raise RuntimeError("kMaxKeys not found in attention_fwd_wgmma.cu")
        rule = ("template <int DP>\n"
                "cudaError_t by_length(const Args<float>& a) {\n"
                f"  if (a.S < 256) return launch<Fwd<DP, {group}>>(a);\n"
                f"  return launch<Fwd<DP, {bh}>>(a);\n}}\n")
        text, n = _RULE.subn(lambda _: rule, text)
        if n != 1:
            raise RuntimeError("by_length not found in attention_fwd_wgmma.cu")
        text = re.sub(r"static_assert\(.*?\);\n", "", text, flags=re.S)
        cu = out / f"{name}.cu"
        cu.write_text(text)
        cmd = [native._nvcc(), *native.NVCC_FLAGS, "-I", str(native.CSRC),
               "-o", str(out / f"lib{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True)
    fns = {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate()
        log = (stdout + stderr).splitlines()
        print(json.dumps({
            "variant": name, "rules": VARIANTS[name], "nvcc_rc": proc.returncode,
            "registers": [ln.split("Used")[1].split(",")[0].strip()
                          for ln in log if "Used" in ln],
            "spills": [ln.strip() for ln in log if "spill" in ln
                       and " 0 bytes spill stores" not in ln],
            "error": stderr[-2000:] if proc.returncode else ""}), flush=True)
        if proc.returncode == 0:
            fn = ctypes.CDLL(str(out / f"lib{name}.so")).sx_attention_fwd_f32
            fn.restype = ctypes.c_int
            fns[name] = fn
    return fns


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args()
    names = args.variants.split(",")
    unknown = set(names) - set(VARIANTS)
    if unknown:
        ap.error(f"unknown variants {sorted(unknown)}; known: {list(VARIANTS)}")
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from simxns_tpu_torch.ops import _native
    from simxns_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.nvidia_smi()
    fns = build(_native, names)
    for fn in fns.values():
        fn.argtypes = fa._FWD_ARGS
    dev = torch.device("cuda")
    for b, s, d in SHAPES:
        gen = torch.Generator(device=dev).manual_seed(0)
        q, k, v = (torch.randn(b, s, 8 * d, device=dev, generator=gen)
                   .view(b, s, 8, d).transpose(1, 2) for _ in range(3))
        mask = torch.ones(b, s, dtype=torch.int32, device=dev)
        lens = torch.randint(s // 2, s + 1, (b,), device=dev, generator=gen)
        mask[torch.arange(s, device=dev)[None, :] >= lens[:, None]] = 0
        mask[-1] = 0
        o64, _ = fa.attention_f64(q, k, v, mask, torch.zeros_like(q))
        vmax = float(v.abs().max())
        row = {"shape": [b, 8, s, d], "nvidia_smi": smi}
        for name, fn in fns.items():
            o = fa._out(q)

            def call(fn=fn, o=o):
                code = _native.launch(
                    fn, dev, _native.ptr(q), _native.ptr(k), _native.ptr(v),
                    *q.stride()[:3], _native.ptr(mask), *fa._view_args(o),
                    b, 8, s, d, 1.0 / d ** 0.5)
                _native.check("attention_fwd_wgmma", code, name)

            call()
            torch.cuda.synchronize()
            row[name] = {
                "ms": cs.timed(torch, call, 20),
                "device_ms": cs.device_call_ms(torch, call),
                "err_of_max_v_vs_f64":
                    float((o.double() - o64).abs().max()) / vmax}
        qb, kb, vb = (t.bfloat16() for t in (q, k, v))
        bf16 = fa.bh_attention_fwd if s >= 256 else fa.group_attention_fwd
        row["bf16_ms"] = cs.timed(torch, lambda: bf16(qb, kb, vb, mask), 20)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
