#!/usr/bin/env python3
"""Time variants of K3's and K8's shape rules on one CUDA card.

    python3 scripts/torch_attention_shapes.py [--kernel k3|k8]
        [--variants NAME,...]

Each kernel picks its block shape in ``by_length``: K3
(``csrc/small_s_attention.cu``) the keys a streamed tile (N), the
warpgroups a block (WG), the blocks an SM its launch bounds ask for (MIN)
and whether every key fits one tile whose scores stay in registers from
pass 1 to pass 2 (ONE), by ranges of S; K8 (``csrc/attention_bwd_wgmma.cu``)
the query pass's and the key pass's Pass<DP, N, WG, E> from S = 256. Each
variant below rewrites that rule in a copy of the source (the
shared-memory asserts dropped), builds it with the package's nvcc flags
into ``simxns_tpu_torch/_build/shapes_<kernel>/`` and calls its C entry
point on ``chip_smoke.py``'s inputs at the shapes the port runs (K3: random
bf16 q | k | v rows, key lengths from the shortest given to S; K8: bf16
head views, key lengths S/2..S, the first batch row all masked). It prints
one JSON line per variant (ptxas registers and spills) and per shape: each
variant's CUDA-event ms over 10 calls, the profiler's device ms of a call
and its largest error against the plain version (K3: of max|v|, limit
2^-7; K8: of each gradient's largest, limit 2^-7), with the card's name
and power limit.
"""

import argparse
import ctypes
import json
import math
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# K3: name -> the template arguments of Shape after DP ("N, WG, MIN, ONE")
# for S <= 128, S <= 192, S < 256 and from 256
K3_VARIANTS = {
    "chosen": ("128, 1, DP <= 64 ? 3 : 2, true",
               "192, 1, DP <= 64 ? 2 : 1, true",
               "64, 1, DP <= 64 ? 4 : 2, false",
               "64, 2, DP <= 64 ? 2 : 1, false"),
    "two_pass": ("64, 2, DP <= 64 ? 2 : 1, false",
                 "64, 1, DP <= 64 ? 4 : 2, false",
                 "64, 1, DP <= 64 ? 4 : 2, false",
                 "64, 2, DP <= 64 ? 2 : 1, false"),
    "one_tile_wg2": ("128, 2, 1, true", "192, 1, DP <= 64 ? 2 : 1, true",
                     "64, 1, DP <= 64 ? 4 : 2, false",
                     "64, 2, DP <= 64 ? 2 : 1, false"),
    "keys32_wg1": ("128, 1, DP <= 64 ? 3 : 2, true",
                   "32, 1, DP <= 64 ? 4 : 2, false",
                   "32, 1, DP <= 64 ? 4 : 2, false",
                   "64, 1, DP <= 64 ? 4 : 2, false"),
    "keys128_wg2": ("128, 1, DP <= 64 ? 3 : 2, true",
                    "192, 1, DP <= 64 ? 2 : 1, true",
                    "64, 2, DP <= 64 ? 2 : 1, false",
                    "128, 2, 1, false"),
}
# K8: name -> the bf16 instance's (query pass, key pass) "N, WG" from S =
# 256 at DP = 32 and 64 (DP = 16 and 128, and the f32 instance, keep the
# source's rule)
K8_VARIANTS = {
    "chosen": ("64, 1", "64, 1"),
    "f32_rule": ("128, 2", "64, 2"),
    "query64": ("64, 2", "64, 2"),
    "key32": ("128, 2", "32, 2"),
}
# K3: (sequences, S, shortest key length, hidden, heads): the encode chunk,
# the CE-large teacher and rerank, the msdoc encode, a request, S = 1,100;
# K8: (batch, heads, S, d): the msdoc reranker's, the two edges, and d = 32
K3_SHAPES = [(1024, 128, 8, 768, 12), (128, 160, 100, 1024, 16),
             (256, 160, 100, 1024, 16), (1024, 512, 300, 768, 12),
             (8, 32, 8, 768, 12), (64, 1100, 550, 768, 12)]
K8_SHAPES = [(128, 12, 512, 64), (4, 8, 1024, 128), (16, 8, 256, 64),
             (16, 8, 512, 32)]
_K3_RULE = re.compile(r"template <int DP>\ncudaError_t by_length\(const Args& "
                      r"a\) \{.*?\n\}\n", re.S)
_K8_RULE = re.compile(r"template <int DP, class E>\ncudaError_t by_length\("
                      r"const Args<E>& a\) \{.*?\n\}\n", re.S)


def _k3_rule(variant):
    small, mid, low, large = variant
    return ("template <int DP>\ncudaError_t by_length(const Args& a) {\n"
            f"  if (a.S <= 128) return launch<Shape<DP, {small}>>(a);\n"
            f"  if (a.S <= 192) return launch<Shape<DP, {mid}>>(a);\n"
            f"  if (a.S < 256) return launch<Shape<DP, {low}>>(a);\n"
            f"  return launch<Shape<DP, {large}>>(a);\n}}\n")


def _k8_rule(variant):
    query, key = variant
    return ("template <int DP, class E>\n"
            "cudaError_t by_length(const Args<E>& a) {\n"
            "  if (a.S < 256) return launch<Pass<DP, 32, 1, E>, "
            "Pass<DP, 32, 1, E>>(a);\n"
            "  if constexpr (DP == 128)\n"
            "    return launch<Pass<DP, 32, 2, E>, Pass<DP, 32, 2, E>>(a);\n"
            "  else if constexpr (DP == 16)\n"
            "    return launch<Pass<DP, 64, 2, E>, Pass<DP, 64, 2, E>>(a);\n"
            "  else if constexpr (Pass<DP, 32, 1, E>::kSplit)\n"
            "    return launch<Pass<DP, 128, 2, E>, Pass<DP, 64, 2, E>>(a);\n"
            "  else\n"
            f"    return launch<Pass<DP, {query}, E>, Pass<DP, {key}, E>>(a);\n"
            "}\n")


KERNELS = {
    "k3": ("small_s_attention", "sx_small_s_attention", _K3_RULE, _k3_rule,
           K3_VARIANTS),
    "k8": ("attention_bwd_wgmma", "sx_bh_attention_bwd", _K8_RULE, _k8_rule,
           K8_VARIANTS),
}


def build(native, kernel, names):
    """name -> the typed C entry point of each variant's library."""
    source, symbol, pattern, rule, variants = KERNELS[kernel]
    src = (native.CSRC / f"{source}.cu").read_text()
    out = native.BUILD_DIR / f"shapes_{kernel}"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        text, n = pattern.subn(lambda _: rule(variants[name]), src)
        if n != 1:
            raise RuntimeError(f"by_length not found in {source}.cu")
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
            "kernel": kernel, "variant": name, "rules": variants[name],
            "nvcc_rc": proc.returncode,
            "registers": [ln.split("Used")[1].split(",")[0].strip()
                          for ln in log if "Used" in ln],
            "spills": [ln.strip() for ln in log if "spill" in ln
                       and " 0 bytes spill stores" not in ln],
            "error": stderr[-2000:] if proc.returncode else ""}), flush=True)
        if proc.returncode == 0:
            fn = getattr(ctypes.CDLL(str(out / f"lib{name}.so")), symbol)
            fn.restype = ctypes.c_int
            fns[name] = fn
    return fns


def time_k3(torch, cs, native, fns, smi):
    from simxns_tpu_torch.ops import fused_layer as fl

    for fn in fns.values():
        fn.argtypes = fl._ATTN_ARGS
    dev = torch.device("cuda")
    for b, s, lo, h, heads in K3_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(0)
        qkv = torch.randn(b * s, 3 * h, device=dev, generator=gen).to(
            torch.bfloat16)
        mask = torch.ones(b, s, dtype=torch.int32, device=dev)
        lens = torch.randint(lo, s + 1, (b,), device=dev, generator=gen)
        mask[torch.arange(s, device=dev)[None, :] >= lens[:, None]] = 0
        want = fl._small_s_attention_plain(qkv, mask, heads)
        vmax = float(qkv[:, 2 * h:].float().abs().max())
        row = {"kernel": "k3", "shape": [b, s, h, heads], "nvidia_smi": smi}
        for name, fn in fns.items():
            ctx = torch.empty(b * s, h, dtype=torch.float32, device=dev)

            def call(fn=fn, ctx=ctx):
                code = native.launch(
                    fn, dev, native.ptr(qkv), native.ptr(mask),
                    native.ptr(ctx), b, s, h, h // heads,
                    1.0 / math.sqrt(h // heads))
                native.check("small_s_attention", code, name)

            call()
            torch.cuda.synchronize()
            row[name] = {
                "ms": cs.timed(torch, call, 10),
                "device_ms": cs.device_call_ms(torch, call),
                "err_of_max_v": float((ctx - want).abs().max()) / vmax}
        print(json.dumps(row), flush=True)


def time_k8(torch, cs, native, fns, smi):
    from simxns_tpu_torch.ops import flash_attention as fa

    for fn in fns.values():
        fn.argtypes = fa._BH_BWD_ARGS
    dev = torch.device("cuda")
    for b, heads, s, d in K8_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(0)
        q, k, v, do = (torch.randn(b, s, heads * d, device=dev, generator=gen)
                       .to(torch.bfloat16).view(b, s, heads, d)
                       .transpose(1, 2) for _ in range(4))
        mask = torch.ones(b, s, dtype=torch.int32, device=dev)
        lens = torch.randint(s // 2, s + 1, (b,), device=dev, generator=gen)
        mask[torch.arange(s, device=dev)[None, :] >= lens[:, None]] = 0
        mask[0] = 0
        refs = fa._group_bwd_plain(q, k, v, mask, do)
        row = {"kernel": "k8", "shape": [b, heads, s, d], "nvidia_smi": smi}
        for name, fn in fns.items():
            grads = (fa._out(q), fa._out(q), fa._out(q))
            stats = torch.empty(2, b, heads, s, dtype=torch.float32,
                                device=dev)

            def call(fn=fn, grads=grads, stats=stats):
                code = native.launch(
                    fn, dev, native.ptr(q), native.ptr(k), native.ptr(v),
                    *q.stride()[:3], *fa._view_args(do), native.ptr(mask),
                    *(native.ptr(g) for g in grads), *grads[0].stride()[:3],
                    native.ptr(stats), b, heads, s, d, 1.0 / math.sqrt(d))
                native.check("attention_bwd_wgmma", code, name)

            call()
            torch.cuda.synchronize()
            row[name] = {
                "ms": cs.timed(torch, call, 10),
                "device_ms": cs.device_call_ms(torch, call),
                "err_of_largest": max(fa.errors_of_largest(grads, refs))}
        print(json.dumps(row), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", default="k3", choices=sorted(KERNELS))
    ap.add_argument("--variants", default=None)
    args = ap.parse_args()
    variants = KERNELS[args.kernel][4]
    names = (args.variants or ",".join(variants)).split(",")
    unknown = set(names) - set(variants)
    if unknown:
        ap.error(f"unknown variants {sorted(unknown)}; known: {list(variants)}")
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from simxns_tpu_torch.ops import _native

    smi = cs.nvidia_smi()
    fns = build(_native, args.kernel, names)
    (time_k3 if args.kernel == "k3" else time_k8)(torch, cs, _native, fns,
                                                   smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
