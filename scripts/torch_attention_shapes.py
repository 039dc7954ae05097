#!/usr/bin/env python3
"""Time variants of K3's and K5-K8's shape rules on one CUDA card.

    python3 scripts/torch_attention_shapes.py [--kernel k3|k5|k6|k7|k8]
        [--variants NAME,...]

(every variant of the kernel's rule by default; the ablations of K6 and
K7 below, which take a part of the kernel out, only when named)

Each kernel picks its block shape in a rule: K3
(``csrc/small_s_attention.cu``, ``by_length``) the keys a streamed tile
(N), the warpgroups a block (WG), the blocks an SM its launch bounds ask
for (MIN) and whether every key fits one tile whose scores stay in
registers from pass 1 to pass 2 (ONE), by ranges of S; K5 and K7 bf16
(``csrc/attention_fwd_wgmma.cu``, ``by_length_bf16``: K5 below S = 256,
K7 from 256) their Fwd<DP, N, WG, MIN, bf16, STAGES> (STAGES = 1, in the
K5 variants ``one_tile*`` only: every key in one tile of N, S <= N, a path
the source does not carry, which ``ONE_TILE`` patches into the copy); K6
bf16 (``csrc/attention_bwd_wgmma.cu``,
``group_by_length``) up to which S its one-launch kernel runs, and K8's
two passes past that; K8 (the same source, ``by_length``) the query
pass's and the key pass's Pass<DP, N, WG, E> from S = 256. Each variant
below rewrites that rule in a copy of the source (the shared-memory
asserts dropped), builds it with the package's nvcc flags into
``simxns_tpu_torch/_build/shapes_<kernel>/`` and calls its C entry point
on ``chip_smoke.py``'s inputs at the shapes the port runs (K3: random bf16
q | k | v rows, key lengths from the shortest given to S; K5-K8: bf16
head views, key lengths S/2..S, the first batch row all masked). It prints
one JSON line per variant (ptxas registers, spills and warnings) and per
shape: each variant's CUDA-event ms over 10 calls, the profiler's device
ms of a call and its largest error against the plain version (K3, K5 and
K7: of max|v|, limits 2^-7 and 2^-8; K6 and K8: of each gradient's
largest, limit 2^-7), with the card's name and power limit; K5 and K7
also the largest difference of each variant's o from the first
variant's.
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
# K7: name -> the bf16 Fwd's "N, WG, MIN, bf16, STAGES" at DP <= 64 (DP =
# 128 keeps the source's)
K7_VARIANTS = {
    "chosen": "64, 2, 2, bf16, 2",
    "stages3": "64, 2, 2, bf16, 3",
    "keys128": "128, 2, 1, bf16, 2",
    "wg1": "64, 1, 4, bf16, 2",
    "wg1_min5": "64, 1, 5, bf16, 2",
    "wg4": "64, 4, 1, bf16, 2",
}
# K5: name -> the bf16 Fwd below S = 256 at DP <= 64 (DP = 128 keeps the
# source's) as [(longest S, "N, WG, MIN, bf16, STAGES")], first match
# taken; STAGES = 1: every key in one tile of N (S <= N; ONE_TILE below)
_K5_TAIL = (255, "32, 1, 6, bf16, 2")
K5_VARIANTS = {
    "chosen": [_K5_TAIL],
    "min4": [(255, "32, 1, 4, bf16, 2")],
    "min7": [(255, "32, 1, 7, bf16, 2")],
    "stages3": [(255, "32, 1, 6, bf16, 3")],
    "keys64": [(255, "64, 1, 4, bf16, 2")],
    "rows128": [(255, "32, 2, 2, bf16, 2")],
    "one_tile": [(64, "64, 1, 4, bf16, 1"), (128, "128, 1, 3, bf16, 1"),
                 (192, "192, 1, 2, bf16, 1"), _K5_TAIL],
    "one_tile_160": [(64, "64, 1, 4, bf16, 1"), (128, "128, 1, 3, bf16, 1"),
                     (160, "160, 1, 3, bf16, 1"), (192, "192, 1, 2, bf16, 1"),
                     _K5_TAIL],
    "one_tile_rows128": [(128, "128, 2, 1, bf16, 1"),
                         (192, "192, 2, 1, bf16, 1"), _K5_TAIL],
    # one block a head: a warpgroup a 64 query rows, every landed key tile
    # shared (no ping-pong past two)
    "block_a_head": [(64, "32, 1, 4, bf16, 2"), (128, "32, 2, 2, bf16, 2"),
                     (192, "32, 3, 2, bf16, 2"), _K5_TAIL],
}
# K6: name -> the longest S of its one-launch kernel at DP <= 64 (0: K8's
# two passes at every S), and K8's pass shape past it ("N, WG")
K6_VARIANTS = {
    "chosen": (192, "32, 1"),
    "k8_passes": (0, "32, 1"),
    "k8_passes64": (0, "64, 1"),
    "one_launch_to_128": (128, "32, 1"),
}
# K3: (sequences, S, shortest key length, hidden, heads): the encode chunk,
# the CE-large teacher and rerank, the msdoc encode, a request, S = 1,100;
# K8: (batch, heads, S, d): the msdoc reranker's, the two edges, and d = 32
K3_SHAPES = [(1024, 128, 8, 768, 12), (128, 160, 100, 1024, 16),
             (256, 160, 100, 1024, 16), (1024, 512, 300, 768, 12),
             (8, 32, 8, 768, 12), (64, 1100, 550, 768, 12)]
K8_SHAPES = [(128, 12, 512, 64), (4, 8, 1024, 128), (16, 8, 256, 64),
             (16, 8, 512, 32)]
# K7: K8's; K6: the reranker step's (128 joint rows x 16 heads x S = 160),
# S = 128 and 255, and the widths 128 (d = 80 runs it) and 32
K7_SHAPES = K8_SHAPES
# K5: the reranker step's (128 joint rows x 16 heads x S = 160), S = 128
# (K3's teacher length), the longest S of a one tile (192) and of the
# route (255), and the widths 32 and 128
K5_SHAPES = [(128, 16, 160, 64), (128, 16, 128, 64), (64, 8, 192, 64),
             (64, 8, 255, 64), (64, 8, 160, 32), (64, 8, 160, 128)]
K6_SHAPES = [(128, 16, 160, 64), (128, 16, 128, 64), (16, 8, 255, 64),
             (64, 8, 160, 128), (64, 8, 160, 80), (64, 8, 160, 32)]
_K3_RULE = re.compile(r"template <int DP>\ncudaError_t by_length\(const Args& "
                      r"a\) \{.*?\n\}\n", re.S)
_K8_RULE = re.compile(r"template <int DP, class E>\ncudaError_t by_length\("
                      r"const Args<E>& a\) \{.*?\n\}\n", re.S)
_K7_RULE = re.compile(r"template <int DP>\ncudaError_t by_length_bf16\("
                      r"const Args<bf16>& a\) \{.*?\n\}\n", re.S)
_K6_RULE = re.compile(r"template <int DP>\ncudaError_t group_by_length\("
                      r"const Args<bf16>& a\) \{.*?\n\}\n", re.S)


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


def _k7_rule(variant):
    return ("template <int DP>\n"
            "cudaError_t by_length_bf16(const Args<bf16>& a) {\n"
            "  if constexpr (DP == 128)\n"
            "    return launch<Fwd<DP, 64, 2, 1, bf16, 2>>(a);\n"
            "  else\n"
            f"    return launch<Fwd<DP, {variant}>>(a);\n}}\n")


def _k5_rule(variant):
    shapes = "".join(f"    if (a.S <= {s}) return launch<Fwd<DP, {shape}>, "
                     f"true>(a);\n" for s, shape in variant)
    return ("template <int DP>\n"
            "cudaError_t by_length_bf16(const Args<bf16>& a) {\n"
            "  if constexpr (DP <= 64) {\n" + shapes + "  }\n"
            "  if (a.S < 256)\n"
            "    return launch<Fwd<DP, 32, 1, 2, bf16, 2>, true>(a);\n"
            "  return launch<Fwd<DP, 64, 2, DP <= 64 ? 2 : 1, bf16, 2>>(a);\n"
            "}\n")


def _k6_rule(variant):
    upto, passes = variant
    return ("template <int DP>\n"
            "cudaError_t group_by_length(const Args<bf16>& a) {\n"
            "  if constexpr (DP <= 64) {\n"
            f"    if (a.S <= 64 && a.S <= {upto})\n"
            "      return launch_group<Group<DP, 1>>(a);\n"
            f"    if (a.S <= 128 && a.S <= {upto})\n"
            "      return launch_group<Group<DP, 2>>(a);\n"
            f"    if (a.S <= 192 && a.S <= {upto})\n"
            "      return launch_group<Group<DP, 3>>(a);\n"
            "  }\n"
            f"  return launch<Pass<DP, {passes}, bf16>, "
            f"Pass<DP, {passes}, bf16>>(a);\n}}\n")


# Ablations: name -> (the variant whose rule they keep, [(pattern,
# replacement)] applied to the source after it). Their results are wrong:
# they time what is left when a part of the kernel is taken out.
_K6_PRODUCTS = (r"    for \(int kk = 0; kk < kRows / 16; \+\+kk\) \{\n"
                r"      Mt::mma\(dvf.*?\n    \}\n")
_K6_SCORES = (r"    issue_scores<DP, kRows, false>\(sc, dp, qt, qt, kt, kt, dt, "
              r"dt, vt, vt\);\n")
ABLATIONS = {
    "k6": {
        # without dV's, dK's and dQ's products
        "no_big_products": ("chosen", [(_K6_PRODUCTS, "")]),
        # only the landing of the operands (and the key fills)
        "loads_only": ("chosen", [(r"    const uint8_t\* qt = op\(0, r\);\n",
                                   "    if (r >= 0) break;\n"
                                   "    const uint8_t* qt = op(0, r);\n")]),
        # and without the score products (zero scores)
        "no_products": ("chosen", [
            (_K6_PRODUCTS, ""),
            (_K6_SCORES, "    for (int x = 0; x < kRows / 8; ++x)\n"
                         "      for (int e = 0; e < 4; ++e)\n"
                         "        sc[x][e] = dp[x][e] = 0.0f;\n")]),
    },
    # without the ping-pong of K7's two warpgroups
    "k7": {"no_pingpong": ("chosen", [(r"(before|after)_scores<P::WG>\(\);",
                                       "")])},
}


def _wgmma_bf16(n):
    """C++ of the m64n{n}k16 bf16 product that wgmma_ring.cuh leaves out."""
    regs = n // 2
    outs = ", ".join(f"%{i}" for i in range(regs))
    binds = ", ".join(f'"+f"(d[{i}])' for i in range(regs))
    return (
        "namespace sx {\nnamespace wg {\n"
        "template <bool TA, bool TB>\n"
        f"struct WgmmaBf16<{n}, TA, TB> {{\n"
        "  __device__ __forceinline__ static void mma(\n"
        f"      float (&d)[{regs}], uint64_t a, uint64_t b, int scale_d) {{\n"
        "    asm volatile(\n"
        f'        "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{regs + 2}, 0;\\n"\n'
        f'        "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "\n'
        f'        "{{{outs}}}, %{regs}, %{regs + 1}, p, 1, 1, %{regs + 3}, '
        f'%{regs + 4};\\n}}\\n"\n'
        f"        : {binds}\n"
        '        : "l"(a), "l"(b), "r"(scale_d), "n"(int{TA}), '
        '"n"(int{TB}));\n'
        "  }\n};\n}  // namespace wg\n}  // namespace sx\n")


# K5's one-tile path (STAGES = 1, S <= N), which lost to the chosen rule
# and is not in the source: [(pattern, replacement)] applied to the copy
# of every K5 variant named one_tile*. k lands, then v in a group behind
# it, under q k^T and the softmax; the loop runs one tile.
ONE_TILE = [
    (r'#include "attention_wgmma.cuh"\n',
     '#include "attention_wgmma.cuh"\n' + _wgmma_bf16(160)),
    (r"  static constexpr int kThreads = 128 \* WG;\n",
     "  static constexpr bool kOne = !kSplit && kStages == 1;\n"
     "  static constexpr int kThreads = 128 * WG;\n"),
    (r"#pragma unroll\n    for \(int i = 0; i < P::kStages - 1; \+\+i\) "
     r"\{\n.*?\n    \}\n",
     "    if constexpr (P::kOne) {\n"
     "      land_tile<DP, N, T>(t0, [&](int i) { return k.row(b, h, i); }, "
     "0, S, d, tid);\n"
     "      wg::cp_async_commit();\n"
     "      land_tile<DP, N, T>(t0 + Str::kBytes, [&](int i) { "
     "return v.row(b, h, i); }, 0, S, d, tid);\n"
     "      wg::cp_async_commit();\n"
     "    } else {\n"
     "#pragma unroll\n"
     "      for (int i = 0; i < P::kStages - 1; ++i) {\n"
     "        if (i < n_tiles) issue(i);\n"
     "        wg::cp_async_commit();\n"
     "      }\n"
     "    }\n"),
    (r"    if constexpr \(!kSplit\) \{   // this tile landed",
     "    if constexpr (P::kOne) {   // q and k landed (v may be in flight)\n"
     "      wg::cp_async_wait<1>();\n"
     "      wg::fence_proxy_async();\n"
     "      __syncthreads();\n"
     "    } else if constexpr (!kSplit) {   // this tile landed"),
    (r"    uint32_t ph\[N / 16\]\[4\], pl\[N / 16\]\[4\];\n",
     "    if constexpr (P::kOne) {   // v landed\n"
     "      wg::cp_async_wait_all();\n"
     "      wg::fence_proxy_async();\n"
     "      __syncthreads();\n"
     "    }\n"
     "    uint32_t ph[N / 16][4], pl[N / 16][4];\n"),
]
# K7's one-warpgroup variants run from S = 256: key fills for every S
_ONE_WG_KEYS = [(r"kMaxKeys = WG == 1 \? 256 : kMaxS", "kMaxKeys = kMaxS")]


def _patches(kernel, name):
    if kernel == "k5" and name.startswith("one_tile"):
        return ONE_TILE
    return _ONE_WG_KEYS if kernel == "k7" else []


KERNELS = {
    "k3": ("small_s_attention", "sx_small_s_attention", _K3_RULE, _k3_rule,
           K3_VARIANTS),
    "k8": ("attention_bwd_wgmma", "sx_bh_attention_bwd", _K8_RULE, _k8_rule,
           K8_VARIANTS),
    "k5": ("attention_fwd_wgmma", "sx_group_attention_fwd", _K7_RULE,
           _k5_rule, K5_VARIANTS),
    "k7": ("attention_fwd_wgmma", "sx_bh_attention_fwd", _K7_RULE, _k7_rule,
           K7_VARIANTS),
    "k6": ("attention_bwd_wgmma", "sx_group_attention_bwd", _K6_RULE,
           _k6_rule, K6_VARIANTS),
}


def build(native, kernel, names):
    """name -> the typed C entry point of each variant's library."""
    source, symbol, pattern, rule, variants = KERNELS[kernel]
    ablations = ABLATIONS.get(kernel, {})
    src = (native.CSRC / f"{source}.cu").read_text()
    out = native.BUILD_DIR / f"shapes_{kernel}"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        keep, cuts = ablations.get(name, (name, []))
        text, n = pattern.subn(lambda _: rule(variants[keep]), src)
        for cut, repl in cuts + _patches(kernel, name):
            text, m = re.subn(cut, lambda _, r=repl: r, text, flags=re.S)
            if not m:
                raise RuntimeError(f"{name}: {cut!r} not in {source}.cu")
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
            "kernel": kernel, "variant": name,
            "rules": variants[ablations.get(name, (name,))[0]],
            "ablation": [cut for cut, _ in ablations.get(name, ("", []))[1]],
            "nvcc_rc": proc.returncode,
            "registers": [ln.split("Used")[1].split(",")[0].strip()
                          for ln in log if "Used" in ln],
            "spills": [ln.strip() for ln in log if "spill" in ln
                       and " 0 bytes spill stores" not in ln],
            "warnings": [ln.strip() for ln in log
                         if "warning" in ln.lower()][:8],
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


def _head_inputs(torch, b, heads, s, d):
    """chip_smoke.py's K7/K8 inputs: bf16 head views of [b, s, heads d]
    projections, key lengths s/2..s, the first batch row all masked."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v, do = (torch.randn(b, s, heads * d, device=dev, generator=gen)
                   .to(torch.bfloat16).view(b, s, heads, d)
                   .transpose(1, 2) for _ in range(4))
    mask = torch.ones(b, s, dtype=torch.int32, device=dev)
    lens = torch.randint(s // 2, s + 1, (b,), device=dev, generator=gen)
    mask[torch.arange(s, device=dev)[None, :] >= lens[:, None]] = 0
    mask[0] = 0
    return q, k, v, do, mask


def time_fwd(torch, cs, native, fns, smi, kernel):
    from simxns_tpu_torch.ops import flash_attention as fa

    for fn in fns.values():
        fn.argtypes = fa._FWD_ARGS
    dev = torch.device("cuda")
    for b, heads, s, d in K7_SHAPES if kernel == "k7" else K5_SHAPES:
        q, k, v, _, mask = _head_inputs(torch, b, heads, s, d)
        want = fa._group_fwd_plain(q, k, v, mask)
        vmax = float(v.float().abs().max())
        row = {"kernel": kernel, "shape": [b, heads, s, d],
               "nvidia_smi": smi}
        first = None
        for name, fn in fns.items():
            o = fa._out(q)

            def call(fn=fn, o=o):
                code = native.launch(
                    fn, dev, native.ptr(q), native.ptr(k), native.ptr(v),
                    *q.stride()[:3], native.ptr(mask), *fa._view_args(o),
                    b, heads, s, d, 1.0 / math.sqrt(d))
                native.check("attention_fwd_wgmma", code, name)

            call()
            torch.cuda.synchronize()
            first = o if first is None else first
            row[name] = {
                "ms": cs.timed(torch, call, 10),
                "device_ms": cs.device_call_ms(torch, call),
                "err_of_max_v": float((o.float() - want.float()).abs().max())
                / vmax,
                "max_abs_diff_vs_first": float(
                    (o.float() - first.float()).abs().max())}
        print(json.dumps(row), flush=True)


def time_k8(torch, cs, native, fns, smi, kernel="k8"):
    from simxns_tpu_torch.ops import flash_attention as fa

    for fn in fns.values():
        fn.argtypes = fa._BWD_ARGS
    dev = torch.device("cuda")
    for b, heads, s, d in K8_SHAPES if kernel == "k8" else K6_SHAPES:
        q, k, v, do, mask = _head_inputs(torch, b, heads, s, d)
        refs = fa._group_bwd_plain(q, k, v, mask, do)
        row = {"kernel": kernel, "shape": [b, heads, s, d],
               "nvidia_smi": smi}
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
    variants = {**KERNELS[args.kernel][4], **ABLATIONS.get(args.kernel, {})}
    names = (args.variants or ",".join(KERNELS[args.kernel][4])).split(",")
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
    if args.kernel == "k3":
        time_k3(torch, cs, _native, fns, smi)
    elif args.kernel in ("k5", "k7"):
        time_fwd(torch, cs, _native, fns, smi, args.kernel)
    else:
        time_k8(torch, cs, _native, fns, smi, args.kernel)
    return 0


if __name__ == "__main__":
    sys.exit(main())
