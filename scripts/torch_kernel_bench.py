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
- ``group_attention:edges``: K5 and K6 at [64, 8, 160, d] for d = 16, 24,
  80, 96 and 128 and at [16, 8, 192, 64] and [16, 8, 255, 64]: the widths
  and the lengths past K6's one-launch kernel;
- ``bh_attention``: K7 and K8 at the msdoc reranker step's shape (128 x 12
  heads x S=512 x d=64);
- ``bh_attention:edges``: K7 and K8 at [4, 8, 1024, 128] (the most shared
  memory), [16, 8, 256, 64] (the shortest S of their route) and [16, 8,
  512, d] at d = 16, 80, 96 and 24 (the widths off 32, 64 and 128: the
  next instance, over zero pads at 24);
- ``small_s_attention:chunk|msdoc|teacher|rerank|request``: K3 at the
  BERT-base encode chunk (1,024 x 128 tokens), the msdoc encode (1,024 x
  512), the CE-large teacher (128 x 160, 16 heads), the rerank (256 x 160)
  and a request (8 x 32), through ``_check_small_s_attention`` (within
  2^-7 max|v| of its plain version, SDPA beside it);
- ``int8_ffn:chunk|request|ragged``: K14 at the encode chunk (131,072 x 768
  x 3072), a request (256 rows) and 4,000 rows, bitwise against its plain
  version, with the K2 -> K1 composition and the library chains beside;
- ``ffn_fused:chunk|ce_large|queries``: K12 at the encode chunk, the
  CE-large step's shape (20,480 x 1024 x 4096) and the DE's queries (256 x
  768 x 3072), within one bf16 step of its plain version, with ``F.linear``
  -> ``F.gelu`` -> ``F.linear`` beside;
- ``int8_dense:chunk_qkv|chunk_output|request_qkv|request_output``: K13 at
  the encode chunk's (131,072 tokens) and a request's (256) q, k, v (768 ->
  2304) and output projection (768 -> 768), bitwise against its plain
  version, with ``_int_mm`` + epilogue and the K2 -> K1 composition beside;
- ``ffn_train:ce_large|de_passages|msdoc|queries|off_model``: K9-K12 at
  the CE-large step, the DE's passages (16,384 x 768 x 3072), an msdoc step
  (65,536 rows), the DE's queries and a width off the models' (3,001 x 512
  x 2048), against their plain versions (K10 on K9's hb, K11 on K10's dh, g
  and db1 parts), with device times by launch and the ``F.linear`` chain
  and its autograd backward beside;
- ``f32_attention:bh|group``: the f32 instances of K7/K8 at [16, 8, 512,
  d] and of K5/K6 at [64, 8, 160, d] (phase 23's shapes) through
  ``_check_f32_pair``, each d of ``F32_WIDTHS`` timed, the forward and the
  backward each by CUDA events (``ms``, ``bwd_ms``) and by the profiler's
  device time (``device_ms``, ``bwd_device_ms``: a small call's event time
  holds the host's launch gaps): against f64, the plain f32 version and
  the bf16 instance, two forward and two backward calls bitwise equal,
  with SDPA in f32 beside;
- ``mips:int8_q8|int8_q1024|bf16_q8|bf16_q1024|mine``: K4 through
  ``_check_mips`` over the 8,847,360 x 768 index (int8 and bf16, at 8 and
  1,024 queries, k=10) and at the mine's 64 queries over 24,576 int8 rows
  (k=100): int8 bitwise and bf16 within its tolerance of the plain version,
  with the library's products + ``topk`` beside; the index (~21 GB for
  both kinds) is built once for the cases that share it.

``--mips-tile BMxBN`` makes K4 take that tile wherever its bucket allows
(``_native.mips_tile`` replaced; a checkout without it is left alone), to
measure each tile forced.

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

_MIPS_INDEX = {}    # (rows, kinds) -> the index the mips cases share


# the libraries of K5-K8 and the f32 instances (the parents' names, then
# this tree's; each checkout builds those it has)
_ATTN = ["group_attention", "bh_attention", "attention_fwd_f32",
         "attention_fwd_wgmma", "attention_bwd_wgmma"]


def _f32_attention(pair, b, s):
    """K7's and K8's or K5's and K6's f32 instances at phase 23's shape,
    every width of ``F32_WIDTHS`` timed."""
    def run(torch, cs, randn, gen):
        from simxns_tpu_torch.ops import flash_attention as fa

        fwd, bwd = ((fa.bh_attention_fwd, fa.bh_attention_bwd)
                    if pair == "bh" else
                    (fa.group_attention_fwd, fa.group_attention_bwd))
        return {f"{bwd.__name__}_f32:d{d}": cs._check_f32_pair(
            torch, gen, fwd, bwd, b, s, d, timing=True)
            for d in cs.F32_WIDTHS}
    return _ATTN, run


def _mips(kind, nq, rows, k, valid_n, kinds):
    def run(torch, cs, randn, gen):
        key = (rows, kinds)
        if key not in _MIPS_INDEX:
            _MIPS_INDEX.clear()
            torch.cuda.empty_cache()
            _MIPS_INDEX[key] = cs._mips_index(torch, rows, kinds=kinds)
        return {"mips_bucket_candidates": cs._check_mips(
            torch, randn, _MIPS_INDEX[key], kind, nq, k=k, valid_n=valid_n)}
    return ["mips_candidates"], run


def _bh_edges(torch, cs, randn, gen):
    out = {}
    for b, s, d in ((4, 1024, 128), (16, 256, 64), (16, 512, 16),
                    (16, 512, 80), (16, 512, 96), (16, 512, 24)):
        out[f"bh_attention:{b}x8x{s}x{d}"] = cs._check_bh_attention(
            torch, randn, gen, b, s, d, s // 2, True, heads=8)
    return out


def _group_edges(torch, cs, randn, gen):
    """K5 and K6 (bf16) at [b, 8, s, d] head views of [b, s, 8d]
    projections, key lengths s/2..s: the widths past K6's one-launch
    kernel (d = 80, 96, 128 run K8's two passes, as d = 16 and 24 run the
    16 and 32 instances) and its longest S (192) and S = 255 (K8's passes):
    K5's o against the plain version (one bf16 step, 2^-8 max|v|), K6's
    gradients (2^-7 of the largest, cosine >= 0.9999), CUDA-event ms and
    the profiler's device ms of a call of each."""
    from simxns_tpu_torch.ops import flash_attention as fa

    out = {}
    for b, s, d in ((64, 160, 16), (64, 160, 24), (64, 160, 80),
                    (64, 160, 96), (64, 160, 128), (16, 192, 64),
                    (16, 255, 64)):
        q, k, v, do = (randn(b, s, 8 * d).to(torch.bfloat16)
                       .view(b, s, 8, d).transpose(1, 2) for _ in range(4))
        mask = torch.ones(b, s, dtype=torch.int32, device=q.device)
        lens = torch.randint(s // 2, s + 1, (b,), device=q.device,
                             generator=gen)
        mask[torch.arange(s, device=q.device)[None, :] >= lens[:, None]] = 0
        o = fa.group_attention_fwd(q, k, v, mask)
        err5 = float((o.float() - fa._group_fwd_plain(q, k, v, mask).float())
                     .abs().max()) / float(v.float().abs().max())
        cs.check(err5 <= 2.0 ** -8,
                 f"group_attention_fwd {b}x8x{s}x{d}: err {err5}")
        grads = fa.group_attention_bwd(q, k, v, mask, do)
        refs = fa._group_bwd_plain(q, k, v, mask, do)
        err = max(fa.errors_of_largest(grads, refs))
        cos = min(float(torch.nn.functional.cosine_similarity(
            g.float().flatten(), r.float().flatten(), dim=0))
            for g, r in zip(grads, refs))
        cs.check(err <= 2.0 ** -7 and cos >= 0.9999,
                 f"group_attention_bwd {b}x8x{s}x{d}: err {err}, cos {cos}")
        out[f"group_attention:{b}x8x{s}x{d}"] = dict(
            shape=[b, 8, s, d], fwd_err_of_max_v=err5, err_of_largest=err,
            min_cosine=cos,
            fwd_ms=cs.timed(torch, lambda: fa.group_attention_fwd(
                q, k, v, mask), 10),
            fwd_device_ms=cs.device_call_ms(
                torch, lambda: fa.group_attention_fwd(q, k, v, mask)),
            bwd_ms=cs.timed(torch, lambda: fa.group_attention_bwd(
                q, k, v, mask, do), 10),
            bwd_device_ms=cs.device_call_ms(
                torch, lambda: fa.group_attention_bwd(q, k, v, mask, do)))
    return out


# K3's shapes: (sequences, S, shortest key length, hidden, heads)
_K3_SHAPES = {"chunk": (1024, 128, 8, 768, 12),
              "msdoc": (1024, 512, 300, 768, 12),
              "teacher": (128, 160, 100, 1024, 16),
              "rerank": (256, 160, 100, 1024, 16),
              "request": (8, 32, 8, 768, 12)}

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
    "group_attention": (_ATTN, (
        lambda torch, cs, randn, gen: dict(zip(
            ("group_attention_fwd", "group_attention_bwd"),
            cs._check_group_attention(torch, randn, gen))))),
    "bh_attention": (_ATTN, (
        lambda torch, cs, randn, gen: {
            "bh_attention": cs._check_bh_attention(
                torch, randn, gen, 128, cs.MS_S, 64, 300, True)})),
    "bh_attention:edges": (_ATTN, _bh_edges),
    "group_attention:edges": (_ATTN, _group_edges),
    **{f"small_s_attention:{label}": (["small_s_attention"], (
        lambda torch, cs, randn, gen, b=b, s=s, lo=lo, h=h, heads=heads: {
            "small_s_attention": cs._check_small_s_attention(
                torch, randn, gen, ((b, s, lo),), h, heads)}))
       for label, (b, s, lo, h, heads) in _K3_SHAPES.items()},
    **{f"int8_ffn:{label}": (["int8_ffn", "int8_linear"], (
        lambda torch, cs, randn, gen, label=label, m=m: {
            "int8_ffn": cs._check_int8_ffn_shape(torch, randn, label, m)}))
       for label, m in (("chunk", 131072), ("request", 256),
                        ("ragged", 4000))},
    **{f"ffn_fused:{label}": (["fused_ffn", "ffn_fwd"], (
        lambda torch, cs, randn, gen, shape=shape: cs._check_ffn_shape(
            torch, randn, shape, *cs.FFN_SHAPES[shape], k12_only=True)))
       for label, shape in (("chunk", "encode_chunk"),
                            ("ce_large", "ce_large"),
                            ("queries", "de_queries"))},
    **{f"int8_dense:{label}": (["int8_ffn", "int8_linear"], (
        lambda torch, cs, randn, gen, label=label, m=m, o=o: {
            "int8_dense": cs._check_int8_dense_shape(torch, randn, label, m,
                                                     o)}))
       for label, m, o in (("chunk_qkv", 131072, 3 * 768),
                           ("chunk_output", 131072, 768),
                           ("request_qkv", 256, 3 * 768),
                           ("request_output", 256, 768))},
    **{f"ffn_train:{label}": (["fused_ffn", "ffn_fwd"], (
        lambda torch, cs, randn, gen, shape=shape: cs._check_ffn_shape(
            torch, randn, shape, *cs.FFN_SHAPES[shape])))
       for label, shape in (("ce_large", "ce_large"),
                            ("de_passages", "de_passages"),
                            ("msdoc", "msdoc"), ("queries", "de_queries"),
                            ("off_model", "off_model"))},
    **{f"mips:{kind}_q{nq}": _mips(kind, nq, 8_847_360, 10, 8_847_360 - 1000,
                                   ("int8", "bf16"))
       for kind in ("int8", "bf16") for nq in (8, 1024)},
    "mips:mine": _mips("int8", 64, 24_576, 100, 24_576, ("int8",)),
    "f32_attention:bh": _f32_attention("bh", 16, 512),
    "f32_attention:group": _f32_attention("group", 64, 160),
}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repo", default=str(ROOT))
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--mips-tile", default=None)
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

    if args.mips_tile and hasattr(_native, "mips_tile"):
        bm, bn = (int(x) for x in args.mips_tile.split("x"))
        _native.mips_tile = (lambda q, n_pad, bucket, sms:
                             (bm, bn) if bucket >= 8 else (64, 128))
    smi = cs.nvidia_smi()
    build_s = _native.build(sorted({lib for c in cases
                                    for lib in CASES[c][0]}
                                   & set(_native.SOURCES)))
    dev = torch.device("cuda")
    for case in cases:
        gen = torch.Generator(device=dev).manual_seed(0)

        def randn(*shape, scale=1.0):
            return torch.randn(*shape, device=dev, generator=gen) * scale

        for kernel, rec in CASES[case][1](torch, cs, randn, gen).items():
            print(json.dumps({
                "case": case, "kernel": kernel,
                "package": str(Path(simxns_tpu_torch.__file__).parent),
                "nvidia_smi": smi, "nvcc_s_by_source": build_s,
                "mips_tile": args.mips_tile, **rec}),
                flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
