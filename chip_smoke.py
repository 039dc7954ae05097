#!/usr/bin/env python3
"""Build the port's kernels, check them, serve, train and co-train on one GPU.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with one CUDA card and
``nvcc``. It imports ``simxns_tpu_torch`` and nothing of the JAX package.
Phases, one JSON line each (a failed check raises, so the script exits
non-zero and prints no result):

1. device and build: the card's name and power limit, the nvcc build and
   the Triton compile of every kernel of the serving path;
2. each kernel against its plain PyTorch version on the same inputs at the
   serving shapes (BERT-base: H=768, F=3072, 12 heads; 1024 passages x 128
   tokens, 8 queries x 32 tokens; an 8,847,360 x 768 index, int8 and bf16,
   at 8 and 1024 queries), with its time, the plain version's, a PyTorch
   library call's (timed only; the port never calls it) and the least time
   the card could take (bytes over 3.35 TB/s or operations over the dense
   tensor-core peak, whichever is larger); K1 bitwise on each of a layer's
   four GEMMs at an encode chunk, at a request (256 tokens) and at the
   mine's queries (2,048 tokens; at both with the wrapper's host
   microseconds a call); then one whole layer composed
   of the kernels against the plain composition; K1, K3 (here and in
   phases 4 and 6), K5 (phase 4) and K7 (phase 6) also with their device
   time per call from the profiler (at a request's shape the CUDA-event
   time is the host's launch rate); beside K4, the search's
   last step over its candidates: the stable ``_finalize`` (equal scores
   in column order, as ``jax.lax.top_k``) and ``torch.topk`` alone;
3. end to end: a full-width BERT-base dual encoder (12 layers, random
   weights from seed 0, layer_impl="fused_int8") behind a DenseRetriever
   with an int8 index in fused mode indexes 65,536 synthetic passages and
   answers 32 requests of 8 queries (k=10); then a bf16 index in fused mode
   answers 8 more. The kernel path is held against the plain path, and the
   launch counts of every kernel, zeroed just before, must have risen;
4. the training kernels: K5/K6 (the grouped attention pair of the CE-large
   reranker, 128 joint rows x 16 heads x S=160, bf16) against their plain
   versions, with SDPA's forward and backward as the yardstick, K5's and
   K6's profiler device time, K8's two launches timed on K6's inputs beside it,
   and two K6 calls held bitwise equal; K1-K3 again
   at the int8 teacher's shapes (20,480 tokens, H=1024, F=4096, 16 heads);
5. training at full width: a BERT-base DE and an ERNIE-large-shaped CE
   (24 layers, H=1024, small_s_attn="group"; random weights from seed 0)
   on one GPU's share of the AR2 recipe batch (8 queries x 16 passages;
   32 / 128 / 160 tokens). The first reranker step's gradients with K5/K6
   are held against the same step on their plain versions (beside the
   cosine of two plain versions that round p otherwise), the teacher
   view's CLS vectors against the plain int8 composition; then 3 DE
   warm-up steps, 3 reranker steps and 3 AR2 retriever steps (fused-int8
   teacher view), with the launch counts zeroed just before and read just
   after, the step times, tokens/s, the CE step's share of the bf16 peak,
   the peak memory, and one traced step of each kind (device time by
   kernel and the device idle share);
6. the msdoc kernels: K7/K8 (the per-(batch, head) attention pair, 128
   joint rows x 12 heads x S=512 x d=64, bf16, key lengths 300..512; and
   S = 256, 288, 1024) against their plain versions, with SDPA's forward
   and backward as the yardstick, the profiler device time of each of
   K8's two launches (query pass, key pass), and two K8 calls held bitwise
   equal at every shape; K3 at S=512 (1024 x 512 tokens of
   BERT-base); K4 at the mine's shape (64 queries, k=100, 24,576 int8
   rows);
7. co-training end to end: ``simxns_tpu_torch.run.run_ar2`` at full width
   in ``nq_ar2_simans`` (BERT-base DE, ERNIE-large-shaped CE; 128 / 32 /
   160 tokens) and ``msdoc_ar2_simans`` (BERT-base DE with the 768
   projection, BERT-base CE; 512 / 32 / 512 tokens, adv_lambda 1), with
   ``--synthetic --full-size --fast-encode --fast-teacher --int8-index``,
   8 queries per step, 24,576 passages, 64 queries, windows of 4 steps
   (8 steps: two boundaries with checkpoints and mines, then a final
   mine), offload ``overlap``; then a relaunch of the nq run that resumes
   from its step-8 checkpoints. Per recipe (one ``co_training`` line): the
   phase times, the mine's passages/s, each step's ms (host clock to a
   synchronise), the peak memory, the top-1 history, and the launches of
   every kernel of its path, zeroed just before the run;
8. the FFN kernels: K9 ``ffn_train_fwd``, K10 ``ffn_bwd_dx``, K11
   ``ffn_bwd_dw`` and K12 ``ffn_fused_fwd`` (bf16) against their plain
   versions at the CE-large step's shape (M=20,480, H=1024, F=4096), the
   DE's passages (16,384 x 768 x 3072) and queries (M=256), an msdoc step
   (M=65,536) and, for K12, an encode chunk (M=131,072), with ``F.linear``
   -> ``F.gelu`` -> ``F.linear`` in bf16 and its autograd backward as the
   yardstick;
9. training under ``ffn_impl="fused_vjp"``: phase 5's models and batches
   with the knob set on the DE and the CE. The first reranker step's
   gradients on K9-K11 against the same step on their plain versions, and
   beside it against ``ffn_impl="xla"``; 3 steps of each kind with the
   launch counts zeroed before each kind (K9 = K10 = K11 = 24 per reranker
   step), step ms and peak memory beside phase 5's, one traced step per
   kind; then one reranker forward and backward with ``remat=True``: the
   gradients of the step without it, K9 launched 48 times;
10. encoding under ``ffn_impl="fused"``: a full-width BERT-base dual encoder
   (bf16, ``layer_impl="xla"``) behind a DenseRetriever indexes 16,384
   synthetic passages (16 chunks of 1024 x 128 tokens) and answers 8
   requests; K12 launched 12 times per chunk; the embeddings against the
   same model on K12's plain version;
11. the int8 encode kernels: K14 ``int8_ffn`` at an encode chunk
   (131,072 x 768 x 3072), a request (256 rows) and a ragged M (4,000),
   K13 ``int8_dense`` at the chunk's q, k, v (O = 2304) and output
   projection (O = 768) and a request's q, k, v, each against its plain
   version (bitwise expected), with the library's ``torch._int_mm`` chains
   and K14's bf16 ``F.linear`` chain as yardsticks and the port's K2 -> K1
   composition of the same function timed beside; then the public
   ``int8_ffn`` at 40 rows (no tile): ``ffn_reference``, no launch;
12. encoding under the int8 knobs: phase 10's model and traffic with
   ``ffn_impl="int8"``, then with ``proj_impl="int8"`` too; K14 launched 12
   times per chunk and request, K13 24 times in the second; the embeddings
   against the same model on the plain versions and under ``"xla"``;
13. the ``kernels`` line (K1-K14, launches of every path); then the last
   line, ``{"ok": true, "device": {...}}``.
"""

import gc
import json
import math
import subprocess
import sys
import time

PEAK_BYTES = 3.35e12          # H100 SXM HBM3, bytes/s
PEAK_INT8 = 1979e12           # dense int8 tensor-core ops/s
PEAK_BF16 = 989e12            # dense bf16 tensor-core flop/s
INDEX_ROWS = 8_847_360        # the MS MARCO passage working point
H, F, HEADS = 768, 3072, 12
# the AR2 reranker (ERNIE-large shape) and one GPU's share of the recipe
# batch: 8 queries x 16 passages; queries 32 tokens, passages 128, joint 160
CE_H, CE_F, CE_HEADS, CE_LAYERS = 1024, 4096, 16, 24
N_Q, N_P, LQ, LC, LJ = 8, 16, 32, 128, 160
# the msdoc recipe's joint rows and passages (S=512, BERT-base), and the
# mine of the co-training phase: 24,576 synthetic passages (above 20,000
# the synthetic corpus keeps the recipe's token lengths), 64 queries, k=100
MS_S = 512
MINE_ROWS, MINE_Q, MINE_K = 24_576, 64, 100


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def bound(bytes_moved, ops, peak_ops):
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def timed(torch, fn, reps, warmup=1):
    """Mean ms of ``fn`` on the card, by CUDA events around ``reps`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def device_ms(torch, fn, kernel, reps=10):
    """Mean device ms of one launch of the kernel whose name holds
    ``kernel`` (``fn`` launches it once), from torch.profiler: a small
    launch's CUDA-event time is the host's launch rate, not the kernel's.
    The mean is over the launches the profiler recorded (a session after
    earlier ones may drop some). -> (ms, launches recorded)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [ev.time_range.elapsed_us() for ev in prof.events()
          if ev.device_type == torch.autograd.DeviceType.CUDA
          and kernel in ev.name]
    return (sum(us) / 1e3 / len(us) if us else None), len(us)


def fresh_peak(torch):
    """Start a peak-memory reading: collect what Python still holds of the
    phases before (an unreachable autograd graph keeps its activations on
    the card until the collector runs, and would count towards the peak),
    hand cached blocks back, reset the peak. -> GB allocated at that
    moment (weights, optimizer state and whatever else is still alive)."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated() / 1e9


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def nvidia_smi():
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def phase_device(torch):
    from simxns_tpu_torch.ops import _native

    smi = nvidia_smi()
    print(smi, flush=True)
    t0 = time.perf_counter()
    nvcc = _native.build()
    build_s = time.perf_counter() - t0
    # Triton compiles row_quant's variants at first call
    from simxns_tpu_torch.ops.fused_layer import row_quant

    t0 = time.perf_counter()
    x = torch.randn(4, H, device="cuda")
    for kw in (dict(), dict(residual=x, ln=(x[0], x[1]), out_f32=True),
               dict(residual=x, ln=(x[0], x[1]), quant=False,
                    out_bf16=True)):
        row_quant(x, **kw)
        row_quant(x.to(torch.bfloat16), **kw)
    torch.cuda.synchronize()
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda,
         nvcc_build_s=build_s, nvcc_s_by_source=nvcc,
         triton_compile_s=time.perf_counter() - t0)
    return smi


def _host_us(torch, fn, calls=200):
    """Host microseconds a call of ``fn``: the enqueue time of ``calls``
    calls (the card keeps up with a request-sized launch, so the host's
    rate is what a request sees)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def _check_int8_linear(torch, randn, m, h, f):
    """K1 on the four GEMMs of a layer at m tokens, width h, FFN f: each
    bitwise against its plain version, with its event time, its profiler
    device time a launch (one launch a call), the plain version's and
    ``torch._int_mm`` + the epilogue's times, its bound and, at m <= 4096,
    the wrapper's host microseconds a call."""
    from simxns_tpu_torch.ops import fused_layer as fl
    from simxns_tpu_torch.ops.fused_ffn import quant_rows

    shapes = [("qkv", 3 * h, h, False, torch.bfloat16),
              ("out", h, h, False, torch.float32),
              ("ffn_in", f, h, True, torch.float32),
              ("ffn_out", h, f, False, torch.float32)]
    rec = dict(ms=0.0, device_ms=0.0, plain_ms=0.0, library_ms=0.0,
               bound_ms=0.0, max_abs_err=0.0, shapes=[])
    ops_total = bytes_total = 0.0
    for name, n, k, gelu, od in shapes:
        a8, xs = quant_rows(randn(m, k))
        w8, ws = quant_rows(randn(n, k, scale=0.02))
        b = randn(n, scale=0.02)
        got = fl.int8_linear(a8, xs, w8, ws, b, gelu=gelu, out_dtype=od)
        want = fl._int8_linear_plain(a8, xs, w8, ws, b, gelu, od)
        err = float((got.float() - want.float()).abs().max())
        check(torch.equal(got, want),
              f"int8_linear {name} at M={m}: not bitwise equal to the plain "
              f"version (max abs err {err})")

        def call():
            return fl.int8_linear(a8, xs, w8, ws, b, gelu=gelu, out_dtype=od)

        ms = timed(torch, call, 10)
        dev_ms, dev_n = device_ms(torch, call, "int8_linear_kernel")
        host = _host_us(torch, call) if m <= 4096 else None
        plain = timed(torch, lambda: fl._int8_linear_plain(
            a8, xs, w8, ws, b, gelu, od), 2)
        wt = w8.t()

        def library():
            y = torch._int_mm(a8, wt).float() * xs[:, None] * ws + b
            if gelu:
                y = torch.nn.functional.gelu(y)
            return y.to(od)

        lib = timed(torch, library, 5)
        ops = 2.0 * m * n * k
        moved = m * k + n * k + 4 * (m + 2 * n) + m * n * (2 if od ==
                                                        torch.bfloat16 else 4)
        bms, by = bound(moved, ops, PEAK_INT8)
        ops_total += ops
        bytes_total += moved
        rec["shapes"].append(dict(gemm=name, m=m, n=n, k=k, ms=ms,
                                  device_ms=dev_ms,
                                  device_launches_recorded=dev_n,
                                  host_us_per_call=host, plain_ms=plain,
                                  library_ms=lib, bound_ms=bms, bound_by=by,
                                  max_abs_err=err))
        for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                         ("bound_ms", bms)):
            rec[key] += val
        rec["device_ms"] = (None if dev_ms is None or rec["device_ms"] is None
                            else rec["device_ms"] + dev_ms)
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        del a8, w8, got, want
    rec["bound_by"] = bound(bytes_total, ops_total, PEAK_INT8)[1]
    rec["tolerance"] = "bitwise equal (identical integer sums and f32 ops)"
    return rec


def _check_row_quant(torch, randn, m, h, f):
    """K2 on the five row passes of a layer at m tokens."""
    from simxns_tpu_torch.ops import fused_layer as fl

    x16 = randn(m, h).to(torch.bfloat16)
    ctx = randn(m, h)
    attn = randn(m, h)
    mid = randn(m, f)
    ffn = randn(m, h)
    ln = (1.0 + randn(h, scale=0.1), randn(h, scale=0.1))
    y1 = fl._row_quant_plain(attn, x16, ln, 1e-12, False, True, False)[2]
    passes = [("x", x16, dict()), ("ctx", ctx, dict()),
              ("ln1", attn, dict(residual=x16, ln=ln, out_f32=True)),
              ("mid", mid, dict()),
              ("ln2", ffn, dict(residual=y1, ln=ln, quant=False,
                                out_bf16=True))]
    rec = dict(ms=0.0, plain_ms=0.0, library_ms=None, bound_ms=0.0,
               max_abs_err=0.0, code_flips=0, shapes=[])
    for name, inp, kw in passes:
        got = fl.row_quant(inp, **kw)
        want = fl._row_quant_plain(inp, kw.get("residual"), kw.get("ln"),
                                   1e-12, kw.get("quant", True),
                                   kw.get("out_f32", False),
                                   kw.get("out_bf16", False))
        err = 0.0
        flips = 0
        for g, w in zip(got, want):
            if g is None:
                continue
            d = (g.float() - w.float()).abs()
            if g.dtype == torch.int8:
                flips += int((d > 0).sum())
                check(float(d.max()) <= 1, f"row_quant {name}: code off by >1")
            elif g.dtype == torch.bfloat16:
                # the f32 values differ by up to 1e-5 (LN statistics summed
                # in another order); rounding both to bf16 adds at most one
                # bf16 step of the value (2^-7 relative)
                check(bool((d <= 2.0 ** -7 * w.float().abs() + 1e-5).all()),
                      f"row_quant {name}: bf16 output off by > 1 step")
                err = max(err, float(d.max()))
            else:
                # f32 LN statistics summed in another order: 1e-5 absolute
                # on values of unit scale (and on the scales, ~1e-2)
                check(float(d.max()) <= 1e-5, f"row_quant {name}: err "
                      f"{float(d.max())}")
                err = max(err, float(d.max()))
        check(flips <= 1e-4 * inp.numel(),
              f"row_quant {name}: {flips} int8 codes differ")
        ms = timed(torch, lambda: fl.row_quant(inp, **kw), 10)
        plain = timed(torch, lambda: fl._row_quant_plain(
            inp, kw.get("residual"), kw.get("ln"), 1e-12,
            kw.get("quant", True), kw.get("out_f32", False),
            kw.get("out_bf16", False)), 3)
        moved = inp.numel() * inp.element_size() + sum(
            t.numel() * t.element_size() for t in got if t is not None)
        if "residual" in kw:
            moved += kw["residual"].numel() * kw["residual"].element_size()
        bms = moved / PEAK_BYTES * 1e3
        rec["shapes"].append(dict(row_pass=name, rows=m, cols=inp.shape[1],
                                  ms=ms, plain_ms=plain, bound_ms=bms,
                                  max_abs_err=err, code_flips=flips))
        rec["ms"] += ms
        rec["plain_ms"] += plain
        rec["bound_ms"] += bms
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        rec["code_flips"] += flips
    rec["bound_by"] = "bytes"
    rec["tolerance"] = ("codes within 1 and <= 1e-4 of them flipped; f32 "
                        "outputs 1e-5; bf16 outputs 1e-5 + one rounding step")
    return rec


def _check_small_s_attention(torch, randn, gen, cases, h, heads):
    """K3 on (sequences, length, shortest key length) cases; the first case
    gives the record's times."""
    from simxns_tpu_torch.ops import fused_layer as fl

    dev = torch.device("cuda")
    rec = dict(shapes=[])
    for b, s, min_len in cases:
        qkv = randn(b * s, 3 * h).to(torch.bfloat16)
        mask = torch.ones(b, s, dtype=torch.int32, device=dev)
        lens = torch.randint(min_len, s + 1, (b,), device=dev, generator=gen)
        mask[torch.arange(s, device=dev)[None, :] >= lens[:, None]] = 0
        got = fl.small_s_attention(qkv, mask, heads)
        want = fl._small_s_attention_plain(qkv, mask, heads)
        err = float((got - want).abs().max())
        # p is rounded to bf16 on both sides; exp and the row sum taken in
        # another order can move a p across a rounding boundary, by one
        # bf16 step (<= 2^-7 p). Even if every p of a row moved, the
        # context moves by <= 2^-7 * sum(p |v|) <= 2^-7 max|v|.
        tol = 2.0 ** -7 * float(qkv[:, 2 * h:].float().abs().max())
        check(err <= tol, f"small_s_attention {b}x{s}: err {err} > {tol}")
        ms = timed(torch, lambda: fl.small_s_attention(qkv, mask, heads), 10)
        dev_ms, dev_n = device_ms(torch, lambda: fl.small_s_attention(
            qkv, mask, heads), "small_s_attention_kernel")
        plain = timed(torch, lambda: fl._small_s_attention_plain(
            qkv, mask, heads), 3)
        q, k, v = (t.transpose(1, 2).contiguous() for t in
                   qkv.view(b, s, 3, heads, h // heads).unbind(2))
        bias = torch.where(mask > 0, 0.0, -1e9)[:, None, None, :].to(
            torch.bfloat16)
        lib = timed(torch, lambda: torch.nn.functional
                    .scaled_dot_product_attention(q, k, v, attn_mask=bias), 10)
        moved = qkv.numel() * 2 + mask.numel() * 4 + got.numel() * 4
        bms, by = bound(moved, 4.0 * b * heads * s * s * (h // heads),
                        PEAK_BF16)
        rec["shapes"].append(dict(batch=b, seq=s, ms=ms, device_ms=dev_ms,
                                  device_launches_recorded=dev_n,
                                  plain_ms=plain, library_ms=lib,
                                  bound_ms=bms, bound_by=by,
                                  max_abs_err=err, tolerance=tol))
        del qkv, q, k, v
    main = rec["shapes"][0]
    rec.update({key: main[key] for key in ("ms", "plain_ms", "library_ms",
                                           "bound_ms", "bound_by")})
    rec["max_abs_err"] = max(sh["max_abs_err"] for sh in rec["shapes"])
    rec["tolerance"] = "2^-7 x max|v| on the f32 context (one bf16 step of p)"
    return rec


def phase_kernels(torch, smi):
    """Phase 2. Returns the kernel records (launches filled in later)."""
    from simxns_tpu_torch.ops import mips_kernel as mk
    from simxns_tpu_torch.ops.fused_ffn import quant_rows

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, device=dev, generator=gen) * scale

    records = {}

    # --- K1-K3 at the serving shapes: 1024 passages x 128 tokens ---------
    m = 1024 * 128
    records["int8_linear"] = _check_int8_linear(torch, randn, m, H, F)
    emit("kernel", name="int8_linear", nvidia_smi=smi,
         **records["int8_linear"])
    # a request's four GEMMs: 8 queries x 32 tokens
    records["int8_linear"]["request"] = _check_int8_linear(torch, randn,
                                                           8 * 32, H, F)
    emit("kernel_request_shapes", name="int8_linear", nvidia_smi=smi,
         tokens=8 * 32, **records["int8_linear"]["request"])
    # the mine's queries: 64 x 32 tokens (from their own generator, so the
    # checks after this one keep their inputs)
    qgen = torch.Generator(device=dev).manual_seed(3)
    records["int8_linear"]["mine_query"] = _check_int8_linear(
        torch, lambda *shape, scale=1.0: torch.randn(
            *shape, device=dev, generator=qgen) * scale, MINE_Q * LQ, H, F)
    emit("kernel_mine_query_shapes", name="int8_linear", nvidia_smi=smi,
         tokens=MINE_Q * LQ, **records["int8_linear"]["mine_query"])
    records["row_quant"] = _check_row_quant(torch, randn, m, H, F)
    emit("kernel", name="row_quant", nvidia_smi=smi, **records["row_quant"])
    # passages 1024 x 128, queries 8 x 32
    records["small_s_attention"] = _check_small_s_attention(
        torch, randn, gen, ((1024, 128, 8), (8, 32, 8)), H, HEADS)
    emit("kernel", name="small_s_attention", nvidia_smi=smi,
         **records["small_s_attention"])

    # --- the composed layer, 64 x 128 tokens ------------------------------
    from simxns_tpu_torch.ops.fused_layer import (fused_encoder_layer_int8,
                                                  layer_int8_plain,
                                                  quantize_layer)

    params = {"wq": randn(H, H, scale=0.02), "wk": randn(H, H, scale=0.02),
              "wv": randn(H, H, scale=0.02), "wo": randn(H, H, scale=0.02),
              "w1": randn(F, H, scale=0.02), "w2": randn(H, F, scale=0.02),
              "bq": randn(H, scale=0.02), "bk": randn(H, scale=0.02),
              "bv": randn(H, scale=0.02), "bo": randn(H, scale=0.02),
              "b1": randn(F, scale=0.02), "b2": randn(H, scale=0.02),
              "ln1_scale": 1 + randn(H, scale=0.1),
              "ln1_bias": randn(H, scale=0.1),
              "ln2_scale": 1 + randn(H, scale=0.1),
              "ln2_bias": randn(H, scale=0.1)}
    ql = quantize_layer(params)
    x = randn(64, 128, H).to(torch.bfloat16)
    mask = torch.ones(64, 128, dtype=torch.int32, device=dev)
    mask[::3, 100:] = 0
    got = fused_encoder_layer_int8(x, mask, quantized=ql, num_heads=HEADS)
    want = layer_int8_plain(x, mask, ql, num_heads=HEADS)
    d = (got.float() - want.float()).abs()
    # a flipped int8 code moves one output by about one quantization step;
    # outputs are LayerNorm-scaled (|y| < ~8, bf16 step 2^-5 there)
    check(float(d.max()) <= 0.0625 and float(d.mean()) <= 1e-3,
          f"layer: max {float(d.max())}, mean {float(d.mean())}")
    ms = timed(torch, lambda: fused_encoder_layer_int8(
        x, mask, quantized=ql, num_heads=HEADS), 10)
    plain = timed(torch, lambda: layer_int8_plain(x, mask, ql,
                                                   num_heads=HEADS), 3)
    emit("layer", tokens=64 * 128, ms=ms, plain_ms=plain,
         max_abs_err=float(d.max()), mean_abs_err=float(d.mean()),
         share_differing=float((d > 0).float().mean()), nvidia_smi=smi)
    del x, got, want, params, ql

    # --- K4 mips_bucket_candidates over 8,847,360 x 768 -------------------
    codes = torch.empty(INDEX_ROWS, H, dtype=torch.int8, device=dev)
    scales = torch.empty(INDEX_ROWS, dtype=torch.float32, device=dev)
    corpus16 = torch.empty(INDEX_ROWS, H, dtype=torch.bfloat16, device=dev)
    step = 262144
    for r0 in range(0, INDEX_ROWS, step):
        rows = randn(min(step, INDEX_ROWS - r0), H)
        codes[r0:r0 + rows.shape[0]], scales[r0:r0 + rows.shape[0]] = \
            quant_rows(rows)
        corpus16[r0:r0 + rows.shape[0]] = rows.to(torch.bfloat16)
    del rows
    valid_n = INDEX_ROWS - 1000
    block_n = 2048
    n_pad = INDEX_ROWS
    bucket = mk._fit_bucket(128, block_n, n_pad, 10)
    variants = []
    for nq in (8, 1024):
        queries = randn(nq, H)
        q8, qs = quant_rows(queries)
        q16 = queries.to(torch.bfloat16)
        for kind in ("int8", "bf16"):
            if kind == "int8":
                args = (q8, codes, valid_n)
                kw = dict(bucket=bucket, block_n=block_n, query_scales=qs,
                          row_scales=scales)
                plain_args = (q8, codes, valid_n, bucket, n_pad, qs, scales)
            else:
                args = (q16, corpus16, valid_n)
                kw = dict(bucket=bucket, block_n=block_n)
                plain_args = (q16, corpus16, valid_n, bucket, n_pad, None,
                              None)
            got_s, got_i = mk.mips_bucket_candidates(*args, **kw)
            want_s, want_i = mk._candidates_plain(*plain_args)
            err = float((got_s - want_s).abs().max())
            ids_off = int((got_i != want_i).sum())
            if kind == "int8":
                # exact int32 sums and the same two f32 products
                check(err == 0.0 and ids_off == 0,
                      f"mips int8 Q={nq}: err {err}, {ids_off} ids differ")
            else:
                # f32 sums in another order: |score| ~ 100 -> ~1e-4; a
                # near-tie inside a bucket may pick the other row
                check(err <= 1e-3 and ids_off <= 1e-5 * got_i.numel(),
                      f"mips bf16 Q={nq}: err {err}, {ids_off} ids differ")
            top_k = mk._finalize(got_s, got_i, 10, 0)
            ref_k = mk._finalize(want_s, want_i, 10, 0)
            overlap = float(sum(len(set(a) & set(b)) for a, b in zip(
                top_k[1].tolist(), ref_k[1].tolist())) / (10.0 * nq))
            check(overlap >= 0.99, f"mips {kind} Q={nq}: top-10 overlap "
                  f"{overlap}")
            del got_s, got_i, want_s, want_i
            ms = timed(torch, lambda: mk.mips_bucket_candidates(*args, **kw),
                       5 if nq == 8 else 3)
            plain = timed(torch, lambda: mk._candidates_plain(*plain_args),
                          1, warmup=0)
            lib = timed(torch, lambda: _library_search(torch, args[0],
                                                       args[1], kind), 1)
            # the search's last step over K4's candidates: the port's
            # stable _finalize, and the same selection by torch.topk alone
            # (equal scores in no set order; what the port used before)
            cand = mk.mips_bucket_candidates(*args, **kw)
            fin = timed(torch, lambda: mk._finalize(*cand, 10, 0), 5)
            fin_topk = timed(torch, lambda: _topk_finalize(torch, *cand, 10),
                             5)
            del cand
            elt = 1 if kind == "int8" else 2
            moved = (INDEX_ROWS * H * elt + nq * H * elt
                     + (4 * (INDEX_ROWS + nq) if kind == "int8" else 0)
                     + nq * (n_pad // bucket) * 8)
            bms, by = bound(moved, 2.0 * nq * INDEX_ROWS * H,
                            PEAK_INT8 if kind == "int8" else PEAK_BF16)
            variants.append(dict(kind=kind, queries=nq, rows=INDEX_ROWS,
                                 ms=ms, plain_ms=plain, library_ms=lib,
                                 bound_ms=bms, bound_by=by, max_abs_err=err,
                                 ids_differing=ids_off,
                                 top10_overlap=overlap,
                                 candidates_per_query=n_pad // bucket,
                                 finalize_ms=fin, topk_finalize_ms=fin_topk,
                                 search_ms=ms + fin,
                                 stable_finalize_added_share=(
                                     (fin - fin_topk) / (ms + fin_topk))))
            emit("kernel_variant", name="mips_bucket_candidates",
                 nvidia_smi=smi, **variants[-1])
    main = variants[0]                     # int8, 8 queries: a request
    rec = {key: main[key] for key in ("ms", "plain_ms", "library_ms",
                                      "bound_ms", "bound_by")}
    rec["max_abs_err"] = max(v["max_abs_err"] for v in variants)
    rec["tolerance"] = ("int8: exact (scores and ids); bf16: 1e-3 on scores, "
                        "<= 1e-5 of ids")
    rec["variants"] = variants
    rec["also_replaces"] = "simxns_tpu/ops/mips_kernel.py:112"   # bf16
    records["mips_bucket_candidates"] = rec
    del codes, scales, corpus16
    torch.cuda.empty_cache()
    return records


def _topk_finalize(torch, flat_s, flat_i, k):
    """``mips_kernel._finalize`` with ``torch.topk`` as its selection (the
    order of equal scores undefined): the yardstick of the stable one.
    Timed only."""
    from simxns_tpu_torch.ops.mips_kernel import NEG_INF

    top_s, sel = torch.topk(flat_s, k, dim=1)
    top_i = torch.gather(flat_i, 1, sel)
    return top_s, torch.where(top_s > NEG_INF / 2, top_i, -1)


def _library_search(torch, queries, corpus, kind, k=10,
                    chunk=1_048_576):
    """Yardstick: PyTorch's own products + topk over the index, in chunks
    (the [Q, N] scores would not fit at Q=1024). Timed only."""
    out = []
    if kind == "int8":
        q = queries
        if q.shape[0] <= 16:                # torch._int_mm needs M > 16
            q = torch.nn.functional.pad(q, (0, 0, 0, 32 - q.shape[0]))
    for r0 in range(0, corpus.shape[0], chunk):
        block = corpus[r0:r0 + chunk]
        if kind == "int8":
            s = torch._int_mm(q, block.t())
        else:
            s = torch.matmul(queries, block.t())
        out.append(torch.topk(s, k, dim=1))
    return out


def _synthetic_passages(n, seed=0):
    """Passages of 60-110 words over a 20,000-word vocabulary, from a seed."""
    import numpy as np

    rng = np.random.default_rng(seed)
    words = np.array([f"w{i}" for i in range(20000)])
    lens = rng.integers(60, 111, n)
    draws = rng.zipf(1.3, size=int(lens.sum())) % 20000
    out, at = {}, 0
    for i in range(n):
        out[i] = (" ".join(words[draws[at:at + lens[i]]]), f"title {i}")
        at += lens[i]
    return out


def phase_end_to_end(torch, smi, records):
    import numpy as np

    from simxns_tpu_torch import ops
    from simxns_tpu_torch.data import HashTokenizer
    from simxns_tpu_torch.models import BertConfig, BiEncoder, BiEncoderConfig
    from simxns_tpu_torch.ops import mips_kernel as mk
    from simxns_tpu_torch.ops.fused_ffn import quant_rows
    from simxns_tpu_torch.ops.fused_layer import layer_int8_plain
    from simxns_tpu_torch.serve import DenseRetriever

    dev = torch.device("cuda")
    cfg = BiEncoderConfig(bert=BertConfig(
        vocab_size=30522, hidden_size=H, num_layers=12, num_heads=HEADS,
        intermediate_size=F, dtype=torch.bfloat16, layer_impl="fused_int8"))
    t0 = time.perf_counter()
    model = BiEncoder(cfg, generator=torch.Generator().manual_seed(0))
    init_s = time.perf_counter() - t0
    tok = HashTokenizer(vocab_size=30522)
    n_pass = 65536
    passages = _synthetic_passages(n_pass)
    retriever = DenseRetriever(model, tok, max_q_length=32,
                               max_ctx_length=128, index_mode="fused",
                               store_dtype=torch.int8, query_batch=8,
                               encode_chunk=1024)
    t0 = time.perf_counter()
    ids, mask = retriever._tokenize([passages[i][1] for i in range(n_pass)],
                                    [passages[i][0] for i in range(n_pass)],
                                    128)
    tokenize_s = time.perf_counter() - t0
    rng = np.random.default_rng(1)
    picks = rng.integers(0, n_pass, 32 * 8)
    requests = [[" ".join(passages[int(i)][0].split()[:12])
                 for i in picks[r * 8:(r + 1) * 8]] for r in range(32)]

    # the main path: launch counts zeroed just before, read just after
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    retriever.index_corpus(passages, precomputed_tokens=ids)
    torch.cuda.synchronize()
    index_s = time.perf_counter() - t0
    latencies, answers = [], []
    for req in requests:
        t0 = time.perf_counter()
        hits = retriever.search(req, k=10)
        latencies.append((time.perf_counter() - t0) * 1e3)
        answers.append(hits)
    launches = ops.launches()
    for name in records:               # the serving path's kernels
        check(launches[name] > 0, f"{name} was not launched on the serving "
              "path")
    # the requests again under the profiler
    retriever.search(requests[0], k=10)
    request_trace = _trace(torch, [lambda req=req: retriever.search(req, k=10)
                                   for req in requests[:8]], "request")

    # the same path through a bf16 index (the bf16 template of K4)
    ops.reset_launches()
    sub = {i: passages[i] for i in range(16384)}
    r16 = DenseRetriever(model, tok, index_mode="fused",
                         store_dtype=torch.bfloat16, query_batch=8)
    r16.index_corpus(sub, precomputed_tokens=ids[:16384])
    hits16 = [r16.search(req, k=10) for req in requests[:8]]
    launches_bf16 = ops.launches()
    check(launches_bf16["mips_bucket_candidates"] > 0,
          "the bf16 search did not launch mips_bucket_candidates")
    check(all(len(h) == 10 and h[0].passage_id >= 0
              for req in hits16 for h in req), "bf16 search results")

    # results: shapes, finite scores, ids in range, sorted
    for hits in answers:
        for q_hits in hits:
            scores = [h.score for h in q_hits]
            check(len(q_hits) == 10 and all(math.isfinite(s) for s in scores)
                  and all(0 <= h.passage_id < n_pass for h in q_hits)
                  and scores == sorted(scores, reverse=True),
                  "malformed search result")

    # kernel path vs plain path on the card
    enc_ids = torch.from_numpy(ids[:1024]).to(dev)
    enc_mask = torch.from_numpy(mask[:1024]).to(dev)
    with torch.inference_mode():
        kern = model.encode_passage(enc_ids, enc_mask).float()
        plain = _plain_encode(model.ctx_model.encoder, enc_ids, enc_mask,
                              layer_int8_plain).float()
    cos = torch.nn.functional.cosine_similarity(kern, plain, dim=1)
    # The same requests through the plain path: queries encoded by the
    # plain layers, then the plain candidate search over the same index.
    # With random weights the CLS rows of unrelated passages lie close, so
    # a top-10 list can end in near-ties that one flipped int8 code of a
    # query reorders. Reported beside the raw overlap: the share of
    # kernel-path ids that the plain list holds or whose plain score ties
    # the plain 10th score within 1e-3 relative.
    overlap, agree, spread = [], [], []
    idx = retriever.index
    n_pad = idx.embeddings.shape[0]
    bucket = mk._fit_bucket(128, 2048, n_pad, 10)
    with torch.inference_mode():
        for req, hits in zip(requests, answers):
            q_ids, q_mask = retriever._tokenize(req, None, 32)
            q_ids = torch.from_numpy(q_ids).to(dev)
            q_mask = torch.from_numpy(q_mask).to(dev)
            q_emb = _plain_encode(model.question_model.encoder, q_ids, q_mask,
                                  layer_int8_plain).to(torch.bfloat16)
            q8, qs = quant_rows(q_emb)
            cand = mk._candidates_plain(q8, idx.embeddings, idx.num_rows,
                                        bucket, n_pad, qs, idx.row_scales)
            want_s, want_i = mk._finalize(*cand, 10, 0)
            for qi, q_hits in enumerate(hits):
                got = torch.tensor([h.passage_id for h in q_hits], device=dev)
                plain_s = (q8[qi].float() @ idx.embeddings[got].float().T
                           * qs[qi] * idx.row_scales[got])
                tenth = float(want_s[qi, 9])
                shared = set(got.tolist()) & set(want_i[qi].tolist())
                tied = plain_s >= tenth - 1e-3 * abs(tenth)
                overlap.append(len(shared) / 10.0)
                agree.append(sum(1 for j, pid in enumerate(got.tolist())
                                 if pid in shared or bool(tied[j])) / 10.0)
                spread.append((float(want_s[qi, 0]) - tenth) / abs(tenth))
    overlap, agree = float(np.mean(overlap)), float(np.mean(agree))

    lat = np.array(latencies)
    emit("end_to_end", nvidia_smi=smi, passages=n_pass,
         index_corpus_s=index_s, passages_per_s=n_pass / index_s,
         tokenize_s=tokenize_s, model_init_s=init_s,
         requests=len(requests), queries_per_request=8,
         request_ms_p50=float(np.percentile(lat, 50)),
         request_ms_p99=float(np.percentile(lat, 99)),
         request_ms=latencies, launches=launches,
         launches_bf16_index=launches_bf16,
         min_cosine_kernel_vs_plain=float(cos.min()),
         top10_overlap_kernel_vs_plain=overlap,
         top10_agree_kernel_vs_plain=agree,
         top10_relative_spread_median=float(np.median(spread)),
         max_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
         request_trace=request_trace)
    check(float(cos.min()) >= 0.995,
          f"passage embeddings: min cosine {float(cos.min())}")
    check(overlap >= 0.95, f"top-10 kernel vs plain: raw overlap {overlap}")
    for name, rec in records.items():
        rec["launches"] = launches[name]
    records["mips_bucket_candidates"]["launches_bf16_index"] = \
        launches_bf16["mips_bucket_candidates"]


def _trace(torch, calls, unit):
    """``calls`` under torch.profiler: device time by kernel, and the share
    of the wall time the device was idle (its busy time is the sum of
    kernel and copy times, which do not overlap on one stream)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for call in calls:
            call()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    device = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            name = ev.name[:60]
            us, n = device.get(name, (0.0, 0))
            device[name] = (us + ev.time_range.elapsed_us(), n + 1)
    busy_us = sum(us for us, _ in device.values())
    top = sorted(device.items(), key=lambda kv: -kv[1][0])[:10]
    n = len(calls)
    return {f"{unit}s": n, f"wall_ms_per_{unit}": wall_us / 1e3 / n,
            f"device_busy_ms_per_{unit}": busy_us / 1e3 / n,
            "device_idle_share": 1.0 - busy_us / wall_us,
            f"top_device_ms_per_{unit}": [
                (name, us / 1e3 / n, count // n)
                for name, (us, count) in top]}


def _plain_encode(encoder, ids, mask, layer_plain):
    """The encoder with every layer's plain composition (CLS pooling)."""
    x = encoder.embeddings(ids)
    for layer in encoder.layers:
        x = layer_plain(x.to(encoder.cfg.dtype), mask, layer.quantized(),
                        num_heads=encoder.cfg.num_heads,
                        layer_norm_eps=encoder.cfg.layer_norm_eps)
    return x[:, 0]


def _check_group_attention(torch, randn, gen):
    """K5/K6 at the reranker step's attention shape (128 joint rows x 16
    heads x S=160 x d=64, bf16 head views of [B, S, H] projections, key
    lengths 100..160) against their plain versions, two K6 calls held
    bitwise equal; their times, device times a launch, SDPA's forward and
    backward (the yardstick), K8's two launches on K6's inputs, and the
    bounds. -> (K5's record, K6's record)."""
    from simxns_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    b, s, heads, d = N_Q * N_P, LJ, CE_HEADS, CE_H // CE_HEADS

    def head_view(x):          # the model's layout: heads of [B, S, H]
        return x.view(b, s, heads, d).transpose(1, 2)

    q, k, v, do = (head_view(randn(b, s, CE_H).to(torch.bfloat16))
                   for _ in range(4))
    mask = torch.ones(b, s, dtype=torch.int32, device=dev)
    lens = torch.randint(100, s + 1, (b,), device=dev, generator=gen)
    mask[torch.arange(s, device=dev)[None, :] >= lens[:, None]] = 0

    got = fa.group_attention_fwd(q, k, v, mask)
    want = fa._group_fwd_plain(q, k, v, mask)
    err5 = float((got.float() - want.float()).abs().max())
    # f32 results rounded to bf16 on both sides: one bf16 step of o
    tol5 = 2.0 ** -8 * float(v.float().abs().max())
    check(err5 <= tol5, f"group_attention_fwd: err {err5} > {tol5}")
    grads = fa.group_attention_bwd(q, k, v, mask, do)
    refs = fa._group_bwd_plain(q, k, v, mask, do)
    err6, cos6 = [], []
    for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
        e = float((g.float() - r.float()).abs().max())
        c = float(torch.nn.functional.cosine_similarity(
            g.float().flatten(), r.float().flatten(), dim=0))
        # p and dS enter the products as hi + lo bf16 halves (~16 bits)
        # and the results round to bf16
        check(e <= 2.0 ** -7 * float(r.float().abs().max()) and c >= 0.9999,
              f"group_attention_bwd {name}: err {e}, cosine {c}")
        err6.append(e)
        cos6.append(c)
    again = fa.group_attention_bwd(q, k, v, mask, do)
    check(all(torch.equal(a, g) for a, g in zip(again, grads)),
          "group_attention_bwd: two calls differ (no atomics: they must not)")
    del got, want, grads, refs, again

    ms5 = timed(torch, lambda: fa.group_attention_fwd(q, k, v, mask), 20)
    dev5, dev5_n = device_ms(torch, lambda: fa.group_attention_fwd(
        q, k, v, mask), "group_attention_fwd_kernel")
    plain5 = timed(torch, lambda: fa._group_fwd_plain(q, k, v, mask), 3)
    ms6 = timed(torch, lambda: fa.group_attention_bwd(q, k, v, mask, do), 20)
    dev6, dev6_n = device_ms(torch, lambda: fa.group_attention_bwd(
        q, k, v, mask, do), "group_attention_bwd_kernel")
    # the same function in K8's two ring launches, timed beside it
    ms6_k8 = timed(torch, lambda: fa.bh_attention_bwd(q, k, v, mask, do), 20)
    plain6 = timed(torch, lambda: fa._group_bwd_plain(q, k, v, mask, do), 3)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    keep = (mask > 0)[:, None, None, :]
    lib5 = timed(torch, lambda: sdpa(q, k, v, attn_mask=keep), 20)
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    out = sdpa(qg, kg, vg, attn_mask=keep)
    lib6 = timed(torch, lambda: torch.autograd.grad(
        out, (qg, kg, vg), do, retain_graph=True), 10)

    def library_fwd_bwd():
        o = sdpa(qg, kg, vg, attn_mask=keep)
        torch.autograd.grad(o, (qg, kg, vg), do)

    lib56 = timed(torch, library_fwd_bwd, 10)
    del out
    elems = b * heads * s * d
    product = 2.0 * b * heads * s * s * d      # the model's: 2 and 5
    bms5, by5 = bound(4 * elems * 2 + mask.numel() * 4, 2 * product,
                      PEAK_BF16)
    bms6, by6 = bound(7 * elems * 2 + mask.numel() * 4, 5 * product,
                      PEAK_BF16)
    shape = [b, heads, s, d]
    rec5 = dict(
        ms=ms5, device_ms=dev5, device_launches_recorded=dev5_n,
        plain_ms=plain5, library_ms=lib5, bound_ms=bms5,
        bound_by=by5, max_abs_err=err5, shape=shape,
        library="scaled_dot_product_attention forward, boolean key mask",
        tolerance="2^-8 x max|v| (one bf16 step of the f32 output)")
    rec6 = dict(
        ms=ms6, device_ms=dev6, device_launches_recorded=dev6_n,
        plain_ms=plain6, library_ms=lib6, bound_ms=bms6,
        bound_by=by6, max_abs_err=max(err6), min_cosine=min(cos6),
        bh_attention_bwd_ms=ms6_k8, repeat_bitwise_equal=True,
        shape=shape, fwd_bwd_ms=ms5 + ms6, library_fwd_bwd_ms=lib56,
        library="scaled_dot_product_attention backward (autograd.grad)",
        tolerance="2^-7 x max|ref| per gradient and cosine >= 0.9999")
    del q, k, v, do, qg, kg, vg
    return rec5, rec6


def phase_train_kernels(torch, smi, records):
    """Phase 4: K5/K6 at the reranker step's attention shape, and K1-K3 at
    the int8 teacher's shapes (20,480 tokens of CE-large)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, device=dev, generator=gen) * scale

    (records["group_attention_fwd"],
     records["group_attention_bwd"]) = _check_group_attention(
        torch, randn, gen)
    for name in ("group_attention_fwd", "group_attention_bwd"):
        emit("kernel", name=name, nvidia_smi=smi, **records[name])
    b, s = N_Q * N_P, LJ
    m = b * s
    teacher = {
        "int8_linear": _check_int8_linear(torch, randn, m, CE_H, CE_F),
        "row_quant": _check_row_quant(torch, randn, m, CE_H, CE_F),
        "small_s_attention": _check_small_s_attention(
            torch, randn, gen, ((b, s, 100),), CE_H, CE_HEADS)}
    for name, rec in teacher.items():
        records[name]["teacher"] = rec
        emit("kernel_teacher_shapes", name=name, nvidia_smi=smi, tokens=m,
             hidden=CE_H, ffn=CE_F, heads=CE_HEADS, **rec)
    torch.cuda.empty_cache()


def _train_batch(np, seed):
    """One per-GPU AR2 batch: 8 queries x 16 passages (1 positive, 15
    negatives), 32 / 128 / 160 tokens with random real lengths; the joint
    row is the query's tokens, then the passage's."""
    rng = np.random.default_rng(seed)
    n, m = N_Q, N_P

    def tokens(rows, width, lo):
        lens = rng.integers(lo, width + 1, rows)
        ids = rng.integers(1000, 30522, (rows, width)).astype(np.int32)
        ids[:, 0] = 101
        mask = (np.arange(width)[None, :] < lens[:, None]).astype(np.int32)
        return ids * mask, mask, lens

    q_ids, q_mask, q_lens = tokens(n, LQ, 8)
    c_ids, c_mask, c_lens = tokens(n * m, LC, 60)
    pos = np.arange(LJ)[None, :]
    ql = np.repeat(q_lens, m)[:, None]
    src = np.clip(pos - ql + 1, 0, LC - 1)    # skip the passage's CLS
    joint = np.where(pos < ql, np.repeat(q_ids, m, 0)[:, np.minimum(
        np.arange(LJ), LQ - 1)], np.take_along_axis(c_ids, src, 1))
    jmask = (pos < ql + c_lens[:, None] - 1).astype(np.int32)
    return {"q_ids": q_ids, "q_mask": q_mask, "ctx_ids": c_ids,
            "ctx_mask": c_mask,
            "positive_idx": (np.arange(n) * m).astype(np.int32),
            "joint_ids": (joint * jmask).reshape(n, m, LJ),
            "joint_mask": jmask.reshape(n, m, LJ)}


def _full_models(torch, ffn_impl):
    """The nq recipe's models at full width on the card, random weights
    from seed 0: a BERT-base DE and an ERNIE-large-shaped CE (24 layers,
    H=1024, small_s_attn="group"), both with ``ffn_impl``. -> (de, ce,
    seconds)."""
    from simxns_tpu_torch.models import (BertConfig, BiEncoder,
                                         BiEncoderConfig, CrossEncoder,
                                         CrossEncoderConfig)

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    de = BiEncoder(BiEncoderConfig(bert=BertConfig(
        vocab_size=30522, hidden_size=H, num_layers=12, num_heads=HEADS,
        intermediate_size=F, dtype=torch.bfloat16, ffn_impl=ffn_impl)),
        generator=torch.Generator().manual_seed(0)).to(dev)
    ce = CrossEncoder(CrossEncoderConfig(bert=BertConfig(
        vocab_size=30522, hidden_size=CE_H, num_layers=CE_LAYERS,
        num_heads=CE_HEADS, intermediate_size=CE_F, dtype=torch.bfloat16,
        small_s_attn="group", ffn_impl=ffn_impl)),
        generator=torch.Generator().manual_seed(0)).to(dev)
    return de, ce, time.perf_counter() - t0


def _flat_gradients(torch, steps, model, batch):
    """(loss, every gradient flattened into one f32 vector) of one reranker
    forward and backward of ``model``; no update, the .grad fields cleared."""
    loss, _ = steps.reranker_loss(model, batch)
    grads = steps.gradients(model, loss)
    flat = torch.cat([g.float().flatten() for g in grads.values()
                      if g is not None])
    for p in model.parameters():
        p.grad = None
    return float(loss.detach()), flat


def _cosine(torch, a, b):
    return float(torch.nn.functional.cosine_similarity(a, b, dim=0))


def phase_training(torch, smi, records):
    """Phase 5: the training path. A BERT-base DE and an ERNIE-large-shaped
    CE (random weights, seed 0) take 3 DE warm-up steps, 3 reranker steps
    and 3 AR2 retriever steps with the fused-int8 teacher view, on the
    warm-up AdamW at the recipe's learning rates."""
    import numpy as np

    from simxns_tpu_torch import ops
    from simxns_tpu_torch.models import int8_view
    from simxns_tpu_torch.ops import flash_attention as fa
    from simxns_tpu_torch.ops.fused_layer import layer_int8_plain
    from simxns_tpu_torch.train import (TrainState, make_adamw,
                                        make_ar2_retriever_step,
                                        make_biencoder_step,
                                        make_reranker_step, steps)

    dev = torch.device("cuda")
    fresh_peak(torch)
    de, ce, init_s = _full_models(torch, "xla")
    batches = [_train_batch(np, seed) for seed in range(3)]
    b0 = steps.to_device(batches[0], dev)

    # the first reranker step's gradients, K5/K6 against their plain
    # versions, from the same weights (no update in between)
    def ce_gradients():
        return _flat_gradients(torch, steps, ce, b0)

    def softmax_probs(q, k, mask):
        # p through torch.softmax: the same f32 function as the plain
        # pair's explicit exp / sum, rounded otherwise
        scale = 1.0 / math.sqrt(q.shape[-1])
        s = (q.float() @ k.float().transpose(-1, -2)) * scale
        s = torch.where(mask[:, None, None, :] > 0, s, -1e9)
        return torch.softmax(s, dim=-1), scale

    loss_k, grad_k = ce_gradients()
    kernels = fa.group_attention_fwd, fa.group_attention_bwd, fa._probs
    fa.group_attention_fwd = fa._group_fwd_plain
    fa.group_attention_bwd = fa._group_bwd_plain
    try:
        loss_p, grad_p = ce_gradients()
        fa._probs = softmax_probs
        loss_f, grad_f = ce_gradients()
    finally:
        fa.group_attention_fwd, fa.group_attention_bwd, fa._probs = kernels

    grad_cos = _cosine(torch, grad_k, grad_p)
    floor_cos = _cosine(torch, grad_p, grad_f)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    del grad_k, grad_p, grad_f
    # bf16 activations through 24 random-weight layers: an f32 rounding
    # anywhere in the attention flips bf16 roundings downstream, and the
    # gradients of two equally exact plain versions already part at a
    # cosine of ~0.9945 (measured on one H100). The kernels must sit on that
    # floor, not below it.
    check(loss_rel <= 1e-2 and grad_cos >= 0.99
          and grad_cos >= floor_cos - 0.002,
          f"reranker step, K5/K6 vs plain: loss rel {loss_rel}, gradient "
          f"cosine {grad_cos} (two plain versions: {floor_cos})")

    # the teacher view's pooled CLS vectors: kernels against the plain
    # int8 composition
    view = int8_view(ce)
    jid = b0["joint_ids"].reshape(-1, LJ)
    jmask = b0["joint_mask"].reshape(-1, LJ)
    with torch.no_grad():
        kern = view.encoder(jid, jmask).pooled.float()
        plain = _plain_encode(view.encoder, jid, jmask,
                              layer_int8_plain).float()
    teacher_cos = float(torch.nn.functional.cosine_similarity(
        kern, plain, dim=1).min())
    check(teacher_cos >= 0.995, f"teacher CLS: min cosine {teacher_cos}")
    del kern, plain

    # the main path: launch counts zeroed just before, read just after
    tx_de = make_adamw(1e-5, total_steps=0)
    tx_ce = make_adamw(1e-6, total_steps=0)
    de_state = TrainState.create(de, tx_de)
    ce_state = TrainState.create(ce, tx_ce)
    kinds = {"biencoder": make_biencoder_step(tx_de),
             "reranker": make_reranker_step(tx_ce),
             "retriever": make_ar2_retriever_step(tx_de, temperature=1.0,
                                                  adv_lambda=0.0)}
    ops.reset_launches()
    torch.cuda.synchronize()
    phase_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms, losses, peak_gb, resident_gb, de_state, ce_state = _run_steps(
        torch, kinds, batches, de_state, ce_state, view)
    phase_peak_gb = max(phase_peak_gb, *peak_gb.values())
    launches = ops.launches()
    for name in ("int8_linear", "row_quant", "small_s_attention",
                 "group_attention_fwd", "group_attention_bwd"):
        check(launches[name] > 0, f"{name} was not launched on the training "
              "path")
    check(all(math.isfinite(x) for v in losses.values() for x in v),
          f"non-finite loss: {losses}")
    # one more step of each kind under the profiler
    traces = {
        "biencoder": _trace(torch, [lambda: kinds["biencoder"](
            de_state, batches[0])], "step"),
        "reranker": _trace(torch, [lambda: kinds["reranker"](
            ce_state, batches[0])], "step"),
        "retriever": _trace(torch, [lambda: kinds["retriever"](
            de_state, view, batches[0])], "step")}

    de_tokens = N_Q * LQ + N_Q * N_P * LC
    ce_tokens = N_Q * N_P * LJ
    # model FLOPs of one CE step: 3 x forward, forward per token and layer
    # 2 x (4 H^2 + 2 H F) in the GEMMs + 4 S H in attention
    ce_flop = 3.0 * CE_LAYERS * ce_tokens * (
        8 * CE_H ** 2 + 4 * CE_H * CE_F + 4 * LJ * CE_H)
    steady = {kind: float(np.mean(ms[1:])) for kind, ms in step_ms.items()}
    emit("training", nvidia_smi=smi, model_init_s=init_s,
         step_ms=step_ms, steady_step_ms=steady, losses=losses,
         tokens_per_s={
             "biencoder": de_tokens / steady["biencoder"] * 1e3,
             "reranker": ce_tokens / steady["reranker"] * 1e3,
             "retriever": (de_tokens + ce_tokens) / steady["retriever"]
             * 1e3},
         padded_tokens_per_step={"biencoder": de_tokens,
                                 "reranker": ce_tokens,
                                 "retriever_teacher": ce_tokens},
         reranker_model_tflop=ce_flop / 1e12,
         reranker_bf16_peak_share=ce_flop / (steady["reranker"] / 1e3)
         / PEAK_BF16,
         reranker_kernel_vs_plain={"loss_kernel": loss_k,
                                   "loss_plain": loss_p,
                                   "loss_plain_softmax": loss_f,
                                   "loss_rel": loss_rel,
                                   "gradient_cosine": grad_cos,
                                   "gradient_cosine_two_plain": floor_cos},
         teacher_cls_min_cosine_kernel_vs_plain=teacher_cos,
         launches=launches, max_memory_gb=phase_peak_gb,
         max_memory_gb_by_kind=peak_gb, resident_gb_by_kind=resident_gb,
         step_traces=traces)
    for name, rec in records.items():
        serving = rec.get("launches", 0)
        rec["launches_by_path"] = {"serving": serving,
                                   "training": launches.get(name, 0)}
        rec["launches"] = serving + launches.get(name, 0)
    return {"steady_step_ms": steady, "max_memory_gb_by_kind": peak_gb}


def _run_steps(torch, kinds, batches, de_state, ce_state, view):
    """Every batch through each kind of step, each step timed on the host
    clock to a synchronise; the peak memory is read per kind, beside what
    was resident before its first step. -> (step_ms, losses, peak_gb,
    resident_gb, de_state, ce_state)."""
    step_ms = {kind: [] for kind in kinds}
    losses = {kind: [] for kind in kinds}
    peak_gb, resident_gb = {}, {}
    for kind, step in kinds.items():
        resident_gb[kind] = fresh_peak(torch)
        for batch in batches:
            t0 = time.perf_counter()
            if kind == "biencoder":
                de_state, metrics = step(de_state, batch)
            elif kind == "reranker":
                ce_state, metrics = step(ce_state, batch)
            else:
                de_state, metrics = step(de_state, view, batch)
            losses[kind].append(float(metrics["loss"]))
            torch.cuda.synchronize()
            step_ms[kind].append((time.perf_counter() - t0) * 1e3)
        peak_gb[kind] = torch.cuda.max_memory_allocated() / 1e9
    return step_ms, losses, peak_gb, resident_gb, de_state, ce_state


def _check_bh_attention(torch, randn, gen, b, s, d, min_len, timing):
    """K7/K8 on head views of [b, s, HEADS * d] projections with key
    lengths min_len..s, against their plain versions; with ``timing`` also
    their times, SDPA's (the yardstick: forward, backward, both) and the
    bounds (the model's products: 2 in the forward, 5 in the backward)."""
    from simxns_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    heads = HEADS

    def head_view(x):
        return x.view(b, s, heads, d).transpose(1, 2)

    q, k, v, do = (head_view(randn(b, s, heads * d).to(torch.bfloat16))
                   for _ in range(4))
    mask = torch.ones(b, s, dtype=torch.int32, device=dev)
    lens = torch.randint(min_len, s + 1, (b,), device=dev, generator=gen)
    mask[torch.arange(s, device=dev)[None, :] >= lens[:, None]] = 0
    got = fa.bh_attention_fwd(q, k, v, mask)
    want = fa._group_fwd_plain(q, k, v, mask)
    err7 = float((got.float() - want.float()).abs().max())
    # f32 results rounded to bf16 on both sides: one bf16 step of o
    tol7 = 2.0 ** -8 * float(v.float().abs().max())
    check(err7 <= tol7, f"bh_attention_fwd S={s}: err {err7} > {tol7}")
    del got, want
    grads = fa.bh_attention_bwd(q, k, v, mask, do)
    refs = fa._group_bwd_plain(q, k, v, mask, do)
    err8, cos8 = [], []
    for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
        e = float((g.float() - r.float()).abs().max())
        c = float(torch.nn.functional.cosine_similarity(
            g.float().flatten(), r.float().flatten(), dim=0))
        # p and dS enter the products as hi + lo bf16 halves (~16 bits)
        # and the results round to bf16
        check(e <= 2.0 ** -7 * float(r.float().abs().max()) and c >= 0.9999,
              f"bh_attention_bwd S={s} {name}: err {e}, cosine {c}")
        err8.append(e)
        cos8.append(c)
    again = fa.bh_attention_bwd(q, k, v, mask, do)
    check(all(torch.equal(a, g) for a, g in zip(again, grads)),
          f"bh_attention_bwd S={s}: two calls differ (no atomics: they must "
          "not)")
    del grads, refs, again
    rec = dict(shape=[b, heads, s, d], key_lengths=[min_len, s],
               fwd_max_abs_err=err7, fwd_tolerance=tol7,
               bwd_max_abs_err=max(err8), bwd_min_cosine=min(cos8))
    if not timing:
        return rec
    ms7 = timed(torch, lambda: fa.bh_attention_fwd(q, k, v, mask), 10)
    dev7, dev7_n = device_ms(torch, lambda: fa.bh_attention_fwd(
        q, k, v, mask), "bh_attention_fwd_kernel")
    plain7 = timed(torch, lambda: fa._group_fwd_plain(q, k, v, mask), 2)
    ms8 = timed(torch, lambda: fa.bh_attention_bwd(q, k, v, mask, do), 10)
    dev8 = {f"device_ms_{p}_pass": device_ms(
        torch, lambda: fa.bh_attention_bwd(q, k, v, mask, do),
        f"bh_attention_bwd_{p}_kernel")[0] for p in ("query", "key")}
    plain8 = timed(torch, lambda: fa._group_bwd_plain(q, k, v, mask, do), 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    keep = (mask > 0)[:, None, None, :]
    lib7 = timed(torch, lambda: sdpa(q, k, v, attn_mask=keep), 10)
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    out = sdpa(qg, kg, vg, attn_mask=keep)
    lib8 = timed(torch, lambda: torch.autograd.grad(
        out, (qg, kg, vg), do, retain_graph=True), 5)

    def library_fwd_bwd():
        o = sdpa(qg, kg, vg, attn_mask=keep)
        torch.autograd.grad(o, (qg, kg, vg), do)

    lib78 = timed(torch, library_fwd_bwd, 5)
    del out, qg, kg, vg
    elems = b * heads * s * d
    product = 2.0 * b * heads * s * s * d
    bms7, by7 = bound(4 * elems * 2 + mask.numel() * 4, 2 * product,
                      PEAK_BF16)
    bms8, by8 = bound(7 * elems * 2 + mask.numel() * 4, 5 * product,
                      PEAK_BF16)
    rec.update(ms=ms7, device_ms=dev7, device_launches_recorded=dev7_n,
               plain_ms=plain7, library_ms=lib7, bound_ms=bms7,
               bound_by=by7, bwd_ms=ms8, bwd_plain_ms=plain8,
               **{f"bwd_{n}": x for n, x in dev8.items()},
               bwd_library_ms=lib8, bwd_bound_ms=bms8, bwd_bound_by=by8,
               fwd_bwd_ms=ms7 + ms8, library_fwd_bwd_ms=lib78)
    return rec


def phase_msdoc_kernels(torch, smi, records):
    """Phase 6: K7/K8 at the msdoc reranker step's attention shape (128
    joint rows x 12 heads x S=512 x d=64, bf16, key lengths 300..512) and
    at S = 256, 288 and 1024; K3 at the msdoc encode's S=512 (1024 x 512
    tokens, BERT-base); K4 at the mine's shape (64 queries, k=100, over
    24,576 int8 rows)."""
    from simxns_tpu_torch.ops import mips_kernel as mk
    from simxns_tpu_torch.ops.fused_ffn import quant_rows

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    torch.cuda.empty_cache()

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, device=dev, generator=gen) * scale

    main = _check_bh_attention(torch, randn, gen, N_Q * N_P, MS_S,
                               H // HEADS, 300, timing=True)
    others = [_check_bh_attention(torch, randn, gen, 16, s, H // HEADS,
                                  s // 2, timing=False)
              for s in (256, 288, 1024)]
    shapes = [main] + others
    records["bh_attention_fwd"] = dict(
        ms=main["ms"], plain_ms=main["plain_ms"],
        library_ms=main["library_ms"], bound_ms=main["bound_ms"],
        bound_by=main["bound_by"],
        max_abs_err=max(r["fwd_max_abs_err"] for r in shapes),
        shape=main["shape"], shapes=shapes,
        library="scaled_dot_product_attention forward, boolean key mask",
        tolerance="2^-8 x max|v| (one bf16 step of the f32 output)")
    records["bh_attention_bwd"] = dict(
        ms=main["bwd_ms"], plain_ms=main["bwd_plain_ms"],
        library_ms=main["bwd_library_ms"], bound_ms=main["bwd_bound_ms"],
        bound_by=main["bwd_bound_by"],
        device_ms_query_pass=main["bwd_device_ms_query_pass"],
        device_ms_key_pass=main["bwd_device_ms_key_pass"],
        repeat_bitwise_equal=True,
        max_abs_err=max(r["bwd_max_abs_err"] for r in shapes),
        min_cosine=min(r["bwd_min_cosine"] for r in shapes),
        shape=main["shape"], fwd_bwd_ms=main["fwd_bwd_ms"],
        library_fwd_bwd_ms=main["library_fwd_bwd_ms"],
        library="scaled_dot_product_attention backward (autograd.grad)",
        tolerance="2^-7 x max|ref| per gradient and cosine >= 0.9999")
    for name in ("bh_attention_fwd", "bh_attention_bwd"):
        emit("kernel", name=name, nvidia_smi=smi, **records[name])
    torch.cuda.empty_cache()

    rec3 = _check_small_s_attention(torch, randn, gen, ((1024, MS_S, 300),),
                                    H, HEADS)
    records["small_s_attention"]["msdoc"] = rec3
    emit("kernel_msdoc_shapes", name="small_s_attention", nvidia_smi=smi,
         tokens=1024 * MS_S, hidden=H, heads=HEADS, **rec3)
    torch.cuda.empty_cache()

    codes, scales = quant_rows(randn(MINE_ROWS, H))
    q8, qs = quant_rows(randn(MINE_Q, H))
    block_n = 2048
    bucket = mk._fit_bucket(128, block_n, MINE_ROWS, MINE_K)
    kw = dict(bucket=bucket, block_n=block_n, query_scales=qs,
              row_scales=scales)
    got_s, got_i = mk.mips_bucket_candidates(q8, codes, MINE_ROWS, **kw)
    want_s, want_i = mk._candidates_plain(q8, codes, MINE_ROWS, bucket,
                                          MINE_ROWS, qs, scales)
    err = float((got_s - want_s).abs().max())
    ids_off = int((got_i != want_i).sum())
    check(err == 0.0 and ids_off == 0,
          f"mips int8 at the mine's shape: err {err}, {ids_off} ids differ")
    ms = timed(torch, lambda: mk.mips_bucket_candidates(q8, codes, MINE_ROWS,
                                                        **kw), 20)
    plain = timed(torch, lambda: mk._candidates_plain(
        q8, codes, MINE_ROWS, bucket, MINE_ROWS, qs, scales), 3)
    lib = timed(torch, lambda: _library_search(torch, q8, codes, "int8",
                                               k=MINE_K), 5)
    moved = (MINE_ROWS * H + MINE_Q * H + 4 * (MINE_ROWS + MINE_Q)
             + MINE_Q * (MINE_ROWS // bucket) * 8)
    bms, by = bound(moved, 2.0 * MINE_Q * MINE_ROWS * H, PEAK_INT8)
    rec4 = dict(kind="int8", queries=MINE_Q, rows=MINE_ROWS, k=MINE_K,
                bucket=bucket, ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=bms, bound_by=by, max_abs_err=err,
                ids_differing=ids_off)
    records["mips_bucket_candidates"]["mine"] = rec4
    emit("kernel_variant", name="mips_bucket_candidates", nvidia_smi=smi,
         **rec4)
    del codes, scales, got_s, got_i, want_s, want_i
    torch.cuda.empty_cache()


# the co-training phase's per-recipe kernel path
CO_TRAINING = {
    "nq_ar2_simans": ("int8_linear", "row_quant", "small_s_attention",
                      "mips_bucket_candidates", "group_attention_fwd",
                      "group_attention_bwd"),
    "msdoc_ar2_simans": ("int8_linear", "row_quant", "small_s_attention",
                         "mips_bucket_candidates", "bh_attention_fwd",
                         "bh_attention_bwd"),
}


def _co_training_run(run, recipe, argv):
    """One ``run.run_ar2`` of ``recipe`` with windows of 4 steps (1 + 1
    reranker steps, then 2 retriever steps); -> its output."""
    import dataclasses

    from simxns_tpu_torch.config import RECIPES

    args = run.build_parser().parse_args(["--recipe", recipe, *argv])
    cfg = dataclasses.replace(RECIPES[recipe], iteration_step=4,
                              iteration_reranker_step=1)
    return run.run_ar2(recipe, cfg, args)


def phase_co_training(torch, smi, records):
    """Phase 7: the AR2 co-training loop end to end through
    ``simxns_tpu_torch.run.run_ar2`` at full width, once per recipe: warm-up,
    a mine, 2 reranker + 2 retriever steps, a boundary (checkpoint + mine),
    again, a final mine; then one relaunch of the nq run that resumes from
    its step-8 checkpoints. Each step is timed on the host clock to a
    synchronise (wrappers around the launcher's step factories)."""
    import os
    import shutil
    import tempfile

    import numpy as np

    from simxns_tpu_torch import ops, run

    factories = {"make_biencoder_step": "biencoder",
                 "make_reranker_step": "reranker",
                 "make_ar2_retriever_step": "retriever"}
    real = {name: getattr(run, name) for name in factories}
    step_ms = {}

    def timing(factory, kind):
        def make(*a, **kw):
            step = factory(*a, **kw)

            def timed_step(*args):
                t0 = time.perf_counter()
                out = step(*args)
                torch.cuda.synchronize()
                step_ms.setdefault(kind, []).append(
                    (time.perf_counter() - t0) * 1e3)
                return out

            return timed_step

        return make

    common = ["--synthetic", "--full-size", "--fast-encode", "--fast-teacher",
              "--int8-index", "--batch", str(N_Q), "--steps", "8",
              "--warm-epochs", "1", "--corpus-size", str(MINE_ROWS),
              "--num-queries", str(MINE_Q)]
    root = tempfile.mkdtemp(prefix="chip_smoke_co_training_")
    free_gb = shutil.disk_usage(root).free / 1e9
    totals = {name: 0 for name in ops.KERNELS}
    summary = {}
    for name, kind in factories.items():
        setattr(run, name, timing(real[name], kind))
    try:
        for recipe, path in CO_TRAINING.items():
            out_dir = os.path.join(root, recipe)
            step_ms.clear()
            fresh_peak(torch)
            # the main path: launch counts zeroed just before, read after
            ops.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _co_training_run(run, recipe,
                                   common + ["--output-dir", out_dir])
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            launches = ops.launches()
            for name in path:
                check(launches[name] > 0, f"{name} was not launched on the "
                      f"{recipe} co-training path")
            for name in totals:
                totals[name] += launches[name]
            losses = []
            with open(os.path.join(out_dir, "metrics.jsonl"),
                      encoding="utf-8") as f:
                for line in f:
                    rec = json.loads(line)
                    if rec["phase"] in ("reranker", "retriever"):
                        losses.append((rec["step"], rec["phase"],
                                       rec["loss"]))
            check(len(losses) == 8 and all(math.isfinite(x[2])
                                           for x in losses),
                  f"{recipe}: co-training losses {losses}")
            check(0.0 <= out["top1"] <= 1.0
                  and all(0.0 <= x <= 1.0 for x in out["history_top1"]),
                  f"{recipe}: top1 {out['top1']} {out['history_top1']}")
            names = set(os.listdir(out_dir))
            for step in (4, 8):
                for state in ("retriever_state", "reranker_state"):
                    check(f"{state}-{step}" in names,
                          f"{recipe}: no {state}-{step} checkpoint")
            phases = out["phase_times_s"]
            mines = len(out["history_top1"]) + 1
            rec = dict(recipe=recipe, wall_s=wall_s, top1=out["top1"],
                       history_top1=out["history_top1"],
                       mrr10=out["mrr10"], losses=losses,
                       phase_times_s=phases, mines=mines,
                       mine_encode_passages_per_s=(
                           mines * MINE_ROWS / phases["encode_corpus"]),
                       step_ms=dict(step_ms),
                       mean_step_ms={k: float(np.mean(v))
                                     for k, v in step_ms.items()},
                       max_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                       launches=launches, disk_free_gb_before=free_gb)
            if recipe == "nq_ar2_simans":
                t0 = time.perf_counter()
                again = _co_training_run(
                    run, recipe,
                    common + ["--output-dir", out_dir, "--resume", "auto"])
                check(math.isfinite(again["top1"])
                      and len(again["history_top1"]) == 1,
                      f"resume: {again}")
                with open(os.path.join(out_dir, "metrics.jsonl"),
                          encoding="utf-8") as f:
                    resumed = [json.loads(line) for line in f
                               if '"resume_eval"' in line]
                check(len(resumed) == 1 and resumed[0]["step"] == 8,
                      f"resume did not restore step 8: {resumed}")
                rec["resume"] = dict(top1=again["top1"],
                                     uninterrupted_top1=out["top1"],
                                     wall_s=time.perf_counter() - t0)
            summary[recipe] = rec
            emit("co_training", nvidia_smi=smi, **rec)
            shutil.rmtree(out_dir, ignore_errors=True)
    finally:
        for name in factories:
            setattr(run, name, real[name])
        shutil.rmtree(root, ignore_errors=True)
    for name, rec in records.items():
        rec.setdefault("launches_by_path", {})["co_training"] = totals[name]
        rec["launches"] = sum(rec["launches_by_path"].values())
    return summary


# (M, H, F) of the FFN kernels on the main paths
FFN_SHAPES = {"ce_large": (N_Q * N_P * LJ, CE_H, CE_F),
              "de_passages": (N_Q * N_P * LC, H, F),
              "de_queries": (N_Q * LQ, H, F),
              "msdoc": (N_Q * N_P * MS_S, H, F),
              "encode_chunk": (1024 * LC, H, F)}
FFN_KERNELS = ("ffn_train_fwd", "ffn_bwd_dx", "ffn_bwd_dw", "ffn_fused_fwd")


def _check_ffn_shape(torch, randn, label, m, h, f):
    """K9-K12 at one (M, H, F) against their plain versions on the same
    bf16 inputs, with their times, the bounds and the library yardstick
    (``F.linear`` -> ``F.gelu`` -> ``F.linear`` in bf16 and its autograd
    backward; timed only). ``encode_chunk`` is K12's shape alone.
    -> {kernel name: record}."""
    from simxns_tpu_torch.ops import fused_ffn as pf

    bf = torch.bfloat16
    x = randn(m, h).to(bf)
    w1 = randn(f, h, scale=0.02).to(bf)
    b1 = randn(f, scale=0.02).to(bf)
    w2 = randn(h, f, scale=0.02).to(bf)
    b2 = randn(h, scale=0.02).to(bf)
    shape = dict(shape=label, m=m, h=h, f=f)
    ops = 4.0 * m * h * f

    def close_bf16(got, want, what):
        # both sides round f32 sums taken in another order to bf16: a
        # result may land one bf16 step away (2^-7 relative at most), and
        # what is summed from a moved hb or dh element moves far less
        err = float((got.float() - want.float()).abs().max())
        tol = 2.0 ** -7 * float(want.float().abs().max())
        check(err <= tol, f"{what} at {label}: err {err} > {tol}")
        share = float((got != want).float().mean())
        return err, share

    def close_f32(got, want, what):
        # f32 sums of M bf16 products in another order (and the tensor
        # cores' f32 accumulation): 1e-3 of the largest value, and a cosine
        err = float((got - want).abs().max())
        rel = err / float(want.abs().max())
        cos = float(torch.nn.functional.cosine_similarity(
            got.flatten().double(), want.flatten().double(), dim=0))
        check(rel <= 1e-3 and cos >= 0.99999,
              f"{what} at {label}: err {rel} of the largest, cosine {cos}")
        return err, rel, cos

    def library_fwd(xx=x, a=w1, b=b1, c=w2, d=b2):
        lin = torch.nn.functional.linear
        return lin(torch.nn.functional.gelu(lin(xx, a, b)), c, d)

    out = {}
    y_ref, hb_ref = pf._ffn_train_fwd_plain(x, w1, b1, w2, b2)
    plain_fwd = timed(torch, lambda: pf._ffn_train_fwd_plain(
        x, w1, b1, w2, b2), 1, warmup=0)
    lib_fwd = timed(torch, library_fwd, 5)
    w_bytes = 2 * (2 * h * f + h + f)

    y12 = pf.ffn_fused_fwd(x, w1, b1, w2, b2)
    err, share = close_bf16(y12, y_ref, "ffn_fused_fwd y")
    bms, by = bound(2 * (2 * m * h) + w_bytes, ops, PEAK_BF16)
    out["ffn_fused_fwd"] = dict(
        shape, ms=timed(torch, lambda: pf.ffn_fused_fwd(x, w1, b1, w2, b2),
                        5), plain_ms=plain_fwd, library_ms=lib_fwd,
        bound_ms=bms, bound_by=by, max_abs_err=err, share_differing=share)
    del y12
    if label == "encode_chunk":
        return out

    y, hb = pf.ffn_train_fwd(x, w1, b1, w2, b2)
    err_h, share_h = close_bf16(hb, hb_ref, "ffn_train_fwd hb")
    err, share = close_bf16(y, y_ref, "ffn_train_fwd y")
    bms, by = bound(2 * (2 * m * h + m * f) + w_bytes, ops, PEAK_BF16)
    out["ffn_train_fwd"] = dict(
        shape, ms=timed(torch, lambda: pf.ffn_train_fwd(x, w1, b1, w2, b2),
                        5), plain_ms=plain_fwd, library_ms=lib_fwd,
        bound_ms=bms, bound_by=by, max_abs_err=max(err, err_h),
        share_differing=max(share, share_h))
    del y, y_ref, hb_ref

    # the backward kernels and their plain versions read K9's hb, and K11
    # K10's dh: the same inputs on both sides
    dy = randn(m, h).to(bf)
    dx, dh = pf.ffn_bwd_dx(dy, w1, w2, hb)
    dx_ref, dh_ref = pf._ffn_bwd_dx_plain(dy, w1, w2, hb)
    err_h, share_h = close_bf16(dh, dh_ref, "ffn_bwd_dx dh")
    err, share = close_bf16(dx, dx_ref, "ffn_bwd_dx dx")
    del dx, dx_ref, dh_ref
    ms10 = timed(torch, lambda: pf.ffn_bwd_dx(dy, w1, w2, hb), 5)
    plain10 = timed(torch, lambda: pf._ffn_bwd_dx_plain(dy, w1, w2, hb), 1,
                    warmup=0)
    bms, by = bound(2 * (2 * m * h + 2 * m * f + 2 * h * f), ops, PEAK_BF16)
    out["ffn_bwd_dx"] = dict(
        shape, ms=ms10, plain_ms=plain10, library_ms=None, bound_ms=bms,
        bound_by=by, max_abs_err=max(err, err_h),
        share_differing=max(share, share_h))

    got = pf.ffn_bwd_dw(x, dy, hb, dh)
    want = pf._ffn_bwd_dw_plain(x, dy, hb, dh)
    errs = [close_f32(g, w, f"ffn_bwd_dw {name}")
            for name, g, w in zip(("dw1", "db1", "dw2"), got, want)]
    del got, want
    ms11 = timed(torch, lambda: pf.ffn_bwd_dw(x, dy, hb, dh), 5)
    plain11 = timed(torch, lambda: pf._ffn_bwd_dw_plain(x, dy, hb, dh), 1,
                    warmup=0)
    bms, by = bound(2 * (2 * m * h + 2 * m * f) + 4 * (2 * h * f + f), ops,
                    PEAK_BF16)
    out["ffn_bwd_dw"] = dict(
        shape, ms=ms11, plain_ms=plain11, library_ms=None, bound_ms=bms,
        bound_by=by, max_abs_err=max(e[0] for e in errs),
        max_err_of_largest=max(e[1] for e in errs),
        min_cosine=min(e[2] for e in errs))

    # the yardstick of K10 + K11 together: the library forward's backward
    leaves = [t.detach().requires_grad_() for t in (x, w1, b1, w2, b2)]
    y_lib = library_fwd(*leaves)
    lib_bwd = timed(torch, lambda: torch.autograd.grad(
        y_lib, leaves, dy, retain_graph=True), 5)
    for name in ("ffn_bwd_dx", "ffn_bwd_dw"):
        out[name].update(bwd_ms=ms10 + ms11, library_bwd_ms=lib_bwd)
    return out


def phase_ffn_kernels(torch, smi, records):
    """Phase 8: K9-K12 at the shapes of FFN_SHAPES. The record of K9-K11 is
    the CE-large step's shape, K12's the encode chunk's."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    torch.cuda.empty_cache()

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, device=dev, generator=gen) * scale

    by_kernel = {name: [] for name in FFN_KERNELS}
    for label, (m, h, f) in FFN_SHAPES.items():
        for name, rec in _check_ffn_shape(torch, randn, label, m, h,
                                          f).items():
            by_kernel[name].append(rec)
            emit("kernel_shape", name=name, nvidia_smi=smi, **rec)
        torch.cuda.empty_cache()
    tolerance = {
        "ffn_bwd_dw": "1e-3 x max|ref| and cosine >= 0.99999 (f32 sums over "
                      "M in another order)"}
    for name, shapes in by_kernel.items():
        main = next(r for r in shapes if r["shape"] == (
            "encode_chunk" if name == "ffn_fused_fwd" else "ce_large"))
        rec = {key: val for key, val in main.items()
               if key not in ("m", "h", "f")}
        rec["max_abs_err"] = max(r["max_abs_err"] for r in shapes)
        rec["shape"] = [main["m"], main["h"], main["f"]]
        rec["shapes"] = shapes
        rec["tolerance"] = tolerance.get(
            name, "2^-7 x max|ref| (one bf16 step of the largest value)")
        rec["library"] = ("F.linear -> F.gelu -> F.linear in bf16; "
                          "library_bwd_ms its autograd backward, the "
                          "yardstick of K10 + K11 together (bwd_ms)")
        records[name] = rec
        emit("kernel", name=name, nvidia_smi=smi,
             **{k: v for k, v in rec.items() if k != "shapes"})


def phase_ffn_training(torch, smi, records, xla):
    """Phase 9: phase 5's training path with ``ffn_impl="fused_vjp"`` on the
    DE and the CE (the teacher view stays fused_int8). ``xla`` is what
    phase 5 measured with ``ffn_impl="xla"``."""
    import numpy as np

    from simxns_tpu_torch import ops
    from simxns_tpu_torch.models import CrossEncoder, int8_view
    from simxns_tpu_torch.models.bert import share_parameters
    from simxns_tpu_torch.ops import fused_ffn as pf
    from simxns_tpu_torch.train import (TrainState, make_adamw,
                                        make_ar2_retriever_step,
                                        make_biencoder_step,
                                        make_reranker_step, steps)

    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    de, ce, init_s = _full_models(torch, "fused_vjp")
    batches = [_train_batch(np, seed) for seed in range(3)]
    b0 = steps.to_device(batches[0], dev)

    def view_of(**knobs):
        """``ce`` under another config, over the same Parameters."""
        import dataclasses

        with torch.device("meta"):
            view = CrossEncoder(dataclasses.replace(
                ce.cfg, bert=ce.cfg.bert.replace(**knobs)))
        return share_parameters(view, ce)

    # the first reranker step's gradients: K9-K11, their plain versions,
    # and ffn_impl="xla", from the same weights (no update in between)
    ops.reset_launches()
    loss_k, grad_k = _flat_gradients(torch, steps, ce, b0)
    first = ops.launches()
    check(all(first[name] == CE_LAYERS for name in FFN_KERNELS[:3]),
          f"one reranker forward and backward launched {first}")
    kernels = pf.ffn_train_fwd, pf.ffn_bwd_dx, pf.ffn_bwd_dw
    pf.ffn_train_fwd = pf._ffn_train_fwd_plain
    pf.ffn_bwd_dx = pf._ffn_bwd_dx_plain
    pf.ffn_bwd_dw = pf._ffn_bwd_dw_plain
    try:
        loss_p, grad_p = _flat_gradients(torch, steps, ce, b0)
    finally:
        pf.ffn_train_fwd, pf.ffn_bwd_dx, pf.ffn_bwd_dw = kernels
    loss_x, grad_x = _flat_gradients(torch, steps, view_of(ffn_impl="xla"),
                                     b0)
    grad_cos = _cosine(torch, grad_k, grad_p)
    cos_kx = _cosine(torch, grad_k, grad_x)
    cos_px = _cosine(torch, grad_p, grad_x)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    del grad_k, grad_p, grad_x
    # bf16 activations through 24 random-weight layers: one flipped bf16
    # rounding moves the roundings downstream, and the gradients of two
    # equally exact versions of this step part at a cosine of ~0.994
    # (phase 5). Here the plain versions against ffn_impl="xla" are such a
    # pair, measured in this run: the kernels must sit on that floor against
    # their plain versions, and no further from "xla" than those do.
    check(loss_rel <= 1e-2 and grad_cos >= cos_px - 0.002
          and cos_kx >= cos_px - 0.002,
          f"reranker step, K9-K11 vs plain: loss rel {loss_rel}, gradient "
          f"cosine {grad_cos}; against xla {cos_kx} (plain: {cos_px})")

    # the main path: launch counts zeroed just before each kind of step
    view = int8_view(ce)
    tx_de = make_adamw(1e-5, total_steps=0)
    tx_ce = make_adamw(1e-6, total_steps=0)
    de_state = TrainState.create(de, tx_de)
    ce_state = TrainState.create(ce, tx_ce)
    kinds = {"biencoder": make_biencoder_step(tx_de),
             "reranker": make_reranker_step(tx_ce),
             "retriever": make_ar2_retriever_step(tx_de, temperature=1.0,
                                                  adv_lambda=0.0)}
    step_ms, losses, peak_gb, resident_gb, launches = {}, {}, {}, {}, {}
    for kind, step in kinds.items():
        ops.reset_launches()
        torch.cuda.synchronize()
        ms, loss, peak, resident, de_state, ce_state = _run_steps(
            torch, {kind: step}, batches, de_state, ce_state, view)
        resident_gb.update(resident)
        launches[kind] = {k: v for k, v in ops.launches().items() if v}
        step_ms.update(ms)
        losses.update(loss)
        peak_gb.update(peak)
    per_step = {"biencoder": 24, "reranker": CE_LAYERS, "retriever": 24}
    for kind, n in per_step.items():
        got = [launches[kind].get(name, 0) for name in FFN_KERNELS[:3]]
        check(got == [3 * n] * 3, f"{kind}: 3 steps launched K9, K10, K11 "
              f"{got} times, not {3 * n} each")
    check(all(math.isfinite(x) for v in losses.values() for x in v),
          f"non-finite loss: {losses}")
    traces = {
        "biencoder": _trace(torch, [lambda: kinds["biencoder"](
            de_state, batches[0])], "step"),
        "reranker": _trace(torch, [lambda: kinds["reranker"](
            ce_state, batches[0])], "step"),
        "retriever": _trace(torch, [lambda: kinds["retriever"](
            de_state, view, batches[0])], "step")}

    # remat: one reranker forward and backward that recomputes each layer,
    # against the same one that does not (same weights, no update)
    def measured(model):
        torch.cuda.synchronize()
        fresh_peak(torch)
        ops.reset_launches()
        t0 = time.perf_counter()
        loss, flat = _flat_gradients(torch, steps, model, b0)
        torch.cuda.synchronize()
        return dict(loss=loss, ms=(time.perf_counter() - t0) * 1e3,
                    max_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                    launches={k: v for k, v in ops.launches().items()
                              if v}), flat

    remat_view = view_of(remat=True)
    measured(remat_view)                       # warm
    off, grad_off = measured(ce)
    on, grad_on = measured(remat_view)
    remat_cos = _cosine(torch, grad_off, grad_on)
    remat_err = float((grad_off - grad_on).abs().max()
                      / grad_off.abs().max())
    del grad_off, grad_on
    # the recomputed forward repeats the kernels on the same inputs, so the
    # loss is equal; the embedding gradients add with atomics in an order
    # that changes from run to run
    check(on["loss"] == off["loss"] and remat_cos >= 0.999999
          and remat_err <= 1e-3,
          f"remat: loss {on['loss']} vs {off['loss']}, gradient cosine "
          f"{remat_cos}, err {remat_err} of the largest")
    check(on["launches"].get("ffn_train_fwd") == 2 * CE_LAYERS
          and on["launches"].get("ffn_bwd_dx") == CE_LAYERS
          and on["launches"].get("ffn_bwd_dw") == CE_LAYERS
          and off["launches"].get("ffn_train_fwd") == CE_LAYERS,
          f"remat launches: {on['launches']} (without: {off['launches']})")

    steady = {kind: float(np.mean(ms[1:])) for kind, ms in step_ms.items()}
    emit("ffn_training", nvidia_smi=smi, model_init_s=init_s,
         ffn_impl="fused_vjp", step_ms=step_ms, steady_step_ms=steady,
         steady_step_ms_xla=xla["steady_step_ms"], losses=losses,
         max_memory_gb_by_kind=peak_gb, resident_gb_by_kind=resident_gb,
         max_memory_gb_by_kind_xla=xla["max_memory_gb_by_kind"],
         reranker_kernel_vs_plain={
             "loss_kernel": loss_k, "loss_plain": loss_p, "loss_xla": loss_x,
             "loss_rel": loss_rel, "gradient_cosine": grad_cos,
             "gradient_cosine_kernel_vs_xla": cos_kx,
             "gradient_cosine_plain_vs_xla": cos_px},
         launches_first_forward_backward={k: v for k, v in first.items()
                                          if v},
         launches_by_kind=launches, step_traces=traces,
         remat={"off": off, "on": on, "gradient_cosine": remat_cos,
                "gradient_err_of_largest": remat_err})
    total = {}
    for by_name in launches.values():
        for name, n in by_name.items():
            total[name] = total.get(name, 0) + n
    for name, rec in records.items():
        rec.setdefault("launches_by_path", {})["ffn_training"] = total.get(
            name, 0)


def phase_ffn_encode(torch, smi, records):
    """Phase 10: the serving path with ``ffn_impl="fused"``: a full-width
    BERT-base dual encoder in bf16 on the library's projections, the plain
    attention and K12."""
    import numpy as np

    from simxns_tpu_torch import ops
    from simxns_tpu_torch.data import HashTokenizer
    from simxns_tpu_torch.models import BertConfig, BiEncoder, BiEncoderConfig
    from simxns_tpu_torch.ops import fused_ffn as pf
    from simxns_tpu_torch.serve import DenseRetriever

    dev = torch.device("cuda")
    fresh_peak(torch)
    model = BiEncoder(BiEncoderConfig(bert=BertConfig(
        vocab_size=30522, hidden_size=H, num_layers=12, num_heads=HEADS,
        intermediate_size=F, dtype=torch.bfloat16, ffn_impl="fused")),
        generator=torch.Generator().manual_seed(0))
    tok = HashTokenizer(vocab_size=30522)
    n_pass, chunk, n_req = 16384, 1024, 8
    passages = _synthetic_passages(n_pass)
    retriever = DenseRetriever(model, tok, max_q_length=LQ,
                               max_ctx_length=LC, index_mode="fused",
                               store_dtype=torch.int8, query_batch=8,
                               encode_chunk=chunk)
    ids, mask = retriever._tokenize([passages[i][1] for i in range(n_pass)],
                                    [passages[i][0] for i in range(n_pass)],
                                    LC)
    rng = np.random.default_rng(2)
    picks = rng.integers(0, n_pass, n_req * 8)
    requests = [[" ".join(passages[int(i)][0].split()[:12])
                 for i in picks[r * 8:(r + 1) * 8]] for r in range(n_req)]
    # warm: the first call of a process pays cuBLAS's set-up
    with torch.inference_mode():
        model.encode_passage(torch.from_numpy(ids[:chunk]).to(dev),
                             torch.from_numpy(mask[:chunk]).to(dev))

    # the main path: launch counts zeroed just before, read just after
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    retriever.index_corpus(passages, precomputed_tokens=ids)
    torch.cuda.synchronize()
    index_s = time.perf_counter() - t0
    indexed = ops.launches()
    latencies, answers = [], []
    for req in requests:
        t0 = time.perf_counter()
        answers.append(retriever.search(req, k=10))
        latencies.append((time.perf_counter() - t0) * 1e3)
    launches = ops.launches()
    layers = model.cfg.bert.num_layers
    check(indexed["ffn_fused_fwd"] == layers * (n_pass // chunk),
          f"indexing {n_pass // chunk} chunks launched K12 "
          f"{indexed['ffn_fused_fwd']} times, not {layers} per chunk")
    check(launches["ffn_fused_fwd"] == layers * (n_pass // chunk + n_req),
          f"K12 launches after {n_req} requests: {launches['ffn_fused_fwd']}")
    for hits in answers:
        for q_hits in hits:
            scores = [h.score for h in q_hits]
            check(len(q_hits) == 10 and all(math.isfinite(s) for s in scores)
                  and all(0 <= h.passage_id < n_pass for h in q_hits)
                  and scores == sorted(scores, reverse=True),
                  "malformed search result")

    # the same model on K12's plain version
    enc_ids = torch.from_numpy(ids[:chunk]).to(dev)
    enc_mask = torch.from_numpy(mask[:chunk]).to(dev)
    kernel = pf.ffn_fused_fwd
    with torch.inference_mode():
        kern = model.encode_passage(enc_ids, enc_mask).float()
        pf.ffn_fused_fwd = lambda *a: pf._ffn_train_fwd_plain(*a)[0]
        try:
            plain = model.encode_passage(enc_ids, enc_mask).float()
        finally:
            pf.ffn_fused_fwd = kernel
    cos = torch.nn.functional.cosine_similarity(kern, plain, dim=1)
    check(bool(torch.isfinite(kern).all()) and kern.shape == (chunk, H),
          "passage embeddings: shape or non-finite values")
    # bf16 through 12 layers: a rounding that lands on the other side moves
    # the roundings downstream (the serving path's floor is 0.9997)
    check(float(cos.min()) >= 0.995,
          f"passage embeddings, K12 vs plain: min cosine {float(cos.min())}")
    lat = np.array(latencies)
    emit("ffn_encode", nvidia_smi=smi, ffn_impl="fused", passages=n_pass,
         index_corpus_s=index_s, passages_per_s=n_pass / index_s,
         requests=n_req, queries_per_request=8,
         request_ms_p50=float(np.percentile(lat, 50)), request_ms=latencies,
         launches={k: v for k, v in launches.items() if v},
         min_cosine_kernel_vs_plain=float(cos.min()),
         max_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    for name, rec in records.items():
        rec.setdefault("launches_by_path", {})["ffn_encode"] = launches.get(
            name, 0)
        rec["launches"] = sum(rec["launches_by_path"].values())


def _int8_close(torch, got, want, what):
    """K13/K14 against their plain versions: the same codes, integer sums
    and f32 operations in the same order, so bitwise is expected. The rule
    allows a code of g one step off (an ulp of GELU's exp across a
    rounding), which moves its row's outputs by at most gs * 127 * s2 =
    max|g| max|w2| / 127, below one bf16 step of the largest |y|: every
    element within 2^-7 max|y|, at most 1e-3 of them different.
    -> (max_abs_err, elements that differ)."""
    d = (got.float() - want.float()).abs()
    err, differ = float(d.max()), int((d > 0).sum())
    tol = 2.0 ** -7 * float(want.float().abs().max())
    check(err <= tol and differ <= 1e-3 * d.numel(),
          f"{what}: max err {err} (tolerance {tol}), {differ} of "
          f"{d.numel()} elements differ")
    return err, differ


def _check_int8_ffn_shape(torch, randn, label, m):
    """K14 at (m, H, F) against its plain version, with its time, the plain
    version's, the bound, the library's int8 chain (``_int_mm`` -> epilogue
    + GELU -> ``quant_rows`` -> ``_int_mm`` -> epilogue, on codes of x made
    beforehand) and bf16 chain (``F.linear`` -> ``F.gelu`` -> ``F.linear``),
    and the port's K2 -> K1 composition of the same function (timed only;
    compared as a note)."""
    from simxns_tpu_torch.ops import fused_ffn as pf
    from simxns_tpu_torch.ops import fused_layer as fl

    bf = torch.bfloat16
    x = randn(m, H).to(bf)
    w1, b1 = randn(F, H, scale=0.02), randn(F, scale=0.02)
    w2, b2 = randn(H, F, scale=0.02), randn(H, scale=0.02)
    (w1_8, s1), (w2_8, s2) = pf.quantize_weight(w1), pf.quantize_weight(w2)
    args = (x, w1_8, s1, b1, w2_8, s2, b2)
    got = pf.int8_ffn_fwd(*args)
    want = pf._int8_ffn_plain(*args)
    err, differ = _int8_close(torch, got, want, f"int8_ffn at {label}")
    ms = timed(torch, lambda: pf.int8_ffn_fwd(*args), 5)
    plain = timed(torch, lambda: pf._int8_ffn_plain(*args), 1, warmup=0)
    xq, xs = pf.quant_rows(x)
    w1t, w2t = w1_8.t(), w2_8.t()

    def library_int8():
        h = torch._int_mm(xq, w1t).float() * xs[:, None] * s1 + b1
        gq, gs = pf.quant_rows(torch.nn.functional.gelu(h))
        return (torch._int_mm(gq, w2t).float() * gs[:, None] * s2
                + b2).to(bf)

    lin = torch.nn.functional.linear
    w1b, b1b, w2b, b2b = (t.to(bf) for t in (w1, b1, w2, b2))
    lib = timed(torch, library_int8, 5)
    lib_bf16 = timed(torch, lambda: lin(torch.nn.functional.gelu(
        lin(x, w1b, b1b)), w2b, b2b), 5)

    def composition():
        a8, a_s, _, _ = fl.row_quant(x)
        mid = fl.int8_linear(a8, a_s, w1_8, s1, b1, gelu=True)
        g8, g_s, _, _ = fl.row_quant(mid)
        return fl.int8_linear(g8, g_s, w2_8, s2, b2, out_dtype=bf)

    comp_diff = int((composition() != got).sum())
    comp = timed(torch, composition, 3)
    bms, by = bound(2 * 2 * m * H + 2 * H * F + 4 * 2 * (H + F),
                    4.0 * m * H * F, PEAK_INT8)
    return dict(shape=label, m=m, h=H, f=F, ms=ms, plain_ms=plain,
                library_ms=lib, library_bf16_ms=lib_bf16, bound_ms=bms,
                bound_by=by, k2_k1_composition_ms=comp,
                k2_k1_composition_elements_differing=comp_diff,
                max_abs_err=err, elements_differing=differ)


def _check_int8_dense_shape(torch, randn, label, m, o):
    """K13 at (m, H, o) against its plain version, with its time, the plain
    version's, the bound, ``_int_mm`` on codes of x made beforehand plus
    the dequantize epilogue in PyTorch (the library yardstick, as K1's),
    and the port's K2 -> K1 composition of the same function."""
    from simxns_tpu_torch.ops import fused_ffn as pf
    from simxns_tpu_torch.ops import fused_layer as fl

    bf = torch.bfloat16
    x = randn(m, H).to(bf)
    w, b = randn(o, H, scale=0.02), randn(o, scale=0.02)
    w8, ws = pf.quantize_weight(w)
    got = pf.int8_dense_fwd(x, w8, ws, b)
    want = pf._int8_dense_plain(x, w8, ws, b)
    err, differ = _int8_close(torch, got, want, f"int8_dense at {label}")
    ms = timed(torch, lambda: pf.int8_dense_fwd(x, w8, ws, b), 10)
    plain = timed(torch, lambda: pf._int8_dense_plain(x, w8, ws, b), 2)
    xq, xs = pf.quant_rows(x)
    wt = w8.t()
    lib = timed(torch, lambda: (torch._int_mm(xq, wt).float() * xs[:, None]
                                * ws + b).to(bf), 5)

    def composition():
        a8, a_s, _, _ = fl.row_quant(x)
        return fl.int8_linear(a8, a_s, w8, ws, b, out_dtype=bf)

    comp_diff = int((composition() != got).sum())
    comp = timed(torch, composition, 5)
    bms, by = bound(2 * m * H + H * o + 4 * 2 * o + 2 * m * o,
                    2.0 * m * H * o, PEAK_INT8)
    return dict(shape=label, m=m, i=H, o=o, ms=ms, plain_ms=plain,
                library_ms=lib, bound_ms=bms, bound_by=by,
                k2_k1_composition_ms=comp,
                k2_k1_composition_elements_differing=comp_diff,
                max_abs_err=err, elements_differing=differ)


def phase_int8_kernels(torch, smi, records):
    """Phase 11: K14 ``int8_ffn`` at an encode chunk (131,072 rows), a
    request (256) and a ragged M (4,000), K13 ``int8_dense`` at the chunk's
    q, k, v (O = 2304) and output projection (O = 768) and a request's
    q, k, v; then the public ``int8_ffn`` at a shape that does not tile,
    which is ``ffn_reference`` and launches nothing. The records are the
    chunk's (K13: its q, k, v)."""
    from simxns_tpu_torch.ops import fused_ffn as pf

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    torch.cuda.empty_cache()

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, device=dev, generator=gen) * scale

    shapes = {"int8_ffn": [], "int8_dense": []}
    for label, m in (("encode_chunk", 131072), ("request", 256),
                     ("ragged", 4000)):
        shapes["int8_ffn"].append(_check_int8_ffn_shape(torch, randn, label,
                                                        m))
        emit("kernel_shape", name="int8_ffn", nvidia_smi=smi,
             **shapes["int8_ffn"][-1])
        torch.cuda.empty_cache()
    for label, m, o in (("encode_chunk_qkv", 131072, 3 * H),
                        ("encode_chunk_output", 131072, H),
                        ("request_qkv", 256, 3 * H)):
        shapes["int8_dense"].append(_check_int8_dense_shape(
            torch, randn, label, m, o))
        emit("kernel_shape", name="int8_dense", nvidia_smi=smi,
             **shapes["int8_dense"][-1])
        torch.cuda.empty_cache()

    # the JAX rule on the card: 40 rows do not tile, so int8_ffn is the
    # unquantized composition and K14 does not launch
    x = randn(40, H).to(torch.bfloat16)
    w = (randn(F, H, scale=0.02), randn(F, scale=0.02),
         randn(H, F, scale=0.02), randn(H, scale=0.02))
    before = pf.int8_ffn_fwd.launches
    check(torch.equal(pf.int8_ffn(x, *w), pf.ffn_reference(x, *w))
          and pf.int8_ffn_fwd.launches == before,
          "int8_ffn at 40 rows: not ffn_reference, or K14 launched")
    library = {
        "int8_ffn": "torch._int_mm on codes of x made beforehand -> "
                    "epilogue + F.gelu -> quant_rows -> _int_mm -> epilogue; "
                    "library_bf16_ms: F.linear -> F.gelu -> F.linear in bf16",
        "int8_dense": "torch._int_mm on codes of x made beforehand + the "
                      "dequantize epilogue in PyTorch"}
    for name, recs in shapes.items():
        rec = {k: v for k, v in recs[0].items() if k not in ("m", "h", "f",
                                                               "i", "o")}
        rec.update(shape=[recs[0]["m"], H, recs[0].get("f", recs[0].get("o"))],
                   max_abs_err=max(r["max_abs_err"] for r in recs),
                   elements_differing=sum(r["elements_differing"]
                                          for r in recs),
                   shapes=recs, library=library[name],
                   tolerance="bitwise expected; allowed: a code of g one "
                             "step off, every element within 2^-7 max|y| "
                             "and at most 1e-3 of them different")
        records[name] = rec
        emit("kernel", name=name, nvidia_smi=smi,
             **{k: v for k, v in rec.items() if k != "shapes"})
    emit("int8_dispatch", nvidia_smi=smi, rows=40,
         int8_ffn_equals_ffn_reference=True, k14_launched=False)


def phase_int8_encode(torch, smi, records):
    """Phase 12: the serving path under the int8 knobs of
    ``scripts/bench_r2.py:220-231``: a full-width BERT-base dual encoder in
    bf16 (``layer_impl="xla"``) behind a DenseRetriever with
    ``ffn_impl="int8"`` (K14), then with ``proj_impl="int8"`` too (K13 for
    q, k, v as one call and for the output projection), over the same
    weights. Each indexes 16,384 passages and answers 8 requests."""
    import dataclasses

    import numpy as np

    from simxns_tpu_torch import ops
    from simxns_tpu_torch.data import HashTokenizer
    from simxns_tpu_torch.models import BertConfig, BiEncoder, BiEncoderConfig
    from simxns_tpu_torch.models.bert import BertLayer, share_parameters
    from simxns_tpu_torch.ops import fused_ffn as pf
    from simxns_tpu_torch.serve import DenseRetriever

    dev = torch.device("cuda")
    fresh_peak(torch)
    model = BiEncoder(BiEncoderConfig(bert=BertConfig(
        vocab_size=30522, hidden_size=H, num_layers=12, num_heads=HEADS,
        intermediate_size=F, dtype=torch.bfloat16, ffn_impl="int8")),
        generator=torch.Generator().manual_seed(0)).to(dev).eval()

    def view_of(**knobs):
        with torch.device("meta"):
            view = BiEncoder(dataclasses.replace(
                model.cfg, bert=model.cfg.bert.replace(**knobs)))
        return share_parameters(view, model).eval()

    tok = HashTokenizer(vocab_size=30522)
    n_pass, chunk, n_req = 16384, 1024, 8
    layers = model.cfg.bert.num_layers
    passages = _synthetic_passages(n_pass)
    rng = np.random.default_rng(2)
    picks = rng.integers(0, n_pass, n_req * 8)
    requests = [[" ".join(passages[int(i)][0].split()[:12])
                 for i in picks[r * 8:(r + 1) * 8]] for r in range(n_req)]
    xla = view_of(ffn_impl="xla")
    ids = mask = None
    for label, encoder, per_layer in (
            ("ffn_int8", model, {"int8_ffn": 1}),
            ("ffn_proj_int8", view_of(proj_impl="int8"),
             {"int8_ffn": 1, "int8_dense": 2})):
        fresh_peak(torch)
        retriever = DenseRetriever(encoder, tok, max_q_length=LQ,
                                   max_ctx_length=LC, index_mode="fused",
                                   store_dtype=torch.int8, query_batch=8,
                                   encode_chunk=chunk)
        if ids is None:
            ids, mask = retriever._tokenize(
                [passages[i][1] for i in range(n_pass)],
                [passages[i][0] for i in range(n_pass)], LC)
        enc_ids = torch.from_numpy(ids[:chunk]).to(dev)
        enc_mask = torch.from_numpy(mask[:chunk]).to(dev)
        with torch.inference_mode():          # warm; quantizes the weights
            encoder.encode_passage(enc_ids, enc_mask)

        # the main path: launch counts zeroed just before, read just after
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        retriever.index_corpus(passages, precomputed_tokens=ids)
        torch.cuda.synchronize()
        index_s = time.perf_counter() - t0
        indexed = ops.launches()
        latencies, answers = [], []
        for req in requests:
            t0 = time.perf_counter()
            answers.append(retriever.search(req, k=10))
            latencies.append((time.perf_counter() - t0) * 1e3)
        launches = ops.launches()
        # what the layers' cache of int8 weights saves a request: the same
        # requests with the weights quantized again at every call, as the
        # JAX package does (simxns_tpu/ops/fused_ffn.py:193-194, 252)
        quantizing = []
        for req in requests[:4]:
            for layer in encoder.modules():
                if isinstance(layer, BertLayer):
                    layer.drop_quantized()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            retriever.search(req, k=10)
            quantizing.append((time.perf_counter() - t0) * 1e3)
        for name, n in per_layer.items():
            check(indexed[name] == n * layers * (n_pass // chunk)
                  and launches[name] == n * layers * (n_pass // chunk
                                                      + n_req),
                  f"{label}: {name} launched {indexed[name]} times over "
                  f"{n_pass // chunk} chunks and {launches[name]} after "
                  f"{n_req} requests, not {n * layers} per chunk and "
                  f"request")
        check(launches["int8_dense"] == 0 or "int8_dense" in per_layer,
              f"{label}: K13 launched without proj_impl='int8'")
        check(launches["mips_bucket_candidates"] > 0,
              f"{label}: K4 never launched")
        for hits in answers:
            for q_hits in hits:
                scores = [h.score for h in q_hits]
                check(len(q_hits) == 10
                      and all(math.isfinite(s) for s in scores)
                      and all(0 <= h.passage_id < n_pass for h in q_hits)
                      and scores == sorted(scores, reverse=True),
                      f"{label}: malformed search result")

        # one chunk on the plain versions, and under ffn_impl="xla"
        kernels = pf.int8_ffn_fwd, pf.int8_dense_fwd
        with torch.inference_mode():
            kern = encoder.encode_passage(enc_ids, enc_mask).float()
            pf.int8_ffn_fwd, pf.int8_dense_fwd = (pf._int8_ffn_plain,
                                                  pf._int8_dense_plain)
            try:
                plain = encoder.encode_passage(enc_ids, enc_mask).float()
            finally:
                pf.int8_ffn_fwd, pf.int8_dense_fwd = kernels
            ref = xla.encode_passage(enc_ids, enc_mask).float()
        check(bool(torch.isfinite(kern).all()) and kern.shape == (chunk, H),
              f"{label}: passage embeddings: shape or non-finite values")
        cos = torch.nn.functional.cosine_similarity(kern, plain, dim=1)
        cos_xla = torch.nn.functional.cosine_similarity(kern, ref, dim=1)
        # expected bitwise; a code one step off moves the bf16 roundings
        # downstream, and the serving path's floor is 0.995
        check(float(cos.min()) >= 0.995,
              f"{label}: embeddings, kernels vs plain: min cosine "
              f"{float(cos.min())}")
        lat = np.array(latencies)
        emit("int8_encode", nvidia_smi=smi, config=label,
             ffn_impl="int8", proj_impl=encoder.cfg.bert.proj_impl,
             passages=n_pass, index_corpus_s=index_s,
             passages_per_s=n_pass / index_s, requests=n_req,
             queries_per_request=8,
             request_ms_p50=float(np.percentile(lat, 50)),
             request_ms=latencies,
             request_ms_p50_quantizing_weights_per_call=float(
                 np.median(quantizing)),
             launches={k: v for k, v in launches.items() if v},
             embeddings_equal_kernel_vs_plain=bool(torch.equal(kern, plain)),
             embedding_elements_differing=int((kern != plain).sum()),
             max_abs_err_kernel_vs_plain=float((kern - plain).abs().max()),
             min_cosine_kernel_vs_plain=float(cos.min()),
             min_cosine_vs_xla=float(cos_xla.min()),
             mean_cosine_vs_xla=float(cos_xla.mean()),
             max_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
        for name, rec in records.items():
            rec.setdefault("launches_by_path", {})[
                f"int8_encode_{label}"] = launches.get(name, 0)
            rec["launches"] = sum(rec["launches_by_path"].values())
        del retriever, kern, plain, ref


SOURCES = {
    "int8_linear": ("cuda", "simxns_tpu_torch/csrc/int8_linear.cu",
                    "simxns_tpu/ops/fused_layer.py:87"),
    "row_quant": ("triton", "simxns_tpu_torch/ops/fused_layer.py",
                  "simxns_tpu/ops/fused_layer.py:87"),
    "small_s_attention": ("cuda", "simxns_tpu_torch/csrc/small_s_attention.cu",
                          "simxns_tpu/ops/fused_layer.py:87"),
    "mips_bucket_candidates": ("cuda",
                               "simxns_tpu_torch/csrc/mips_candidates.cu",
                               "simxns_tpu/ops/mips_kernel.py:181"),
    "group_attention_fwd": ("cuda", "simxns_tpu_torch/csrc/group_attention.cu",
                            "simxns_tpu/ops/flash_attention.py:113"),
    "group_attention_bwd": ("cuda", "simxns_tpu_torch/csrc/group_attention.cu",
                            "simxns_tpu/ops/flash_attention.py:125"),
    "bh_attention_fwd": ("cuda", "simxns_tpu_torch/csrc/bh_attention.cu",
                         "simxns_tpu/ops/flash_attention.py:67"),
    "bh_attention_bwd": ("cuda", "simxns_tpu_torch/csrc/bh_attention.cu",
                         "simxns_tpu/ops/flash_attention.py:80"),
    "ffn_train_fwd": ("cuda", "simxns_tpu_torch/csrc/fused_ffn.cu",
                      "simxns_tpu/ops/fused_ffn.py:324"),
    "ffn_bwd_dx": ("cuda", "simxns_tpu_torch/csrc/fused_ffn.cu",
                   "simxns_tpu/ops/fused_ffn.py:348"),
    "ffn_bwd_dw": ("cuda", "simxns_tpu_torch/csrc/fused_ffn.cu",
                   "simxns_tpu/ops/fused_ffn.py:374"),
    "ffn_fused_fwd": ("cuda", "simxns_tpu_torch/csrc/fused_ffn.cu",
                      "simxns_tpu/ops/fused_ffn.py:77"),
    "int8_dense": ("cuda", "simxns_tpu_torch/csrc/int8_ffn.cu",
                   "simxns_tpu/ops/fused_ffn.py:222"),
    "int8_ffn": ("cuda", "simxns_tpu_torch/csrc/int8_ffn.cu",
                 "simxns_tpu/ops/fused_ffn.py:160"),
}


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "runs on a CUDA card", file=sys.stderr)
        return 2
    try:
        import simxns_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run from the root of the repository "
              "(simxns_tpu_torch is not importable)", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    smi = phase_device(torch)
    records = phase_kernels(torch, smi)
    phase_end_to_end(torch, smi, records)
    phase_train_kernels(torch, smi, records)
    xla = phase_training(torch, smi, records)
    phase_msdoc_kernels(torch, smi, records)
    phase_co_training(torch, smi, records)
    phase_ffn_kernels(torch, smi, records)
    phase_ffn_training(torch, smi, records, xla)
    phase_ffn_encode(torch, smi, records)
    phase_int8_kernels(torch, smi, records)
    phase_int8_encode(torch, smi, records)
    kernels = []
    for name, rec in records.items():
        route, source, replaces = SOURCES[name]
        kernels.append({"name": name, "route": route, "source": source,
                        "replaces": replaces, **rec})
    emit("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
