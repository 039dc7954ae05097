#!/usr/bin/env python3
"""Build the port's kernels, check them, and serve requests on one GPU.

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
   tensor-core peak, whichever is larger); then one whole layer composed of
   the kernels against the plain composition;
3. end to end: a full-width BERT-base dual encoder (12 layers, random
   weights from seed 0, layer_impl="fused_int8") behind a DenseRetriever
   with an int8 index in fused mode indexes 65,536 synthetic passages and
   answers 32 requests of 8 queries (k=10); then a bf16 index in fused mode
   answers 8 more. The kernel path is held against the plain path, and the
   launch counts of every kernel, zeroed just before, must have risen;
4. the ``kernels`` line; then the last line,
   ``{"ok": true, "device": {...}}``.
"""

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


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def phase_device(torch):
    from simxns_tpu_torch.ops import _native

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
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


def phase_kernels(torch, smi):
    """Phase 2. Returns the kernel records (launches filled in later)."""
    from simxns_tpu_torch.ops import fused_layer as fl
    from simxns_tpu_torch.ops import mips_kernel as mk
    from simxns_tpu_torch.ops.fused_ffn import quant_rows

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, device=dev, generator=gen) * scale

    records = {}

    # --- K1 int8_linear: the four GEMMs of a layer, 1024 x 128 tokens -----
    m = 1024 * 128
    shapes = [("qkv", 3 * H, H, False, torch.bfloat16),
              ("out", H, H, False, torch.float32),
              ("ffn_in", F, H, True, torch.float32),
              ("ffn_out", H, F, False, torch.float32)]
    rec = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
               max_abs_err=0.0, shapes=[])
    ops_total = bytes_total = 0.0
    for name, n, k, gelu, od in shapes:
        a8, xs = quant_rows(randn(m, k))
        w8, ws = quant_rows(randn(n, k, scale=0.02))
        b = randn(n, scale=0.02)
        got = fl.int8_linear(a8, xs, w8, ws, b, gelu=gelu, out_dtype=od)
        want = fl._int8_linear_plain(a8, xs, w8, ws, b, gelu, od)
        err = float((got.float() - want.float()).abs().max())
        ref = float(want.float().abs().max())
        check(err <= 1e-6 * ref, f"int8_linear {name}: err {err} > 1e-6*{ref}")
        ms = timed(torch, lambda: fl.int8_linear(a8, xs, w8, ws, b, gelu=gelu,
                                                 out_dtype=od), 10)
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
                                  plain_ms=plain, library_ms=lib,
                                  bound_ms=bms, bound_by=by, max_abs_err=err))
        for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                         ("bound_ms", bms)):
            rec[key] += val
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        del a8, w8, got, want
    rec["bound_by"] = bound(bytes_total, ops_total, PEAK_INT8)[1]
    rec["tolerance"] = "1e-6 x max|y| (identical integer sums and f32 ops)"
    records["int8_linear"] = rec
    emit("kernel", name="int8_linear", nvidia_smi=smi, **rec)

    # --- K2 row_quant: the five row passes of a layer ---------------------
    x16 = randn(m, H).to(torch.bfloat16)
    ctx = randn(m, H)
    attn = randn(m, H)
    mid = randn(m, F)
    ffn = randn(m, H)
    ln = (1.0 + randn(H, scale=0.1), randn(H, scale=0.1))
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
    records["row_quant"] = rec
    emit("kernel", name="row_quant", nvidia_smi=smi, **rec)
    del x16, ctx, attn, mid, ffn, y1

    # --- K3 small_s_attention: passages 1024 x 128, queries 8 x 32 --------
    rec = dict(shapes=[])
    for b, s in ((1024, 128), (8, 32)):
        qkv = randn(b * s, 3 * H).to(torch.bfloat16)
        mask = torch.ones(b, s, dtype=torch.int32, device=dev)
        lens = torch.randint(8, s + 1, (b,), device=dev, generator=gen)
        mask[torch.arange(s, device=dev)[None, :] >= lens[:, None]] = 0
        got = fl.small_s_attention(qkv, mask, HEADS)
        want = fl._small_s_attention_plain(qkv, mask, HEADS)
        err = float((got - want).abs().max())
        # p is rounded to bf16 on both sides; exp and the row sum taken in
        # another order can move a p across a rounding boundary, by one
        # bf16 step (<= 2^-7 p). Even if every p of a row moved, the
        # context moves by <= 2^-7 * sum(p |v|) <= 2^-7 max|v|.
        tol = 2.0 ** -7 * float(qkv[:, 2 * H:].float().abs().max())
        check(err <= tol, f"small_s_attention {b}x{s}: err {err} > {tol}")
        ms = timed(torch, lambda: fl.small_s_attention(qkv, mask, HEADS), 10)
        plain = timed(torch, lambda: fl._small_s_attention_plain(
            qkv, mask, HEADS), 3)
        q, k, v = (t.transpose(1, 2).contiguous() for t in
                   qkv.view(b, s, 3, HEADS, H // HEADS).unbind(2))
        bias = torch.where(mask > 0, 0.0, -1e9)[:, None, None, :].to(
            torch.bfloat16)
        lib = timed(torch, lambda: torch.nn.functional
                    .scaled_dot_product_attention(q, k, v, attn_mask=bias), 10)
        moved = qkv.numel() * 2 + mask.numel() * 4 + got.numel() * 4
        bms, by = bound(moved, 4.0 * b * HEADS * s * s * (H // HEADS),
                        PEAK_BF16)
        rec["shapes"].append(dict(batch=b, seq=s, ms=ms, plain_ms=plain,
                                  library_ms=lib, bound_ms=bms, bound_by=by,
                                  max_abs_err=err, tolerance=tol))
    main = rec["shapes"][0]
    rec.update({key: main[key] for key in ("ms", "plain_ms", "library_ms",
                                           "bound_ms", "bound_by")})
    rec["max_abs_err"] = max(sh["max_abs_err"] for sh in rec["shapes"])
    rec["tolerance"] = "2^-7 x max|v| on the f32 context (one bf16 step of p)"
    records["small_s_attention"] = rec
    emit("kernel", name="small_s_attention", nvidia_smi=smi, **rec)
    del qkv, q, k, v

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
                                 top10_overlap=overlap))
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
    for name, count in launches.items():
        check(count > 0, f"{name} was not launched on the serving path")
    request_trace = _trace_requests(torch, retriever, requests[:8])

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


def _trace_requests(torch, retriever, requests):
    """Requests again under torch.profiler: device time by kernel, and the
    share of the wall time the device was idle (its busy time is the sum
    of kernel and copy times, which do not overlap on one stream)."""
    from torch.profiler import ProfilerActivity, profile

    retriever.search(requests[0], k=10)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for req in requests:
            retriever.search(req, k=10)
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
    return dict(requests=len(requests), wall_ms_per_request=wall_us / 1e3
                / len(requests), device_busy_ms_per_request=busy_us / 1e3
                / len(requests), device_idle_share=1.0 - busy_us / wall_us,
                top_device_ms_per_request=[
                    (name, us / 1e3 / len(requests), n // len(requests))
                    for name, (us, n) in top])


def _plain_encode(encoder, ids, mask, layer_plain):
    """The encoder with every layer's plain composition (CLS pooling)."""
    x = encoder.embeddings(ids)
    for layer in encoder.layers:
        x = layer_plain(x.to(encoder.cfg.dtype), mask, layer.quantized(),
                        num_heads=encoder.cfg.num_heads,
                        layer_norm_eps=encoder.cfg.layer_norm_eps)
    return x[:, 0]


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
