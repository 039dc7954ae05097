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
   phases 4 and 6), K4, K5 (phase 4) and K7 (phase 6) also with their
   device time per call from the profiler (at a request's shape the
   CUDA-event time is the host's launch rate); beside K4, the search's
   last step over its candidates: the stable ``_finalize`` (equal scores
   in column order, as ``jax.lax.top_k``) and ``torch.topk`` alone; then
   K4 where the port once refused what JAX computes: 8,000 rows at the
   launcher's block for them (2,000, not a multiple of 128), k=100, int8
   and bf16, and through ``blocked_mips_topk(mode="fused")`` against the
   same call on the CPU, and ``bucket=100`` (the kernel at gcd(100, 128));
3. end to end: a full-width BERT-base dual encoder (12 layers, random
   weights from seed 0, layer_impl="fused_int8") behind a DenseRetriever
   with an int8 index in fused mode indexes 65,536 synthetic passages and
   answers 32 requests of 8 queries (k=10); then a bf16 index in fused mode
   answers 8 more. The kernel path is held against the plain path, and the
   launch counts of every kernel, zeroed just before, must have risen;
4. the training kernels: K5/K6 (the grouped attention pair of the CE-large
   reranker, 128 joint rows x 16 heads x S=160, bf16) against their plain
   versions, with SDPA's forward and backward as the yardstick, K5's and
   K6's profiler device time (K6: its one-launch ``wgmma`` kernel), K8's
   two launches timed on K6's inputs beside it, and two K6 calls held
   bitwise equal; K1-K3 again
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
   joint rows x 12 heads x S=512 x d=64, bf16, key lengths 300..512;
   S = 256, 288, 1024; [4, 8, 1024, 128] and [16, 8, 256, 64], K8's
   edges) against their plain versions, with SDPA's forward
   and backward as the yardstick, the profiler device time of K7 and of
   each of K8's two launches (query pass, key pass), and two K8 calls held
   bitwise equal at every shape; K3 at S=512 (1024 x 512 tokens of
   BERT-base); K4 at the mine's shape (64 queries, k=100, 24,576 int8
   rows), with its profiler device time (the event time is the host's);
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
   (M=65,536), a width off the models' (3,001 x 512 x 2048) and, for K12,
   an encode chunk (M=131,072), with ``F.linear`` -> ``F.gelu`` ->
   ``F.linear`` in bf16 and its autograd backward as the yardstick; each
   with its device time by launch (K9, K10, K12: two GEMMs a call; K11 a
   GEMM over both weight gradients and the pass that adds db1's parts and
   the splits of K) and the memory a call allocates; two K11 calls held
   bitwise equal;
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
   (131,072 x 768 x 3072), a request (256 rows), a ragged M (4,000) and
   phase 8's width off the models' (3,001 x 512 x 2048),
   bitwise against its plain version and without a launch of K1 or K2,
   K13 ``int8_dense`` at the chunk's and a request's q, k, v (O = 2304)
   and output projection (O = 768), bitwise against its plain version;
   K13 and K14 with their device time by launch (a call makes two and
   four) and the memory a call allocates; with the library's
   ``torch._int_mm`` chains
   and K14's bf16 ``F.linear`` chain as yardsticks and the port's K2 -> K1
   composition of the same function timed beside; then the public
   ``int8_ffn`` at 40 rows (no tile): ``ffn_reference``, no launch;
12. encoding under the int8 knobs: phase 10's model and traffic with
   ``ffn_impl="int8"``, then with ``proj_impl="int8"`` too; K14 launched 12
   times per chunk and request, K13 24 times in the second; the embeddings
   against the same model on the plain versions and under ``"xla"``;
13. ``remat_policy="dots"``: the msdoc reranker (BERT-base CE, vocab
   50265) at the recipe's 32 queries x 16 passages x 512 tokens, 1 warm-up
   and 3 timed steps under full remat, then under "dots" (without remat
   it does not fit): step ms, peak memory, K7/K8 launches (twice and once
   a layer a step under both), equal losses and gradient cosine >=
   0.999999 between the two, and the dense products the backward runs
   (full remat recomputes six a layer, "dots" none); then the nq reranker
   (CE-large, S=160, 8 x 16) under ``ffn_impl="fused_vjp"``, "dots"
   against no remat: the same checks, K9 and K5 launched twice a layer;
14. dropout: phase 5's three step kinds with ``dropout=True``, 3 steps each,
   twice from the same weights at lr 0 (bitwise-equal losses); step ms
   beside phase 5's; K5/K6 not launched under ``attention_dropout=0.1``
   (the plain attention, as in JAX) and launched under
   ``attention_dropout=0``; a remat reranker step with dropout against
   one without (the masks replay);
15. LEAD's teacher: a BERT-base CE with ``per_layer_logits`` and attention
   maps over 8 x 2 rows of 160 tokens (the last layer's logits are the
   logits, every probability row sums to 1 over the unmasked keys); a
   tied ``MLMHead`` forward and backward over BERT-base at 8 x 128 tokens;
16. rerank: K1-K3 checked and timed at the rerank batch (256 x 160 tokens
   of CE-large), then ``evals.rerank_topk`` over 64 queries x top-100
   joint rows (6,400) through the int8 view (K1-K3) and in bf16 (K5):
   rows/s, launches, each order the stable argsort of its scores, the
   first batch's CLS vectors and scores against the plain versions, the
   top-10 overlap of the two orders;
17. data parallelism over ``torch.distributed``: (a) NCCL at world 1 in
   this process, phase 5's three step kinds (2 steps each, batches 0 and
   1) through the mesh path bitwise equal to the same steps with no group
   (deterministic algorithms on); (b) two gloo ranks on the card, launched
   by ``torchrun`` (this script in its rank mode), the same steps with
   the global batch of 8 queries split 4 and 4 against the world-1 steps
   (loss, the cosine of the parameter updates, the largest parameter
   difference in learning rates; limits ``DP_*`` from readings), the
   parameters bitwise equal across the ranks, then the 8,847,360 x 768
   int8 index built in two shards (each rank encodes its own) and searched
   at 8 and 1,024 queries: ids and scores bitwise the world-1 search's;
   (c) ``run_ar2`` under ``torchrun`` at world 2 in phase 7's nq
   configuration (gloo on the card), beside phase 7's losses, each rank's
   peak memory and phase times, then a relaunch that resumes from step 8.
   Launches counted in every rank. Two ranks on one card check
   correctness, not scaling: the gloo collectives cross the host;
18. PROD distillation at full width: ``run_kd`` in ``prod_kd_marcodoc``
   (6-layer BERT-base student, 12-layer BERT-base CE teacher; 32 / 256 /
   288 tokens: K7/K8) and ``prod_kd_nq`` (32 / 128 / 160: K5/K6 in the
   teacher's warm-up) with ``--synthetic --full-size --fast-teacher``
   (K1-K3), 8 queries a step, 8 KD steps, then a relaunch that resumes to
   12; per recipe the step ms, the peak memory, the losses and the
   launches, zeroed just before each run; then marcodoc's first KD step:
   the student's gradients on K7/K8 against the plain versions (beside two
   plain versions' cosine), the teacher view's CLS vectors against the
   plain int8 composition, one ``double`` and one ``dual_encoder`` step
   and a LAMB step, whose next update is held against the same update on
   the host;
19. the rest of the mesh: (a) NCCL at world 1 in this process as (data 1,
   model 1) and as a (1, 1, 1) multislice mesh: the BERT-base DE step and
   the AR2 retriever step (``auto_state``; slice-scoped negatives) on
   phase 18's marcodoc batches (the DE's queries on K5/K6, its passages
   on K7/K8, the teacher's int8 view on K1-K3) bitwise equal to the steps
   with no group, and beside them the same steps with every dense layer an
   f32 product (the rounding floor); (b)-(d) two gloo ranks on the card
   under one ``torchrun``: the DE split over (data 1, model 2) (K5-K8 at
   6 heads a rank), 2 steps of each kind against the world-1 steps (loss,
   update cosine, the gathered parameters and each rank's slice in
   learning rates, beside the floor; limits ``TP_*``),
   2 slices x 1 with ``negatives_scope="slice"`` against the per-slice
   oracle, and ``DenseRetriever(mesh=...)`` over 65,536 passages answering
   8 requests with the world-1 retriever's ids. Two ranks on one card
   check correctness, not scaling;
20. the repairs (ROADMAP.md Queue 3 items 7 and 8): (a)
   ``layer_impl="fused_int8"`` at the tiny config (H=64, d=16: off the
   128 grid, ``layer_reference`` bitwise with no launch of K1-K3) and at
   H=128 with 8 heads (d=16:
   K1-K3 against the plain int8 composition); (b) K5/K6 at S=160 and K7/K8
   at S=512 at head widths 16, 80, 96 and 24 (the 32 instance over
   zero-padded heads) against the plain pair, phase 4's and 6's limits;
   (c) f32 q, k, v at S=160 and 512 through the dispatch under autograd:
   the f32 instances of K5/K6 and K7/K8 launch (read from the counts) and
   agree with an f64 evaluation within phase 23's limits; (d) a tiny
   ``run_ar2 --fast-encode --fast-teacher`` and a tiny ``run_lead
   --freeze-teachers --fast-teacher`` run to their end; (e) Queue 3 item
   9, one call each against its plain version: d = 192 (H = 768 over 4
   heads) through ``flash_attention`` (the plain attention, no launch of
   K5-K8) and a fused-int8 layer (K1 and K2, no K3), a fused-int8
   BERT-base layer at S = 1,100 (K3 launched once) with K3 alone at 64 x
   1,100 timed, and the fused int8 search over an index of width 100 (K4
   over rows padded to 112 bytes, its candidates bitwise the plain
   version's);
21. LEAD at full width: ``run_lead`` in ``lead_ms_distill`` (6-layer
   BERT-base student with shared towers, 12-layer BERT-base CE on K5/K6;
   32 / 128 / 160 tokens, 8 queries x 2 passages a step): 12 joint steps
   (the re-draw and its states at 10), a relaunch that resumes to 16, then
   ``--freeze-teachers --fast-teacher`` for 8 (the frozen CE's int8 view:
   K1-K3 in the joint steps, no K6); per run the step ms, the peak memory,
   the losses and the launches (those inside the joint steps apart); then
   the first joint step's student and CE gradients on K5/K6 against the
   plain versions (beside two plain versions' cosine), one
   ``make_colbert_step`` and one ``make_kd_step(teacher_type="colbert")``
   with a BERT-base ColBERT (dim 128);
22. MASTER at full width: ``run_pretrain`` in ``master_pretrain``
   (BERT-base, seq 128, 2 head layers, 32 sequences a step): 6 steps, then
   a relaunch to 8; the exported encoder loaded into a ``BiEncoder`` and
   run; one ELECTRA step; the collator's host ms a batch on its native and
   numpy paths. No Pallas kernel is on this path;
23. f32 attention (ROADMAP.md Queue 3 item 8b): the f32 instances of K5/K6
   at [64, 8, 160, d] and K7/K8 at [16, 8, 512, d], d = 64, 16, 128, 24,
   against an f64 evaluation (``F32_*`` limits), beside the plain f32
   version (TF32 off) and the bf16 instance on the inputs cast to bf16
   (which they must beat 16-fold), two forward and two backward calls
   bitwise equal, with the times of the kernels (event and profiler
   device ms), the plain versions and SDPA in f32 at d = 64; the same
   checks at S = 1024, d = 128 and S = 256 (K7/K8) and S = 255 (K5/K6;
   the f32 forward of both pairs is ``csrc/attention_fwd_wgmma.cu``, the f32
   backward K8's ``csrc/attention_bwd_wgmma.cu``, both on ``wgmma``);
   then 3 ``make_biencoder_step``
   steps of an f32 ``BertConfig.tiny`` DE on passages of 512 tokens (K7/K8
   f32), the first step against the same step on the plain pair;
24. ``--init-checkpoint`` at full width, from artifacts written here under
   HF's key names with random weights: (a) ``run_ar2`` in
   ``msdoc_ar2_simans`` from RoBERTa-base (``--fast-encode --fast-teacher
   --int8-index``; 20,480 passages, 16 queries, one window of 4 steps):
   both DE towers the artifact's at the graft, K7/K8 in the DE and CE
   steps, K1-K4 in the mine and the teacher, step ms and peak memory; (b)
   ``DenseRetriever.from_checkpoint`` on its step-4 DE state, 4,096 of the
   run's passages indexed and 8 requests answered on K1-K4, the hits equal to
   the same retriever over the trained DE in memory; (c) ``run_lead`` from
   DistilBERT-base (4 joint steps, K5/K6) and ``run_pretrain`` from a
   BERT-base MLM artifact (2 steps, the MLM head grafted too);
25. the reader and ALLIES: a BERT-base ``Reader`` over 2 questions x 8
   passages x 256 tokens in bf16 (K7/K8), its first step's gradients
   against the plain pair beside two plain versions, 3 AdamW steps of
   ``reader_loss``; then ``run_allies`` in ``allies_qa`` with
   ``--int8-index`` over 2,048 synthetic passages to its end (K4);
26. CAPSTONE: (a) a T5-base v1.0 artifact written here under HF's names
   (random weights, tied), loaded through ``--init-checkpoint``'s sniff,
   ``convert_hf_t5`` and ``t5_config_from_state_dict``, generates 3
   queries for each of 1,024 synthetic passages of 512 tokens
   (``doc2query_tsv``: 64 target tokens, top-10, 32 passages a batch, f32,
   TF32 off, a word-level tokenizer built here) at passages/s, with one
   batch's teacher-forcing logits against the CPU, the incremental
   decoder's step logits (eager and graphed) against the re-run decoder,
   every sampled token
   in its step's top-10 and PAD after EOS; (b) ``run_capstone`` in
   ``capstone_curriculum`` over that TSV (``--synthetic --full-size
   --int8-index``, 1,024 passages, 16 queries, 8 a step x 32 passages):
   10 steps, then a relaunch that resumes to 12; step ms and host ms a step
   apart, peak memory, losses and buckets, K4 in the eval, its top-10
   equal to the plain version of the same search (ids) and, as a
   reading, against the exact search of the same state;
27. the ``kernels`` line (K1-K14 and the f32 instances of K5-K8 apart,
   launches of every path); then the last line, ``{"ok": true, "device":
   {...}}``.

``python3 chip_smoke.py --data-parallel-rank steps|co_training|mesh DIR``
is a rank of phase 17 or 19 (started by ``torchrun``, not by hand).
"""

import gc
import json
import math
import os
import subprocess
import sys
import time

PEAK_BYTES = 3.35e12          # H100 SXM HBM3, bytes/s
PEAK_INT8 = 1979e12           # dense int8 tensor-core ops/s
PEAK_BF16 = 989e12            # dense bf16 tensor-core flop/s
PEAK_TF32 = 495e12            # dense TF32 tensor-core flop/s (f32 inputs)
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
# the rerank phase's limits, kernels against plain over 256 rows of the nq
# reranker (scripts/torch_rerank_witness.py, PERF.md section 2): each layer
# on the plain path's input within two bf16 steps of its largest output;
# the scores within twice their spread, correlation >= 0.8
RERANK_LAYER_TOL, RERANK_GAP, RERANK_CORR = 2.0 ** -6, 2.0, 0.8


_START = time.perf_counter()


def emit(phase, **fields):
    """One JSON line of a phase's record, with the seconds since the script
    started (``t``: each phase's cost is the difference)."""
    print(json.dumps({"phase": phase,
                      "t": round(time.perf_counter() - _START, 1),
                      **fields}), flush=True)


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
    ``kernel`` (a string, or a tuple of alternatives; ``fn`` launches it
    once), from torch.profiler: a small
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
    names = (kernel,) if isinstance(kernel, str) else kernel
    us = [ev.time_range.elapsed_us() for ev in prof.events()
          if ev.device_type == torch.autograd.DeviceType.CUDA
          and any(k in ev.name for k in names)]
    return (sum(us) / 1e3 / len(us) if us else None), len(us)


def device_split(torch, fn, reps=5):
    """Device ms by kernel of a wrapper whose one call launches several
    kernels once each (K12: two GEMMs; K14: the codes of x, a GEMM, the
    codes of g, a GEMM), from torch.profiler: {kernel name: mean ms a
    launch over the launches recorded} (a profiler session late in a
    process may drop some)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            name = ev.name.replace("(anonymous namespace)::", "")
            split.setdefault(name.split("(")[0][:120], []).append(
                ev.time_range.elapsed_us())
    return {k: sum(v) / len(v) / 1e3 for k, v in split.items()}


def device_call_ms(torch, fn, reps=5):
    """Device ms of one call of ``fn`` over every kernel it launches, from
    torch.profiler: each kernel's mean ms a launch times its launches a
    call (those recorded over ``reps`` calls, rounded; a session late in a
    process may drop some). None when the session recorded no kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us.setdefault(ev.name, []).append(ev.time_range.elapsed_us())
    if not us:
        return None
    return sum(sum(v) / len(v) * max(1, round(len(v) / reps))
               for v in us.values()) / 1e3


def call_peak_gb(torch, fn):
    """GB that one call of ``fn`` allocates above what is live before it
    (its outputs and workspaces)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del out
    return (peak - base) / 1e9


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
        dev_ms, dev_n = device_ms(torch, call, ("gemm_kernel",
                                                "int8_linear_kernel"))
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
    index = _mips_index(torch, INDEX_ROWS)
    variants = [_check_mips(torch, randn, index, kind, nq,
                            valid_n=INDEX_ROWS - 1000)
                for nq in (8, 1024) for kind in ("int8", "bf16")]
    for v in variants:
        emit("kernel_variant", name="mips_bucket_candidates", nvidia_smi=smi,
             **v)
    del index
    torch.cuda.empty_cache()
    main = variants[0]                     # int8, 8 queries: a request
    rec = {key: main[key] for key in ("ms", "device_ms", "plain_ms",
                                      "library_ms", "bound_ms", "bound_by")}
    rec["max_abs_err"] = max(v["max_abs_err"] for v in variants)
    rec["tolerance"] = ("int8: exact (scores and ids); bf16: 1e-3 on scores, "
                        "<= 1e-5 of ids")
    rec["variants"] = variants
    rec["also_replaces"] = "simxns_tpu/ops/mips_kernel.py:112"   # bf16
    # what the port refused before K4 covered any block: the launcher's
    # block for 8,000 passages (2,000) at k=100, and a bucket off 128
    rec["repair"] = _check_mips_repair(torch, randn)
    emit("kernel_variant", name="mips_bucket_candidates", nvidia_smi=smi,
         **rec["repair"])
    records["mips_bucket_candidates"] = rec
    return records


def _mips_index(torch, rows, kinds=("int8", "bf16"), seed=5):
    """A random index of ``rows`` x H on the card, made in slices from its
    own generator: {"int8": (codes, scales), "bf16": (rows,)}."""
    from simxns_tpu_torch.ops.fused_ffn import quant_rows

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    if "int8" in kinds:
        out["int8"] = (torch.empty(rows, H, dtype=torch.int8, device=dev),
                       torch.empty(rows, dtype=torch.float32, device=dev))
    if "bf16" in kinds:
        out["bf16"] = (torch.empty(rows, H, dtype=torch.bfloat16,
                                   device=dev),)
    step = 262144
    for r0 in range(0, rows, step):
        x = torch.randn(min(step, rows - r0), H, device=dev, generator=gen)
        r1 = r0 + x.shape[0]
        if "int8" in out:
            out["int8"][0][r0:r1], out["int8"][1][r0:r1] = quant_rows(x)
        if "bf16" in out:
            out["bf16"][0][r0:r1] = x.to(torch.bfloat16)
    return out


def _check_mips(torch, randn, index, kind, nq, k=10, block_n=2048,
                bucket=128, valid_n=None, reps=None, search_timing=True):
    """K4 on ``nq`` random queries over ``index`` (``_mips_index``) at the
    wrapper's bucket for k (``_fit_bucket``): candidates against
    ``_candidates_plain`` on the same inputs (int8 scores and ids bitwise;
    bf16 scores within 1e-3 and at most 1e-5 of ids differing: f32 sums in
    another order), top-k overlap >= 0.99 after ``_finalize``; its event
    time and profiler device time a launch, the plain version's, the
    library's products + ``topk`` and the bound; with ``search_timing`` the
    search's last step over the candidates too (the stable ``_finalize``
    and ``torch.topk`` alone)."""
    from simxns_tpu_torch.ops import mips_kernel as mk
    from simxns_tpu_torch.ops.fused_ffn import quant_rows
    from simxns_tpu_torch.parallel.mesh import pad_to_multiple

    corpus = index[kind]
    rows = corpus[0].shape[0]
    valid_n = rows if valid_n is None else valid_n
    n_pad = pad_to_multiple(rows, block_n)
    bucket = mk._fit_bucket(bucket, block_n, n_pad, k)
    queries = randn(nq, H)
    if kind == "int8":
        q8, qs = quant_rows(queries)
        args = (q8, corpus[0], valid_n)
        kw = dict(bucket=bucket, block_n=block_n, query_scales=qs,
                  row_scales=corpus[1])
        plain_args = (q8, corpus[0], valid_n, bucket, n_pad, qs, corpus[1])
    else:
        args = (queries.to(torch.bfloat16), corpus[0], valid_n)
        kw = dict(bucket=bucket, block_n=block_n)
        plain_args = (args[0], corpus[0], valid_n, bucket, n_pad, None, None)
    label = f"mips {kind} Q={nq} N={rows} block_n={block_n} bucket={bucket}"
    got_s, got_i = mk.mips_bucket_candidates(*args, **kw)
    want_s, want_i = mk._candidates_plain(*plain_args)
    err = float((got_s - want_s).abs().max())
    ids_off = int((got_i != want_i).sum())
    if kind == "int8":
        # exact int32 sums and the same two f32 products
        check(err == 0.0 and ids_off == 0,
              f"{label}: err {err}, {ids_off} ids differ")
    else:
        # f32 sums in another order: |score| ~ 100 -> ~1e-4; a near-tie
        # inside a bucket may pick the other row
        check(err <= 1e-3 and ids_off <= max(1, 1e-5 * got_i.numel()),
              f"{label}: err {err}, {ids_off} ids differ")
    top_k = mk._finalize(got_s, got_i, k, 0)
    ref_k = mk._finalize(want_s, want_i, k, 0)
    overlap = float(sum(len(set(a) & set(b)) for a, b in zip(
        top_k[1].tolist(), ref_k[1].tolist())) / (k * nq))
    check(overlap >= 0.99, f"{label}: top-{k} overlap {overlap}")
    del got_s, got_i, want_s, want_i, top_k, ref_k
    big = rows >= 1 << 20                  # the MARCO index
    reps = reps or (20 if not big else 5 if nq <= 64 else 3)

    def call():
        return mk.mips_bucket_candidates(*args, **kw)

    ms = timed(torch, call, reps)
    dev_ms, seen = device_ms(torch, call, ("gemm_kernel", "mips_candidates"),
                             reps=reps)
    plain = timed(torch, lambda: mk._candidates_plain(*plain_args),
                  1 if big else 3, warmup=0 if big else 1)
    lib = timed(torch, lambda: _library_search(torch, args[0], args[1], kind,
                                               k=k), 1 if big else 5)
    elt = 1 if kind == "int8" else 2
    moved = (rows * H * elt + nq * H * elt
             + (4 * (rows + nq) if kind == "int8" else 0)
             + nq * (n_pad // bucket) * 8)
    bms, by = bound(moved, 2.0 * nq * rows * H,
                    PEAK_INT8 if kind == "int8" else PEAK_BF16)
    rec = dict(kind=kind, queries=nq, rows=rows, k=k, block_n=block_n,
               bucket=bucket, ms=ms, device_ms=dev_ms,
               device_launches_seen=seen, plain_ms=plain, library_ms=lib,
               bound_ms=bms, bound_by=by, max_abs_err=err,
               ids_differing=ids_off, top_k_overlap=overlap,
               candidates_per_query=n_pad // bucket)
    if search_timing:
        # the search's last step over K4's candidates: the port's stable
        # _finalize, and the same selection by torch.topk alone (equal
        # scores in no set order; what the port used before)
        cand = call()
        fin = timed(torch, lambda: mk._finalize(*cand, k, 0), 5)
        fin_topk = timed(torch, lambda: _topk_finalize(torch, *cand, k), 5)
        del cand
        rec.update(finalize_ms=fin, topk_finalize_ms=fin_topk,
                   search_ms=ms + fin,
                   stable_finalize_added_share=(fin - fin_topk)
                   / (ms + fin_topk))
    return rec


def _check_mips_repair(torch, randn):
    """What the port refused on the card before K4 covered any block and
    bucket: 8,000 rows at the launcher's block for them (2,000, not a
    multiple of 128) and k=100, through ``_check_mips`` and through
    ``blocked_mips_topk(mode="fused")`` against the same call on the CPU
    (the plain version; int8 scores and ids bitwise); and ``bucket=100``
    (the kernel at gcd(100, 128) = 4, its runs of 25 merged)."""
    from simxns_tpu_torch.ops import mips_kernel as mk
    from simxns_tpu_torch.ops.topk import blocked_mips_topk

    index = _mips_index(torch, 8000, seed=6)
    rec = {"block_2000": _check_mips(torch, randn, index, "int8", 64, k=100,
                                     block_n=2000, search_timing=False),
           "bucket_100": _check_mips(torch, randn, index, "int8", 64,
                                     block_n=2000, bucket=100,
                                     search_timing=False),
           "bf16_block_2000": _check_mips(torch, randn, index, "bf16", 64,
                                          k=100, block_n=2000,
                                          search_timing=False)}
    codes, scales = index["int8"]
    queries = randn(64, H).to(torch.bfloat16)
    before = mk.mips_bucket_candidates.launches
    got = blocked_mips_topk(queries, codes, 100, block_size=2000,
                            valid_n=7990, mode="fused", row_scales=scales)
    check(mk.mips_bucket_candidates.launches == before + 1,
          "blocked_mips_topk(mode='fused', block_size=2000) did not launch K4")
    want = blocked_mips_topk(queries.cpu(), codes.cpu(), 100,
                             block_size=2000, valid_n=7990, mode="fused",
                             row_scales=scales.cpu())
    same = (torch.equal(got[0].cpu(), want[0])
            and torch.equal(got[1].cpu(), want[1]))
    check(same, "blocked_mips_topk(mode='fused', block_size=2000) on the "
          "card differs from the plain version")
    rec["blocked_fused_block_2000_equal_to_plain"] = same
    return rec


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
    from simxns_tpu_torch.models import BertConfig, BiEncoder, BiEncoderConfig

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    de = BiEncoder(BiEncoderConfig(bert=BertConfig(
        vocab_size=30522, hidden_size=H, num_layers=12, num_heads=HEADS,
        intermediate_size=F, dtype=torch.bfloat16, ffn_impl=ffn_impl)),
        generator=torch.Generator().manual_seed(0)).to(dev)
    ce = _ce_large(torch, ffn_impl=ffn_impl)
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


def _softmax_probs(q, k, mask, scale=None):
    """The plain pair's p through ``torch.softmax``: the same f32 function
    as its explicit exp / sum, rounded otherwise (the second plain version
    the gradient checks set their floor by); stands in for
    ``flash_attention._probs``."""
    import torch

    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    s = torch.where(mask[:, None, None, :] > 0, s, -1e9)
    return torch.softmax(s, dim=-1), scale


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

    loss_k, grad_k = ce_gradients()
    kernels = fa.group_attention_fwd, fa.group_attention_bwd, fa._probs
    fa.group_attention_fwd = fa._group_fwd_plain
    fa.group_attention_bwd = fa._group_bwd_plain
    try:
        loss_p, grad_p = ce_gradients()
        fa._probs = _softmax_probs
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


def _check_bh_attention(torch, randn, gen, b, s, d, min_len, timing,
                        heads=HEADS):
    """K7/K8 on head views of [b, s, heads * d] projections with key
    lengths min_len..s, against their plain versions, two K8 calls bitwise
    equal; with ``timing`` also their times, SDPA's (the yardstick:
    forward, backward, both) and the bounds (the model's products: 2 in the
    forward, 5 in the backward)."""
    from simxns_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")

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
    # the kernel's name, and that of the mma.sync kernel it replaced (an
    # A/B against an older checkout with scripts/torch_kernel_bench.py)
    dev7, dev7_n = device_ms(torch, lambda: fa.bh_attention_fwd(
        q, k, v, mask), ("attention_fwd<", "bh_attention_fwd_kernel"))
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
    joint rows x 12 heads x S=512 x d=64, bf16, key lengths 300..512), at
    S = 256, 288 and 1024, and at [4, 8, 1024, 128] and [16, 8, 256, 64]; K3 at the msdoc encode's S=512 (1024 x 512
    tokens, BERT-base); K4 at the mine's shape (64 queries, k=100, over
    24,576 int8 rows)."""
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
    # K8's edges: the most shared memory (d = 128, S = 1,024) and the
    # shortest S of its route, at 8 heads
    others += [_check_bh_attention(torch, randn, gen, b, s, d, s // 2,
                                   timing=False, heads=8)
               for b, s, d in ((4, 1024, 128), (16, 256, 64))]
    shapes = [main] + others
    records["bh_attention_fwd"] = dict(
        ms=main["ms"], device_ms=main["device_ms"],
        device_launches_recorded=main["device_launches_recorded"],
        plain_ms=main["plain_ms"],
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

    index = _mips_index(torch, MINE_ROWS, kinds=("int8",), seed=7)
    rec4 = _check_mips(torch, randn, index, "int8", MINE_Q, k=MINE_K,
                       search_timing=False)
    records["mips_bucket_candidates"]["mine"] = rec4
    emit("kernel_variant", name="mips_bucket_candidates", nvidia_smi=smi,
         **rec4)
    del index
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


# phase 7's flags and cuts: full width, the int8 views and index, 8 queries
# a step, 8 steps, 1 warm-up epoch, 24,576 passages, 64 queries
CO_TRAINING_FLAGS = ["--synthetic", "--full-size", "--fast-encode",
                     "--fast-teacher", "--int8-index", "--batch", str(N_Q),
                     "--steps", "8", "--warm-epochs", "1", "--corpus-size",
                     str(MINE_ROWS), "--num-queries", str(MINE_Q)]
STEP_FACTORIES = {"make_biencoder_step": "biencoder",
                  "make_reranker_step": "reranker",
                  "make_ar2_retriever_step": "retriever"}


def _timed_factory(torch, factory, kind, step_ms, launches=None):
    """``factory`` whose steps append their ms (host clock to a synchronise)
    to ``step_ms[kind]`` and, given ``launches``, add the kernel launches
    made inside them to ``launches[kind]``."""
    from simxns_tpu_torch import ops

    def make(*a, **kw):
        step = factory(*a, **kw)

        def timed_step(*args):
            before = ops.launches() if launches is not None else None
            t0 = time.perf_counter()
            out = step(*args)
            torch.cuda.synchronize()
            step_ms.setdefault(kind, []).append(
                (time.perf_counter() - t0) * 1e3)
            if launches is not None:
                into = launches.setdefault(kind, {})
                for name, n in ops.launches().items():
                    if n - before[name]:
                        into[name] = into.get(name, 0) + n - before[name]
            return out

        return timed_step

    return make


def _co_training_losses(out_dir):
    """(step, kind, loss) of every co-training step in ``metrics.jsonl``."""
    losses = []
    with open(f"{out_dir}/metrics.jsonl", encoding="utf-8") as f:
        for line in f:
            rec = json.loads(line)
            if rec["phase"] in ("reranker", "retriever"):
                losses.append((rec["step"], rec["phase"], rec["loss"]))
    return losses


def _co_training_run(run, recipe, argv, window=4):
    """One ``run.run_ar2`` of ``recipe`` with windows of ``window`` steps
    (half reranker steps, then half retriever steps: 1 + 1 and 2 at 4);
    -> its output."""
    import dataclasses

    from simxns_tpu_torch.config import RECIPES

    args = run.build_parser().parse_args(["--recipe", recipe, *argv])
    cfg = dataclasses.replace(RECIPES[recipe], iteration_step=window,
                              iteration_reranker_step=window // 2 - 1)
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

    factories = STEP_FACTORIES
    real = {name: getattr(run, name) for name in factories}
    step_ms = {}
    common = CO_TRAINING_FLAGS
    root = tempfile.mkdtemp(prefix="chip_smoke_co_training_")
    free_gb = shutil.disk_usage(root).free / 1e9
    totals = {name: 0 for name in ops.KERNELS}
    summary = {}
    for name, kind in factories.items():
        setattr(run, name, _timed_factory(torch, real[name], kind, step_ms))
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
            losses = _co_training_losses(out_dir)
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
              "off_model": (3001, 512, 2048),
              "encode_chunk": (1024 * LC, H, F)}
FFN_KERNELS = ("ffn_train_fwd", "ffn_bwd_dx", "ffn_bwd_dw", "ffn_fused_fwd")


def _check_ffn_shape(torch, randn, label, m, h, f, k12_only=False):
    """K9-K12 at one (M, H, F) against their plain versions on the same
    bf16 inputs, with their times, the bounds and the library yardstick
    (``F.linear`` -> ``F.gelu`` -> ``F.linear`` in bf16 and its autograd
    backward; timed only). ``encode_chunk`` is K12's shape alone, and
    ``k12_only`` stops after K12 at any shape. -> {kernel name: record}."""
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

    def k12():
        return pf.ffn_fused_fwd(x, w1, b1, w2, b2)

    out["ffn_fused_fwd"] = dict(
        shape, ms=timed(torch, k12, 5), plain_ms=plain_fwd,
        library_ms=lib_fwd, bound_ms=bms, bound_by=by, max_abs_err=err,
        share_differing=share, device_ms_by_kernel=device_split(torch, k12),
        call_peak_gb=call_peak_gb(torch, k12))
    del y12
    if label == "encode_chunk" or k12_only:
        return out

    y, hb = pf.ffn_train_fwd(x, w1, b1, w2, b2)
    err_h, share_h = close_bf16(hb, hb_ref, "ffn_train_fwd hb")
    err, share = close_bf16(y, y_ref, "ffn_train_fwd y")
    bms, by = bound(2 * (2 * m * h + m * f) + w_bytes, ops, PEAK_BF16)

    def k9():
        return pf.ffn_train_fwd(x, w1, b1, w2, b2)

    out["ffn_train_fwd"] = dict(
        shape, ms=timed(torch, k9, 5), plain_ms=plain_fwd,
        library_ms=lib_fwd, bound_ms=bms, bound_by=by,
        max_abs_err=max(err, err_h), share_differing=max(share, share_h),
        device_ms_by_kernel=device_split(torch, k9),
        call_peak_gb=call_peak_gb(torch, k9))
    del y, y_ref, hb_ref

    # the backward kernels and their plain versions read K9's hb, and K11
    # K10's dh, g and db1 parts: the same inputs on both sides
    dy = randn(m, h).to(bf)

    def k10():
        return pf.ffn_bwd_dx(dy, w1, w2, hb)

    dx, dh, g, parts = k10()
    dx_ref, dh_ref, g_ref, parts_ref = pf._ffn_bwd_dx_plain(dy, w1, w2, hb)
    err_h, share_h = close_bf16(dh, dh_ref, "ffn_bwd_dx dh")
    err, share = close_bf16(dx, dx_ref, "ffn_bwd_dx dx")
    err_g, share_g = close_bf16(g, g_ref, "ffn_bwd_dx g")
    # the parts are column sums of the kernel's own dh (64 rows each)
    close_f32(parts, pf._column_parts(dh), "ffn_bwd_dx db1 parts")
    del dx, dx_ref, dh_ref, g_ref, parts_ref
    ms10 = timed(torch, k10, 5)
    plain10 = timed(torch, lambda: pf._ffn_bwd_dx_plain(dy, w1, w2, hb), 1,
                    warmup=0)
    rows64 = -(-m // 64)
    bms, by = bound(2 * (2 * m * h + 3 * m * f + 2 * h * f) + 4 * rows64 * f,
                    ops, PEAK_BF16)
    out["ffn_bwd_dx"] = dict(
        shape, ms=ms10, plain_ms=plain10, library_ms=None, bound_ms=bms,
        bound_by=by, max_abs_err=max(err, err_h, err_g),
        share_differing=max(share, share_h, share_g),
        device_ms_by_kernel=device_split(torch, k10),
        call_peak_gb=call_peak_gb(torch, k10))

    def k11():
        return pf.ffn_bwd_dw(x, dy, g, dh, parts)

    got = k11()
    want = pf._ffn_bwd_dw_plain(x, dy, g, dh, parts)
    errs = [close_f32(gt, w, f"ffn_bwd_dw {name}")
            for name, gt, w in zip(("dw1", "db1", "dw2"), got, want)]
    again = k11()
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"ffn_bwd_dw at {label}: two calls differ")
    del got, want, again
    ms11 = timed(torch, k11, 5)
    plain11 = timed(torch, lambda: pf._ffn_bwd_dw_plain(x, dy, g, dh, parts),
                    1, warmup=0)
    bms, by = bound(2 * (2 * m * h + 2 * m * f) + 4 * rows64 * f
                    + 4 * (2 * h * f + f), ops, PEAK_BF16)
    bm, bn, splits = pf.ffn_bwd_workspace(
        m, h, f, torch.cuda.get_device_properties(0).multi_processor_count
    )["dw"]
    out["ffn_bwd_dw"] = dict(
        shape, ms=ms11, plain_ms=plain11, library_ms=None, bound_ms=bms,
        bound_by=by, max_abs_err=max(e[0] for e in errs),
        max_err_of_largest=max(e[1] for e in errs),
        min_cosine=min(e[2] for e in errs), bitwise_run_to_run=True,
        tile=[bm, bn], splits=splits,
        device_ms_by_kernel=device_split(torch, k11),
        call_peak_gb=call_peak_gb(torch, k11))
    del g, parts

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
    from simxns_tpu_torch.models import int8_view
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
    loss_x, grad_x = _flat_gradients(
        torch, steps, _view_of(torch, ce, ffn_impl="xla"), b0)
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

    remat_view = _view_of(torch, ce, remat=True)
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


def _int8_exact(torch, got, want, what):
    """K13/K14 against their plain versions: the same codes, integer sums
    and f32 operations in the same order, so bitwise (``torch.equal``).
    -> (max_abs_err, elements that differ)."""
    d = (got.float() - want.float()).abs()
    err, differ = float(d.max()), int((d > 0).sum())
    check(torch.equal(got, want), f"{what}: not bitwise equal to its plain "
          f"version ({differ} of {d.numel()} elements differ, max err "
          f"{err})")
    return err, differ


def _check_int8_ffn_shape(torch, randn, label, m, h=H, f=F):
    """K14 at (m, h, f) against its plain version, with its time, the plain
    version's, the bound, the library's int8 chain (``_int_mm`` -> epilogue
    + GELU -> ``quant_rows`` -> ``_int_mm`` -> epilogue, on codes of x made
    beforehand) and bf16 chain (``F.linear`` -> ``F.gelu`` -> ``F.linear``),
    and the port's K2 -> K1 composition of the same function (timed only;
    compared as a note)."""
    from simxns_tpu_torch.ops import fused_ffn as pf
    from simxns_tpu_torch.ops import fused_layer as fl

    bf = torch.bfloat16
    x = randn(m, h).to(bf)
    w1, b1 = randn(f, h, scale=0.02), randn(f, scale=0.02)
    w2, b2 = randn(h, f, scale=0.02), randn(h, scale=0.02)
    (w1_8, s1), (w2_8, s2) = pf.quantize_weight(w1), pf.quantize_weight(w2)
    args = (x, w1_8, s1, b1, w2_8, s2, b2)
    # K14's path bypasses K1 and K2: their counts must not move
    before = (fl.int8_linear.launches, fl.row_quant.launches)
    got = pf.int8_ffn_fwd(*args)
    check((fl.int8_linear.launches, fl.row_quant.launches) == before,
          f"int8_ffn at {label} launched K1 or K2")
    want = pf._int8_ffn_plain(*args)
    err, differ = _int8_exact(torch, got, want, f"int8_ffn at {label}")
    ms = timed(torch, lambda: pf.int8_ffn_fwd(*args), 5)
    split = device_split(torch, lambda: pf.int8_ffn_fwd(*args))
    peak = call_peak_gb(torch, lambda: pf.int8_ffn_fwd(*args))
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
    bms, by = bound(2 * 2 * m * h + 2 * h * f + 4 * 2 * (h + f),
                    4.0 * m * h * f, PEAK_INT8)
    return dict(shape=label, m=m, h=h, f=f, ms=ms, plain_ms=plain,
                library_ms=lib, library_bf16_ms=lib_bf16, bound_ms=bms,
                bound_by=by, k2_k1_composition_ms=comp,
                k2_k1_composition_elements_differing=comp_diff,
                max_abs_err=err, elements_differing=differ, bitwise=True,
                device_ms_by_kernel=split, call_peak_gb=peak)


def _check_int8_dense_shape(torch, randn, label, m, o):
    """K13 at (m, H, o) bitwise against its plain version, with its time,
    its device time by launch (the codes of x, the GEMM), the memory a
    call allocates, the plain version's time, the bound, ``_int_mm`` on
    codes of x made beforehand plus the dequantize epilogue in PyTorch
    (the library yardstick, as K1's), and the port's K2 -> K1 composition
    of the same function."""
    from simxns_tpu_torch.ops import fused_ffn as pf
    from simxns_tpu_torch.ops import fused_layer as fl

    bf = torch.bfloat16
    x = randn(m, H).to(bf)
    w, b = randn(o, H, scale=0.02), randn(o, scale=0.02)
    w8, ws = pf.quantize_weight(w)
    got = pf.int8_dense_fwd(x, w8, ws, b)
    want = pf._int8_dense_plain(x, w8, ws, b)
    err, differ = _int8_exact(torch, got, want, f"int8_dense at {label}")

    def k13():
        return pf.int8_dense_fwd(x, w8, ws, b)

    ms = timed(torch, k13, 10)
    split = device_split(torch, k13)
    peak = call_peak_gb(torch, k13)
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
                max_abs_err=err, elements_differing=differ, bitwise=True,
                device_ms_by_kernel=split, call_peak_gb=peak)


def phase_int8_kernels(torch, smi, records):
    """Phase 11: K14 ``int8_ffn`` at an encode chunk (131,072 rows), a
    request (256), a ragged M (4,000) and phase 8's width off the models'
    (3,001 x 512 x 2048), K13 ``int8_dense`` at the chunk's
    and a request's q, k, v (O = 2304) and output projection (O = 768);
    then the public ``int8_ffn`` at a shape that does not tile,
    which is ``ffn_reference`` and launches nothing. The records are the
    chunk's (K13: its q, k, v)."""
    from simxns_tpu_torch.ops import fused_ffn as pf

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    torch.cuda.empty_cache()

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, device=dev, generator=gen) * scale

    shapes = {"int8_ffn": [], "int8_dense": []}
    for label, m, h, f in (("encode_chunk", 131072, H, F),
                           ("request", 256, H, F), ("ragged", 4000, H, F),
                           ("off_model", *FFN_SHAPES["off_model"])):
        shapes["int8_ffn"].append(_check_int8_ffn_shape(torch, randn, label,
                                                        m, h, f))
        emit("kernel_shape", name="int8_ffn", nvidia_smi=smi,
             **shapes["int8_ffn"][-1])
        torch.cuda.empty_cache()
    for label, m, o in (("encode_chunk_qkv", 131072, 3 * H),
                        ("encode_chunk_output", 131072, H),
                        ("request_qkv", 256, 3 * H),
                        ("request_output", 256, H)):
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
                   tolerance="bitwise (torch.equal)")
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
    import numpy as np

    from simxns_tpu_torch import ops
    from simxns_tpu_torch.data import HashTokenizer
    from simxns_tpu_torch.models import BertConfig, BiEncoder, BiEncoderConfig
    from simxns_tpu_torch.models.bert import BertLayer
    from simxns_tpu_torch.ops import fused_ffn as pf
    from simxns_tpu_torch.serve import DenseRetriever

    dev = torch.device("cuda")
    fresh_peak(torch)
    model = BiEncoder(BiEncoderConfig(bert=BertConfig(
        vocab_size=30522, hidden_size=H, num_layers=12, num_heads=HEADS,
        intermediate_size=F, dtype=torch.bfloat16, ffn_impl="int8")),
        generator=torch.Generator().manual_seed(0)).to(dev).eval()

    tok = HashTokenizer(vocab_size=30522)
    n_pass, chunk, n_req = 16384, 1024, 8
    layers = model.cfg.bert.num_layers
    passages = _synthetic_passages(n_pass)
    rng = np.random.default_rng(2)
    picks = rng.integers(0, n_pass, n_req * 8)
    requests = [[" ".join(passages[int(i)][0].split()[:12])
                 for i in picks[r * 8:(r + 1) * 8]] for r in range(n_req)]
    xla = _view_of(torch, model, ffn_impl="xla").eval()
    ids = mask = None
    for label, encoder, per_layer in (
            ("ffn_int8", model, {"int8_ffn": 1}),
            ("ffn_proj_int8",
             _view_of(torch, model, proj_impl="int8").eval(),
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


def _view_of(torch, model, **knobs):
    """``model`` under another ``BertConfig``, over the same Parameters."""
    import dataclasses

    from simxns_tpu_torch.models.bert import share_parameters

    with torch.device("meta"):
        view = type(model)(dataclasses.replace(
            model.cfg, bert=model.cfg.bert.replace(**knobs)))
    return share_parameters(view, model)


def _counted_gradients(torch, steps, model, batch, generator=None):
    """``_flat_gradients`` with the dense products (``aten.mm`` and
    ``aten.addmm``) that the backward runs counted, the recompute's
    included; and the launches of the forward and backward. Untimed: the
    count runs every op of the backward through a Python dispatch mode.
    -> (loss, flat gradients, dense products, launches, peak GB)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from simxns_tpu_torch import ops

    dense = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)

    class CountDense(TorchDispatchMode):
        count = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            CountDense.count += func in dense
            return func(*args, **(kwargs or {}))

    torch.cuda.synchronize()
    fresh_peak(torch)
    ops.reset_launches()
    loss, _ = steps.reranker_loss(model, batch, generator=generator)
    for p in model.parameters():
        p.grad = None
    CountDense.count = 0
    with CountDense():
        loss.backward()
    flat = torch.cat([p.grad.float().flatten() for p in model.parameters()
                      if p.grad is not None])
    for p in model.parameters():
        p.grad = None
    torch.cuda.synchronize()
    return (float(loss.detach()), flat, CountDense.count,
            {k: v for k, v in ops.launches().items() if v},
            torch.cuda.max_memory_allocated() / 1e9)


def _same_step(torch, what, a, b):
    """Two forward and backward passes that must give the same step: equal
    losses, gradient cosine >= 0.999999 and every gradient within 1e-3 of
    the largest (the embedding gradients add with atomics in an order that
    changes from run to run). -> (cosine, error of the largest)."""
    cos = _cosine(torch, a[1], b[1])
    err = float((a[1] - b[1]).abs().max() / b[1].abs().max())
    check(a[0] == b[0] and cos >= 0.999999 and err <= 1e-3,
          f"{what}: loss {a[0]} vs {b[0]}, gradient cosine {cos}, err {err} "
          "of the largest")
    return cos, err


def _ce_large(torch, seed=0, **knobs):
    """The nq recipe's reranker at full width on the card (ERNIE-large
    shape: 24 layers, H=1024, 16 heads, small_s_attn="group"), random
    weights from ``seed``."""
    from simxns_tpu_torch.models import (BertConfig, CrossEncoder,
                                         CrossEncoderConfig)

    return CrossEncoder(CrossEncoderConfig(bert=BertConfig(
        vocab_size=30522, hidden_size=CE_H, num_layers=CE_LAYERS,
        num_heads=CE_HEADS, intermediate_size=CE_F, dtype=torch.bfloat16,
        small_s_attn="group", **knobs)),
        generator=torch.Generator().manual_seed(seed)).to(
            torch.device("cuda"))


def _launch_totals(records, path, launches):
    for name, rec in records.items():
        rec.setdefault("launches_by_path", {})[path] = launches.get(name, 0)
        rec["launches"] = sum(rec["launches_by_path"].values())


def phase_remat_dots(torch, smi, records):
    """Phase 13: ``remat_policy="dots"``. The msdoc reranker (BERT-base CE,
    vocab 50265) at the recipe's 32 queries x 16 passages x 512 tokens under
    full remat, then under "dots" (it does not fit without remat); then the
    nq reranker (CE-large, S=160, 8 x 16) under ``ffn_impl="fused_vjp"``,
    "dots" against no remat."""
    import numpy as np

    from simxns_tpu_torch import ops
    from simxns_tpu_torch.config import RECIPES
    from simxns_tpu_torch.models import CrossEncoder, CrossEncoderConfig
    from simxns_tpu_torch.train import (TrainState, make_adamw,
                                        make_reranker_step, steps)

    dev = torch.device("cuda")
    fresh_peak(torch)
    recipe = RECIPES["msdoc_ar2_simans"]
    bert = recipe.reranker.bert.replace(dtype=torch.bfloat16, remat=True)
    n_q, n_p = 32, 16
    t0 = time.perf_counter()
    ce = CrossEncoder(CrossEncoderConfig(bert=bert),
                      generator=torch.Generator().manual_seed(0)).to(dev)
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)

    def batch():
        lens = rng.integers(MS_S * 3 // 5, MS_S + 1, n_q * n_p)
        ids = rng.integers(1000, bert.vocab_size,
                           (n_q * n_p, MS_S)).astype(np.int32)
        mask = (np.arange(MS_S)[None, :] < lens[:, None]).astype(np.int32)
        return {"joint_ids": (ids * mask).reshape(n_q, n_p, MS_S),
                "joint_mask": mask.reshape(n_q, n_p, MS_S)}

    batches = [batch() for _ in range(4)]
    b0 = steps.to_device(batches[0], dev)
    modes = {"full": ce, "dots": _view_of(torch, ce, remat_policy="dots")}
    first = {mode: _counted_gradients(torch, steps, model, b0)
             for mode, model in modes.items()}
    cos, err = _same_step(torch, "msdoc dots vs full remat", first["dots"],
                          first["full"])
    dense = {mode: r[2] for mode, r in first.items()}
    # full remat recomputes every layer's six dense products; "dots" takes
    # them from what the forward kept
    check(dense["full"] - dense["dots"] == 6 * bert.num_layers,
          f"msdoc: dense products in the backward {dense}")
    msdoc = {"queries": n_q, "passages": n_p, "joint_length": MS_S,
             "tokens_per_step": n_q * n_p * MS_S, "model_init_s": init_s,
             "loss": first["full"][0], "gradient_cosine_dots_vs_full": cos,
             "gradient_err_of_largest": err,
             "dense_products_in_backward": dense}
    tx = make_adamw(recipe.reranker_optim.learning_rate, total_steps=0)
    launches = {}
    for mode, model in modes.items():
        del first[mode]
        state, step = TrainState.create(model, tx), make_reranker_step(tx)
        resident = fresh_peak(torch)
        state, _ = step(state, batches[0])          # warm-up
        torch.cuda.synchronize()
        ops.reset_launches()
        ms, losses = [], []
        for b in batches[1:]:
            t0 = time.perf_counter()
            state, metrics = step(state, b)
            losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        launches[mode] = ops.launches()
        peak = torch.cuda.max_memory_allocated() / 1e9
        n = len(ms)
        check(launches[mode]["bh_attention_fwd"] == 2 * bert.num_layers * n
              and launches[mode]["bh_attention_bwd"] == bert.num_layers * n,
              f"msdoc {mode}: K7/K8 launched {launches[mode]} over {n} "
              "steps, not twice and once a layer a step")
        check(all(math.isfinite(x) for x in losses),
              f"msdoc {mode}: non-finite loss {losses}")
        msdoc[mode] = dict(step_ms=ms, mean_step_ms=float(np.mean(ms)),
                           losses=losses, resident_gb=resident,
                           max_memory_gb=peak,
                           launches={k: v for k, v in launches[mode].items()
                                     if v})
        del state
    del modes, ce
    fresh_peak(torch)

    # the nq reranker under fused_vjp: "dots" against no remat
    ce = _ce_large(torch, ffn_impl="fused_vjp")
    b0 = steps.to_device(_train_batch(np, 0), dev)
    dots = _view_of(torch, ce, remat=True, remat_policy="dots")
    _counted_gradients(torch, steps, dots, b0)          # warm
    runs = {"none": _counted_gradients(torch, steps, ce, b0),
            "dots": _counted_gradients(torch, steps, dots, b0)}
    cos, err = _same_step(torch, "nq dots vs no remat", runs["dots"],
                          runs["none"])
    got = {mode: r[3] for mode, r in runs.items()}
    want = {"none": dict(ffn_train_fwd=CE_LAYERS, group_attention_fwd=CE_LAYERS),
            "dots": dict(ffn_train_fwd=2 * CE_LAYERS,
                         group_attention_fwd=2 * CE_LAYERS)}
    for mode, counts in want.items():
        counts.update(ffn_bwd_dx=CE_LAYERS, ffn_bwd_dw=CE_LAYERS,
                      group_attention_bwd=CE_LAYERS)
        check(all(got[mode].get(k) == v for k, v in counts.items()),
              f"nq {mode}: launches {got[mode]}, want {counts}")
    check(runs["dots"][2] == runs["none"][2],
          f"nq: dense products in the backward, dots {runs['dots'][2]} vs "
          f"none {runs['none'][2]}")

    def forward_backward(model):
        loss, _ = steps.reranker_loss(model, b0)
        loss.backward()
        for p in model.parameters():
            p.grad = None

    # selective checkpointing runs every op of the forward and the
    # recompute through a Python dispatch mode: the trace's idle share
    traces = {mode: _trace(torch, [lambda m=model: forward_backward(m)],
                           "call")
              for mode, model in (("none", ce), ("dots", dots))}
    nq = {"rows": N_Q * N_P, "joint_length": LJ, "ffn_impl": "fused_vjp",
          "gradient_cosine_dots_vs_none": cos,
          "gradient_err_of_largest": err,
          **{mode: dict(loss=r[0], dense_products_in_backward=r[2],
                        launches=r[3], max_memory_gb=r[4],
                        trace=traces[mode])
             for mode, r in runs.items()}}
    emit("remat_dots", nvidia_smi=smi, msdoc_reranker=msdoc,
         nq_reranker=nq)
    _launch_totals(records, "remat_dots",
                   {k: launches["full"][k] + launches["dots"][k]
                    + got["none"].get(k, 0) + got["dots"].get(k, 0)
                    for k in launches["full"]})
    del runs, ce, dots
    fresh_peak(torch)


def phase_dropout_steps(torch, smi, records, xla):
    """Phase 14: the Training configuration's three step kinds with
    ``dropout=True`` (the JAX seeds 0, 1, 2), 3 steps each, twice from the
    same weights at lr 0 (the weights stay bitwise equal; the embedding
    gradients add with atomics, so a real update would part two runs by
    rounding); a remat reranker step with dropout against one without; a
    reranker step with ``attention_dropout=0`` (K5/K6 run)."""
    import numpy as np

    from simxns_tpu_torch import ops
    from simxns_tpu_torch.models import int8_view
    from simxns_tpu_torch.train import (TrainState, make_adamw,
                                        make_ar2_retriever_step,
                                        make_biencoder_step,
                                        make_reranker_step, steps)

    dev = torch.device("cuda")
    fresh_peak(torch)
    de, ce, init_s = _full_models(torch, "xla")
    view = int8_view(ce)
    batches = [_train_batch(np, seed) for seed in range(3)]
    tx = make_adamw(0.0, total_steps=0)

    def run():
        kinds = {"biencoder": make_biencoder_step(tx, dropout=True),
                 "reranker": make_reranker_step(tx, dropout=True),
                 "retriever": make_ar2_retriever_step(
                     tx, temperature=1.0, adv_lambda=0.0, dropout=True)}
        ops.reset_launches()
        torch.cuda.synchronize()
        out = _run_steps(torch, kinds, batches, TrainState.create(de, tx),
                         TrainState.create(ce, tx), view)
        return out[:4], ops.launches()

    (step_ms, losses, peak_gb, _), launches = run()
    (_, again, _, _), _ = run()
    check(all(math.isfinite(x) for v in losses.values() for x in v),
          f"dropout steps: non-finite loss {losses}")
    check(losses == again, f"dropout steps at one seed: {losses} then "
          f"{again}")
    # attention_dropout=0.1: the attention takes the plain path (no K5/K6)
    check(launches["group_attention_fwd"] == 0
          and launches["group_attention_bwd"] == 0
          and launches["int8_linear"] > 0,
          f"dropout steps: launches {launches}")

    b0 = steps.to_device(batches[0], dev)
    gen = steps.dropout_generator(True, 1, 0)
    plain = _counted_gradients(torch, steps, ce, b0, generator=gen)
    remat = _counted_gradients(torch, steps, _view_of(torch, ce, remat=True),
                               b0, generator=steps.dropout_generator(True, 1,
                                                                     0))
    cos, err = _same_step(torch, "dropout under remat", remat, plain)
    del plain, remat

    # hidden dropout alone: K5/K6 run
    hidden_only = _view_of(torch, ce, attention_dropout=0.0)
    state = TrainState.create(hidden_only, tx)
    step = make_reranker_step(tx, dropout=True)
    ops.reset_launches()
    hidden_ms = []
    for b in batches:
        t0 = time.perf_counter()
        state, metrics = step(state, b)
        check(math.isfinite(float(metrics["loss"])), "hidden-only: loss")
        torch.cuda.synchronize()
        hidden_ms.append((time.perf_counter() - t0) * 1e3)
    hidden_launches = ops.launches()
    check(hidden_launches["group_attention_fwd"] == 3 * CE_LAYERS
          and hidden_launches["group_attention_bwd"] == 3 * CE_LAYERS,
          f"attention_dropout=0: launches {hidden_launches}")

    steady = {kind: float(np.mean(ms[1:])) for kind, ms in step_ms.items()}
    emit("dropout_steps", nvidia_smi=smi, model_init_s=init_s,
         hidden_dropout=ce.cfg.bert.hidden_dropout,
         attention_dropout=ce.cfg.bert.attention_dropout, step_ms=step_ms,
         steady_step_ms=steady,
         steady_step_ms_dropout_off=xla["steady_step_ms"], losses=losses,
         losses_bitwise_equal_two_runs=True, max_memory_gb_by_kind=peak_gb,
         launches={k: v for k, v in launches.items() if v},
         remat_vs_none={"gradient_cosine": cos,
                        "gradient_err_of_largest": err},
         reranker_attention_dropout_0={
             "step_ms": hidden_ms,
             "launches": {k: v for k, v in hidden_launches.items() if v}})
    _launch_totals(records, "dropout_steps",
                   {k: launches[k] + hidden_launches[k] for k in launches})
    del de, ce, view, state, hidden_only
    fresh_peak(torch)


def phase_lead_ce(torch, smi):
    """Phase 15: LEAD's teacher, a BERT-base CE with ``per_layer_logits``
    and ``output_attentions`` over 8 x 2 rows of 160 tokens; then a tied
    ``MLMHead`` forward and backward over BERT-base at 8 x 128 tokens."""
    import numpy as np

    from simxns_tpu_torch.models import (BertConfig, CrossEncoder,
                                         CrossEncoderConfig, MLMHead)

    dev = torch.device("cuda")
    fresh_peak(torch)
    bert = BertConfig(vocab_size=30522, hidden_size=H, num_layers=12,
                      num_heads=HEADS, intermediate_size=F,
                      dtype=torch.bfloat16)
    ce = CrossEncoder(CrossEncoderConfig(bert=bert, per_layer_logits=True),
                      generator=torch.Generator().manual_seed(0)).to(dev)
    batch = _train_batch(np, 5)
    ids = torch.from_numpy(batch["joint_ids"][:, :2].reshape(-1, LJ)).to(
        dev).long()
    mask = torch.from_numpy(batch["joint_mask"][:, :2].reshape(-1, LJ)).to(
        dev)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ce(ids, mask, group_size=2, output_attentions=True)
        torch.cuda.synchronize()
        lead_ms = (time.perf_counter() - t0) * 1e3
    per_layer = out["per_layer_logits"]
    check(per_layer.shape == (12, N_Q, 2)
          and torch.equal(per_layer[-1], out["logits"])
          and bool(torch.isfinite(per_layer).all()),
          "per_layer_logits: shape, last layer or finiteness")
    row_err = 0.0
    for p in out["attentions"]:
        check(p.shape == (N_Q * 2, HEADS, LJ, LJ), f"attention map {p.shape}")
        rows = (p * mask[:, None, None, :]).sum(-1)
        row_err = max(row_err, float((rows - 1.0).abs().max()))
    check(row_err <= 1e-5, f"attention rows sum to 1 within {row_err}")
    check(len(out["hidden_states"]) == 13, "hidden states: 13")

    head = MLMHead(bert, tied=True).to(dev)
    words = ce.encoder.embeddings.word_embeddings.weight
    rng = np.random.default_rng(6)
    mlm_ids = torch.from_numpy(rng.integers(1000, 30522, (8, 128))).to(dev)
    labels = torch.from_numpy(rng.integers(0, 30522, (8, 128))).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hidden = ce.encoder(mlm_ids).last_hidden_state
    logits = head(hidden, words)
    loss = torch.nn.functional.cross_entropy(logits.reshape(-1, 30522),
                                             labels.reshape(-1))
    loss.backward()
    torch.cuda.synchronize()
    mlm_ms = (time.perf_counter() - t0) * 1e3
    check(logits.dtype == torch.float32 and logits.shape == (8, 128, 30522)
          and math.isfinite(float(loss.detach())) and bool(
              torch.isfinite(words.grad).all()),
          f"MLM head: loss {float(loss.detach())}")
    emit("lead_ce", nvidia_smi=smi, rows=N_Q * 2, joint_length=LJ,
         forward_ms=lead_ms, per_layer_logits_shape=list(per_layer.shape),
         attention_row_sum_max_err=row_err,
         last_layer_equals_logits=True, mlm_tokens=8 * 128,
         mlm_loss=float(loss.detach()), mlm_forward_backward_ms=mlm_ms,
         max_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    del ce, head, out, logits, hidden
    fresh_peak(torch)


def _rerank_joint(n_q=64, k=100, n_pass=2048):
    """The rerank phase's joint rows [n_q, k, LJ]: queries of 12 words of a
    synthetic passage, each against k of the 2,048 passages drawn at
    random, through ``build_joint_inputs``."""
    import numpy as np

    from simxns_tpu_torch.data import HashTokenizer
    from simxns_tpu_torch.evals import build_joint_inputs

    tok = HashTokenizer(vocab_size=30522)
    passages = _synthetic_passages(n_pass, seed=3)
    corpus = np.zeros((n_pass, LC), np.int32)
    for i in range(n_pass):
        enc = tok.encode(passages[i][1], text_pair=passages[i][0],
                         max_length=LC)
        corpus[i, :len(enc)] = enc
    rng = np.random.default_rng(5)
    queries = np.zeros((n_q, LQ), np.int32)
    for qi, pid in enumerate(rng.integers(0, n_pass, n_q)):
        enc = tok.encode(" ".join(passages[int(pid)][0].split()[:12]),
                         max_length=LQ)
        queries[qi, :len(enc)] = enc
    topk = np.stack([rng.choice(n_pass, k, replace=False)
                     for _ in range(n_q)]).astype(np.int32)
    return build_joint_inputs(queries, corpus, topk, LJ)


def _score_gap(np, got, want):
    """Scores ``got`` against ``want`` over the same rows: the largest
    difference, the spread (standard deviation) of ``want``, their ratio
    and the correlation."""
    err = float(np.abs(got - want).max())
    spread = float(want.std())
    return dict(max_abs_err=err, spread=spread, gap_over_spread=err / spread,
                correlation=float(np.corrcoef(got, want)[0, 1]))


def _layer_walk(torch, a, b, x, score):
    """Two stacks of layer functions (hidden [B, S, H] -> hidden) from the
    same input ``x``: stack ``b`` as the reference, stack ``a`` both
    free-running and on ``b``'s input at every layer (teacher-forced).
    ``score`` maps CLS vectors to numpy scores. -> (per layer: the
    teacher-forced error, max |a(x_b) - b(x_b)| over max |b(x_b)|, and the
    free-running score gap at that depth; the last layer's scores of ``a``
    and ``b``, and the minimum cosine of their CLS vectors, as they are and
    each centred on the rows' mean)."""
    import numpy as np

    xa = xb = x
    layers = []
    for fa, fb in zip(a, b):
        yb = fb(xb).float()
        forced = fa(xb).float()
        xa = fa(xa)
        sa, sb = score(xa[:, 0]), score(yb[:, 0])
        layers.append(dict(
            forced_err=float((forced - yb).abs().max() / yb.abs().max()),
            score_gap=_score_gap(np, sa, sb)))
        xb = yb.to(x.dtype)
        del forced
    ca, cb = xa[:, 0].float(), xb[:, 0].float()
    cos = torch.nn.functional.cosine_similarity
    return layers, dict(
        scores=(sa, sb), cls_min_cosine=float(cos(ca, cb, dim=1).min()),
        cls_centred_min_cosine=float(cos(ca - ca.mean(0), cb - cb.mean(0),
                                         dim=1).min()))


def _rerank_stacks(torch, ce, mask, fault_at=None, int8_hook=None):
    """The layer stacks of the rerank phase's two paths over one batch
    (``mask`` its key mask): {"int8": (the int8 view's layers on K1-K3,
    their plain composition), "bf16": (the CE's layers with K5, with the
    plain attention)}, and the input each path starts from as a function
    of the token ids. ``fault_at``: layer ``i`` of each plain stack
    attends over every key, padding included (a control the gates must
    reject). ``int8_hook(i, quant, attend) -> (quant, attend)`` swaps the
    row pass and the attention of layer ``i`` of the plain int8 stack
    (``scripts/torch_rerank_witness.py``'s controls)."""
    from simxns_tpu_torch.models import int8_view
    from simxns_tpu_torch.ops import flash_attention as fa
    from simxns_tpu_torch.ops import fused_layer as fl

    view = int8_view(ce)
    cfg = view.encoder.cfg
    ones = torch.ones_like(mask)

    def plain8(layer, i):
        def attend(qkv, m, heads):
            return fl._small_s_attention_plain(
                qkv, ones if i == fault_at else m, heads)

        def linear(a8, xs, w8, ws, b, gelu=False, out_dtype=torch.float32):
            return fl._int8_linear_plain(a8, xs, w8, ws, b, gelu, out_dtype)

        def quant(x, residual=None, ln=None, eps=1e-12, quant=True,
                  out_f32=False, out_bf16=False):
            return fl._row_quant_plain(x, residual, ln, eps, quant, out_f32,
                                       out_bf16)

        if int8_hook is not None:
            quant, attend = int8_hook(i, quant, attend)
        return lambda h: fl._compose(h, mask, layer.quantized(),
                                     cfg.num_heads, cfg.layer_norm_eps,
                                     linear, quant, attend)

    def plain16(layer, i):
        def attend(q, k, v, m):
            return fa._group_fwd_plain(q, k, v, ones if i == fault_at else m)

        def run(h):
            fwd = fa.group_attention_fwd
            fa.group_attention_fwd = attend
            try:
                return layer(h, mask)[0]
            finally:
                fa.group_attention_fwd = fwd
        return run

    def kernel(layer):
        return lambda h: layer(h, mask)[0]

    stacks = {
        "int8": ([kernel(layer) for layer in view.encoder.layers],
                 [plain8(layer, i)
                  for i, layer in enumerate(view.encoder.layers)]),
        "bf16": ([kernel(layer) for layer in ce.encoder.layers],
                 [plain16(layer, i)
                  for i, layer in enumerate(ce.encoder.layers)])}
    embed = {"int8": lambda ids: view.encoder.embed(ids).to(cfg.dtype),
             "bf16": lambda ids: ce.encoder.embed(ids)}
    return stacks, embed


def phase_rerank(torch, smi, records):
    """Phase 16: ``rerank_topk`` with the nq reranker (CE-large,
    small_s_attn="group", random weights from seed 0) over 64 queries x
    top-100 joint rows of 160 tokens (6,400 rows, batches of 256), through
    the int8 view (K1-K3) and in bf16 (K5 forward); K1-K3 checked and timed
    at the rerank batch (40,960 tokens); the first batch held against the
    plain versions layer by layer, and a fault that must fail that check."""
    import numpy as np

    from simxns_tpu_torch import ops
    from simxns_tpu_torch.evals import rerank_topk
    from simxns_tpu_torch.models.bert import dense

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    fresh_peak(torch)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, device=dev, generator=gen) * scale

    batch, n_q, k, n_pass = 256, 64, 100, 2048
    m = batch * LJ
    kernels = {
        "int8_linear": _check_int8_linear(torch, randn, m, CE_H, CE_F),
        "row_quant": _check_row_quant(torch, randn, m, CE_H, CE_F),
        "small_s_attention": _check_small_s_attention(
            torch, randn, gen, ((batch, LJ, 100),), CE_H, CE_HEADS)}
    for name, rec in kernels.items():
        records[name]["rerank"] = rec
        emit("kernel_rerank_shapes", name=name, nvidia_smi=smi, tokens=m,
             hidden=CE_H, ffn=CE_F, heads=CE_HEADS, **rec)
    torch.cuda.empty_cache()

    joint = _rerank_joint(n_q, k, n_pass)

    ce = _ce_large(torch)
    rerank_topk(ce, joint[:4], batch=batch, fused_int8=True)     # warm
    rerank_topk(ce, joint[:4], batch=batch)
    out, launches = {}, {}
    for label, fused in (("int8", True), ("bf16", False)):
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scores, order = rerank_topk(ce, joint, batch=batch, fused_int8=fused)
        seconds = time.perf_counter() - t0
        launches[label] = ops.launches()
        check(np.isfinite(scores).all() and scores.shape == (n_q, k)
              and (order == np.argsort(-scores, axis=1,
                                       kind="stable")).all(),
              f"rerank {label}: scores not finite or order not their "
              "stable argsort")
        out[label] = dict(scores=scores, order=order, seconds=seconds,
                          rows_per_s=n_q * k / seconds)
    batches = -(-n_q * k // batch)
    layers = CE_LAYERS * batches
    check(launches["int8"]["int8_linear"] == 4 * layers
          and launches["int8"]["small_s_attention"] == layers
          and launches["int8"]["row_quant"] > 0
          and launches["bf16"]["group_attention_fwd"] == layers
          and launches["bf16"]["group_attention_bwd"] == 0,
          f"rerank launches {launches}")

    # the first 256 rows, layer by layer, against the plain versions: K1-K3
    # (the int8 view), K5 (bf16). The limits are readings of
    # scripts/torch_rerank_witness.py (PERF.md section 2): with random
    # weights the rows' scores spread so little that one bf16 rounding in
    # one layer moves them by about their spread, so the scores only
    # catch scores on the wrong rows; each layer on the plain path's input
    # catches a fault in a kernel
    ids = torch.from_numpy(joint.reshape(-1, LJ)[:batch]).to(dev).long()
    mask = (ids != 0).to(torch.int32)

    def score(cls):
        return dense(ce.qa_classifier, cls.to(torch.bfloat16),
                     torch.bfloat16)[:, 0].float().cpu().numpy()

    def held_to(layers, final):
        rec = dict(_score_gap(np, *final["scores"]),
                   layer_forced_err_max=max(r["forced_err"] for r in layers),
                   cls_min_cosine=final["cls_min_cosine"],
                   cls_centred_min_cosine=final["cls_centred_min_cosine"])
        rec["within_limits"] = (
            rec["layer_forced_err_max"] <= RERANK_LAYER_TOL
            and rec["gap_over_spread"] <= RERANK_GAP
            and rec["correlation"] >= RERANK_CORR)
        return rec

    held = {}
    with torch.no_grad():
        stacks, embed = _rerank_stacks(torch, ce, mask)
        for label, (kern, plain) in stacks.items():
            layers, final = _layer_walk(torch, kern, plain, embed[label](ids),
                                        score)
            # rerank_topk's first batch is the kernel path over these rows
            check(np.array_equal(out[label]["scores"].reshape(-1)[:batch],
                                 final["scores"][0]),
                  f"rerank {label}: rerank_topk's first batch differs from a "
                  "forward of its rows")
            held[label] = held_to(layers, final)
            check(held[label]["within_limits"]
                  and held[label]["cls_min_cosine"] >= 0.995,
                  f"rerank {label}, kernels vs plain: {held[label]}")
        # a fault the limits must reject: the middle layer of the plain int8
        # path attends over the padding too
        faulty, _ = _rerank_stacks(torch, ce, mask, fault_at=CE_LAYERS // 2)
        fault = held_to(*_layer_walk(torch, faulty["int8"][1],
                                     stacks["int8"][1], embed["int8"](ids),
                                     score))
        check(not fault["within_limits"],
              f"rerank: a layer attending over padding passed: {fault}")
    del stacks, faulty
    top = 10
    overlap = float(np.mean([
        len(set(out["int8"]["order"][q, :top])
            & set(out["bf16"]["order"][q, :top])) / top
        for q in range(n_q)]))
    emit("rerank", nvidia_smi=smi, queries=n_q, top_k=k, joint_length=LJ,
         rows=n_q * k, batch=batch,
         rows_per_s={lbl: r["rows_per_s"] for lbl, r in out.items()},
         seconds={lbl: r["seconds"] for lbl, r in out.items()},
         launches={lbl: {n: v for n, v in c.items() if v}
                   for lbl, c in launches.items()},
         kernel_vs_plain_first_batch=held,
         limits={"layer_forced_err": RERANK_LAYER_TOL,
                 "gap_over_spread": RERANK_GAP,
                 "correlation": RERANK_CORR, "cls_min_cosine": 0.995},
         fault_unmasked_middle_layer=fault,
         top10_overlap_int8_vs_bf16=overlap,
         max_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    _launch_totals(records, "rerank",
                   {n: launches["int8"][n] + launches["bf16"][n]
                    for n in launches["int8"]})
    del ce
    fresh_peak(torch)


# --- phase 17: data parallelism ---------------------------------------------

DP_WORLD = 2            # gloo ranks sharing the one card
DP_STEPS = 2            # steps of each kind, on phase 5's batches 0 and 1
DP_CHUNK = 262_144      # rows a streaming-build chunk of the split index
DP_K = 10
# two gloo ranks (4 queries each) against the world-1 steps over the same 8
# queries, each kind 2 steps from the same weights: the loss (relative), the
# cosine of the two runs' parameter updates, the largest parameter
# difference in units of the step's learning rate. Readings (PERF.md, PR
# 14): loss 3.2e-4 (reranker) to 0.019 (the DE's second step), cosine
# 0.982-0.997, difference up to 4.0 lr. Limits: 2.5x the loss and cosine
# gaps; the difference within AdamW's bound (two steps of at most ~1.05 lr
# each way), which only a wrong update scale exceeds.
DP_LOSS_REL, DP_UPDATE_COS, DP_PARAM_LR = 5e-2, 0.95, 4.5
DP_PATH = ("int8_linear", "row_quant", "small_s_attention",
           "group_attention_fwd", "group_attention_bwd")
DP_MINE = ("int8_linear", "row_quant", "small_s_attention",
           "mips_bucket_candidates")
# (c)'s depth, cut from phase 7's to keep the script inside its time limit:
# two windows of DP_CO_WINDOW steps (one reranker step, then one retriever
# step), DP_CO_STEPS in all, over DP_CO_Q queries (phase 7: two windows of
# 4 steps over MINE_Q); its corpus and other flags are phase 7's
DP_CO_STEPS, DP_CO_WINDOW, DP_CO_Q = 4, 2, 32


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _dp_models(torch):
    """Phase 5's models (seed 0), the teacher view and ``DP_STEPS`` global
    batches of 8 x 16. -> (de, ce, view, batches, init seconds)."""
    import numpy as np

    from simxns_tpu_torch.models import int8_view

    de, ce, init_s = _full_models(torch, "xla")
    return (de, ce, int8_view(ce),
            [_train_batch(np, seed) for seed in range(DP_STEPS)], init_s)


def _dp_kinds(torch, de, ce, view, mesh):
    """{kind: (model, step(state, batch), lr)}: phase 5's three steps (the
    retriever's teacher the int8 view; adv_lambda=0, the nq recipe's)."""
    from simxns_tpu_torch.train import (make_adamw, make_ar2_retriever_step,
                                        make_biencoder_step,
                                        make_reranker_step)

    tx_de = make_adamw(1e-5, total_steps=0)
    tx_ce = make_adamw(1e-6, total_steps=0)
    retriever = make_ar2_retriever_step(tx_de, temperature=1.0,
                                        adv_lambda=0.0, mesh=mesh)
    return {"biencoder": (de, make_biencoder_step(tx_de, mesh=mesh), tx_de,
                          1e-5),
            "retriever": (de, lambda s, b: retriever(s, view, b), tx_de,
                          1e-5),
            "reranker": (ce, make_reranker_step(tx_ce, mesh=mesh), tx_ce,
                         1e-6)}


def _dp_steps(torch, kind, init, batches, mesh):
    """``DP_STEPS`` steps of one kind (``_dp_kinds``' tuple) from the
    parameters ``init``, each on this rank's rows of its global batch.
    -> (metrics per step, ms per step: host clock to a synchronise)."""
    from simxns_tpu_torch.parallel import shard_batch
    from simxns_tpu_torch.train import TrainState

    model, step, tx, _ = kind
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(init[n])
    state = TrainState.create(model, tx)
    metrics, step_ms = [], []
    for batch in batches:
        t0 = time.perf_counter()
        state, m = step(state, shard_batch(batch, mesh))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, step_ms


def _dp_index_rows(torch):
    """The passage encoder of the split index: row i is token id i + 1, and
    a streaming-build chunk's rows are normal values from a generator
    seeded by its first token, so a chunk holds the same rows whichever
    rank builds it (every shard starts on a chunk boundary)."""
    def encode(ids, mask):
        gen = torch.Generator(device=ids.device).manual_seed(
            1000 + int(ids[0, 0]))
        return torch.randn(ids.shape[0], H, device=ids.device, generator=gen)

    return encode


def _dp_search(torch, mesh):
    """Build the ``INDEX_ROWS`` x 768 int8 index (fused mode; under a group
    each rank its shard) and search it with 8 and 1,024 queries, k=10.
    -> ({"q8"/"q1024": (scores, ids)}, {"q8"/"q1024": ms}, build s)."""
    import numpy as np

    from simxns_tpu_torch.index import MIPSIndex

    queries = np.random.default_rng(11).standard_normal((1024, H),
                                                        dtype=np.float32)
    index = MIPSIndex(torch.device("cuda"), store_dtype=torch.int8,
                      mode="fused", mesh=mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index.build_streaming(_dp_index_rows(torch), np.arange(
        1, INDEX_ROWS + 1, dtype=np.int32)[:, None], chunk_size=DP_CHUNK)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    found, ms = {}, {}
    for nq in (8, 1024):
        index.search(queries[:nq], DP_K)                # warm-up
        t0 = time.perf_counter()
        found[f"q{nq}"] = index.search(queries[:nq], DP_K)
        ms[f"q{nq}"] = (time.perf_counter() - t0) * 1e3
    del index
    return found, ms, build_s


def _dp_world_one(torch, root):
    """(a) NCCL at world 1, in this process: each kind's steps with no group,
    then through the mesh path from the same weights, under
    ``torch.use_deterministic_algorithms`` (without it the position and
    token-type embedding gradients add with atomics): metrics and
    parameters bitwise equal. The no-group results and the world-1 search
    of the split index are saved under ``root`` for the ranks of (b)."""
    import numpy as np
    import torch.distributed as dist

    from simxns_tpu_torch import ops
    from simxns_tpu_torch.parallel import Mesh

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", rank=0, world_size=1,
                            init_method=f"tcp://localhost:{_free_port()}")
    rec = {"kinds": {}}
    launches = {name: 0 for name in ops.KERNELS}
    try:
        mesh = Mesh.of_group(None, dev)
        fresh_peak(torch)
        de, ce, view, batches, rec["model_init_s"] = _dp_models(torch)
        plain = _dp_kinds(torch, de, ce, view, None)
        grouped = _dp_kinds(torch, de, ce, view, mesh)
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            for kind in plain:
                model = plain[kind][0]
                init = {n: p.detach().clone()
                        for n, p in model.named_parameters()}
                want, want_ms = _dp_steps(torch, plain[kind], init, batches,
                                          None)
                after = {n: p.detach().clone()
                         for n, p in model.named_parameters()}
                # the main path: launch counts zeroed just before, read after
                ops.reset_launches()
                torch.cuda.synchronize()
                got, got_ms = _dp_steps(torch, grouped[kind], init, batches,
                                        mesh)
                for name, n in ops.launches().items():
                    launches[name] += n
                differ = [n for n, p in model.named_parameters()
                          if not torch.equal(p.detach(), after[n])]
                check(got == want and not differ,
                      f"{kind}: NCCL world 1 differs from no group: "
                      f"{got} vs {want}; parameters {differ[:5]}")
                torch.save({"metrics": want,
                            "init": {n: t.cpu() for n, t in init.items()},
                            "params": {n: t.cpu() for n, t in after.items()}},
                           f"{root}/world1_{kind}.pt")
                rec["kinds"][kind] = {"metrics": want,
                                      "step_ms_no_group": want_ms,
                                      "step_ms_nccl_world_1": got_ms,
                                      "bitwise_equal": True}
                with torch.no_grad():
                    for n, p in model.named_parameters():
                        p.copy_(init[n])
                del init, after
        finally:
            torch.use_deterministic_algorithms(False)
        for name in DP_PATH:
            check(launches[name] > 0, f"{name} was not launched on the NCCL "
                  "world-1 step path")
        rec["launches"] = launches
        rec["max_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del de, ce, view, plain, grouped
    finally:
        dist.destroy_process_group()
    fresh_peak(torch)
    found, ms, build_s = _dp_search(torch, None)
    np.savez(f"{root}/world1_search.npz",
             **{f"{q}_{part}": np.asarray(arr)
                for q, pair in found.items()
                for part, arr in zip(("scores", "ids"), pair)})
    rec["search_world_1"] = {"ms": ms, "build_s": build_s}
    fresh_peak(torch)
    return rec, launches


def _dp_rank_steps(torch, root):
    """(b), one gloo rank of ``DP_WORLD`` on the card: the three kinds on
    its 4 of every 8 queries against the world-1 steps of (a) (saved under
    ``root``), the parameters compared across ranks bit for bit; then its
    shard of the split index, searched, against the world-1 search."""
    import numpy as np
    import torch.distributed as dist

    from simxns_tpu_torch import ops
    from simxns_tpu_torch.parallel import create_mesh

    mesh = create_mesh("cuda:0", backend="gloo", timeout_s=900)
    dev = mesh.device
    rec = {"rank": mesh.rank, "kinds": {}}
    de, ce, view, batches, rec["model_init_s"] = _dp_models(torch)
    kinds = _dp_kinds(torch, de, ce, view, mesh)
    ops.reset_launches()
    torch.cuda.synchronize()
    for kind, spec in kinds.items():
        model, lr = spec[0], spec[3]
        ref = torch.load(f"{root}/world1_{kind}.pt", weights_only=True)
        init = {n: t.to(dev) for n, t in ref["init"].items()}
        metrics, step_ms = _dp_steps(torch, spec, init, batches, mesh)
        dot = n_got = n_want = 0.0
        max_diff = 0.0
        differ_across_ranks = 0
        for n, p in model.named_parameters():
            got = p.detach()
            want = ref["params"][n].to(dev)
            d_got = (got - init[n]).double()
            d_want = (want - init[n]).double()
            dot += float((d_got * d_want).sum())
            n_got += float((d_got * d_got).sum())
            n_want += float((d_want * d_want).sum())
            max_diff = max(max_diff, float((got - want).abs().max()))
            parts = [torch.empty_like(got) for _ in range(mesh.world_size)]
            dist.all_gather(parts, got.contiguous(), group=mesh.group)
            differ_across_ranks += int(not all(torch.equal(parts[0], x)
                                               for x in parts[1:]))
        rec["kinds"][kind] = {
            "metrics": metrics, "world1_metrics": ref["metrics"],
            "step_ms": step_ms,
            "loss_rel": max(abs(g["loss"] - w["loss"]) / abs(w["loss"])
                            for g, w in zip(metrics, ref["metrics"])),
            "update_cosine": dot / math.sqrt(n_got * n_want),
            "param_max_diff_over_lr": max_diff / lr,
            "params_differing_across_ranks": differ_across_ranks}
        del init, ref
    rec["launches_steps"] = ops.launches()
    del de, ce, view, kinds
    fresh_peak(torch)
    ops.reset_launches()
    found, ms, build_s = _dp_search(torch, mesh)
    rec["launches_index"] = ops.launches()
    want = np.load(f"{root}/world1_search.npz")
    rec["search"] = {"ms": ms, "build_s": build_s, "bitwise_equal": {
        q: bool(np.array_equal(found[q][0], want[f"{q}_scores"])
                and np.array_equal(found[q][1], want[f"{q}_ids"]))
        for q in found}}
    rec["max_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    with open(f"{root}/steps_rank{mesh.rank}.json", "w") as f:
        json.dump(rec, f)
    dist.destroy_process_group()


def _dp_rank_co_training(torch, root, resume):
    """(c), one rank of ``run_ar2`` under torchrun: phase 7's nq run (its
    flags and cuts, with DP_CO_STEPS steps in windows of DP_CO_WINDOW and
    DP_CO_Q queries) with the gloo group on the card, each step timed."""
    import torch.distributed as dist

    from simxns_tpu_torch import ops, run

    step_ms = {}
    for name, kind in STEP_FACTORIES.items():
        setattr(run, name, _timed_factory(torch, getattr(run, name), kind,
                                          step_ms))
    ops.reset_launches()
    t0 = time.perf_counter()
    out = _co_training_run(run, "nq_ar2_simans", CO_TRAINING_FLAGS + [
        "--steps", str(DP_CO_STEPS), "--num-queries", str(DP_CO_Q),
        "--output-dir", f"{root}/co_training", "--dist-backend", "gloo",
        "--device", "cuda:0"] + (["--resume", "auto"] if resume else []),
        window=DP_CO_WINDOW)
    torch.cuda.synchronize()
    rank = dist.get_rank()
    rec = {"rank": rank, "wall_s": time.perf_counter() - t0,
           "launches": ops.launches(), "step_ms": step_ms,
           "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           **{k: out[k] for k in ("top1", "mrr10", "history_top1",
                                  "phase_times_s", "max_memory_gb_by_rank",
                                  "world_size")}}
    name = "co_training_resume" if resume else "co_training"
    with open(f"{root}/{name}_rank{rank}.json", "w") as f:
        json.dump(rec, f)
    dist.destroy_process_group()


def _torchrun(args, timeout_s):
    """``python -m torch.distributed.run --standalone`` with ``DP_WORLD``
    ranks of this script in its rank mode; the process group (torchrun and
    its ranks) is killed if it outlives ``timeout_s``. -> wall seconds."""
    import signal

    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={DP_WORLD}", os.path.abspath(__file__),
           "--data-parallel-rank", *args]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise AssertionError(f"torchrun {args}: over {timeout_s} s\n"
                             f"{out[-6000:]}")
    check(proc.returncode == 0,
          f"torchrun {args}: exit {proc.returncode}\n{out[-6000:]}")
    return time.perf_counter() - t0


def _rank_files(root, name):
    out = []
    for rank in range(DP_WORLD):
        with open(f"{root}/{name}_rank{rank}.json", encoding="utf-8") as f:
            out.append(json.load(f))
    return out


def phase_data_parallel(torch, smi, records, co_training):
    """Phase 17: data parallelism over ``torch.distributed``. (a) NCCL at
    world 1 in this process; (b) two gloo ranks on the card (torchrun):
    the three step kinds at phase 5's width against the world-1 steps, the
    split 8.8M-row index against the world-1 search; (c) ``run_ar2`` under
    torchrun at world 2 in phase 7's nq configuration (two windows of
    DP_CO_WINDOW steps, DP_CO_Q queries), and a resume. Two
    ranks on one card check correctness, not scaling: the gloo collectives
    cross the host."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="chip_smoke_data_parallel_")
    totals = {}
    try:
        # (a)
        t0 = time.perf_counter()
        world1, launches = _dp_world_one(torch, root)
        world1["seconds"] = time.perf_counter() - t0
        emit("data_parallel_world_1", nvidia_smi=smi, **world1)
        totals = dict(launches)

        # (b)
        wall = _torchrun(["steps", root], 900)
        ranks = _rank_files(root, "steps")
        for r in ranks:
            for kind, k in r["kinds"].items():
                what = f"rank {r['rank']} {kind}"
                check(k["params_differing_across_ranks"] == 0,
                      f"{what}: parameters differ across ranks")
                check(k["loss_rel"] <= DP_LOSS_REL
                      and k["update_cosine"] >= DP_UPDATE_COS
                      and k["param_max_diff_over_lr"] <= DP_PARAM_LR,
                      f"{what} against world 1: {k}")
                check(all(math.isfinite(m["loss"]) for m in k["metrics"]),
                      f"{what}: losses {k['metrics']}")
            check(all(r["search"]["bitwise_equal"].values()),
                  f"rank {r['rank']}: the split index's search differs "
                  f"from the world-1 search: {r['search']}")
            for name in DP_PATH:
                check(r["launches_steps"][name] > 0,
                      f"rank {r['rank']}: {name} not launched in its steps")
            check(r["launches_index"]["mips_bucket_candidates"] > 0,
                  f"rank {r['rank']}: K4 not launched in its search")
            for name in totals:
                totals[name] += (r["launches_steps"][name]
                                 + r["launches_index"][name])
        emit("data_parallel_steps", nvidia_smi=smi, world=DP_WORLD,
             backend="gloo", torchrun_wall_s=wall,
             limits={"loss_rel": DP_LOSS_REL,
                     "update_cosine": DP_UPDATE_COS,
                     "param_max_diff_over_lr": DP_PARAM_LR},
             world1_search=world1["search_world_1"], ranks=ranks)

        # (c)
        co = {}
        for resume in (False, True):
            name = "co_training_resume" if resume else "co_training"
            wall = _torchrun(["co_training", root]
                             + (["resume"] if resume else []), 900)
            ranks = _rank_files(root, name)
            for r in ranks:
                check(r["world_size"] == DP_WORLD
                      and r["history_top1"] == ranks[0]["history_top1"]
                      and r["top1"] == ranks[0]["top1"],
                      f"{name}: the ranks' mines differ: {ranks}")
                # the relaunch resumes at the last step: it mines, no step
                path = (DP_MINE if resume
                        else CO_TRAINING["nq_ar2_simans"])
                for kname in path:
                    check(r["launches"][kname] > 0,
                          f"{name} rank {r['rank']}: {kname} not launched")
                for kname in totals:
                    totals[kname] += r["launches"][kname]
            co[name] = {"torchrun_wall_s": wall, "ranks": ranks}
        out_dir = f"{root}/co_training"
        losses = _co_training_losses(out_dir)
        check(len(losses) == DP_CO_STEPS
              and all(math.isfinite(x[2]) for x in losses),
              f"world-2 co-training losses {losses}")
        names = set(os.listdir(out_dir))
        for step in range(DP_CO_WINDOW, DP_CO_STEPS + 1, DP_CO_WINDOW):
            for state in ("retriever_state", "reranker_state"):
                check(f"{state}-{step}" in names,
                      f"world 2: no {state}-{step} checkpoint")
        with open(f"{out_dir}/metrics.jsonl", encoding="utf-8") as f:
            resumed = [json.loads(line) for line in f
                       if '"resume_eval"' in line]
        check(len(resumed) == 1 and resumed[0]["step"] == DP_CO_STEPS,
              f"world-2 resume did not restore step {DP_CO_STEPS}: "
              f"{resumed}")
        nq = co_training["nq_ar2_simans"]
        emit("data_parallel_co_training", nvidia_smi=smi, world=DP_WORLD,
             backend="gloo", losses=losses, world1_losses=nq["losses"],
             world1_phase_times_s=nq["phase_times_s"],
             world1_max_memory_gb=nq["max_memory_gb"], **co)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    _launch_totals(records, "data_parallel", totals)


def _data_parallel_rank(argv):
    """A rank of phase 17 or 19 under torchrun: ``steps ROOT``,
    ``co_training ROOT [resume]`` or ``mesh ROOT``."""
    import torch

    check(torch.cuda.is_available(), "a data-parallel rank needs the card")
    what, root = argv[0], argv[1]
    if what == "steps":
        _dp_rank_steps(torch, root)
    elif what == "mesh":
        _mesh_rank(torch, root)
    elif what == "co_training":
        _dp_rank_co_training(torch, root, argv[2:] == ["resume"])
    else:
        raise ValueError(f"unknown rank task {what!r}")
    return 0


# --- phase 18: PROD distillation --------------------------------------------

# the KD recipes at full width: the student's and teacher's attention pair
KD_RECIPES = {"prod_kd_marcodoc": ("bh_attention_fwd", "bh_attention_bwd"),
              "prod_kd_nq": ("group_attention_fwd", "group_attention_bwd")}
KD_TEACHER = ("int8_linear", "row_quant", "small_s_attention")
# 8 queries a step (the recipe's 64 over 8 GPUs), 16 queries (2 teacher
# warm-up steps), 20,480 synthetic passages (above 20,000 they keep the
# recipe's token lengths: 256 marcodoc, 128 nq), then a relaunch to 12
KD_FLAGS = ["--synthetic", "--full-size", "--fast-teacher", "--batch", "8",
            "--corpus-size", "20480", "--num-queries", "16"]
KD_STEPS, KD_RESUME_STEPS = 8, 12
KD_N, KD_M, KD_LQ, KD_LC, KD_LJ = 8, 8, 32, 256, 288   # marcodoc's shapes
# the first KD step's student gradients with K7/K8 against their plain
# versions (marcodoc), beside two plain versions that round p otherwise,
# as phase 5's reranker rule. With random weights the student's CLS
# embeddings nearly coincide (scores ~|e|^2), so one bf16 rounding moves
# the KD loss by percents. Readings (PERF.md, section 6): kernel against plain
# loss 0.0529 relative, two plain versions 0.0523; gradient cosine 0.9728,
# two plain versions 0.9745. Limits: the loss within 2.5x the two plain
# versions' gap (or 1e-2), the cosine within 2.5x the reading's 0.0017 of
# theirs.
KD_LOSS_REL, KD_LOSS_FACTOR, KD_FLOOR_GAP = 1e-2, 2.5, 0.005


def _kd_batch(np, seed):
    """One marcodoc KD batch: 8 queries x 8 passages (1 positive, 7
    negatives, the recipe's cut), 32 / 256 / 288 tokens, random lengths;
    the joint row is the query's tokens, then the passage's."""
    rng = np.random.default_rng(seed)
    n, m = KD_N, KD_M

    def tokens(rows, width, lo):
        lens = rng.integers(lo, width + 1, rows)
        ids = rng.integers(1000, 30522, (rows, width)).astype(np.int32)
        ids[:, 0] = 101
        mask = (np.arange(width)[None, :] < lens[:, None]).astype(np.int32)
        return ids * mask, mask, lens

    q_ids, q_mask, q_lens = tokens(n, KD_LQ, 8)
    c_ids, c_mask, c_lens = tokens(n * m, KD_LC, 120)
    pos = np.arange(KD_LJ)[None, :]
    ql = np.repeat(q_lens, m)[:, None]
    src = np.clip(pos - ql + 1, 0, KD_LC - 1)
    joint = np.where(pos < ql, np.repeat(q_ids, m, 0)[:, np.minimum(
        np.arange(KD_LJ), KD_LQ - 1)], np.take_along_axis(c_ids, src, 1))
    jmask = (pos < np.minimum(ql + c_lens[:, None] - 1, KD_LJ)).astype(
        np.int32)
    return {"q_ids": q_ids, "q_mask": q_mask, "ctx_ids": c_ids,
            "ctx_mask": c_mask,
            "positive_idx": (np.arange(n) * m).astype(np.int32),
            "joint_ids": (joint * jmask).reshape(n, m, KD_LJ),
            "joint_mask": jmask.reshape(n, m, KD_LJ)}


def _kd_models(torch):
    """marcodoc's student (6-layer BERT-base DE), CE teacher (12 layers,
    small_s_attn="group") and a 12-layer BERT-base DE teacher, random
    weights from seeds 0, 1, 2, on the card."""
    from simxns_tpu_torch.models import (BertConfig, BiEncoder,
                                         BiEncoderConfig, CrossEncoder,
                                         CrossEncoderConfig)

    dev = torch.device("cuda")
    base = BertConfig(vocab_size=30522, dtype=torch.bfloat16)
    student = BiEncoder(BiEncoderConfig(bert=base.replace(num_layers=6)),
                        generator=torch.Generator().manual_seed(0)).to(dev)
    ce = CrossEncoder(CrossEncoderConfig(bert=base.replace(
        small_s_attn="group")),
        generator=torch.Generator().manual_seed(1)).to(dev)
    de = BiEncoder(BiEncoderConfig(bert=base),
                   generator=torch.Generator().manual_seed(2)).to(dev)
    return student, ce, de


def _kd_student_loss(torch, student, batch, t_logits):
    """The recipe's cross_encoder KD objective (CE_WEIGHT 0.1, KD_WEIGHT
    0.9, T 4, LwF 0 as ``run_kd`` passes it) on given teacher logits."""
    from simxns_tpu_torch.train.kd import _grouped_scores, soft_kd_loss

    q, ctx = student(batch["q_ids"], batch["q_mask"], batch["ctx_ids"],
                     batch["ctx_mask"])
    s = _grouped_scores(q, ctx)
    hard = -torch.log_softmax(s, dim=1)[:, 0].mean()
    zeros = torch.zeros(s.shape[0], dtype=torch.long, device=s.device)
    return 0.1 * hard + 0.9 * soft_kd_loss("KD_softmax", s, t_logits,
                                           zeros, 4.0)


def _kd_full_width(torch, smi):
    """The first KD step's student gradients with K7/K8 against the plain
    versions (and the teacher view's CLS vectors against the plain int8
    composition); one ``double`` and one ``dual_encoder`` step; one LAMB
    step and its update against the same update on the host."""
    import numpy as np

    from simxns_tpu_torch import ops
    from simxns_tpu_torch.models import int8_view
    from simxns_tpu_torch.ops import flash_attention as fa
    from simxns_tpu_torch.ops.fused_layer import layer_int8_plain
    from simxns_tpu_torch.train import (TrainState, make_adamw, make_kd_step,
                                        make_lamb, steps)

    dev = torch.device("cuda")
    fresh_peak(torch)
    t0 = time.perf_counter()
    student, ce, de = _kd_models(torch)
    init_s = time.perf_counter() - t0
    view = int8_view(ce)
    batch = _kd_batch(np, 0)
    b0 = steps.to_device(batch, dev)
    jid = b0["joint_ids"].reshape(-1, KD_LJ)
    jmask = b0["joint_mask"].reshape(-1, KD_LJ)
    with torch.no_grad():
        t_logits = view(jid, jmask, group_size=KD_M)["logits"]
        kern = view.encoder(jid, jmask).pooled.float()
        plain = _plain_encode(view.encoder, jid, jmask,
                              layer_int8_plain).float()
    teacher_cos = float(torch.nn.functional.cosine_similarity(
        kern, plain, dim=1).min())
    check(teacher_cos >= 0.995, f"KD teacher CLS: min cosine {teacher_cos}")
    del kern, plain

    def grads():
        loss = _kd_student_loss(torch, student, b0, t_logits)
        g = steps.gradients(student, loss)
        flat = torch.cat([x.float().flatten() for x in g.values()
                          if x is not None])
        for p in student.parameters():
            p.grad = None
        return float(loss.detach()), flat

    ops.reset_launches()
    loss_k, grad_k = grads()
    launched = ops.launches()
    check(launched["bh_attention_fwd"] > 0 and launched["bh_attention_bwd"]
          > 0, f"K7/K8 not launched in the KD student step: {launched}")
    kernels = fa.bh_attention_fwd, fa.bh_attention_bwd, fa._probs
    fa.bh_attention_fwd, fa.bh_attention_bwd = (fa._group_fwd_plain,
                                                fa._group_bwd_plain)
    try:
        loss_p, grad_p = grads()
        fa._probs = _softmax_probs
        loss_f, grad_f = grads()
    finally:
        fa.bh_attention_fwd, fa.bh_attention_bwd, fa._probs = kernels
    grad_cos = _cosine(torch, grad_k, grad_p)
    floor_cos = _cosine(torch, grad_p, grad_f)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    floor_loss_rel = abs(loss_f - loss_p) / abs(loss_p)
    del grad_k, grad_p, grad_f
    check(loss_rel <= max(KD_LOSS_REL, KD_LOSS_FACTOR * floor_loss_rel)
          and grad_cos >= floor_cos - KD_FLOOR_GAP,
          f"KD student step, K7/K8 vs plain: loss rel {loss_rel} (two plain "
          f"versions: {floor_loss_rel}), gradient cosine {grad_cos} (two "
          f"plain versions: {floor_cos})")

    # one step of each other teacher mode; then LAMB
    rec = {"model_init_s": init_s, "teacher_cls_min_cosine": teacher_cos,
           "student_kernel_vs_plain": {
               "loss_kernel": loss_k, "loss_plain": loss_p,
               "loss_plain_softmax": loss_f, "loss_rel": loss_rel,
               "loss_rel_two_plain": floor_loss_rel,
               "gradient_cosine": grad_cos,
               "gradient_cosine_two_plain": floor_cos},
           "limits": {"loss_rel": KD_LOSS_REL,
                      "loss_factor_over_two_plain": KD_LOSS_FACTOR,
                      "floor_gap": KD_FLOOR_GAP}}
    init = {n: p.detach().clone() for n, p in student.named_parameters()}
    launches = {name: 0 for name in ops.KERNELS}
    for mode, teachers in (("double", {"de": de, "ce": view}),
                           ("dual_encoder", {"de": de})):
        tx = make_adamw(5e-5, total_steps=0)
        step = make_kd_step(tx, mode, kd_type="KD_softmax", temperature=4.0,
                            ce_weight=0.1, kd_weight=0.9)
        state = TrainState.create(student, tx)
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, teachers, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        for name, n in ops.launches().items():
            launches[name] += n
        m = {k: float(v) for k, v in m.items()}
        check(math.isfinite(m["loss"]), f"{mode} KD step: {m}")
        rec[mode] = {"metrics": m, "step_ms": ms}
        with torch.no_grad():
            for n, p in student.named_parameters():
                p.copy_(init[n])
    check(rec["double"]["metrics"]["teacher_pick"] in (0.0, 1.0),
          f"double: {rec['double']}")
    for name in ("bh_attention_fwd", "bh_attention_bwd") + KD_TEACHER:
        check(launches[name] > 0, f"{name} not launched in the double / "
              "dual_encoder steps")

    # LAMB: one KD step, then one more update from its state against the
    # same update on the host (f32), at lr 1 so that the update, not the
    # parameters' f32 spacing, sets the scale of the comparison
    tx = make_lamb(5e-5, total_steps=0)
    lamb_step = make_kd_step(tx, "cross_encoder", kd_type="KD_softmax",
                             temperature=4.0, ce_weight=0.1, kd_weight=0.9)
    state = TrainState.create(student, tx)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = lamb_step(state, {"ce": view}, batch)
    torch.cuda.synchronize()
    lamb_ms = (time.perf_counter() - t0) * 1e3
    check(math.isfinite(float(m["loss"])), f"LAMB KD step: {m}")
    g = steps.gradients(student, _kd_student_loss(torch, student, b0,
                                                  t_logits))
    params = dict(student.named_parameters())
    before = {n: p.detach().cpu().double() for n, p in params.items()}
    host = {n: p.clone() for n, p in before.items()}
    host_state = {"count": state.opt_state["count"],
                  "mu": {n: t.cpu().double()
                         for n, t in state.opt_state["mu"].items()},
                  "nu": {n: t.cpu().double()
                         for n, t in state.opt_state["nu"].items()}}
    one = make_lamb(1.0, total_steps=0)
    one.update_(host, {n: x.cpu().double() for n, x in g.items()},
                host_state)
    one.update_(params, g, state.opt_state)
    # each parameter within 1e-4 of its own update's largest element,
    # against the same update in f64 on the host (reading 5.9e-7; the
    # host's f32 norm of the 23M-element embedding table drifted 1.5e-3;
    # a wrong trust ratio, eps or decay moves a parameter by the order of
    # its update)
    lamb_err = max(float((params[n].detach().cpu().double() - host[n])
                         .abs().max())
                   / max(float((host[n] - before[n]).abs().max()), 1e-30)
                   for n in params)
    moved = sum(int(not torch.equal(host[n], before[n])) for n in params)
    check(lamb_err <= 1e-4 and moved == len(params),
          f"LAMB on the card against the host: {lamb_err}, {moved} of "
          f"{len(params)} moved")
    rec["lamb"] = {"loss": float(m["loss"]), "step_ms": lamb_ms,
                   "update_vs_host_max_rel": lamb_err,
                   "parameters_moved": moved}
    rec["launches"] = launches
    rec["max_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    for p in student.parameters():
        p.grad = None
    del student, ce, de, view, state, init, g, host, before
    return rec, launches


def _kd_losses(out_dir):
    with open(f"{out_dir}/metrics.jsonl", encoding="utf-8") as f:
        return [(r["step"], r["loss"]) for r in map(json.loads, f)
                if r["phase"] == "kd"]


def phase_prod_kd(torch, smi, records):
    """Phase 18: PROD distillation at full width. ``run_kd`` in
    ``prod_kd_marcodoc`` and ``prod_kd_nq`` (8 KD steps, then a relaunch
    that resumes to 12), launch counts zeroed just before each run; then
    the student's gradients on the kernels against the plain versions, a
    ``double`` and a ``dual_encoder`` step and a LAMB step."""
    import shutil
    import tempfile

    from simxns_tpu_torch import ops, run

    root = tempfile.mkdtemp(prefix="chip_smoke_prod_kd_")
    factories = {name: getattr(run, name)
                 for name in ("make_kd_step", "make_reranker_step")}
    totals = {name: 0 for name in ops.KERNELS}
    try:
        for recipe, pair in KD_RECIPES.items():
            out_dir = f"{root}/{recipe}"
            step_ms = {}
            run.make_kd_step = _timed_factory(torch, factories[
                "make_kd_step"], "kd", step_ms)
            run.make_reranker_step = _timed_factory(torch, factories[
                "make_reranker_step"], "teacher_warmup", step_ms)
            rec = {}
            for steps_to, label in ((KD_STEPS, "run"),
                                    (KD_RESUME_STEPS, "resume")):
                fresh_peak(torch)
                ops.reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = run.main(["--recipe", recipe, *KD_FLAGS, "--steps",
                                str(steps_to), "--output-dir", out_dir])
                torch.cuda.synchronize()
                launches = ops.launches()
                for name, n in launches.items():
                    totals[name] += n
                rec[label] = {"wall_s": time.perf_counter() - t0,
                              "steps": out["steps"],
                              "final_loss": out["final_loss"],
                              "phase_times_s": out["phase_times_s"],
                              "max_memory_gb": out["max_memory_gb"],
                              "launches": launches}
                check(out["steps"] == steps_to
                      and math.isfinite(out["final_loss"]),
                      f"{recipe} {label}: {out}")
                path = KD_TEACHER + (pair if label == "run"
                                     else ("bh_attention_fwd",
                                           "bh_attention_bwd")
                                     if recipe == "prod_kd_marcodoc" else ())
                for name in path:
                    check(launches[name] > 0,
                          f"{recipe} {label}: {name} not launched")
            losses = _kd_losses(out_dir)
            check([s for s, _ in losses] == list(range(1, KD_RESUME_STEPS
                                                       + 1))
                  and all(math.isfinite(x) for _, x in losses),
                  f"{recipe}: KD losses {losses}")
            names = set(os.listdir(out_dir))
            for name in ("eval.json", "kd_teacher_state-0",
                         f"student_state-{KD_STEPS}",
                         f"student-{KD_RESUME_STEPS}"):
                check(name in names, f"{recipe}: no {name}")
            check("teacher_warmup" not in rec["resume"]["phase_times_s"],
                  f"{recipe}: the relaunch warmed the teacher again")
            emit("prod_kd", nvidia_smi=smi, recipe=recipe, flags=KD_FLAGS,
                 losses=losses, step_ms=step_ms,
                 steady_kd_step_ms=float(sum(step_ms["kd"][1:KD_STEPS])
                                         / (KD_STEPS - 1)), **rec)
            shutil.rmtree(out_dir, ignore_errors=True)
    finally:
        for name, fn in factories.items():
            setattr(run, name, fn)
        shutil.rmtree(root, ignore_errors=True)
    rec, launches = _kd_full_width(torch, smi)
    for name, n in launches.items():
        totals[name] += n
    emit("prod_kd_steps", nvidia_smi=smi, **rec)
    fresh_peak(torch)
    _launch_totals(records, "prod_kd", totals)


# --- phase 19: the rest of the mesh -----------------------------------------

MESH_WORLD = DP_WORLD   # gloo ranks sharing the one card (torchrun's)
MESH_STEPS = 2          # steps of each kind, on phase 18's batches 0 and 1
MESH_PASSAGES, MESH_REQUESTS = 65_536, 8
# two model ranks (each half of every split layer) against the world-1
# steps from the same weights: the loss (relative), the cosine of the two
# runs' updates, the largest parameter difference in learning rates, over
# the gathered parameters and over each rank's slice. A row-split layer
# sums f32 partials before its bf16 rounding, and with random weights the
# in-batch loss is ill-conditioned (CLS embeddings nearly coincide), so
# the TP readings are held beside a floor measured in (a): the world-1
# steps with every dense layer an f32 product of the bf16 operands (the
# CPU's formula of the same flax function) against the bf16 GEMMs.
# Readings (PERF.md, section 6), TP / floor, on these batches: DE loss 0.017
# / 0.029 relative, update cosine 0.918 / 0.923; retriever 0.017 / 0.045,
# 0.893 / 0.883; on phase 5's batches (8 x 16 x 128) 0.043 / 0.053, 0.913
# / 0.925 and 0.022 / 0.032, 0.887 / 0.905; all 4.00 lr (Adam's sign
# flips). Limits: the loss within 2.5x the floor's gap (or 1e-2), the
# cosine within 2.5x the larger gap seen (0.018) of the floor's, the
# parameters within AdamW's two-step bound (DP_PARAM_LR).
TP_LOSS_REL, TP_LOSS_FACTOR, TP_COS_GAP, TP_PARAM_LR = 1e-2, 2.5, 0.045, 4.5
# slice-scoped negatives over 2 slices against the per-slice oracle from
# world-1 embeddings (the first step's loss, relative). Readings: 9.9e-4
# on these batches (a rank encodes 32 passages, world 1 64: other GEMM
# shapes), 3.5e-8 on phase 5's; negatives gathered over both slices would
# read the global oracle instead (reported beside it). Limit: 5x.
SLICE_LOSS_REL = 5e-3
# the steps: the DE's queries on K5/K6 and its passages on K7/K8 (at
# heads / 2 on a model rank), the teacher's int8 view on K1-K3
MESH_PATH = ("int8_linear", "row_quant", "small_s_attention",
             "group_attention_fwd", "group_attention_bwd",
             "bh_attention_fwd", "bh_attention_bwd")
MESH_SERVING = ("int8_linear", "row_quant", "small_s_attention",
                "mips_bucket_candidates")


def _mesh_models(torch):
    """A BERT-base DE (seed 0, small_s_attn="group") and the int8 view of a
    BERT-base CE teacher (seed 1), phase 18's marcodoc batches 0 and 1 (8
    queries x 8 passages, 32 / 256 / 288 tokens)."""
    import numpy as np

    from simxns_tpu_torch.models import (BertConfig, BiEncoder,
                                         BiEncoderConfig, CrossEncoder,
                                         CrossEncoderConfig, int8_view)

    dev = torch.device("cuda")
    base = BertConfig(vocab_size=30522, dtype=torch.bfloat16,
                      small_s_attn="group")
    de = BiEncoder(BiEncoderConfig(bert=base),
                   generator=torch.Generator().manual_seed(0)).to(dev)
    ce = CrossEncoder(CrossEncoderConfig(bert=base),
                      generator=torch.Generator().manual_seed(1)).to(dev)
    return de, int8_view(ce), [_kd_batch(np, s) for s in range(MESH_STEPS)]


def _mesh_kinds(torch, view, mesh, auto_state=False, scope="global"):
    """{kind: step(state, batch)}: the DE step and the AR2 retriever step
    (adv_lambda 0) at lr 1e-5."""
    from simxns_tpu_torch.train import (make_adamw, make_ar2_retriever_step,
                                        make_biencoder_step)

    tx = make_adamw(1e-5, total_steps=0)
    r = make_ar2_retriever_step(tx, temperature=1.0, adv_lambda=0.0,
                                mesh=mesh, auto_state=auto_state)
    return tx, {"biencoder": make_biencoder_step(
        tx, mesh=mesh, auto_state=auto_state, negatives_scope=scope),
        "retriever": lambda s, b: r(s, view, b)}


def _mesh_run(torch, model, tx, step, init, batches, mesh):
    """Steps from ``init`` (whole parameters; a split model takes its
    slices); -> (metrics, ms per step)."""
    from simxns_tpu_torch.parallel import shard_batch
    from simxns_tpu_torch.parallel.tp import _split_dim, tensor_parallel_of
    from simxns_tpu_torch.train import TrainState

    info = tensor_parallel_of(model)
    with torch.no_grad():
        for n, p in model.named_parameters():
            src = init[n]
            if info is not None and n in info[1]:
                src = src.chunk(info[0].world_size, _split_dim(n, src.ndim))[
                    info[0].rank]
            p.copy_(src)
    state = TrainState.create(model, tx)
    metrics, ms = [], []
    for b in batches:
        t0 = time.perf_counter()
        state, m = step(state, shard_batch(b, mesh))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, ms


def _slice_oracle(torch, de, batch):
    """The per-slice in-batch NLL over 2 slices (each slice's 4 queries
    against its 32 passages), averaged over the 8 queries, from the
    world-1 encoders (no update); and the global one (every query against
    all 64 passages). -> (slice loss, global loss)."""
    from simxns_tpu_torch.losses import in_batch_nll
    from simxns_tpu_torch.train import steps

    b = steps.to_device(batch, torch.device("cuda"))
    with torch.no_grad():
        q, c = de(b["q_ids"], b["q_mask"], b["ctx_ids"], b["ctx_mask"])
    half_q, half_c = KD_N // 2, KD_N * KD_M // 2
    total = 0.0
    for s in range(2):
        loss, _ = in_batch_nll(q[s * half_q:(s + 1) * half_q],
                               c[s * half_c:(s + 1) * half_c],
                               b["positive_idx"][s * half_q:(s + 1) * half_q]
                               - s * half_c, reduction="sum")
        total += float(loss)
    every, _ = in_batch_nll(q, c, b["positive_idx"])
    return total / KD_N, float(every)


def _mesh_retriever(torch, mesh, tokens=None):
    """Phase 3's serving model (BERT-base, fused_int8, seed 0) behind a
    ``DenseRetriever`` over ``MESH_PASSAGES`` synthetic passages (int8
    index, fused mode; ``tokens``: their token ids, else tokenized here)
    answering ``MESH_REQUESTS`` requests of 8 queries (k=10). -> (ids
    [R*8, 10], scores, index s, request ms, the token ids)."""
    import numpy as np

    from simxns_tpu_torch.data import HashTokenizer
    from simxns_tpu_torch.models import BertConfig, BiEncoder, BiEncoderConfig
    from simxns_tpu_torch.serve import DenseRetriever

    model = BiEncoder(BiEncoderConfig(bert=BertConfig(
        vocab_size=30522, dtype=torch.bfloat16, layer_impl="fused_int8")),
        generator=torch.Generator().manual_seed(0))
    passages = _synthetic_passages(MESH_PASSAGES)
    r = DenseRetriever(model, HashTokenizer(vocab_size=30522),
                       device="cuda:0", max_q_length=32, max_ctx_length=128,
                       index_mode="fused", store_dtype=torch.int8,
                       query_batch=8, encode_chunk=1024, mesh=mesh)
    rng = np.random.default_rng(1)
    picks = rng.integers(0, MESH_PASSAGES, MESH_REQUESTS * 8)
    requests = [[" ".join(passages[int(i)][0].split()[:12])
                 for i in picks[q * 8:(q + 1) * 8]]
                for q in range(MESH_REQUESTS)]
    if tokens is None:
        tokens, _ = r._tokenize([passages[i][1] for i in range(MESH_PASSAGES)],
                                [passages[i][0] for i in range(MESH_PASSAGES)],
                                128)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r.index_corpus(passages, precomputed_tokens=tokens)
    torch.cuda.synchronize()
    index_s = time.perf_counter() - t0
    ids, scores, ms = [], [], []
    for req in requests:
        t0 = time.perf_counter()
        hits = r.search(req, k=10)
        ms.append((time.perf_counter() - t0) * 1e3)
        ids += [[h.passage_id for h in q] for q in hits]
        scores += [[h.score for h in q] for q in hits]
    del r, model
    return np.array(ids), np.array(scores), index_s, ms, tokens


def _update_gap(torch, got, want, init, lr):
    """(update cosine, largest parameter difference in learning rates) of
    two runs from ``init``."""
    dot = n_got = n_want = diff = 0.0
    for n, g in got.items():
        w = want[n]
        d_got, d_want = (g - init[n]).double(), (w - init[n]).double()
        dot += float((d_got * d_want).sum())
        n_got += float((d_got * d_got).sum())
        n_want += float((d_want * d_want).sum())
        diff = max(diff, float((g - w).abs().max()))
    return dot / math.sqrt(n_got * n_want), diff / lr


def _mesh_floor(torch, de, step, tx, init, batches, want, after):
    """The same world-1 steps with every dense layer an f32 product of its
    bf16 operands, rounded (``linear_dt``'s CPU formula of the same flax
    function) against the bf16 GEMMs: the size of a rounding change, beside
    which the tensor-parallel steps are held. -> {loss_rel, update_cosine,
    param_max_diff_over_lr}."""
    from simxns_tpu_torch.ops import fused_ffn

    def linear_f32(x, weight, bias, dt):
        y = torch.matmul(x.to(dt).float(), weight.to(dt).float().T)
        return y.to(dt) + bias.to(dt)

    real = fused_ffn.linear_dt
    fused_ffn.linear_dt = linear_f32
    try:
        got, _ = _mesh_run(torch, de, tx, step, init, batches, None)
    finally:
        fused_ffn.linear_dt = real
    cos, diff = _update_gap(torch, {n: p.detach() for n, p in
                                    de.named_parameters()}, after, init, 1e-5)
    return {"metrics": got,
            "loss_rel": max(abs(g["loss"] - w["loss"]) / abs(w["loss"])
                            for g, w in zip(got, want)),
            "update_cosine": cos, "param_max_diff_over_lr": diff}


def _mesh_world_one(torch, root):
    """(a) NCCL at world 1 in this process: the DE and retriever steps with
    no group, then on ``create_mesh(n_data=1, n_model=1)`` (``auto_state``,
    the split a no-op) and on ``create_multislice_mesh(1)`` (slice-scoped
    negatives), bitwise equal (deterministic algorithms on). Saved under
    ``root`` for the ranks of (b)-(d): the world-1 steps, the per-slice
    oracle, the world-1 retriever's hits."""
    import numpy as np
    import torch.distributed as dist

    from simxns_tpu_torch import ops
    from simxns_tpu_torch.parallel import create_mesh, create_multislice_mesh
    from simxns_tpu_torch.parallel.tp import shard_params

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", rank=0, world_size=1,
                            init_method=f"tcp://localhost:{_free_port()}")
    rec = {"kinds": {}}
    launches = {name: 0 for name in ops.KERNELS}
    try:
        fresh_peak(torch)
        de, view, batches = _mesh_models(torch)
        init = {n: p.detach().clone() for n, p in de.named_parameters()}
        tp = create_mesh("cuda:0", n_data=1, n_model=1)
        ms = create_multislice_mesh(1, device="cuda:0")
        shard_params(de, tp)          # n_model 1: the module as it is
        rec["oracle_slice_loss"], rec["oracle_global_loss"] = \
            _slice_oracle(torch, de, batches[0])
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            for kind in ("biencoder", "retriever"):
                tx, plain = _mesh_kinds(torch, view, None)
                want, want_ms = _mesh_run(torch, de, tx, plain[kind], init,
                                          batches, None)
                after = {n: p.detach().clone()
                         for n, p in de.named_parameters()}
                runs = {"model_1": _mesh_kinds(torch, view, tp,
                                               auto_state=True),
                        "multislice_1": _mesh_kinds(torch, view, ms,
                                                    scope="slice")}
                got_ms = {}
                for label, (tx2, kinds) in runs.items():
                    # the main path: launch counts zeroed just before
                    ops.reset_launches()
                    torch.cuda.synchronize()
                    got, got_ms[label] = _mesh_run(torch, de, tx2,
                                                   kinds[kind], init,
                                                   batches, tp if label ==
                                                   "model_1" else ms)
                    for name, n in ops.launches().items():
                        launches[name] += n
                    differ = [n for n, p in de.named_parameters()
                              if not torch.equal(p.detach(), after[n])]
                    check(got == want and not differ,
                          f"{kind} on {label} differs from no group: {got} "
                          f"vs {want}; parameters {differ[:5]}")
                torch.save({"metrics": want,
                            "init": {n: t.cpu() for n, t in init.items()},
                            "params": {n: t.cpu() for n, t in after.items()}},
                           f"{root}/mesh1_{kind}.pt")
                rec["kinds"][kind] = {"metrics": want,
                                      "step_ms_no_group": want_ms,
                                      "step_ms": got_ms,
                                      "bitwise_equal": True,
                                      "floor": _mesh_floor(
                                          torch, de, plain[kind], tx, init,
                                          batches, want, after)}
        finally:
            torch.use_deterministic_algorithms(False)
        for name in MESH_PATH:
            check(launches[name] > 0, f"{name} not launched on the world-1 "
                  "mesh steps")
        with open(f"{root}/mesh1_oracle.json", "w") as f:
            json.dump({"slice": rec["oracle_slice_loss"],
                       "global": rec["oracle_global_loss"]}, f)
        for kind in rec["kinds"]:
            check(all(math.isfinite(m["loss"]) for m in
                      rec["kinds"][kind]["floor"]["metrics"]),
                  f"{kind}: the f32-product floor run: {rec['kinds'][kind]}")
        rec["max_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del de, view, init, after
    finally:
        dist.destroy_process_group()
    fresh_peak(torch)
    ids, scores, index_s, req_ms, tokens = _mesh_retriever(torch, None)
    np.savez(f"{root}/mesh1_retriever.npz", ids=ids, scores=scores,
             tokens=tokens)
    rec["retriever_world_1"] = {"index_s": index_s, "request_ms": req_ms}
    fresh_peak(torch)
    return rec, launches


def _mesh_rank(torch, root):
    """(b)-(d), one gloo rank of ``MESH_WORLD`` on the card: (b) the DE and
    retriever steps with the DE split over (data 1, model 2)
    (``auto_state``) against the world-1 steps; (c) slice-scoped negatives
    over 2 slices x 1 against the per-slice oracle; (d) the sharded
    ``DenseRetriever`` against the world-1 retriever's ids."""
    import numpy as np
    import torch.distributed as dist

    from simxns_tpu_torch import ops
    from simxns_tpu_torch.parallel import create_mesh, create_multislice_mesh
    from simxns_tpu_torch.parallel.tp import (_all_gather, _split_dim,
                                              shard_params,
                                              tensor_parallel_of)

    world = create_mesh("cuda:0", backend="gloo", timeout_s=900)
    dev = world.device
    tp = create_mesh("cuda:0", n_data=1, n_model=MESH_WORLD)
    ms = create_multislice_mesh(MESH_WORLD, device="cuda:0")
    rec = {"rank": world.rank, "kinds": {}}
    de, view, batches = _mesh_models(torch)
    shard_params(de, tp)
    split = tensor_parallel_of(de)[1]
    ops.reset_launches()
    torch.cuda.synchronize()
    for kind in ("biencoder", "retriever"):
        ref = torch.load(f"{root}/mesh1_{kind}.pt", weights_only=True)
        init = {n: t.to(dev) for n, t in ref["init"].items()}
        tx, kinds = _mesh_kinds(torch, view, tp, auto_state=True)
        metrics, step_ms = _mesh_run(torch, de, tx, kinds[kind], init,
                                     batches, tp)
        full = {n: (_all_gather(p.detach(), tp.model_mesh,
                                _split_dim(n, p.ndim))
                    if n in split else p.detach())
                for n, p in de.named_parameters()}
        cos, diff = _update_gap(torch, full, {
            n: t.to(dev) for n, t in ref["params"].items()}, init, 1e-5)
        slice_diff = 0.0
        for n, p in de.named_parameters():
            dim = _split_dim(n, p.ndim)
            want = ref["params"][n].to(dev)
            if p.shape != want.shape:
                want = want.chunk(MESH_WORLD, dim)[tp.model_mesh.rank]
            slice_diff = max(slice_diff, float((p.detach() - want).abs()
                                               .max()))
        rec["kinds"][kind] = {
            "metrics": metrics, "world1_metrics": ref["metrics"],
            "step_ms": step_ms,
            "loss_rel": max(abs(g["loss"] - w["loss"]) / abs(w["loss"])
                            for g, w in zip(metrics, ref["metrics"])),
            "update_cosine": cos, "param_max_diff_over_lr": diff,
            "slice_max_diff_over_lr": slice_diff / 1e-5}
    rec["launches_tp"] = ops.launches()
    del de
    # (c) slice scope over 2 slices x 1: a whole DE from the same init
    from simxns_tpu_torch.models import BertConfig, BiEncoder, BiEncoderConfig

    de = BiEncoder(BiEncoderConfig(bert=BertConfig(
        vocab_size=30522, dtype=torch.bfloat16))).to(dev)
    ref = torch.load(f"{root}/mesh1_biencoder.pt", weights_only=True)
    init = {n: t.to(dev) for n, t in ref["init"].items()}
    tx, kinds = _mesh_kinds(torch, view, ms, scope="slice")
    metrics, slice_ms = _mesh_run(torch, de, tx, kinds["biencoder"], init,
                                  batches[:1], ms)
    with open(f"{root}/mesh1_oracle.json", encoding="utf-8") as f:
        oracle = json.load(f)
    rec["slice"] = {"loss": metrics[0]["loss"], "oracle": oracle["slice"],
                    "oracle_global": oracle["global"],
                    "loss_rel": abs(metrics[0]["loss"] - oracle["slice"])
                    / oracle["slice"],
                    "step_ms": slice_ms, "replica": ms.replica_index}
    del de, view, init, ref
    fresh_peak(torch)
    # (d) the sharded retriever
    want = np.load(f"{root}/mesh1_retriever.npz")
    ops.reset_launches()
    ids, scores, index_s, req_ms, _ = _mesh_retriever(torch, world,
                                                      want["tokens"])
    rec["launches_serving"] = ops.launches()
    rec["retriever"] = {"index_s": index_s, "request_ms": req_ms,
                        "ids_bitwise_equal": bool(np.array_equal(
                            ids, want["ids"])),
                        "scores_bitwise_equal": bool(np.array_equal(
                            scores, want["scores"]))}
    rec["max_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    with open(f"{root}/mesh_rank{world.rank}.json", "w") as f:
        json.dump(rec, f)
    dist.destroy_process_group()


def phase_mesh(torch, smi, records):
    """Phase 19: the rest of the mesh. (a) NCCL at world 1 as (data 1,
    model 1) and as a (1, 1, 1) multislice mesh; (b)-(d) two gloo ranks on
    the card under ``torchrun``: tensor parallelism at (data 1, model 2),
    2 slices x 1 with slice-scoped negatives, the sharded retriever. Two
    ranks on one card check correctness, not scaling: the gloo
    collectives cross the host."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        t0 = time.perf_counter()
        world1, totals = _mesh_world_one(torch, root)
        world1["seconds"] = time.perf_counter() - t0
        emit("mesh_world_1", nvidia_smi=smi, **world1)
        wall = _torchrun(["mesh", root], 900)
        ranks = _rank_files(root, "mesh")
        emit("mesh_ranks", nvidia_smi=smi, world=MESH_WORLD, backend="gloo",
             torchrun_wall_s=wall,
             limits={"tp_loss_rel": TP_LOSS_REL,
                     "tp_loss_factor_over_floor": TP_LOSS_FACTOR,
                     "tp_cosine_gap_to_floor": TP_COS_GAP,
                     "tp_param_max_diff_over_lr": TP_PARAM_LR,
                     "slice_loss_rel": SLICE_LOSS_REL},
             retriever_world_1=world1["retriever_world_1"], ranks=ranks)
        for r in ranks:
            for kind, k in r["kinds"].items():
                what = f"rank {r['rank']} {kind} at (data 1, model 2)"
                floor = world1["kinds"][kind]["floor"]
                check(k["loss_rel"] <= max(TP_LOSS_REL, TP_LOSS_FACTOR
                                           * floor["loss_rel"])
                      and k["update_cosine"] >= floor["update_cosine"]
                      - TP_COS_GAP
                      and k["param_max_diff_over_lr"] <= TP_PARAM_LR
                      and k["slice_max_diff_over_lr"] <= TP_PARAM_LR,
                      f"{what} against world 1: {k}; floor {floor}")
                check(all(math.isfinite(m["loss"]) for m in k["metrics"]),
                      f"{what}: losses {k['metrics']}")
            check(r["slice"]["loss_rel"] <= SLICE_LOSS_REL,
                  f"rank {r['rank']}: slice scope against the oracle: "
                  f"{r['slice']}")
            check(r["retriever"]["ids_bitwise_equal"],
                  f"rank {r['rank']}: the sharded retriever's ids differ "
                  f"from world 1's: {r['retriever']}")
            for name in MESH_PATH:
                check(r["launches_tp"][name] > 0,
                      f"rank {r['rank']}: {name} not launched in its steps")
            for name in MESH_SERVING:
                check(r["launches_serving"][name] > 0,
                      f"rank {r['rank']}: {name} not launched serving")
            for name in totals:
                totals[name] += (r["launches_tp"][name]
                                 + r["launches_serving"][name])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    _launch_totals(records, "mesh", totals)


# --- phase 20: the repairs (ROADMAP.md Queue 3 items 7 and 8) ----------------

# head widths the attention kernels take besides 32, 64 and 128: the
# template instances 16, 80 and 96, and 24 (the 32 instance over
# zero-padded heads); K5/K6 at the joint length, K7/K8 at msdoc's
REPAIR_WIDTHS = (16, 80, 96, 24)
REPAIR_HEADS = 8
# the tiny launcher runs on the card: --tiny-models (H=64, 4 heads, d=16),
# whose int8 views take the JAX package's layer_reference
TINY_RUNS = {
    "nq_ar2_simans": ["--synthetic", "--steps", "12", "--batch", "8",
                      "--corpus-size", "64", "--num-queries", "24",
                      "--topk", "8", "--fast-encode", "--fast-teacher"],
    "lead_ms_distill": ["--synthetic", "--steps", "8", "--batch", "8",
                        "--corpus-size", "48", "--num-queries", "16",
                        "--freeze-teachers", "--fast-teacher"]}
LAYER_KERNELS = ("int8_linear", "row_quant", "small_s_attention")


def _params_like(torch, module, seed):
    """Random weights for ``module`` on the card: normal(0, 0.05), the
    LayerNorm scales about 1."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            p.copy_(torch.randn(p.shape, device="cuda", generator=gen)
                    * 0.05 + ("layer_norm.weight" in name))


def _repair_layer(torch):
    """(a) ``layer_impl="fused_int8"`` at the tiny config (H=64, d=16: off
    the 128 grid, ``layer_reference``, bitwise, no launch of K1-K3), then
    H=128 with 8 heads (d=16: K1-K3, against the plain int8 composition,
    phase 2's limits)."""
    from simxns_tpu_torch import ops
    from simxns_tpu_torch.models import BertConfig
    from simxns_tpu_torch.models.bert import BertLayer
    from simxns_tpu_torch.ops import fused_layer as fl

    dev = torch.device("cuda")
    rec = {}
    for h, heads in ((64, 4), (128, 8)):
        layer = BertLayer(BertConfig(
            vocab_size=64, hidden_size=h, num_layers=1, num_heads=heads,
            intermediate_size=4 * h, max_position_embeddings=128,
            dtype=torch.bfloat16, layer_impl="fused_int8")).to(dev)
        _params_like(torch, layer, h)
        gen = torch.Generator(device="cuda").manual_seed(h)
        x = torch.randn(32, 128, h, device=dev, generator=gen).to(
            torch.bfloat16)
        mask = torch.ones(32, 128, dtype=torch.int32, device=dev)
        mask[::3, 90:] = 0
        ops.reset_launches()
        with torch.no_grad():
            got, _ = layer(x, mask)
        torch.cuda.synchronize()
        launched = {k: ops.launches()[k] for k in LAYER_KERNELS}
        on_kernels = fl.reaches_kernels(128, h, 4 * h)
        if on_kernels:
            with torch.no_grad():
                want = fl.layer_int8_plain(x, mask, layer.quantized(),
                                           num_heads=heads)
            d = (got.float() - want.float()).abs()
            check(launched == {"int8_linear": 4, "row_quant": 5,
                               "small_s_attention": 1}
                  and float(d.max()) <= 0.0625 and float(d.mean()) <= 1e-3,
                  f"fused_int8 H={h} d=16: launches {launched}, max "
                  f"{float(d.max())}, mean {float(d.mean())}")
        else:
            with torch.no_grad():
                want = fl.layer_reference(x, mask, layer.kernel_params(),
                                          num_heads=heads)
            d = (got.float() - want.float()).abs()
            check(not any(launched.values()) and torch.equal(got, want),
                  f"fused_int8 H={h}: launches {launched}, not "
                  "layer_reference")
        rec[f"H{h}_heads{heads}"] = {
            "reaches_kernels": on_kernels,
            "route": "K1-K3" if on_kernels else "layer_reference",
            "launches": launched, "max_abs_err": float(d.max()),
            "mean_abs_err": float(d.mean())}
    return rec


def _repair_attention(torch):
    """(b) K5/K6 at S=160 (64 rows) and K7/K8 at S=512 (16 rows), 8 heads,
    at each of ``REPAIR_WIDTHS``, against the plain pair under phase 4's
    and phase 6's limits, with their times; (c) f32 q, k, v at both S
    through the dispatch under autograd (head views, d=64): the f32
    instances launch, once forward and once backward (read from the
    counts), within the F32_* limits of an f64 evaluation. -> (the widths'
    records, the f32 records, the launches (b) and (c) made)."""
    from simxns_tpu_torch import ops
    from simxns_tpu_torch.ops import flash_attention as fa
    from simxns_tpu_torch.ops.attention import multi_head_attention

    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(20)
    rec = {}
    ops.reset_launches()
    for pair, s, b in (("K5/K6", LJ, 64), ("K7/K8", MS_S, 16)):
        fwd, bwd = ((fa.group_attention_fwd, fa.group_attention_bwd)
                    if pair == "K5/K6" else
                    (fa.bh_attention_fwd, fa.bh_attention_bwd))
        mask = torch.ones(b, s, dtype=torch.int32, device=dev)
        lens = torch.randint(s // 2, s + 1, (b,), device=dev, generator=gen)
        mask[torch.arange(s, device=dev)[None, :] >= lens[:, None]] = 0
        for d in REPAIR_WIDTHS:
            q, k, v, do = (torch.randn(b, s, REPAIR_HEADS * d, device=dev,
                                       generator=gen).to(torch.bfloat16)
                           .view(b, s, REPAIR_HEADS, d).transpose(1, 2)
                           for _ in range(4))
            before = fwd.launches, bwd.launches
            got = fwd(q, k, v, mask)
            want = fa._group_fwd_plain(q, k, v, mask)
            err_f = float((got.float() - want.float()).abs().max())
            tol_f = 2.0 ** -8 * float(v.float().abs().max())
            grads = bwd(q, k, v, mask, do)
            refs = fa._group_bwd_plain(q, k, v, mask, do)
            err_b, cos_b = 0.0, 1.0
            for g, r in zip(grads, refs):
                e = float((g.float() - r.float()).abs().max()
                          / r.float().abs().max())
                c = float(torch.nn.functional.cosine_similarity(
                    g.float().flatten(), r.float().flatten(), dim=0))
                err_b, cos_b = max(err_b, e), min(cos_b, c)
            torch.cuda.synchronize()
            check(err_f <= tol_f and err_b <= 2.0 ** -7 and cos_b >= 0.9999
                  and (fwd.launches, bwd.launches) == (before[0] + 1,
                                                       before[1] + 1)
                  and got.shape == q.shape,
                  f"{pair} d={d}: fwd err {err_f} (limit {tol_f}), bwd "
                  f"err {err_b} of the largest, cosine {cos_b}")
            rec[f"{pair} d={d}"] = {
                "shape": [b, REPAIR_HEADS, s, d],
                "instance": fa.kernel_head_width(d),
                "fwd_max_abs_err": err_f, "fwd_tolerance": tol_f,
                "bwd_max_err_of_largest": err_b, "bwd_min_cosine": cos_b,
                "fwd_ms": timed(torch, lambda: fwd(q, k, v, mask), 5),
                "bwd_ms": timed(torch, lambda: bwd(q, k, v, mask, do), 5)}
            del q, k, v, do, got, want, grads, refs
    widths_launched = ops.launches()
    f32 = {}
    for s, b in ((LJ, 16), (MS_S, 4)):
        fwd, bwd = ((fa.group_attention_fwd, fa.group_attention_bwd)
                    if s < 256 else (fa.bh_attention_fwd, fa.bh_attention_bwd))
        x = [torch.randn(b, s, REPAIR_HEADS * 64, device=dev, generator=gen)
             .requires_grad_() for _ in range(3)]
        q, k, v = (t.view(b, s, REPAIR_HEADS, 64).transpose(1, 2) for t in x)
        do = torch.randn(b, REPAIR_HEADS, s, 64, device=dev, generator=gen)
        mask = torch.ones(b, s, dtype=torch.int32, device=dev)
        mask[1:, s // 3:] = 0
        ops.reset_launches()
        got = multi_head_attention(q, k, v, mask, impl="flash",
                                   small_s_impl="group")[0]
        got.backward(do)
        torch.cuda.synchronize()
        launched = {k: n for k, n in ops.launches().items() if n}
        for name, n in launched.items():
            widths_launched[name] += n
        o64, g64 = fa.attention_f64(q.detach(), k.detach(), v.detach(),
                                    mask, do)
        err_o = float((got.detach().double() - o64).abs().max()
                      / v.detach().abs().max())
        grads = [t.grad.view(b, s, REPAIR_HEADS, 64).transpose(1, 2)
                 for t in x]
        err_g = fa.errors_of_largest(grads, g64)
        want = {f"{fwd.__name__}_f32": 1, f"{bwd.__name__}_f32": 1}
        check(got.dtype == torch.float32 and launched == want
              and err_o <= fa.F32_FWD_TOL and max(err_g) <= fa.F32_BWD_TOL,
              f"f32 attention S={s}: launches {launched} (want {want}), "
              f"errors against f64 {err_o}, {err_g}")
        qd, kd, vd = q.detach(), k.detach(), v.detach()
        f32[f"S={s}"] = {"route": "the f32 instances", "launches": launched,
                         "fwd_err_of_max_v_vs_f64": err_o,
                         "bwd_err_of_largest_vs_f64": err_g,
                         "ms": timed(torch, lambda: multi_head_attention(
                             qd, kd, vd, mask, impl="flash",
                             small_s_impl="group")[0], 5)}
        del x, q, k, v, got, grads
    return rec, f32, widths_launched


def _repair_item9(torch):
    """ROADMAP.md Queue 3 item 9, one call each against its plain version:
    (a) d = 192 (H = 768 over 4 heads) through ``flash_attention`` at S =
    256, forward and backward (the plain attention: no launch of K5-K8),
    and a fused-int8 layer of H = 768 with 4 heads (K1 and K2 around the
    plain attention: no K3); (b) a fused-int8 BERT-base layer at S = 1,100
    (K1-K3, K3 once) and K3 alone at 64 x 1,100 with its times (phase 2's
    check); (c) the fused int8 search over an index of 24,576 rows of width
    100 (K4 over rows padded to 112 bytes), its candidates bitwise the
    plain version's and its top-100 ids those of the plain candidates. ->
    (record, launches)."""
    from simxns_tpu_torch import ops
    from simxns_tpu_torch.models import BertConfig
    from simxns_tpu_torch.models.bert import BertLayer
    from simxns_tpu_torch.ops import flash_attention as fa
    from simxns_tpu_torch.ops import fused_layer as fl
    from simxns_tpu_torch.ops import mips_kernel as mk

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(21)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, device=dev, generator=gen) * scale

    totals = {name: 0 for name in ops.KERNELS}

    def count():
        for name, n in ops.launches().items():
            totals[name] += n
        return {name: n for name, n in ops.launches().items() if n}

    rec = {}
    # (a) flash_attention at d = 192
    b, s, heads, d = 4, 256, 4, 192
    x = [randn(b, s, heads * d).to(torch.bfloat16).requires_grad_()
         for _ in range(3)]
    q, k, v = (t.view(b, s, heads, d).transpose(1, 2) for t in x)
    mask = torch.ones(b, s, dtype=torch.int32, device=dev)
    mask[1:, s // 2:] = 0
    ops.reset_launches()
    out = fa.flash_attention(q, k, v, mask)
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    launched = count()
    refs = [t.detach().clone().requires_grad_() for t in x]
    rq, rk, rv = (t.view(b, s, heads, d).transpose(1, 2) for t in refs)
    want = fa._group_fwd_plain(rq, rk, rv, mask)
    err_o = float((out.detach().float() - want.detach().float()).abs().max())
    tol_o = 2.0 ** -7 * float(v.float().abs().max())
    want.float().square().sum().backward()
    err_g = max(float((g.grad.float() - r.grad.float()).abs().max()
                      / r.grad.float().abs().max()) for g, r in zip(x, refs))
    # the plain attention rounds p to bf16 before p v, the kernels' f32
    # function does not
    check(not launched and err_o <= tol_o and err_g <= 2.0 ** -6,
          f"flash_attention d=192: launches {launched}, err {err_o} (limit "
          f"{tol_o}), gradients {err_g} of the largest")
    rec["flash_attention_d192"] = {
        "shape": [b, heads, s, d], "route": fa.route(s, d, q.dtype, True),
        "launches": launched, "fwd_max_abs_err": err_o,
        "fwd_tolerance": tol_o, "bwd_max_err_of_largest": err_g}
    del x, q, k, v, out, refs, want
    # (a) and (b): fused-int8 layers
    for name, h_, heads_, s_, b_, k3 in (("fused_int8_d192", H, 4, 128, 8, 0),
                                         ("fused_int8_s1100", H, HEADS, 1100,
                                          2, 1)):
        layer = BertLayer(BertConfig(
            vocab_size=64, hidden_size=h_, num_layers=1, num_heads=heads_,
            intermediate_size=4 * h_, max_position_embeddings=2048,
            dtype=torch.bfloat16, layer_impl="fused_int8")).to(dev)
        _params_like(torch, layer, s_)
        xl = randn(b_, s_, h_).to(torch.bfloat16)
        ml = torch.ones(b_, s_, dtype=torch.int32, device=dev)
        ml[1:, s_ // 3:] = 0
        ops.reset_launches()
        with torch.no_grad():
            got, _ = layer(xl, ml)
        torch.cuda.synchronize()
        launched = count()
        with torch.no_grad():
            want = fl.layer_int8_plain(xl, ml, layer.quantized(),
                                       num_heads=heads_)
        dd = (got.float() - want.float()).abs()
        expect = {"int8_linear": 4, "row_quant": 5}
        if k3:
            expect["small_s_attention"] = k3
        check(fl.reaches_kernels(s_, h_, 4 * h_) and launched == expect
              and float(dd.max()) <= 0.0625 and float(dd.mean()) <= 1e-3,
              f"{name}: launches {launched} (want {expect}), max "
              f"{float(dd.max())}, mean {float(dd.mean())}")
        rec[name] = {"hidden": h_, "heads": heads_, "tokens": [b_, s_],
                     "launches": launched, "max_abs_err": float(dd.max()),
                     "mean_abs_err": float(dd.mean())}
        del layer, xl, got, want
    rec["small_s_attention_s1100"] = _check_small_s_attention(
        torch, randn, gen, ((64, 1100, 550),), H, HEADS)
    # (c) an int8 index of width 100
    n, nq, width = MINE_ROWS, MINE_Q, 100
    codes, scales = mk.quantize_rows(randn(n, width))
    q8, qs = mk.quantize_rows(randn(nq, width))
    ops.reset_launches()
    cand = mk.mips_bucket_candidates(q8, codes, n, bucket=128, block_n=2048,
                                     query_scales=qs, row_scales=scales)
    torch.cuda.synchronize()
    launched = count()
    n_pad = -(-n // 2048) * 2048
    plain = mk._candidates_plain(q8, codes, n, 128, n_pad, qs, scales)
    top = mk._finalize(*cand, MINE_K, 0)
    top_plain = mk._finalize(*plain, MINE_K, 0)
    check(launched == {"mips_bucket_candidates": 1}
          and torch.equal(cand[0], plain[0]) and torch.equal(cand[1], plain[1])
          and torch.equal(top[1], top_plain[1]),
          f"int8 index of width {width}: launches {launched}, candidates "
          "or ids differ from the plain version's")
    rec["int8_index_width100"] = {
        "rows": n, "queries": nq, "width": width,
        "kernel_width": mk.kernel_row_width(width, 1), "launches": launched,
        "candidates_bitwise_equal": True, "top100_ids_equal": True}
    return rec, totals


def phase_repairs(torch, smi, records):
    """Phase 20: ROADMAP.md Queue 3 items 7, 8 and 9 on the card. (a) the
    fused-int8 layer's JAX dispatch; (b) K5/K6 and K7/K8 at head widths
    16, 80, 96 and 24; (c) f32 attention on the f32 instances; (d) a tiny ``run_ar2
    --fast-encode --fast-teacher`` and a tiny ``run_lead --freeze-teachers
    --fast-teacher`` (H=64: their int8 views take layer_reference) run to
    their end; (e) item 9 (``_repair_item9``)."""
    import shutil
    import tempfile

    from simxns_tpu_torch import ops, run

    t0 = time.perf_counter()
    totals = {name: 0 for name in ops.KERNELS}
    layer = _repair_layer(torch)
    widths, f32, launched = _repair_attention(torch)
    for name, n in launched.items():
        totals[name] += n
    root = tempfile.mkdtemp(prefix="chip_smoke_repairs_")
    tiny = {}
    try:
        for recipe, argv in TINY_RUNS.items():
            ops.reset_launches()
            t1 = time.perf_counter()
            out = run.main(["--recipe", recipe, *argv, "--output-dir",
                            f"{root}/{recipe}"])
            torch.cuda.synchronize()
            launched = ops.launches()
            for name, n in launched.items():
                totals[name] += n
            check(math.isfinite(out["top1"]) and all(
                launched[k] == 0 for k in LAYER_KERNELS),
                f"tiny {recipe}: {out}, launches {launched}")
            tiny[recipe] = {"flags": argv, "wall_s": time.perf_counter() - t1,
                            "top1": out["top1"],
                            "launches": {k: n for k, n in launched.items()
                                         if n}}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for name in LAYER_KERNELS:
        totals[name] += layer["H128_heads8"]["launches"][name]
    item9, launched = _repair_item9(torch)
    for name, n in launched.items():
        totals[name] += n
    records["small_s_attention"]["s1100"] = item9["small_s_attention_s1100"]
    emit("repairs", nvidia_smi=smi, fused_int8_layer=layer,
         attention_widths=widths, f32_attention=f32, tiny_runs=tiny,
         item9=item9, seconds=time.perf_counter() - t0)
    fresh_peak(torch)
    _launch_totals(records, "repairs", totals)


# --- phase 21: LEAD at full width -------------------------------------------

# lead_ms_distill at full width: a 6-layer BERT-base student (shared
# towers) and a 12-layer BERT-base CE (small_s_attn="group": K5/K6 at the
# joint rows of 160), 32 / 128 / 160 tokens, 8 queries x 2 passages a step
# (the recipe's 64 over 8 GPUs; 1 negative), 20,480 synthetic passages
# (above 20,000 they keep the recipe's lengths), 16 queries (two batches an
# epoch, one warm-up epoch of each model); 12 joint steps (the re-draw and
# its states at 10), a relaunch that resumes to 16, then the frozen CE
# behind its int8 view (K1-K3) for 8
LEAD_FLAGS = ["--synthetic", "--full-size", "--batch", "8",
              "--corpus-size", "20480", "--num-queries", "16"]
LEAD_RUNS = (("run", (), 12), ("resume", (), 16),
             ("frozen", ("--freeze-teachers", "--fast-teacher"), 8))
LEAD_N, LEAD_M = N_Q, 2
# the first joint step's gradients (student and CE) with K5/K6 against
# the plain versions, beside two plain versions that round p otherwise,
# as phase 18's rule: the loss within LEAD_LOSS_FACTOR x the two plain
# versions' gap (or LEAD_LOSS_REL), each model's gradient cosine within
# LEAD_FLOOR_GAP of theirs. Readings (PERF.md, section 6, LEAD): loss
# 3.5e-4 relative against two plain versions' 8.5e-4; cosine student
# 0.99743 (two plain 0.99832), CE 0.99041 (0.99267): gaps 0.0009 and
# 0.0023, the limit about twice the larger
LEAD_LOSS_REL, LEAD_LOSS_FACTOR, LEAD_FLOOR_GAP = 1e-2, 2.5, 0.005


def _lead_batch(np, seed):
    """One LEAD batch: phase 5's 8 queries with their first 2 passages (the
    positive and one negative), 32 / 128 / 160 tokens."""
    b = _train_batch(np, seed)
    n, m = LEAD_N, LEAD_M
    return {"q_ids": b["q_ids"], "q_mask": b["q_mask"],
            "ctx_ids": b["ctx_ids"].reshape(n, N_P, LC)[:, :m].reshape(
                n * m, LC),
            "ctx_mask": b["ctx_mask"].reshape(n, N_P, LC)[:, :m].reshape(
                n * m, LC),
            "positive_idx": (np.arange(n) * m).astype(np.int32),
            "joint_ids": b["joint_ids"][:, :m], "joint_mask":
                b["joint_mask"][:, :m]}


def _lead_full_width(torch, smi):
    """The first joint step's gradients on K5/K6 against the plain pair
    (the recipe's LeadConfig, both models trained, 3 of the layers); then
    one ``make_colbert_step`` and one ``make_kd_step(teacher_type=
    "colbert")`` with a BERT-base ColBERT (dim 128)."""
    import numpy as np

    from simxns_tpu_torch import ops
    from simxns_tpu_torch.models import (BertConfig, BiEncoder,
                                         BiEncoderConfig, ColBERT,
                                         ColBERTConfig, CrossEncoder,
                                         CrossEncoderConfig)
    from simxns_tpu_torch.ops import flash_attention as fa
    from simxns_tpu_torch.train import (LeadConfig, TrainState, make_adamw,
                                        make_colbert_step, make_kd_step,
                                        make_lead_step)

    dev = torch.device("cuda")
    fresh_peak(torch)
    base = BertConfig(vocab_size=30522, dtype=torch.bfloat16)
    db = BiEncoder(BiEncoderConfig(bert=base.replace(num_layers=6),
                                   share_weight=True),
                   generator=torch.Generator().manual_seed(0)).to(dev)
    ce = CrossEncoder(CrossEncoderConfig(
        bert=base.replace(small_s_attn="group"), per_layer_logits=True),
        generator=torch.Generator().manual_seed(1)).to(dev)
    tx = make_adamw(5e-5, total_steps=0)
    step = make_lead_step(
        {"db": db, "ce": ce}, {"db": tx, "ce": tx},
        LeadConfig(distill_db=True, distill_ce=True, train_db=True,
                   train_ce=True, layer_score=True, layer_temperature=10.0))
    states = {"db": TrainState.create(db, tx), "ce": TrainState.create(ce, tx)}
    batch = _lead_batch(np, 0)
    sel = ([1, 3, 5], [2, 6, 11])

    def grads():
        loss, _ = step.loss(states, batch, *sel)
        for m in (db, ce):
            for p in m.parameters():
                p.grad = None
        loss.backward()
        flat = [torch.cat([p.grad.float().flatten() for p in m.parameters()
                           if p.grad is not None]) for m in (db, ce)]
        for m in (db, ce):
            for p in m.parameters():
                p.grad = None
        return float(loss.detach()), flat

    ops.reset_launches()
    loss_k, grad_k = grads()
    launched = ops.launches()
    check(launched["group_attention_fwd"] > 0
          and launched["group_attention_bwd"] > 0,
          f"K5/K6 not launched in the joint step: {launched}")
    kernels = fa.group_attention_fwd, fa.group_attention_bwd, fa._probs
    fa.group_attention_fwd, fa.group_attention_bwd = (fa._group_fwd_plain,
                                                      fa._group_bwd_plain)
    try:
        loss_p, grad_p = grads()
        fa._probs = _softmax_probs
        loss_f, grad_f = grads()
    finally:
        fa.group_attention_fwd, fa.group_attention_bwd, fa._probs = kernels
    cos = [_cosine(torch, a, b) for a, b in zip(grad_k, grad_p)]
    floor = [_cosine(torch, a, b) for a, b in zip(grad_p, grad_f)]
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    floor_rel = abs(loss_f - loss_p) / abs(loss_p)
    del grad_k, grad_p, grad_f
    check(loss_rel <= max(LEAD_LOSS_REL, LEAD_LOSS_FACTOR * floor_rel)
          and all(c >= f - LEAD_FLOOR_GAP for c, f in zip(cos, floor)),
          f"LEAD joint step, K5/K6 vs plain: loss rel {loss_rel} (two plain "
          f"versions: {floor_rel}), gradient cosines (student, CE) {cos} "
          f"(two plain versions: {floor})")
    rec = {"kernel_vs_plain": {
        "loss_kernel": loss_k, "loss_plain": loss_p,
        "loss_plain_softmax": loss_f, "loss_rel": loss_rel,
        "loss_rel_two_plain": floor_rel,
        "gradient_cosine_student": cos[0], "gradient_cosine_ce": cos[1],
        "gradient_cosine_two_plain_student": floor[0],
        "gradient_cosine_two_plain_ce": floor[1]},
        "limits": {"loss_rel": LEAD_LOSS_REL,
                   "loss_factor_over_two_plain": LEAD_LOSS_FACTOR,
                   "floor_gap": LEAD_FLOOR_GAP}}
    launches = {name: 0 for name in ops.KERNELS}
    for name, n in launched.items():
        launches[name] += n
    ms = []
    for _ in range(3):
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        states, m = step(states, batch, *sel)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        for name, n in ops.launches().items():
            launches[name] += n
    check(math.isfinite(float(m["loss"])), f"LEAD joint step: {m}")
    rec["joint_step_ms"] = ms
    del states, step

    # ColBERT: one in-batch MaxSim step, then as the KD teacher
    col = ColBERT(ColBERTConfig(bert=base, dim=128),
                  generator=torch.Generator().manual_seed(3)).to(dev)
    tx = make_adamw(5e-5, total_steps=0)
    cstep = make_colbert_step(tx, group_size=LEAD_M)
    cstate = TrainState.create(col, tx)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cstate, cm = cstep(cstate, batch)
    torch.cuda.synchronize()
    col_ms = (time.perf_counter() - t0) * 1e3
    tx = make_adamw(5e-5, total_steps=0)
    kstep = make_kd_step(tx, "colbert", kd_type="KD_softmax",
                         ce_weight=1.0, kd_weight=1.0)
    kstate = TrainState.create(db, tx)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kstate, km = kstep(kstate, {"colbert": col.eval()}, batch)
    torch.cuda.synchronize()
    kd_ms = (time.perf_counter() - t0) * 1e3
    check(math.isfinite(float(cm["loss"])) and math.isfinite(
        float(km["loss"])), f"ColBERT steps: {cm}, {km}")
    rec["colbert_step"] = {"loss": float(cm["loss"]),
                           "correct": int(cm["correct"]), "step_ms": col_ms}
    rec["kd_colbert_step"] = {k: float(v) for k, v in km.items()}
    rec["kd_colbert_step"]["step_ms"] = kd_ms
    rec["max_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del db, ce, col, cstate, kstate
    return rec, launches


def _run_losses(out_dir, phase):
    with open(f"{out_dir}/metrics.jsonl", encoding="utf-8") as f:
        return [(r["step"], r["loss"]) for r in map(json.loads, f)
                if r.get("phase") == phase]


def phase_lead(torch, smi, records):
    """Phase 21: LEAD at full width. ``run_lead`` in ``lead_ms_distill``:
    12 joint steps, a relaunch that resumes to 16, then
    ``--freeze-teachers --fast-teacher`` for 8; per run the step ms, the
    peak memory, the losses and the launches (zeroed just before each run,
    and those inside the joint steps apart); then the first joint step's
    gradients on the kernels against the plain versions and the ColBERT
    steps."""
    import shutil
    import tempfile

    from simxns_tpu_torch import ops, run

    root = tempfile.mkdtemp(prefix="chip_smoke_lead_")
    names = ("make_lead_step", "make_biencoder_step", "make_reranker_step")
    factories = {name: getattr(run, name) for name in names}
    totals = {name: 0 for name in ops.KERNELS}
    t_phase = time.perf_counter()
    try:
        for label, extra, steps_to in LEAD_RUNS:
            out_dir = f"{root}/{'frozen' if extra else 'joint'}"
            step_ms, in_steps = {}, {}
            for name, kind in zip(names, ("lead", "warm_db", "warm_ce")):
                setattr(run, name, _timed_factory(
                    torch, factories[name], kind, step_ms, in_steps))
            fresh_peak(torch)
            ops.reset_launches()
            t0 = time.perf_counter()
            out = run.main(["--recipe", "lead_ms_distill", *LEAD_FLAGS,
                            "--steps", str(steps_to), *extra,
                            "--output-dir", out_dir])
            torch.cuda.synchronize()
            launched = ops.launches()
            for name, n in launched.items():
                totals[name] += n
            joint = in_steps.get("lead", {})
            check(out["steps"] == steps_to
                  and math.isfinite(out["final_loss"]),
                  f"lead {label}: {out}")
            if extra:
                check(all(joint.get(k, 0) > 0 for k in LAYER_KERNELS)
                      and not joint.get("group_attention_bwd"),
                      f"lead {label}: the joint steps launched {joint}")
            else:
                check(joint.get("group_attention_fwd", 0) > 0
                      and joint.get("group_attention_bwd", 0) > 0,
                      f"lead {label}: the joint steps launched {joint}")
            losses = _run_losses(out_dir, "lead")
            first = 11 if label == "resume" else 1
            check([s for s, _ in losses][-(steps_to - first + 1):]
                  == list(range(first, steps_to + 1))
                  and all(math.isfinite(x) for _, x in losses),
                  f"lead {label}: losses {losses}")
            files = set(os.listdir(out_dir))
            want = {f"student-{steps_to}", f"teacher_ce-{steps_to}",
                    "eval.json"}
            if label == "run":
                want |= {"lead_db_state-10", "lead_ce_state-10"}
            check(want <= files, f"lead {label}: {sorted(files)}")
            lead_ms = step_ms.get("lead", [])
            emit("lead", nvidia_smi=smi, run=label,
                 flags=LEAD_FLAGS + list(extra), steps=steps_to,
                 wall_s=time.perf_counter() - t0, losses=losses,
                 step_ms=step_ms,
                 steady_joint_step_ms=(float(sum(lead_ms[1:])
                                             / (len(lead_ms) - 1))
                                       if len(lead_ms) > 1 else None),
                 top1=out["top1"], phase_times_s=out["phase_times_s"],
                 max_memory_gb=out["max_memory_gb"],
                 launches={k: n for k, n in launched.items() if n},
                 launches_in_joint_steps=joint)
            if label == "frozen":
                shutil.rmtree(out_dir, ignore_errors=True)
    finally:
        for name, fn in factories.items():
            setattr(run, name, fn)
        shutil.rmtree(root, ignore_errors=True)
    rec, launches = _lead_full_width(torch, smi)
    for name, n in launches.items():
        totals[name] += n
    emit("lead_steps", nvidia_smi=smi, seconds=time.perf_counter() - t_phase,
         **rec)
    fresh_peak(torch)
    _launch_totals(records, "lead", totals)


# --- phase 22: MASTER at full width -----------------------------------------

# master_pretrain at full width: BERT-base, seq 128, 2 head layers; 32
# sequences a step (the recipe's 128 a GPU, cut to keep the phase in the
# script's budget), 6 steps, then a relaunch to 8
MASTER_FLAGS = ["--synthetic", "--full-size", "--batch", "32"]
MASTER_STEPS, MASTER_RESUME_STEPS, MASTER_SEQ = 6, 8, 128


def _master_examples(np, rng, n):
    """``run_pretrain``'s synthetic examples at seq 128."""
    return [{"text": rng.integers(5, 2000, size=int(
                 rng.integers(24, MASTER_SEQ - 4))).tolist(),
             "queries": [rng.integers(5, 2000, size=6).tolist()],
             "next": [rng.integers(5, 2000, size=20).tolist()]}
            for _ in range(n)]


def phase_master(torch, smi, records):
    """Phase 22: MASTER pre-training at full width. ``run_pretrain`` in
    ``master_pretrain`` (6 steps, then a relaunch to 8), the exported
    encoder loaded into a ``BiEncoder`` and run, one ELECTRA step, and the
    collator's host ms a batch on each path. No Pallas kernel is on this
    path (the Condenser's towers run the plain attention at S=128, as JAX
    runs XLA's), so no kernel launches here."""
    import shutil
    import tempfile

    import numpy as np

    from simxns_tpu_torch import ops, run
    from simxns_tpu_torch.data import (CondenserCollator, HashTokenizer,
                                       TokenMeta)
    from simxns_tpu_torch.io import encoder_into, restore_checkpoint
    from simxns_tpu_torch.models import (BertConfig, BiEncoder,
                                         BiEncoderConfig, Condenser,
                                         CondenserConfig)
    from simxns_tpu_torch.train import (TrainState, make_adamw,
                                        make_electra_step)

    dev = torch.device("cuda")
    base = BertConfig(vocab_size=30522, dtype=torch.bfloat16)
    root = tempfile.mkdtemp(prefix="chip_smoke_master_")
    factory = run.make_condenser_step
    totals = {name: 0 for name in ops.KERNELS}
    t_phase = time.perf_counter()
    rec = {}
    try:
        step_ms = {}
        run.make_condenser_step = _timed_factory(torch, factory, "pretrain",
                                                 step_ms)
        for label, steps_to in (("run", MASTER_STEPS),
                                ("resume", MASTER_RESUME_STEPS)):
            fresh_peak(torch)
            ops.reset_launches()
            t0 = time.perf_counter()
            out = run.main(["--recipe", "master_pretrain", *MASTER_FLAGS,
                            "--steps", str(steps_to), "--output-dir", root])
            torch.cuda.synchronize()
            launched = {k: n for k, n in ops.launches().items() if n}
            check(out["steps"] == steps_to and math.isfinite(
                out["final_loss"]) and not launched,
                f"master {label}: {out}, launches {launched}")
            rec[label] = {"wall_s": time.perf_counter() - t0,
                          "final_loss": out["final_loss"],
                          "collator_path": out["collator_path"],
                          "phase_times_s": out["phase_times_s"],
                          "max_memory_gb": out["max_memory_gb"],
                          "launches": launched}
        losses = _run_losses(root, "pretrain")
        check([s for s, _ in losses] == list(range(1, MASTER_RESUME_STEPS
                                                   + 1))
              and all(math.isfinite(x) for _, x in losses),
              f"master: losses {losses}")
        files = set(os.listdir(root))
        check({f"encoder-{MASTER_RESUME_STEPS}",
               f"pretrain_state-{MASTER_STEPS}", "eval.json"} <= files,
              f"master: {sorted(files)}")
        # the exported encoder in a BiEncoder tower
        params = restore_checkpoint(root, None, MASTER_RESUME_STEPS,
                                    name="encoder")["params"]
        bi = BiEncoder(BiEncoderConfig(bert=base))
        encoder_into(params, bi.question_model)
        bi = bi.to(dev)
        rng = np.random.default_rng(22)
        ids = torch.from_numpy(rng.integers(5, 2000, (8, MASTER_SEQ))).to(dev)
        with torch.no_grad():
            emb = bi.encode_query(ids, torch.ones_like(ids))
        check(emb.shape == (8, 768) and bool(torch.isfinite(emb).all()),
              "the exported encoder's embeddings")
        del bi, params, emb
    finally:
        run.make_condenser_step = factory
        shutil.rmtree(root, ignore_errors=True)
    # the collator on each path at the step's 32 examples and at 512 (the
    # JAX package's measured batch), then one ELECTRA step
    meta = TokenMeta.for_hash_tokenizer(HashTokenizer(vocab_size=2048))
    rng = np.random.default_rng(3)
    batches = [_master_examples(np, rng, 32) for _ in range(5)]
    big = _master_examples(np, rng, 512)
    host = {}
    for use_native in (True, False):
        coll = CondenserCollator(meta, max_seq_length=MASTER_SEQ, seed=0,
                                 use_native=use_native)
        coll(batches[0])
        t0 = time.perf_counter()
        for b in batches:
            coll(b)
        t1 = time.perf_counter()
        coll(big)
        host[coll.path] = {"32": (t1 - t0) * 1e3 / len(batches),
                           "512": (time.perf_counter() - t1) * 1e3}
    check(set(host) == {"native", "numpy"},
          f"the collator's paths on this machine: {sorted(host)}")
    fresh_peak(torch)
    model = Condenser(CondenserConfig(bert=base, n_head_layers=2),
                      generator=torch.Generator().manual_seed(0)).to(dev)
    tx = make_adamw(3e-4, total_steps=0)
    estep = make_electra_step(tx, meta.mask_id)
    state = TrainState.create(model, tx)
    batch = CondenserCollator(meta, max_seq_length=MASTER_SEQ, seed=1)(
        batches[1])
    ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = estep(state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    check(math.isfinite(float(m["loss"])), f"ELECTRA step: {m}")
    steady = step_ms["pretrain"][1:MASTER_STEPS]
    emit("master", nvidia_smi=smi, flags=MASTER_FLAGS, losses=losses,
         step_ms=step_ms, steady_step_ms=float(sum(steady) / len(steady)),
         collator_host_ms_per_batch=host, electra_step_ms=ms,
         electra_loss=float(m["loss"]),
         electra_max_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
         kernels_on_path="none (the Condenser's towers run the plain "
                         "attention at S=128, as JAX runs XLA's)",
         seconds=time.perf_counter() - t_phase, **rec)
    del model, state
    fresh_peak(torch)
    _launch_totals(records, "master", totals)


# --- phase 23: f32 attention on the kernels ---------------------------------

# The f32 instances of K5-K8 (ROADMAP.md Queue 3 item 8b): each f32 operand
# as hi + lo bf16 halves, three bf16 products into f32 (lo lo dropped). They
# are held to an f64 evaluation of the same function within the limits of
# simxns_tpu_torch/ops/flash_attention.py (F32_FWD_TOL, F32_BWD_TOL,
# F32_VS_BF16; tests/test_torch_cuda.py holds them to the same ones). The
# plain f32 version runs with TF32 off (cuBLAS and cuDNN), a full f32
# product. Their bound counts the model's own products (2 forward, 5
# backward) at the TF32 peak, the highest rate for f32 inputs; the split's
# three bf16 products for each are reported apart as impl_ops_ms.
F32_KERNELS = ("group_attention_fwd_f32", "group_attention_bwd_f32",
               "bh_attention_fwd_f32", "bh_attention_bwd_f32")
F32_WIDTHS = (64, 16, 128, 24)       # the first is the records' shape
F32_HEADS = 8
# the f32 DE of the step check: BertConfig.tiny at 512 positions (H=64, 4
# heads, d=16), 8 queries of 32 tokens x 2 passages of 512 (K7/K8 f32 on
# the passages); the first step against the same step on the plain pair:
# the loss within F32_STEP_LOSS_REL, every gradient within F32_STEP_GRAD of
# the largest (the CPU twin reads 1.1e-7 and 2.8e-7)
F32_STEP_LOSS_REL, F32_STEP_GRAD = 1e-4, 1e-4


def _check_f32_pair(torch, gen, fwd, bwd, b, s, d, timing):
    """One f32 instance pair (``fwd``, ``bwd``) on head views of [b, s, 8d]
    f32 projections (key lengths s/2..s, one row all masked): against f64,
    the plain f32 version and the bf16 instance, two forward and two
    backward calls bitwise equal; with ``timing`` the times of the kernels
    (CUDA events and the profiler's device time), the plain versions and
    SDPA in f32 (additive -1e9 key bias) and the bounds."""
    from simxns_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")

    def head_view(t):
        return t.view(b, s, F32_HEADS, d).transpose(1, 2)

    q, k, v = (head_view(torch.randn(b, s, F32_HEADS * d, device=dev,
                                     generator=gen)) for _ in range(3))
    do = torch.randn(b, F32_HEADS, s, d, device=dev, generator=gen)
    mask = torch.ones(b, s, dtype=torch.int32, device=dev)
    lens = torch.randint(s // 2, s + 1, (b,), device=dev, generator=gen)
    mask[torch.arange(s, device=dev)[None, :] >= lens[:, None]] = 0
    mask[-1] = 0
    o64, g64 = fa.attention_f64(q, k, v, mask, do)
    vmax = float(v.abs().max())
    o = fwd(q, k, v, mask)
    o_again = fwd(q, k, v, mask)
    grads = bwd(q, k, v, mask, do)
    again = bwd(q, k, v, mask, do)
    plain_o = fa._group_fwd_plain(q, k, v, mask)
    plain_g = fa._group_bwd_plain(q, k, v, mask, do)
    qb, kb, vb, dob = (t.to(torch.bfloat16) for t in (q, k, v, do))
    ob = fwd(qb, kb, vb, mask)
    gb = bwd(qb, kb, vb, mask, dob)
    torch.cuda.synchronize()
    err_o = float((o.double() - o64).abs().max()) / vmax
    err_ob = float((ob.double() - o64).abs().max()) / vmax
    err_po = float((plain_o.double() - o64).abs().max()) / vmax
    err_g, err_gb, err_pg = (fa.errors_of_largest(x, g64)
                             for x in (grads, gb, plain_g))
    check(o.dtype == torch.float32 and all(g.dtype == torch.float32
                                           for g in grads),
          "f32 instances: results not f32")
    check(torch.equal(o, o_again),
          f"f32 {fwd.__name__} S={s} d={d}: two calls differ")
    check(all(torch.equal(g, a) for g, a in zip(grads, again)),
          f"f32 {bwd.__name__} S={s} d={d}: two calls differ")
    check(err_o <= fa.F32_FWD_TOL and max(err_g) <= fa.F32_BWD_TOL,
          f"f32 {fwd.__name__} S={s} d={d}: errors against f64 {err_o}, "
          f"{err_g} (limits {fa.F32_FWD_TOL}, {fa.F32_BWD_TOL})")
    check(err_ob >= fa.F32_VS_BF16 * err_o and all(
        e16 >= fa.F32_VS_BF16 * e32 for e16, e32 in zip(err_gb, err_g)),
        f"f32 {fwd.__name__} S={s} d={d}: not {fa.F32_VS_BF16}x closer to "
        f"f64 than the bf16 instance ({err_o} vs {err_ob}; {err_g} vs "
        f"{err_gb})")
    rec = dict(shape=[b, F32_HEADS, s, d], key_lengths=[s // 2, s],
               fwd_err_of_max_v_vs_f64=err_o, bf16_fwd_err_vs_f64=err_ob,
               plain_fwd_err_vs_f64=err_po,
               bwd_err_of_largest_vs_f64=err_g, bf16_bwd_err_vs_f64=err_gb,
               plain_bwd_err_vs_f64=err_pg,
               fwd_max_abs_err=float((o - plain_o).abs().max()),
               bwd_max_abs_err=max(float((g - r).abs().max())
                                   for g, r in zip(grads, plain_g)))
    del ob, gb, qb, kb, vb, dob, plain_o, plain_g, o64, g64, again, o_again
    if not timing:
        return rec
    sdpa = torch.nn.functional.scaled_dot_product_attention
    bias = torch.where(mask > 0, 0.0, -1e9)[:, None, None, :]
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    out = sdpa(qg, kg, vg, attn_mask=bias)
    elems = b * F32_HEADS * s * d
    product = 2.0 * b * F32_HEADS * s * s * d
    # the model's products (2 forward, 5 backward) at the TF32 peak; the
    # split's three bf16 products for each at the bf16 peak apart
    bms_f, by_f = bound(4 * elems * 4 + mask.numel() * 4, 2 * product,
                        PEAK_TF32)
    bms_b, by_b = bound(7 * elems * 4 + mask.numel() * 4, 5 * product,
                        PEAK_TF32)
    rec.update(
        ms=timed(torch, lambda: fwd(q, k, v, mask), 5),
        # the profiler's device ms a call (the event time of a small call
        # holds the host's launch gaps)
        device_ms=device_call_ms(torch, lambda: fwd(q, k, v, mask)),
        plain_ms=timed(torch, lambda: fa._group_fwd_plain(q, k, v, mask), 2),
        library_ms=timed(torch, lambda: sdpa(q, k, v, attn_mask=bias), 5),
        bound_ms=bms_f, bound_by=by_f,
        impl_ops_ms=3 * 2 * product / PEAK_BF16 * 1e3,
        bwd_ms=timed(torch, lambda: bwd(q, k, v, mask, do), 20),
        bwd_device_ms=device_call_ms(torch, lambda: bwd(q, k, v, mask, do)),
        bwd_plain_ms=timed(torch, lambda: fa._group_bwd_plain(
            q, k, v, mask, do), 2),
        bwd_library_ms=timed(torch, lambda: torch.autograd.grad(
            out, (qg, kg, vg), do, retain_graph=True), 5),
        bwd_bound_ms=bms_b, bwd_bound_by=by_b,
        bwd_impl_ops_ms=3 * 5 * product / PEAK_BF16 * 1e3)
    return rec


def _f32_de_step(torch, np):
    """Three ``make_biencoder_step`` steps of an f32 tiny DE on passages
    of 512 tokens (K7/K8 f32), the first step's gradients against the same
    step on the plain pair. -> (record, launches of the three steps)."""
    from simxns_tpu_torch import ops
    from simxns_tpu_torch.models import BertConfig, BiEncoder, BiEncoderConfig
    from simxns_tpu_torch.ops import flash_attention as fa
    from simxns_tpu_torch.train import (TrainState, make_adamw,
                                        make_biencoder_step, steps)

    dev = torch.device("cuda")
    model = BiEncoder(BiEncoderConfig(bert=BertConfig.tiny(
        max_position_embeddings=MS_S)),
        generator=torch.Generator().manual_seed(23)).to(dev)
    rng = np.random.default_rng(23)
    n, m = N_Q, 2

    def batch(seed):
        r = np.random.default_rng(seed)
        lens = r.integers(MS_S // 2, MS_S + 1, n * m)
        cm = (np.arange(MS_S)[None, :] < lens[:, None]).astype(np.int64)
        return steps.to_device({
            "q_ids": r.integers(4, 1024, (n, LQ)),
            "q_mask": np.ones((n, LQ), np.int64),
            "ctx_ids": r.integers(4, 1024, (n * m, MS_S)) * cm,
            "ctx_mask": cm,
            "positive_idx": np.arange(n) * m}, dev)

    batches = [batch(int(rng.integers(1 << 30))) for _ in range(3)]

    def gradients():
        loss, _ = steps.biencoder_loss(model, batches[0])
        grads = steps.gradients(model, loss)
        flat = torch.cat([g.flatten() for g in grads.values()
                          if g is not None])
        for p in model.parameters():
            p.grad = None
        return float(loss.detach()), flat

    loss_k, grad_k = gradients()
    kernels = fa.bh_attention_fwd, fa.bh_attention_bwd
    fa.bh_attention_fwd, fa.bh_attention_bwd = (fa._group_fwd_plain,
                                                fa._group_bwd_plain)
    try:
        loss_p, grad_p = gradients()
    finally:
        fa.bh_attention_fwd, fa.bh_attention_bwd = kernels
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    grad_err = float((grad_k - grad_p).abs().max() / grad_p.abs().max())
    check(loss_rel <= F32_STEP_LOSS_REL and grad_err <= F32_STEP_GRAD,
          f"f32 DE step, K7/K8 f32 vs plain: loss rel {loss_rel}, gradient "
          f"err {grad_err} of the largest")
    tx = make_adamw(1e-4, total_steps=0)
    state = TrainState.create(model, tx)
    step = make_biencoder_step(tx)
    fresh_peak(torch)
    ops.reset_launches()
    ms, losses = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, b)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
    launched = {k: v for k, v in ops.launches().items() if v}
    check(launched.get("bh_attention_fwd_f32", 0) >= 3
          and launched.get("bh_attention_bwd_f32", 0) >= 3
          and not launched.get("bh_attention_fwd")
          and all(math.isfinite(x) for x in losses),
          f"f32 DE steps: launches {launched}, losses {losses}")
    return dict(config="BertConfig.tiny(max_position_embeddings=512), f32",
                batch=f"{n} queries x {LQ} tokens, {n * m} passages x "
                      f"{MS_S}", loss_rel_vs_plain=loss_rel,
                grad_err_of_largest_vs_plain=grad_err, step_ms=ms,
                losses=losses, launches=launched,
                max_memory_gb=torch.cuda.max_memory_allocated() / 1e9), \
        launched


def phase_f32_attention(torch, smi, records):
    """Phase 23: the f32 instances of K5-K8. K5/K6 at [64, 8, 160, d] and
    K7/K8 at [16, 8, 512, d], d = 64, 16, 128, 24, against f64, the plain
    f32 version (TF32 off) and the bf16 instance, two forward and two
    backward calls bitwise equal; the times of the kernel, the plain
    version and SDPA in f32 at d = 64; the same checks of K7/K8 at [4, 8,
    1024, 128] and [16, 8, 256, 64] and K5/K6 at [16, 8, 255, 64]; then an
    f32 DE's steps on K7/K8 f32 against the plain pair."""
    import numpy as np

    from simxns_tpu_torch import ops
    from simxns_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(23)
    totals = {name: 0 for name in ops.KERNELS}
    ops.reset_launches()
    by_pair = {}
    for label, fwd, bwd, b, s in (
            ("K5/K6", fa.group_attention_fwd, fa.group_attention_bwd, 64, LJ),
            ("K7/K8", fa.bh_attention_fwd, fa.bh_attention_bwd, 16, MS_S)):
        shapes = [_check_f32_pair(torch, gen, fwd, bwd, b, s, d,
                                  timing=d == F32_WIDTHS[0])
                  for d in F32_WIDTHS]
        by_pair[label] = shapes
        main = shapes[0]
        common = dict(shape=main["shape"], widths=list(F32_WIDTHS),
                      shapes=shapes,
                      err_vs_f64=max(r["fwd_err_of_max_v_vs_f64"]
                                     for r in shapes),
                      library="scaled_dot_product_attention in f32, additive "
                              "-1e9 key bias")
        records[f"{fwd.__name__}_f32"].update(
            ms=main["ms"], device_ms=main["device_ms"],
            plain_ms=main["plain_ms"],
            library_ms=main["library_ms"], bound_ms=main["bound_ms"],
            bound_by=main["bound_by"], impl_ops_ms=main["impl_ops_ms"],
            max_abs_err=max(r["fwd_max_abs_err"] for r in shapes),
            tolerance=f"against f64: {fa.F32_FWD_TOL} x max|v|, and "
                      f"{fa.F32_VS_BF16}x closer than the bf16 instance; "
                      "max_abs_err is against the plain f32 version",
            **common)
        records[f"{bwd.__name__}_f32"].update(
            ms=main["bwd_ms"], device_ms=main["bwd_device_ms"],
            plain_ms=main["bwd_plain_ms"],
            library_ms=main["bwd_library_ms"], bound_ms=main["bwd_bound_ms"],
            bound_by=main["bwd_bound_by"],
            impl_ops_ms=main["bwd_impl_ops_ms"],
            max_abs_err=max(r["bwd_max_abs_err"] for r in shapes),
            tolerance=f"against f64: {fa.F32_BWD_TOL} x each gradient's "
                      f"largest, and {fa.F32_VS_BF16}x closer than the bf16 "
                      "instance; max_abs_err is against the plain f32 "
                      "version",
            **{**common, "err_vs_f64": max(max(r["bwd_err_of_largest_vs_f64"])
                                           for r in shapes)})
    # the edges of the f32 forward and backward: S = 1024 at d = 128 (their
    # most shared memory), S = 255 on K5's and K6's route (the last key
    # tile 31 of 32) and S = 256 on K7's and K8's (two warpgroups a block)
    edges = {"K7/K8 S=1024 d=128": _check_f32_pair(
                 torch, gen, fa.bh_attention_fwd, fa.bh_attention_bwd, 4,
                 1024, 128, timing=False),
             "K5/K6 S=255 d=64": _check_f32_pair(
                 torch, gen, fa.group_attention_fwd, fa.group_attention_bwd,
                 16, 255, 64, timing=False),
             "K7/K8 S=256 d=64": _check_f32_pair(
                 torch, gen, fa.bh_attention_fwd, fa.bh_attention_bwd, 16,
                 256, 64, timing=False)}
    launched = ops.launches()
    for name, n in launched.items():
        totals[name] += n
    step, step_launches = _f32_de_step(torch, np)
    for name, n in step_launches.items():
        totals[name] += n
    for name in F32_KERNELS:
        emit("kernel", name=name, nvidia_smi=smi,
             **{k: v for k, v in records[name].items() if k != "shapes"})
    emit("f32_attention", nvidia_smi=smi, pairs=by_pair, edges=edges,
         de_steps=step, seconds=time.perf_counter() - t0)
    fresh_peak(torch)
    _launch_totals(records, "f32_attention", totals)


# --- phase 24: --init-checkpoint and from_checkpoint at full width ----------

# artifacts under HF's key names, written here (no transformers on this
# machine), random weights: (family, layers, H, heads, F, vocab, positions,
# token types, MLM head)
HF_ARTIFACTS = {
    "roberta": ("roberta", 12, 768, 12, 3072, 50265, 514, 1, False),
    "distilbert": ("distilbert", 6, 768, 12, 3072, 30522, 512, 0, False),
    "bert_mlm": ("bert", 12, 768, 12, 3072, 30522, 512, 2, True),
}
# (a) msdoc_ar2_simans from the RoBERTa-base artifact: 20,480 passages (above
# 20,000 the synthetic corpus keeps the recipe's 512 tokens), 16 queries,
# one window of 4 steps, 8 queries a step; (b) serves the first
# INIT_SERVE_PASSAGES of them
INIT_MSDOC_FLAGS = ["--synthetic", "--full-size", "--fast-encode",
                    "--fast-teacher", "--int8-index", "--batch", str(N_Q),
                    "--steps", "4", "--warm-epochs", "1", "--corpus-size",
                    "20480", "--num-queries", "16"]
INIT_LEAD_STEPS, INIT_MASTER_STEPS = 4, 2
INIT_REQUESTS, INIT_SERVE_PASSAGES = 8, 4096


def _hf_artifact(torch, root, name, seed):
    """Write ``HF_ARTIFACTS[name]`` as ``<root>/<name>/pytorch_model.bin``
    (f32, normal(0, 0.02), LayerNorm scales about 1). -> its directory."""
    family, layers, h, heads, f, vocab, positions, types, mlm = \
        HF_ARTIFACTS[name]
    gen = torch.Generator().manual_seed(seed)
    sd = {}

    def rnd(*shape, mean=0.0):
        return torch.randn(*shape, generator=gen) * 0.02 + mean

    def lin(key, o, i):
        sd[f"{key}.weight"], sd[f"{key}.bias"] = rnd(o, i), rnd(o)

    def ln(key):
        sd[f"{key}.weight"], sd[f"{key}.bias"] = rnd(h, mean=1.0), rnd(h)

    pre = f"{family}."
    sd[pre + "embeddings.word_embeddings.weight"] = rnd(vocab, h)
    sd[pre + "embeddings.position_embeddings.weight"] = rnd(positions, h)
    if types:
        sd[pre + "embeddings.token_type_embeddings.weight"] = rnd(types, h)
    ln(pre + "embeddings.LayerNorm")
    for i in range(layers):
        if family == "distilbert":
            base = f"{pre}transformer.layer.{i}."
            for part in ("q_lin", "k_lin", "v_lin", "out_lin"):
                lin(base + "attention." + part, h, h)
            ln(base + "sa_layer_norm")
            lin(base + "ffn.lin1", f, h)
            lin(base + "ffn.lin2", h, f)
            ln(base + "output_layer_norm")
        else:
            base = f"{pre}encoder.layer.{i}."
            for part in ("query", "key", "value"):
                lin(base + "attention.self." + part, h, h)
            lin(base + "attention.output.dense", h, h)
            ln(base + "attention.output.LayerNorm")
            lin(base + "intermediate.dense", f, h)
            lin(base + "output.dense", h, f)
            ln(base + "output.LayerNorm")
    if mlm:
        lin("cls.predictions.transform.dense", h, h)
        ln("cls.predictions.transform.LayerNorm")
        sd["cls.predictions.bias"] = rnd(vocab)
    out = os.path.join(root, name)
    os.makedirs(out)
    torch.save(sd, os.path.join(out, "pytorch_model.bin"))
    return out


def _graft_spy(torch, run, grafts):
    """``run._graft_encoder`` that checks, right after each graft, that
    every grafted encoder holds the artifact's first layers bitwise, and
    records (prefixes, layers, family, the model, the artifact)."""
    real = run._graft_encoder

    def spy(model, init, prefixes, num_layers):
        real(model, init, prefixes, num_layers)
        want = run.truncate_layers(init["encoder"], num_layers)
        sd = model.state_dict()
        for prefix in prefixes:
            got = {k[len(prefix) + 1:]: v for k, v in sd.items()
                   if k.startswith(prefix + ".")}
            check(sorted(got) == sorted(want) and all(
                torch.equal(got[k].cpu(), want[k]) for k in want),
                f"graft of {prefix}: not the artifact's weights")
        grafts.append({"prefixes": list(prefixes), "layers": num_layers,
                       "family": init["family"], "model": model,
                       "init": init})

    return real, spy


def _request_hits(retriever, queries):
    """ids and scores of ``INIT_REQUESTS`` requests of 8 queries, k=10."""
    out = []
    for r in range(INIT_REQUESTS):
        out.extend((h.passage_id, h.score) for hits in retriever.search(
            queries[8 * r:8 * r + 8], k=10) for h in hits)
    return out


def phase_init_checkpoint(torch, smi, records):
    """Phase 24: ``--init-checkpoint`` at full width. (a) ``run_ar2`` in
    ``msdoc_ar2_simans`` from a RoBERTa-base artifact (both DE towers
    grafted, checked bitwise at the graft), K7/K8 in the DE and CE steps,
    K1-K4 in the mine and the teacher; (b) ``DenseRetriever.
    from_checkpoint`` on its step-4 DE state: 4,096 of the run's passages
    indexed, 8 requests, K1-K4 launched, hits equal to the same retriever
    over the trained DE in memory; (c) ``run_lead`` from a DistilBERT-base artifact
    (4 joint steps, K5/K6) and ``run_pretrain`` from a BERT-base MLM
    artifact (2 steps; the encoder and the MLM head grafted)."""
    import shutil
    import tempfile

    import numpy as np

    from simxns_tpu_torch import ops, run
    from simxns_tpu_torch.config import RECIPES
    from simxns_tpu_torch.data import HashTokenizer
    from simxns_tpu_torch.models import BiEncoder, BiEncoderConfig
    from simxns_tpu_torch.models import dual_encoder
    from simxns_tpu_torch.serve import DenseRetriever

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_init_")
    totals = {name: 0 for name in ops.KERNELS}
    grafts = []
    real_graft, spy = _graft_spy(torch, run, grafts)
    real_condenser = run.init_condenser
    factories = {name: getattr(run, name) for name in STEP_FACTORIES}
    rec = {}
    try:
        t0 = time.perf_counter()
        arts = {name: _hf_artifact(torch, root, name, seed)
                for seed, name in enumerate(HF_ARTIFACTS)}
        rec["artifacts_s"] = time.perf_counter() - t0
        run._graft_encoder = spy

        # (a) msdoc from RoBERTa-base
        step_ms, in_steps = {}, {}
        for name, kind in STEP_FACTORIES.items():
            setattr(run, name, _timed_factory(torch, factories[name], kind,
                                              step_ms, in_steps))
        out_dir = os.path.join(root, "msdoc")
        argv = INIT_MSDOC_FLAGS + ["--init-checkpoint", arts["roberta"],
                                   "--output-dir", out_dir]
        fresh_peak(torch)
        ops.reset_launches()
        t0 = time.perf_counter()
        out = _co_training_run(run, "msdoc_ar2_simans", argv)
        torch.cuda.synchronize()
        launched = ops.launches()
        for name, n in launched.items():
            totals[name] += n
        for name, fn in factories.items():
            setattr(run, name, fn)
        graft = grafts[-1]
        check(graft["family"] == "roberta" and graft["prefixes"] == [
            "question_model.encoder", "ctx_model.encoder"]
            and graft["layers"] == 12, f"msdoc graft: {graft['prefixes']}")
        for kind in ("biencoder", "reranker", "retriever"):
            got = in_steps.get(kind, {})
            check(got.get("bh_attention_fwd", 0) > 0
                  and got.get("bh_attention_bwd", 0) > 0,
                  f"msdoc from RoBERTa: the {kind} steps launched {got}")
        check(all(in_steps.get("retriever", {}).get(k, 0) > 0
                  for k in LAYER_KERNELS)
              and launched["mips_bucket_candidates"] > 0
              and all(launched[k] > in_steps["retriever"].get(k, 0)
                      for k in LAYER_KERNELS),
              f"msdoc from RoBERTa: K1-K4 in the mine and the teacher: "
              f"{launched}")
        check(math.isfinite(out["top1"]) and len(
            _co_training_losses(out_dir)) == 4,
            f"msdoc from RoBERTa: {out}")
        rec["msdoc_roberta"] = dict(
            flags=argv[:-2], wall_s=time.perf_counter() - t0,
            top1=out["top1"], losses=_co_training_losses(out_dir),
            step_ms=dict(step_ms), phase_times_s=out["phase_times_s"],
            max_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
            grafted=graft["prefixes"],
            launches={k: n for k, n in launched.items() if n},
            launches_in_steps=in_steps)

        # (b) from_checkpoint on the run's step-4 DE state
        t0 = time.perf_counter()
        args = run.build_parser().parse_args(
            ["--recipe", "msdoc_ar2_simans", *INIT_MSDOC_FLAGS])
        cfg = RECIPES["msdoc_ar2_simans"]
        corpus = run._synthesize_vectorized(args, cfg.data)
        bert = run._init_bert_cfg(graft["init"], run._bert_cfg(
            cfg.retriever.bert, False, corpus.vocab_size), corpus.vocab_size)
        serve_cfg = BiEncoderConfig(
            bert=bert.replace(layer_impl="fused_int8"),
            share_weight=cfg.retriever.share_weight,
            pooling=cfg.retriever.pooling,
            projection_dim=cfg.retriever.projection_dim)
        passages = {i: (f"document {i}", f"title{i}")
                    for i in range(INIT_SERVE_PASSAGES)}
        tokens = corpus.corpus_ids[:INIT_SERVE_PASSAGES]
        queries = [f"document {i} fact{i}"
                   for i in range(8 * INIT_REQUESTS)]
        kw = dict(store_dtype=torch.int8, index_mode="fused",
                  max_ctx_length=MS_S, max_q_length=LQ, block_size=2048)
        tok = HashTokenizer(vocab_size=corpus.vocab_size)
        ops.reset_launches()
        # the boundary's TrainState, else the final parameters
        ckpt = ("retriever_state" if os.path.isdir(os.path.join(
            out_dir, "retriever_state-4")) else "retriever")
        served = DenseRetriever.from_checkpoint(
            out_dir, 4, BiEncoder(serve_cfg), tok, name=ckpt,
            device="cuda", **kw)
        served.index_corpus(passages, precomputed_tokens=tokens)
        got = _request_hits(served, queries)
        torch.cuda.synchronize()
        launched = ops.launches()
        for name, n in launched.items():
            totals[name] += n
        check(all(launched[k] > 0 for k in LAYER_KERNELS)
              and launched["mips_bucket_candidates"] > 0,
              f"from_checkpoint: launches {launched}")
        memory = DenseRetriever(dual_encoder.int8_view(graft["model"]), tok,
                                device="cuda", **kw)
        memory.index_corpus(passages, precomputed_tokens=tokens)
        want = _request_hits(memory, queries)
        check(got == want, "from_checkpoint: hits differ from the same "
              "retriever over the trained DE in memory")
        rec["from_checkpoint"] = dict(
            checkpoint=f"{ckpt}-4", passages=len(passages),
            requests=INIT_REQUESTS, k=10,
            hits_equal_to_memory=True, wall_s=time.perf_counter() - t0,
            launches={k: n for k, n in launched.items() if n})
        del served, memory, corpus, tokens, graft
        grafts.clear()
        shutil.rmtree(out_dir, ignore_errors=True)

        # (c) LEAD from DistilBERT-base, MASTER from a BERT-base MLM
        heads = {}

        def condenser(cfg, seed):
            model = real_condenser(cfg, seed)
            load = model.mlm.load_state_dict

            def checked(sd, *a, **kw):
                result = load(sd, *a, **kw)
                own = model.mlm.state_dict()
                heads["equal"] = sorted(own) == sorted(sd) and all(
                    torch.equal(own[k].cpu(), sd[k]) for k in sd)
                return result

            model.mlm.load_state_dict = checked
            return model

        run.init_condenser = condenser
        for label, argv, kernels in (
                ("lead_distilbert", ["--recipe", "lead_ms_distill",
                                     *LEAD_FLAGS, "--steps",
                                     str(INIT_LEAD_STEPS),
                                     "--init-checkpoint",
                                     arts["distilbert"]],
                 ("group_attention_fwd", "group_attention_bwd")),
                ("master_bert_mlm", ["--recipe", "master_pretrain",
                                     *MASTER_FLAGS, "--steps",
                                     str(INIT_MASTER_STEPS),
                                     "--init-checkpoint", arts["bert_mlm"]],
                 ())):
            fresh_peak(torch)
            ops.reset_launches()
            t0 = time.perf_counter()
            out = run.main(argv + ["--output-dir",
                                   os.path.join(root, label)])
            torch.cuda.synchronize()
            launched = ops.launches()
            for name, n in launched.items():
                totals[name] += n
            graft = grafts[-1]
            check(math.isfinite(out["final_loss"]) and all(
                launched[k] > 0 for k in kernels),
                f"{label}: {out}, launches {launched}")
            rec[label] = dict(
                flags=argv[2:-2], wall_s=time.perf_counter() - t0,
                final_loss=out["final_loss"], grafted=graft["prefixes"],
                grafted_layers=graft["layers"], family=graft["family"],
                max_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                launches={k: n for k, n in launched.items() if n})
            grafts.clear()
        check(heads.get("equal") is True,
              "master: the MLM head is not the artifact's")
        rec["master_bert_mlm"]["mlm_head_grafted"] = True
        check(rec["lead_distilbert"]["family"] == "distilbert"
              and rec["master_bert_mlm"]["family"] == "bert",
              f"families: {rec['lead_distilbert']['family']}, "
              f"{rec['master_bert_mlm']['family']}")
    finally:
        run._graft_encoder = real_graft
        run.init_condenser = real_condenser
        for name, fn in factories.items():
            setattr(run, name, fn)
        shutil.rmtree(root, ignore_errors=True)
    emit("init_checkpoint", nvidia_smi=smi,
         seconds=time.perf_counter() - t_phase, **rec)
    fresh_peak(torch)
    _launch_totals(records, "init_checkpoint", totals)


# --- phase 25: the reader and ALLIES ------------------------------------------

# the reader: BERT-base over 2 questions x 8 passages x 256 tokens (K7/K8),
# bf16, 3 AdamW steps of reader_loss; the first step's gradients with
# K7/K8 against the plain pair beside two plain versions (phase 5's rule)
READER_N, READER_M, READER_L = 2, 8, 256
ALLIES_FLAGS = ["--synthetic", "--int8-index", "--corpus-size", "2048",
                "--num-queries", "16"]


def _reader_batch(np, seed):
    rng = np.random.default_rng(seed)
    n, m, l = READER_N, READER_M, READER_L
    lens = rng.integers(l // 2, l + 1, (n, m))
    mask = (np.arange(l)[None, None, :] < lens[..., None]).astype(np.int64)
    ids = rng.integers(1000, 30522, (n, m, l)) * mask
    sp = np.full((n, m, 2), l, np.int64)
    sp[:, 0, 0] = rng.integers(1, l // 2, n)
    ep = sp.copy()
    ep[:, 0, 0] += 3
    am = np.zeros((n, m, 2), np.int64)
    am[:, 0, 0] = 1
    return ids, mask, sp, ep, am


def phase_reader_allies(torch, smi, records):
    """Phase 25: a BERT-base ``Reader`` (2 x 8 x 256 tokens, bf16: K7/K8),
    its first step's gradients against the plain pair, 3 AdamW steps of
    ``reader_loss``; then ``run_allies`` in ``allies_qa`` with
    ``--int8-index`` to its end (K4)."""
    import shutil
    import tempfile

    import numpy as np

    from simxns_tpu_torch import ops, run
    from simxns_tpu_torch.models import (BertConfig, Reader, ReaderConfig,
                                         reader_loss)
    from simxns_tpu_torch.ops import flash_attention as fa
    from simxns_tpu_torch.train import TrainState, make_adamw

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    totals = {name: 0 for name in ops.KERNELS}
    fresh_peak(torch)
    model = Reader(ReaderConfig(bert=BertConfig(dtype=torch.bfloat16)),
                   generator=torch.Generator().manual_seed(25)).to(dev)
    batches = [[torch.from_numpy(x).to(dev) for x in _reader_batch(np, s)]
               for s in range(3)]

    def loss_of(b):
        start, end, rank = model(b[0], b[1])
        return reader_loss(start, end, rank, *b[2:])[0]

    def gradients():
        loss = loss_of(batches[0])
        grads = torch.autograd.grad(loss, list(model.parameters()),
                                    allow_unused=True)
        return float(loss.detach()), torch.cat(
            [g.float().flatten() for g in grads if g is not None])

    loss_k, grad_k = gradients()
    kernels = fa.bh_attention_fwd, fa.bh_attention_bwd, fa._probs
    fa.bh_attention_fwd, fa.bh_attention_bwd = (fa._group_fwd_plain,
                                                fa._group_bwd_plain)
    try:
        loss_p, grad_p = gradients()
        fa._probs = _softmax_probs
        loss_f, grad_f = gradients()
    finally:
        fa.bh_attention_fwd, fa.bh_attention_bwd, fa._probs = kernels
    cos, floor = _cosine(torch, grad_k, grad_p), _cosine(torch, grad_p,
                                                         grad_f)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    floor_rel = abs(loss_f - loss_p) / abs(loss_p)
    check(loss_rel <= max(1e-2, 2.5 * floor_rel) and cos >= 0.99
          and cos >= floor - 0.005,
          f"reader step, K7/K8 vs plain: loss rel {loss_rel} (two plain "
          f"{floor_rel}), gradient cosine {cos} (two plain {floor})")
    del grad_k, grad_p, grad_f
    tx = make_adamw(3e-5, total_steps=0)
    state = TrainState.create(model, tx)
    names = [n for n, _ in model.named_parameters()]
    ops.reset_launches()
    ms, losses = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = loss_of(b)
        grads = torch.autograd.grad(loss, list(model.parameters()),
                                    allow_unused=True)
        state.apply_gradients(dict(zip(names, grads)), tx)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss.detach()))
    launched = ops.launches()
    for name, n in launched.items():
        totals[name] += n
    check(launched["bh_attention_fwd"] >= 3 * 12
          and launched["bh_attention_bwd"] >= 3 * 12
          and all(math.isfinite(x) for x in losses),
          f"reader steps: launches {launched}, losses {losses}")
    reader = dict(shape=[READER_N, READER_M, READER_L],
                  loss_rel_vs_plain=loss_rel, two_plain_loss_rel=floor_rel,
                  gradient_cosine_vs_plain=cos, two_plain_cosine=floor,
                  step_ms=ms, losses=losses,
                  max_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                  launches={k: n for k, n in launched.items() if n})
    del model, state, batches
    fresh_peak(torch)
    root = tempfile.mkdtemp(prefix="chip_smoke_allies_")
    try:
        ops.reset_launches()
        t0 = time.perf_counter()
        out = run.main(["--recipe", "allies_qa", *ALLIES_FLAGS,
                        "--output-dir", root])
        torch.cuda.synchronize()
        launched = ops.launches()
        for name, n in launched.items():
            totals[name] += n
        check(launched["mips_bucket_candidates"] > 0 and out["questions"] > 0
              and 0.0 <= out["em"] <= 1.0 and out["retrievals_per_q"] >= 1
              and os.path.exists(os.path.join(root, "eval.json")),
              f"allies: {out}, launches {launched}")
        allies = dict(flags=ALLIES_FLAGS, wall_s=time.perf_counter() - t0,
                      **{k: out[k] for k in ("questions", "em", "f1",
                                             "api_calls_per_q",
                                             "retrievals_per_q")},
                      launches={k: n for k, n in launched.items() if n})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit("reader_allies", nvidia_smi=smi, reader=reader, allies=allies,
         seconds=time.perf_counter() - t_phase)
    fresh_peak(torch)
    _launch_totals(records, "reader_allies", totals)


# --- phase 26: CAPSTONE -----------------------------------------------------

# (a) doc2query at docT5query's width: a T5-base v1.0 artifact (vocab,
# d_model, layers a stack, heads, d_kv, d_ff, buckets; tied) written here
# under T5ForConditionalGeneration's names, 3 queries (the recipe's
# total_part) for each of 1,024 synthetic passages of 512 tokens, 64
# target tokens, top-10, 32 passages a batch, f32 with TF32 off
T5_BASE = (32128, 768, 12, 12, 64, 3072, 32)
D2Q_PASSAGES, D2Q_SRC, D2Q_TGT, D2Q_BATCH, D2Q_TOP_K = 1024, 512, 64, 32, 10
# the teacher-forcing logits on the card against the CPU, and the
# incremental decoder's step logits, eager and graphed, against the re-run
# decoder, each of the largest |logit| (f32 products in another order:
# ~1e-6 expected)
D2Q_TOL = 1e-4
# (b) run_capstone at full width over (a)'s TSV: BERT-base DE, 1,024
# synthetic passages (32 tokens: the synthetic text corpus's cap), 16
# queries, 8 a step x 32 passages (1 + 31 negatives), 10 steps (the
# launcher's checkpoint every steps // 5 = 2: 5 of 2.6 GB), then a
# relaunch that resumes to 12; the eval's top-10 ids (K4, int8) equal to
# the plain version's of the same search (K4-int8 is exact against it) and,
# as a reading, overlapping the exact search of the same state (the JAX
# package's geometry at 1,024 rows: 64 buckets of 16 rows, one candidate
# each, so two of the true top-10 in one bucket lose one)
CAPSTONE_FLAGS = ["--synthetic", "--full-size", "--int8-index",
                  "--corpus-size", "1024", "--num-queries", "16",
                  "--batch", "8"]
CAPSTONE_RUNS = (("run", 10), ("resume", 12))


def _t5_artifact(torch, root, seed, shape):
    """Write a T5 v1.0 ``T5ForConditionalGeneration`` state_dict (``shape``
    as ``T5_BASE``, tied) as ``<root>/t5/pytorch_model.bin``: HF's
    initializer scales, unit RMS scales; ``lm_head`` and each stack's
    ``embed_tokens`` are the shared table, as HF's ``state_dict`` lists
    them. -> its directory."""
    vocab, d, layers, heads, dkv, dff, buckets = shape
    inner = heads * dkv
    gen = torch.Generator().manual_seed(seed)

    def rnd(std, *size):
        return torch.randn(*size, generator=gen) * std

    sd = {"shared.weight": rnd(1.0, vocab, d)}
    for stack in ("encoder", "decoder"):
        for i in range(layers):
            b = f"{stack}.block.{i}.layer"
            parts = [("0.SelfAttention", "0")]
            if stack == "decoder":
                parts.append(("1.EncDecAttention", "1"))
            for att, norm in parts:
                sd[f"{b}.{att}.q.weight"] = rnd((d * dkv) ** -0.5, inner, d)
                sd[f"{b}.{att}.k.weight"] = rnd(d ** -0.5, inner, d)
                sd[f"{b}.{att}.v.weight"] = rnd(d ** -0.5, inner, d)
                sd[f"{b}.{att}.o.weight"] = rnd(inner ** -0.5, d, inner)
                sd[f"{b}.{norm}.layer_norm.weight"] = torch.ones(d)
            ffn = len(parts)
            sd[f"{b}.{ffn}.DenseReluDense.wi.weight"] = rnd(d ** -0.5, dff, d)
            sd[f"{b}.{ffn}.DenseReluDense.wo.weight"] = rnd(dff ** -0.5, d,
                                                            dff)
            sd[f"{b}.{ffn}.layer_norm.weight"] = torch.ones(d)
        sd[f"{stack}.block.0.layer.0.SelfAttention.relative_attention_bias"
           ".weight"] = rnd(d ** -0.5, buckets, heads)
        sd[f"{stack}.final_layer_norm.weight"] = torch.ones(d)
        sd[f"{stack}.embed_tokens.weight"] = sd["shared.weight"]
    sd["lm_head.weight"] = sd["shared.weight"]
    out = os.path.join(root, "t5")
    os.makedirs(out)
    torch.save(sd, os.path.join(out, "pytorch_model.bin"))
    return out


class _WordTokenizer:
    """A decodable word-level tokenizer (``tests/test_t5.py:135-145``'s
    idea): word ``w<i>`` is id i; PAD (0) and EOS (1) decode to nothing."""

    def encode(self, text, max_length=None, truncation=None):
        ids = [int(w[1:]) for w in text.split()]
        return ids[:max_length] if max_length else ids

    def decode(self, ids):
        return " ".join(f"w{i}" for i in ids if i > 1)


def _d2q_passages(np, n, length, vocab, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, vocab, (n, length))
    return [(i, " ".join(f"w{t}" for t in row)) for i, row in enumerate(ids)]


def _pad_after_eos(flat):
    """Rows that emitted EOS (1), and whether every token after it is PAD."""
    ended, ok = 0, True
    for row in flat.tolist():
        if 1 in row[1:]:
            ended += 1
            ok = ok and all(t == 0 for t in row[row.index(1, 1) + 1:])
    return ended, ok


def _d2q_checks(torch, np, model, passages, tok):
    """On the first batch: its tokens (the same seed as ``doc2query_tsv``'s
    batch 0), the teacher-forcing logits of two of its rows on the card
    against the CPU, the incremental decoder's step logits, eager and as
    the CUDA graph that ``generate`` replays, against the re-run decoder
    over the whole batch, every sampled token inside its
    step's top-k, PAD after EOS; then one batch with EOS made likely (its
    row of the tied table along the decoder's mean output), PAD after it.
    -> (record, the batch's tokens [B, 3, T])."""
    import copy

    from simxns_tpu_torch.models.t5 import _graphed_step, generate

    dev, n, cfg = torch.device("cuda"), 3, model.cfg
    enc = np.zeros((D2Q_BATCH, D2Q_SRC), np.int64)
    for r, (_, text) in enumerate(passages[:D2Q_BATCH]):
        ids = tok.encode(text, max_length=D2Q_SRC)
        enc[r, :len(ids)] = ids
    mask = (enc != 0).astype(np.int64)
    toks = generate(model, enc, mask, 0, max_length=D2Q_TGT,
                    top_k=D2Q_TOP_K, num_return_sequences=n)
    flat = toks.reshape(-1, D2Q_TGT)
    enc_t, mask_t = (torch.from_numpy(x).to(dev) for x in (enc, mask))
    rec = {}
    with torch.no_grad():
        # two rows (passages 0 and 1) on the card and on the CPU
        rows = [0, n]
        cpu = copy.deepcopy(model).cpu()
        dec = flat[rows].long()
        args = (enc_t[:2], mask_t[:2], dec, torch.ones_like(dec))
        want = cpu(*(a.cpu() for a in args))
        got = model(*args).cpu()
        rec["logits_vs_cpu"] = float((got - want).abs().max()
                                     / want.abs().max())
        del cpu
        # the incremental decoder against the re-run, step by step
        hidden = model.encode(enc_t, mask_t)
        full = model.decode(flat.long(), torch.ones_like(flat),
                            hidden.repeat_interleave(n, 0),
                            mask_t.repeat_interleave(n, 0))
        cache = model.start_decode(hidden, mask_t, D2Q_TGT, repeat=n)
        graphed = _graphed_step(model, model.start_decode(
            hidden, mask_t, D2Q_TGT, repeat=n), flat.shape[0])
        worst, worst_graph, outside = 0.0, 0.0, 0
        done = torch.zeros(flat.shape[0], dtype=torch.bool, device=dev)
        for t in range(D2Q_TGT - 1):
            scale = full[:, t].abs().max()
            step = model.decode_step(flat[:, t], t, cache)
            worst = max(worst, float((step - full[:, t]).abs().max()
                                     / scale))
            worst_graph = max(worst_graph, float(
                (graphed(flat[:, t], t) - full[:, t]).abs().max() / scale))
            kth = torch.topk(step, D2Q_TOP_K, dim=-1).values[:, -1]
            nxt = flat[:, t + 1].long()
            picked = step.gather(1, nxt[:, None])[:, 0]
            outside += int(((picked < kth) & ~done).sum())
            done |= nxt == cfg.eos_id
        rec["step_vs_rerun"] = worst
        rec["graphed_step_vs_rerun"] = worst_graph
        rec["sampled_outside_top_k"] = outside
        ended, pad_ok = _pad_after_eos(flat)
        # EOS made likely on a copy of the table row, then restored
        table = model.shared_embed.weight
        saved = table[cfg.eos_id].clone()
        seen = []
        hook = model.dec_final_norm.register_forward_hook(
            lambda mod, a, out: seen.append(out[:, :8].mean((0, 1))))
        model.decode(flat[:, :8].long(), torch.ones_like(flat[:, :8]),
                     hidden.repeat_interleave(n, 0),
                     mask_t.repeat_interleave(n, 0))
        hook.remove()
        mean = seen[0]
        table[cfg.eos_id] = mean / mean.norm() * table.norm(dim=1).mean() * 2
        boosted = generate(model, enc, mask, 1, max_length=D2Q_TGT,
                           top_k=D2Q_TOP_K, num_return_sequences=n)
        table[cfg.eos_id] = saved
        eos_ended, eos_ok = _pad_after_eos(boosted.reshape(-1, D2Q_TGT))
        del full, cache, graphed, hidden
    rec.update(rows_ended=ended, pad_after_eos=pad_ok,
               eos_batch_rows_ended=eos_ended, eos_batch_pad_after_eos=eos_ok)
    check(max(rec["logits_vs_cpu"], worst, worst_graph) <= D2Q_TOL
          and outside == 0 and pad_ok and eos_ok and eos_ended > 0,
          f"doc2query checks: {rec}")
    return rec, toks.cpu().numpy()


def _capstone_losses(out_dir):
    with open(os.path.join(out_dir, "metrics.jsonl"), encoding="utf-8") as f:
        return [(r["step"], r["loss"], r["bucket"]) for r in map(json.loads, f)
                if r.get("phase") == "curriculum"]


def phase_capstone(torch, smi, records):
    """Phase 26: (a) doc2query with a T5-base artifact written here, loaded
    through ``_load_init_checkpoint``'s sniff, ``convert_hf_t5`` and
    ``t5_config_from_state_dict``: 3 queries for each of 1,024 passages
    (``doc2query_tsv``), passages/s and peak memory, and the checks of
    ``_d2q_checks``; (b) ``run_capstone`` over its TSV, 10 steps then a
    resume to 12: step ms and host ms a step apart, peak memory, losses and
    buckets, K4 in the eval and its top-10 against the plain version (and,
    a reading, the exact search)."""
    import argparse
    import shutil
    import tempfile

    import numpy as np

    from simxns_tpu_torch import ops, run
    from simxns_tpu_torch.index import MIPSIndex, RetrievalEngine
    from simxns_tpu_torch.models.bert import from_state_dict
    from simxns_tpu_torch.models.hf_import import (convert_hf_t5,
                                                   t5_config_from_state_dict)
    from simxns_tpu_torch.models.t5 import T5, doc2query_tsv
    from simxns_tpu_torch.ops.topk import blocked_mips_topk

    t_phase = time.perf_counter()
    totals = {name: 0 for name in ops.KERNELS}
    root = tempfile.mkdtemp(prefix="chip_smoke_capstone_")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    factory = run.make_biencoder_step
    real_build, real_mine = run._build_index, RetrievalEngine.mine
    try:
        # (a) doc2query
        t0 = time.perf_counter()
        ckpt = _t5_artifact(torch, root, 26, T5_BASE)
        artifact_s = time.perf_counter() - t0
        init = run._load_init_checkpoint(
            argparse.Namespace(init_checkpoint=ckpt))
        check(init["family"] == "t5", f"sniffed {init['family']}")
        cfg = t5_config_from_state_dict(init["sd"])
        vocab, d, layers, heads, dkv, dff, buckets = T5_BASE
        check((cfg.vocab_size, cfg.d_model, cfg.num_layers, cfg.n_dec,
               cfg.num_heads, cfg.d_kv, cfg.d_ff,
               cfg.relative_attention_num_buckets,
               cfg.relative_attention_max_distance, cfg.tie_word_embeddings)
              == (vocab, d, layers, layers, heads, dkv, dff, buckets, 128,
                  True), f"T5 config {cfg}")
        model = from_state_dict(T5, cfg, convert_hf_t5(init["sd"]))
        del init
        model = model.to("cuda").eval()
        tok = _WordTokenizer()
        passages = _d2q_passages(np, D2Q_PASSAGES, D2Q_SRC, vocab, 26)
        fresh_peak(torch)
        tsv = os.path.join(root, "doc2query.tsv")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        doc2query_tsv(model, tok, passages, tsv, num_queries=3,
                      max_src_length=D2Q_SRC, max_length=D2Q_TGT,
                      top_k=D2Q_TOP_K, batch_size=D2Q_BATCH, seed=0)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        gen_gb = torch.cuda.max_memory_allocated() / 1e9
        rec, toks = _d2q_checks(torch, np, model, passages, tok)
        rows = open(tsv, encoding="utf-8").read().splitlines()
        check(len(rows) == D2Q_PASSAGES and all(
            len(r.split("\t")) == 4 for r in rows), "doc2query TSV rows")
        first = []
        for s in range(3):
            row = toks[0, s]
            end = np.nonzero(row == cfg.eos_id)[0]
            row = row[1:int(end[0])] if len(end) else row[1:]
            first.append(tok.decode(row.tolist()))
        check(rows[0].split("\t")[1:] == first,
              "the TSV's first row is not batch 0's tokens decoded")
        del model
        emit("doc2query", nvidia_smi=smi, shape=dict(zip(
            ("vocab", "d_model", "layers", "heads", "d_kv", "d_ff",
             "buckets"), T5_BASE)), passages=D2Q_PASSAGES,
             source_tokens=D2Q_SRC, target_tokens=D2Q_TGT, returns=3,
             top_k=D2Q_TOP_K, batch=D2Q_BATCH, artifact_s=artifact_s,
             generate_s=gen_s, passages_per_s=D2Q_PASSAGES / gen_s,
             max_memory_gb=gen_gb, **rec)
        fresh_peak(torch)

        # (b) run_capstone over the TSV, and a resume
        seen = {}

        def spy_build(index, encode_fn, token_ids, mask, vocab_size, args):
            seen["build"] = (encode_fn, token_ids, mask, vocab_size, args)
            return real_build(index, encode_fn, token_ids, mask, vocab_size,
                              args)

        def spy_mine(self, query_embeddings, *a, **kw):
            res = real_mine(self, query_embeddings, *a, **kw)
            seen["mine"] = (self.index, np.asarray(query_embeddings),
                            np.asarray(res.topk_ids))
            return res

        run._build_index, RetrievalEngine.mine = spy_build, spy_mine
        out_dir = os.path.join(root, "run")
        for label, steps_to in CAPSTONE_RUNS:
            step_ms = {}
            run.make_biencoder_step = _timed_factory(torch, factory,
                                                     "curriculum", step_ms)
            fresh_peak(torch)
            ops.reset_launches()
            t0 = time.perf_counter()
            out = run.main(["--recipe", "capstone_curriculum",
                            *CAPSTONE_FLAGS, "--query-tsv", tsv, "--steps",
                            str(steps_to), "--output-dir", out_dir])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launched = ops.launches()
            for name, n in launched.items():
                totals[name] += n
            losses = _capstone_losses(out_dir)
            first_step = 1 if label == "run" else CAPSTONE_RUNS[0][1] + 1
            ran = steps_to - first_step + 1
            check(out["steps"] == steps_to
                  and math.isfinite(out["final_loss"])
                  and [s for s, _, _ in losses][-ran:]
                  == list(range(first_step, steps_to + 1))
                  and all(math.isfinite(x) for _, x, _ in losses)
                  and launched["mips_bucket_candidates"] > 0
                  and len(step_ms.get("curriculum", [])) == ran,
                  f"capstone {label}: {out}, losses {losses}, launches "
                  f"{launched}")
            # the run's top-10 (K4) against the plain version of the same
            # fused search on the CPU, and against the exact search of the
            # same state (a reading: the bucket reduction is approximate)
            encode_fn, tokens, mask, vocab_size, args = seen["build"]
            index, queries, fused_ids = seen["mine"]
            q16 = torch.from_numpy(queries).to(torch.bfloat16)
            _, plain_ids = blocked_mips_topk(
                q16, index.embeddings.cpu(), fused_ids.shape[1],
                block_size=index.block_size, valid_n=index.shard_valid,
                mode="fused", row_scales=index.row_scales.cpu())
            exact = MIPSIndex("cuda", block_size=index.block_size,
                              store_dtype=index.store_dtype, mode="exact")
            real_build(exact, encode_fn, tokens, mask, vocab_size, args)
            _, exact_ids = exact.search(queries, fused_ids.shape[1])
            overlap = {name: float(np.mean([
                len(set(a[:10]) & set(b[:10])) / 10
                for a, b in zip(fused_ids.tolist(), other.tolist())]))
                for name, other in (("plain", plain_ids.numpy()),
                                    ("exact", exact_ids))}
            check(np.array_equal(fused_ids, plain_ids.numpy()),
                  f"capstone {label}: K4's ids differ from its plain "
                  f"version's (top-10 overlap {overlap})")
            del exact, index, seen["build"], seen["mine"]
            files = set(os.listdir(out_dir))
            check({f"curriculum_state-{steps_to}", f"retriever-{steps_to}",
                   "eval.json"} <= files, f"capstone {label}: {files}")
            ms = step_ms["curriculum"]
            emit("capstone", nvidia_smi=smi, run=label,
                 flags=CAPSTONE_FLAGS, steps=steps_to, wall_s=wall,
                 losses=[[s, x] for s, x, _ in losses],
                 buckets=[[s, b] for s, _, b in losses], step_ms=ms,
                 steady_step_ms=(float(sum(ms[1:]) / (len(ms) - 1))
                                 if len(ms) > 1 else None),
                 host_ms_per_step=out["phase_times_s"]["expand"] / ran * 1e3,
                 top1=out["top1"], mrr10=out["mrr10"],
                 top10_overlap_vs_plain=overlap["plain"],
                 top10_overlap_vs_exact=overlap["exact"],
                 phase_times_s=out["phase_times_s"],
                 max_memory_gb=out["max_memory_gb"],
                 launches={k: n for k, n in launched.items() if n})
    finally:
        run.make_biencoder_step = factory
        run._build_index, RetrievalEngine.mine = real_build, real_mine
        torch.backends.cuda.matmul.allow_tf32 = tf32
        shutil.rmtree(root, ignore_errors=True)
    emit("capstone_phase", nvidia_smi=smi,
         seconds=time.perf_counter() - t_phase)
    fresh_peak(torch)
    _launch_totals(records, "capstone", totals)


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
    "group_attention_fwd": ("cuda",
                            "simxns_tpu_torch/csrc/attention_fwd_wgmma.cu",
                            "simxns_tpu/ops/flash_attention.py:113"),
    "group_attention_bwd": ("cuda",
                            "simxns_tpu_torch/csrc/attention_bwd_wgmma.cu",
                            "simxns_tpu/ops/flash_attention.py:125"),
    "bh_attention_fwd": ("cuda",
                         "simxns_tpu_torch/csrc/attention_fwd_wgmma.cu",
                         "simxns_tpu/ops/flash_attention.py:67"),
    "bh_attention_bwd": ("cuda",
                         "simxns_tpu_torch/csrc/attention_bwd_wgmma.cu",
                         "simxns_tpu/ops/flash_attention.py:80"),
    "ffn_train_fwd": ("cuda", "simxns_tpu_torch/csrc/ffn_fwd.cu",
                      "simxns_tpu/ops/fused_ffn.py:324"),
    "ffn_bwd_dx": ("cuda", "simxns_tpu_torch/csrc/fused_ffn.cu",
                   "simxns_tpu/ops/fused_ffn.py:348"),
    "ffn_bwd_dw": ("cuda", "simxns_tpu_torch/csrc/fused_ffn.cu",
                   "simxns_tpu/ops/fused_ffn.py:374"),
    "ffn_fused_fwd": ("cuda", "simxns_tpu_torch/csrc/ffn_fwd.cu",
                      "simxns_tpu/ops/fused_ffn.py:77"),
    "int8_dense": ("cuda", "simxns_tpu_torch/csrc/int8_ffn.cu",
                   "simxns_tpu/ops/fused_ffn.py:222"),
    "int8_ffn": ("cuda", "simxns_tpu_torch/csrc/int8_ffn.cu",
                 "simxns_tpu/ops/fused_ffn.py:160"),
    # the f32 instances of K5-K8 (K5's and K7's: one wgmma forward; K6's
    # and K8's: K8's wgmma backward)
    "group_attention_fwd_f32": ("cuda",
                                "simxns_tpu_torch/csrc/attention_fwd_wgmma.cu",
                                "simxns_tpu/ops/flash_attention.py:113"),
    "group_attention_bwd_f32": ("cuda",
                                "simxns_tpu_torch/csrc/attention_bwd_wgmma.cu",
                                "simxns_tpu/ops/flash_attention.py:125"),
    "bh_attention_fwd_f32": ("cuda",
                             "simxns_tpu_torch/csrc/attention_fwd_wgmma.cu",
                             "simxns_tpu/ops/flash_attention.py:67"),
    "bh_attention_bwd_f32": ("cuda",
                             "simxns_tpu_torch/csrc/attention_bwd_wgmma.cu",
                             "simxns_tpu/ops/flash_attention.py:80"),
}


def main():
    if sys.argv[1:2] == ["--data-parallel-rank"]:
        return _data_parallel_rank(sys.argv[2:])
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
    # the f32 instances of K5-K8: off the serving path; counted from here,
    # measured in phase 23
    for name in F32_KERNELS:
        records[name] = {}
    phase_train_kernels(torch, smi, records)
    xla = phase_training(torch, smi, records)
    phase_msdoc_kernels(torch, smi, records)
    co_training = phase_co_training(torch, smi, records)
    phase_ffn_kernels(torch, smi, records)
    phase_ffn_training(torch, smi, records, xla)
    phase_ffn_encode(torch, smi, records)
    phase_int8_kernels(torch, smi, records)
    phase_int8_encode(torch, smi, records)
    phase_remat_dots(torch, smi, records)
    phase_dropout_steps(torch, smi, records, xla)
    phase_lead_ce(torch, smi)
    phase_rerank(torch, smi, records)
    phase_data_parallel(torch, smi, records, co_training)
    phase_prod_kd(torch, smi, records)
    phase_mesh(torch, smi, records)
    phase_repairs(torch, smi, records)
    phase_lead(torch, smi, records)
    phase_master(torch, smi, records)
    phase_f32_attention(torch, smi, records)
    phase_init_checkpoint(torch, smi, records)
    phase_reader_allies(torch, smi, records)
    phase_capstone(torch, smi, records)
    kernels = []
    # K1-K14, then the f32 instances of K5-K8 apart
    for name in [n for n in records if n not in F32_KERNELS] + list(
            F32_KERNELS):
        rec = records[name]
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
