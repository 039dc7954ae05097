"""Readings behind the rerank gates of ``chip_smoke.py`` (phase 16), on a
CUDA card.

For each weight seed, 256 joint rows of the rerank phase (a different 256
for each seed) go through the nq reranker (CE-large, random weights) on
two paths, each against its plain PyTorch version, layer by layer
(``chip_smoke._layer_walk``): the int8 view (K1-K3) and the bf16 encoder
(K5). Each layer gives the teacher-forced error (the kernel layer on the
plain path's input) and the free-running score gap at that depth (the
``qa_classifier`` over that layer's CLS vectors: a model cut to that
depth). Controls on the plain int8 path, each walked against the unchanged
plain path:

- rounding: ``ln1_bf16@0`` (layer 0's post-attention LayerNorm rounded to
  bf16 before its codes and residual), ``code_flip@0`` (in layer 0, the
  code of column 0 of every row's first token one step off);
- faults: ``scale_1pct@12`` (layer 12's token scales 1% high),
  ``head_lost@12`` (layer 12's first head gives no context),
  ``unmasked@12`` (layer 12 attends over the padding too; also on the
  bf16 path) and ``shuffled`` (the plain scores, rolled by one row).

Prints one JSON line per seed and path and per control (with ``--out``,
also appends them to that file)::

    python3 scripts/torch_rerank_witness.py [--seeds 0,1,2,3] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

from simxns_tpu_torch.models.bert import dense  # noqa: E402
from simxns_tpu_torch.ops import _native  # noqa: E402
from simxns_tpu_torch.ops.fused_ffn import quant_rows  # noqa: E402

ROWS = 256
FAULT_LAYER = 12


def _summary(layers, final):
    return dict(
        forced_err=[r["forced_err"] for r in layers],
        gap_over_spread=[r["score_gap"]["gap_over_spread"] for r in layers],
        correlation=[r["score_gap"]["correlation"] for r in layers],
        final=cs._score_gap(np, *final["scores"]),
        cls_min_cosine=final["cls_min_cosine"],
        centred_cls_min_cosine=final["cls_centred_min_cosine"])


def _controls():
    """{name: int8_hook} of the plain-path controls."""
    def ln1_bf16(i, quant, attend):
        if i != 0:
            return quant, attend

        def q(x, residual=None, ln=None, eps=1e-12, quant=True,
              out_f32=False, out_bf16=False):
            if ln is None or not quant:
                return quant_fn(x, residual, ln, eps, quant, out_f32,
                                out_bf16)
            _, _, y, _ = quant_fn(x, residual, ln, eps, False, True, False)
            y = y.to(torch.bfloat16).float()
            return (*quant_rows(y), y, None)

        quant_fn = quant
        return q, attend

    def first_pass(layer_at, change):
        """Change the codes and scales of x (each layer call's first row
        pass) in layer ``layer_at``."""
        def hook(i, quant, attend):
            if i != layer_at:
                return quant, attend
            calls = [0]

            def q(x, *args, **kw):
                out = quant(x, *args, **kw)
                calls[0] += 1
                if calls[0] % 5 == 1:
                    out = change(*out)
                return out
            return q, attend
        return hook

    def flip(codes, scales, y32, y16):
        codes = codes.clone().view(-1, cs.LJ, codes.shape[-1])
        c = codes[:, 0, 0].to(torch.int16)
        codes[:, 0, 0] = torch.where(c >= 127, c - 1, c + 1).to(torch.int8)
        return codes.view(-1, codes.shape[-1]), scales, y32, y16

    def scale(codes, scales, y32, y16):
        return codes, scales * 1.01, y32, y16

    def head_lost(i, quant, attend):
        if i != FAULT_LAYER:
            return quant, attend

        def a(qkv, m, heads):
            ctx = attend(qkv, m, heads).clone()
            ctx[:, :ctx.shape[1] // heads] = 0
            return ctx
        return quant, a

    return {"ln1_bf16@0": ln1_bf16, "code_flip@0": first_pass(0, flip),
            f"scale_1pct@{FAULT_LAYER}": first_pass(FAULT_LAYER, scale),
            f"head_lost@{FAULT_LAYER}": head_lost}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", default="0,1,2,3")
    ap.add_argument("--out", help="a file to append the JSON lines to")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = cs.nvidia_smi()
    t0 = time.perf_counter()
    _native.build()
    joint = cs._rerank_joint().reshape(-1, cs.LJ)
    log = open(args.out, "a") if args.out else None

    def emit(**fields):
        line = json.dumps({"nvidia_smi": smi, **fields})
        print(line, flush=True)
        if log is not None:
            log.write(line + "\n")

    for seed in (int(x) for x in args.seeds.split(",")):
        ce = cs._ce_large(torch, seed=seed)
        rows = slice(ROWS * seed, ROWS * (seed + 1))
        ids = torch.from_numpy(joint[rows]).cuda().long()
        mask = (ids != 0).to(torch.int32)

        def score(cls):
            return dense(ce.qa_classifier, cls.to(torch.bfloat16),
                         torch.bfloat16)[:, 0].float().cpu().numpy()

        with torch.no_grad():
            stacks, embed = cs._rerank_stacks(torch, ce, mask)
            for path, (kern, plain) in stacks.items():
                walk = cs._layer_walk(torch, kern, plain, embed[path](ids),
                                      score)
                emit(seed=seed, rows=[rows.start, rows.stop], path=path,
                     compare="kernel_vs_plain", **_summary(*walk))
                if path == "int8":
                    plain_scores = walk[1]["scores"][1]
            x8 = embed["int8"](ids)
            plain8 = stacks["int8"][1]
            for name, hook in _controls().items():
                ctl, _ = cs._rerank_stacks(torch, ce, mask, int8_hook=hook)
                res = _summary(*cs._layer_walk(torch, ctl["int8"][1], plain8,
                                               x8, score))
                emit(seed=seed, path="int8", compare=name, **res)
            faulty, _ = cs._rerank_stacks(torch, ce, mask,
                                          fault_at=FAULT_LAYER)
            for path in ("int8", "bf16"):
                res = _summary(*cs._layer_walk(
                    torch, faulty[path][1], stacks[path][1],
                    embed[path](ids), score))
                emit(seed=seed, path=path,
                     compare=f"unmasked@{FAULT_LAYER}", **res)
            emit(seed=seed, path="int8", compare="shuffled",
                 final=cs._score_gap(np, np.roll(plain_scores, 1),
                                     plain_scores))
        del ce, stacks, faulty
        cs.fresh_peak(torch)
    emit(done_s=time.perf_counter() - t0)
    if log is not None:
        log.close()


if __name__ == "__main__":
    main()
