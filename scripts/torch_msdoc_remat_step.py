"""One GPU's share of the ``msdoc_ar2_simans`` reranker step in the PyTorch
port, at the recipe's batch, with and without ``BertConfig.remat``.

    python scripts/torch_msdoc_remat_step.py
    python scripts/torch_msdoc_remat_step.py --queries 8 --variants xla,xla+remat

The recipe gives each GPU 32 queries x 16 passages of 512 joint tokens
(262,144 tokens a step) through a BERT-base cross-encoder (vocab 50265).
Each variant ``<ffn_impl>[+remat]`` builds the model from seed 0 in bf16,
takes ``--steps`` AdamW reranker steps on random token batches and prints
one JSON line: the step times (host clock to a synchronise), the peak
device memory and the launches of every hand-written kernel. A variant that
runs out of device memory prints ``"oom": true`` and the next one runs.
Needs one CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from simxns_tpu_torch import ops
from simxns_tpu_torch.config import RECIPES
from simxns_tpu_torch.models import CrossEncoder, CrossEncoderConfig
from simxns_tpu_torch.train import TrainState, make_adamw, make_reranker_step


def run_variant(variant: str, queries: int, passages: int, length: int,
                n_steps: int) -> dict:
    ffn_impl, _, remat = variant.partition("+")
    if remat not in ("", "remat"):
        raise SystemExit(f"unknown variant {variant!r}")
    recipe = RECIPES["msdoc_ar2_simans"]
    bert = recipe.reranker.bert.replace(dtype=torch.bfloat16,
                                        ffn_impl=ffn_impl,
                                        remat=bool(remat))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = {"variant": variant, "queries": queries, "passages": passages,
           "joint_length": length, "tokens_per_step": queries * passages
           * length}
    try:
        ce = CrossEncoder(CrossEncoderConfig(bert=bert),
                          generator=torch.Generator().manual_seed(0)
                          ).to("cuda")
        tx = make_adamw(recipe.reranker_optim.learning_rate, total_steps=0)
        state, step = TrainState.create(ce, tx), make_reranker_step(tx)
        rng = np.random.default_rng(0)
        ops.reset_launches()
        step_ms, losses = [], []
        for _ in range(n_steps):
            ids = rng.integers(1000, bert.vocab_size,
                               (queries, passages, length)).astype(np.int32)
            batch = {"joint_ids": ids, "joint_mask": np.ones_like(ids)}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        out.update(step_ms=step_ms, losses=losses,
                   launches={k: v for k, v in ops.launches().items() if v})
        del state, ce
    except torch.cuda.OutOfMemoryError:
        out["oom"] = True
    out["max_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--queries", type=int, default=32)
    ap.add_argument("--passages", type=int, default=16)
    ap.add_argument("--length", type=int, default=512)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--variants",
                    default="xla+remat,fused_vjp+remat,fused_vjp,xla")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    for variant in args.variants.split(","):
        rec = run_variant(variant, args.queries, args.passages, args.length,
                          args.steps)
        print(json.dumps({"nvidia_smi": smi, **rec}), flush=True)


if __name__ == "__main__":
    main()
