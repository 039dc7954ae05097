"""Attention at 512 tokens (the per-(batch, head) kernels K7 forward and
K8's query and key passes backward) against its roofline: in a reranker
step the reranker's joint rows, in a retriever step the passage tower's
rows, forward and backward once each (the remat recompute is not
counted). The least time of that work in the window (each launch's
larger of bf16 flops at 989 TFLOP/s and bytes at 3.35 TB/s) over the
device time of the kernels. Moves ``train_step_ms``."""

import re

from benchmark import work

_FWD = re.compile(r"(?<![A-Za-z_])attention_fwd<|13attention_fwdI")
_BWD = ("bh_attention_bwd_query_kernel", "bh_attention_bwd_key_kernel")


def _ours(name):
    return (_FWD.search(name) is not None
            and "group_attention" not in name) or any(k in name for k in _BWD)


def read(view):
    seconds = view.kernel_seconds(_ours)
    steps = view.work.get("steps", {})
    if not seconds or not steps:
        return None
    cfg = view.cell.config
    rows = cfg["batch"]["queries"] * (1 + cfg["recipe"]["num_negatives"])
    least = 0.0
    for kind, model, s in (("reranker", cfg["reranker"], cfg["lengths"]["joint"]),
                           ("retriever", cfg["retriever"],
                            cfg["lengths"]["passage"])):
        if s < 256:
            continue
        per = sum(work.least_seconds(w["ops"], w["bytes"], work.PEAK_BF16)
                  for w in (work.attention_work(model, rows, s, False),
                            work.attention_work(model, rows, s, True)))
        least += per * model["num_hidden_layers"] * steps.get(kind, 0)
    return 100.0 * least / seconds
