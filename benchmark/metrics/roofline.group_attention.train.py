"""The reranker's attention at its joint rows (S below 256: the grouped
kernels K5 forward and K6 backward) against its roofline: the least time
of that work in the window (each launch's larger of bf16 flops at 989
TFLOP/s and bytes at 3.35 TB/s; forward reads q, k, v and the key mask
and writes o, backward reads q, k, v, dO and the mask and writes dq, dk,
dv) over the device time of the kernels that compute it. Moves
``train_step_ms``."""

from benchmark import work

KERNELS = ("group_attention_fwd_kernel", "group_attention_bwd_kernel")


def read(view):
    seconds = view.kernel_seconds(lambda n: any(k in n for k in KERNELS))
    steps = view.work.get("steps", {}).get("reranker", 0)
    if not seconds or not steps:
        return None
    cfg = view.cell.config
    ce = cfg["reranker"]
    rows = cfg["batch"]["queries"] * (1 + cfg["recipe"]["num_negatives"])
    s = cfg["lengths"]["joint"]
    least = sum(work.least_seconds(w["ops"], w["bytes"], work.PEAK_BF16)
                for w in (work.attention_work(ce, rows, s, False),
                          work.attention_work(ce, rows, s, True)))
    least *= steps * ce["num_hidden_layers"]
    return 100.0 * least / seconds
