"""The yardstick's arithmetic: the card's published peaks, and the
operations and bytes of the cells' work counted from their shapes.

Peaks are NVIDIA's data sheet for the H100 SXM (dense, no sparsity, at
the full 700 W): 989 TFLOP/s for bf16 products, 1,979 TOP/s for int8
products, 3.35 TB/s of HBM3. A count is of what the algorithm needs at
the cell's padded shapes: each input read once, each output written
once, no recomputation (remat) counted.

A BERT encoder of L layers, width H, FFN width F, over T tokens in rows
of S: the dense products take ``2 T (4 H^2 + 2 H F)`` operations a layer,
the attention ``4 T S H`` (scores and values); a backward takes twice the
forward.
"""

from __future__ import annotations

PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
PEAK_BYTES = 3.35e12


def least_seconds(ops: float, bytes_moved: float, peak_ops: float) -> float:
    """The least time of a piece of work: the larger of its operations at
    the peak of their precision and its bytes at the memory bandwidth."""
    return max(ops / peak_ops, bytes_moved / PEAK_BYTES)


def dense_ops(c: dict, tokens: int) -> float:
    """The dense products of one forward of a model config ``c`` over
    ``tokens`` tokens (all layers)."""
    h, f = c["hidden_size"], c["intermediate_size"]
    return 2.0 * tokens * (4 * h * h + 2 * h * f) * c["num_hidden_layers"]


def attention_ops(c: dict, rows: int, s: int) -> float:
    """Scores and value products of one forward over ``rows`` rows of
    ``s`` tokens (all layers)."""
    return 4.0 * rows * s * s * c["hidden_size"] * c["num_hidden_layers"]


def head_ops(c: dict, rows: int, out: int) -> float:
    """A dense head of ``out`` units over one vector a row."""
    return 2.0 * rows * c["hidden_size"] * out


def tower_ops(c: dict, rows: int, s: int) -> float:
    """One forward of a retriever tower (encoder, then its projection
    head where it has one) over ``rows`` rows of ``s`` tokens."""
    ops = dense_ops(c, rows * s) + attention_ops(c, rows, s)
    if c.get("projection_dim"):
        ops += head_ops(c, rows, c["projection_dim"])
    return ops


def reranker_ops(c: dict, rows: int, s: int) -> float:
    return dense_ops(c, rows * s) + attention_ops(c, rows, s) + head_ops(
        c, rows, 1)


def cotrain_step_work(cfg: dict, kind: str) -> dict:
    """Operations of one co-training step at the cell's padded shapes:
    {"bf16": flops, "int8": int8 ops}. A reranker step is the reranker's
    forward and backward over the joint rows; a retriever step is the int8
    teacher's forward over them (its dense products int8, its attention
    bf16) and both retriever towers' forward and backward."""
    b = cfg["batch"]
    n, m = b["queries"], 1 + cfg["recipe"]["num_negatives"]
    lq, lc, lj = (cfg["lengths"][k] for k in ("query", "passage", "joint"))
    de, ce = cfg["retriever"], cfg["reranker"]
    if kind == "reranker":
        return {"bf16": 3.0 * reranker_ops(ce, n * m, lj), "int8": 0.0}
    teacher_int8 = dense_ops(ce, n * m * lj)
    teacher_bf16 = attention_ops(ce, n * m, lj) + head_ops(ce, n * m, 1)
    student = tower_ops(de, n, lq) + tower_ops(de, n * m, lc)
    return {"bf16": 3.0 * student + teacher_bf16, "int8": teacher_int8}


def attention_work(c: dict, rows: int, s: int, backward: bool) -> dict:
    """One attention launch over all heads of ``rows`` rows of ``s``
    tokens, one layer: forward reads q, k, v (bf16) and the key mask
    (int32) and writes o; backward reads q, k, v, dO and the mask and
    writes dq, dk, dv. -> {"ops", "bytes"}."""
    h = c["hidden_size"]
    t = rows * s
    per = 2 * t * h                     # one [rows, s, H] bf16 tensor
    mask = 4 * t
    if backward:
        return {"ops": 8.0 * rows * s * s * h, "bytes": 7 * per + mask}
    return {"ops": 4.0 * rows * s * s * h, "bytes": 4 * per + mask}


def int8_linear_work(m: int, n: int, k: int, out_bytes: int) -> dict:
    """K1 over [m, k] int8 rows and an [n, k] int8 weight with f32 row
    and channel scales and bias, writing [m, n] of ``out_bytes`` each."""
    return {"ops": 2.0 * m * n * k,
            "bytes": m * k + n * k + 4 * m + 8 * n + out_bytes * m * n}


def encoder_int8_linear_work(c: dict, tokens: int) -> dict:
    """The four K1 launches of each int8 layer (q, k and v as one; the
    output projection; the FFN's two), all layers, over ``tokens`` tokens:
    q, k, v written in bf16, the others in f32."""
    h, f = c["hidden_size"], c["intermediate_size"]
    parts = [int8_linear_work(tokens, 3 * h, h, 2),
             int8_linear_work(tokens, h, h, 4),
             int8_linear_work(tokens, f, h, 4),
             int8_linear_work(tokens, h, f, 4)]
    layers = c["num_hidden_layers"]
    return {"ops": layers * sum(p["ops"] for p in parts),
            "bytes": layers * sum(p["bytes"] for p in parts),
            "least_s": layers * sum(least_seconds(p["ops"], p["bytes"],
                                                  PEAK_INT8) for p in parts)}


def encode_chunk_work(cfg: dict, rows: int, s: int) -> dict:
    """One encode of ``rows`` passages of ``s`` tokens through the int8
    passage tower: {"int8": dense ops, "bf16": attention and head flops}."""
    c = cfg["retriever"]
    bf16 = attention_ops(c, rows, s)
    if c.get("projection_dim"):
        bf16 += head_ops(c, rows, c["projection_dim"])
    return {"int8": dense_ops(c, rows * s), "bf16": bf16}

