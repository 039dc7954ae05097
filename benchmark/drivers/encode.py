"""Traffic kind ``encode``: the mine's and indexing's corpus pass.

Set-up makes the retriever's weights and one shard of pre-tokenized
passages from the seed, and builds what the launcher's ``--fast-encode
--int8-index`` mine builds: the ``fused_int8`` ``int8_view`` of the dual
encoder and an int8 ``MIPSIndex`` in ``fused`` mode, filled by
``build_streaming`` (token ids on the wire as uint16, the encode, the
row quantization and the writes all on the device). It warms the chunk
shape with a two-chunk build. The window builds the shard again and
again and ends with the first build to finish after ``--seconds``;
each build ends in the index's own synchronisation.

The check, once the window has closed: a sample of the last build's
index rows drawn from the seed (codes and scales), against the plain
int8 encoder of the reference over the same passages, quantized the same
way. Compared: ``embedding``, the worst sampled row's
``|program - reference| / |reference|`` of the dequantized rows.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark import data, weights, work
from benchmark.build import initial_weights, models


def _half_rows(fn):
    """A planted fault: the second half of every chunk is not encoded."""
    def encode(ids, mask):
        h = ids.shape[0] // 2
        emb = fn(ids[:h], mask[:h])
        return torch.cat([emb, torch.zeros_like(emb)])[:ids.shape[0]]
    return encode


def _alter_answer(fn):
    """A planted fault: each row of a chunk gets its neighbour's
    embedding where the encode produces it."""
    def encode(ids, mask):
        return torch.roll(fn(ids, mask), 1, dims=0)
    return encode


def setup(cell):
    from simxns_tpu_torch.index.engine import MIPSIndex
    from simxns_tpu_torch.models import dual_encoder

    cfg, p, dev = cell.config, cell.params, cell.device
    tok, width = cfg["tokens"], cfg["lengths"]["passage"]
    tokens = data.token_rows(data.rng(cell.seed, 21), p["shard_rows"], width,
                             p["passage_len"][0], p["passage_len"][1], tok)
    de, _ = models(cfg, dev, reranker=False)
    cell.say("program imported, model built")
    w = initial_weights(cfg, cell.seed, dev, "retriever")
    weights.load_into(de, w)
    del w
    view = dual_encoder.int8_view(de)
    encode = view.encode_passage
    if "half_batch" in cell.faults:
        encode = _half_rows(encode)
    if "alter_answer" in cell.faults:
        encode = _alter_answer(encode)
    index = MIPSIndex(dev, block_size=p["block_rows"],
                      store_dtype=torch.int8, mode="fused")
    wire = np.uint16 if tok["vocab"] <= 0xFFFF else np.int32

    def build(rows):
        index.build_streaming(encode, rows, chunk_size=p["chunk_rows"],
                              pad_id=tok["pad_id"], wire_dtype=wire)

    cell.say("weights, traffic and index built")
    build(tokens[:2 * p["chunk_rows"]])
    cell.say("two chunks encoded")
    return {"de": de, "index": index, "build": build, "tokens": tokens}


def window(cell, state, seconds: float) -> dict:
    p = cell.params
    tokens, build = state["tokens"], state["build"]
    builds = 0
    t0 = time.perf_counter()
    while True:
        build(tokens)
        builds += 1
        if time.perf_counter() - t0 >= seconds:
            break
    wall = time.perf_counter() - t0
    rows = builds * tokens.shape[0]
    chunk = p["chunk_rows"]
    width = cell.config["lengths"]["passage"]
    per_chunk = work.encode_chunk_work(cell.config, chunk, width)
    chunks = rows / chunk
    return {"window_s": wall, "attempted": rows, "failed": 0,
            "e2e": {"encode_passages_per_s": rows / wall},
            "work": {"ops": {k: v * chunks for k, v in per_chunk.items()},
                     "tokens": rows * width, "chunk_tokens": chunk * width}}


def sample_rows(cell) -> np.ndarray:
    p = cell.params
    return np.sort(data.rng(cell.seed, 22).choice(
        p["shard_rows"], p["check"]["rows"], replace=False))


def reference_rows(cell, tokens: np.ndarray, levels: int = 127
                   ) -> torch.Tensor:
    """The reference's dequantized index rows of ``tokens``: the plain
    int8 (``levels=7``: int4) passage tower, then per-row int8 codes."""
    from benchmark.reference import bert

    cfg, dev = cell.config, cell.device
    bert.set_precision()
    w = initial_weights(cfg, cell.seed, dev, "retriever")
    ids = torch.as_tensor(tokens, device=dev).long()
    mask = (ids != cfg["tokens"]["pad_id"]).long()
    out = []
    for s in range(0, ids.shape[0], 256):
        emb = bert.int8_tower(w, "ctx_model.", ids[s:s + 256],
                              mask[s:s + 256], cfg["retriever"], levels)
        q, sc = bert.quant_rows(emb.float())
        out.append(q * sc[:, None])
    return torch.cat(out)


def worst_row_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    gap = (got.float() - want.float()).norm(dim=1)
    return float((gap / want.float().norm(dim=1).clamp_min(1e-30)).max())


def check(cell, state) -> list:
    rows = sample_rows(cell)
    idx = torch.as_tensor(rows, device=state["index"].embeddings.device)
    index = state["index"]
    got = (index.embeddings[idx].float()
           * index.row_scales[idx][:, None]).cpu()
    tokens = state["tokens"][rows]
    state.clear()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    want = reference_rows(cell, tokens).cpu()
    state.update(tokens=tokens, want=want, got=got)
    return [{"name": "embedding", "value": worst_row_gap(got, want),
             "limit": cell.params["limits"]["embedding"]}]


def details(state: dict) -> dict:
    """What lies under the compared number (for the calibration): the
    median and 90th-percentile row gaps, and the share of int8 codes that
    differ from the reference's."""
    got, want = state["got"], state["want"]
    gap = (got - want).norm(dim=1) / want.norm(dim=1).clamp_min(1e-30)
    codes_differ = float((torch.round(got / got.abs().amax(1, keepdim=True)
                                      * 127)
                          != torch.round(want / want.abs().amax(1, keepdim=True)
                                         * 127)).float().mean())
    return {"median_row": float(gap.median()),
            "p90_row": float(gap.quantile(0.9)), "worst_row": float(gap.max()),
            "codes_differ": codes_differ}


def control(cell, state) -> dict:
    """The control's number: the reference's int4 encoder in the
    program's place, against the int8 reference (after :func:`check`)."""
    return {"embedding": worst_row_gap(
        reference_rows(cell, state["tokens"], levels=7).cpu(), state["want"])}
