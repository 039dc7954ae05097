"""Tiny versions of the benchmark's cells for the CPU tests: every width
cut to a few dozen, the same files, drivers and reference otherwise."""

import copy

import torch

from benchmark import harness


def config(name: str, traffic: str = "cotrain") -> dict:
    """The configuration at a test's size: the co-training cells at tiny
    widths; the encode cell at the published widths with 32-token
    passages (its check separates the program from the control only at
    the real widths)."""
    cfg = copy.deepcopy(harness.load_json(
        harness.HERE / "configs" / f"{name}.json"))
    if traffic != "cotrain":
        cfg["lengths"] = dict(cfg["lengths"], passage=32)
        return cfg
    for part in ("retriever", "reranker"):
        cfg[part].update(vocab_size=2000, hidden_size=64, num_hidden_layers=2,
                         num_attention_heads=4, intermediate_size=128,
                         max_position_embeddings=64)
        if cfg[part].get("projection_dim"):
            cfg[part]["projection_dim"] = 64
    cfg["lengths"] = {"query": 8, "passage": 24, "joint": 32}
    cfg["tokens"].update(vocab=2000, first_id=200)
    cfg["batch"]["queries"] = 4
    return cfg


def params(cell: str) -> dict:
    p = copy.deepcopy(harness.load_json(
        harness.HERE / "workloads" / f"{cell}.json"))
    if p["traffic"] == "cotrain":
        p["mined"].update(corpus_rows=512, queries=64, passage_len=[10, 24],
                          query_len=[3, 8])
        p["check"]["block_queries"] = 2
    else:
        p.update(shard_rows=128, chunk_rows=64, block_rows=64,
                 passage_len=[12, 32])
        p["check"]["rows"] = 32
    return p


def cell(name: str, seed: int = 2 ** 31 + 12345, faults=(), trace=False):
    entry = next(w for w in harness.manifest()["workloads"]
                 if w["name"] == name)
    return harness.make_cell(name, seed, torch.device("cpu"), trace=trace,
                             faults=faults, params=params(name),
                             config=config(entry["config"], entry["traffic"]))


def run(name: str, seed: int = 2 ** 31 + 12345, faults=(), trace=False,
        seconds: float = 0.5) -> dict:
    import time

    c = cell(name, seed, faults, trace)
    return harness.run_cell(c, seconds, time.perf_counter())
