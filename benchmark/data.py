"""Traffic made from a seed: token rows, the mined set of a co-training
window, and the passages of an encode pass.

Token ids are drawn uniformly from ``[first_id, vocab)`` (no pad, CLS or
SEP among them), so every row is a real sequence of its drawn length:
``CLS t_1 .. t_n SEP`` and pads after it. Every draw comes from one
``numpy.random.Generator`` seeded from the run seed, so the same seed
gives the same traffic.
"""

from __future__ import annotations

import numpy as np

from benchmark.weights import mix


def rng(seed: int, tag: int) -> np.random.Generator:
    return np.random.default_rng(mix(seed, tag))


def token_rows(r: np.random.Generator, n: int, width: int, lo: int, hi: int,
               tok: dict) -> np.ndarray:
    """[n, width] int32 rows of CLS, ``L - 2`` drawn ids and SEP, with the
    length L drawn from ``[lo, hi]`` (``hi <= width``), pads after it."""
    lens = r.integers(lo, hi + 1, n)
    ids = r.integers(tok["first_id"], tok["vocab"], (n, width),
                     dtype=np.int32)
    ids[:, 0] = tok["cls_id"]
    ids[np.arange(n), lens - 1] = tok["sep_id"]
    ids[np.arange(width)[None, :] >= lens[:, None]] = tok["pad_id"]
    return ids


def mined_set(seed: int, p: dict, tok: dict, q_width: int, c_width: int
              ) -> dict:
    """A mine's output as the co-training window takes it: a tokenized
    corpus, tokenized queries, each query's top-k passage ids (distinct)
    with descending retriever scores, and 1 to ``max_hits`` answer hits
    among them at random ranks."""
    r = rng(seed, 11)
    n_c, n_q, k = p["corpus_rows"], p["queries"], p["topk"]
    corpus = token_rows(r, n_c, c_width, p["passage_len"][0],
                        p["passage_len"][1], tok)
    queries = token_rows(r, n_q, q_width, p["query_len"][0],
                         p["query_len"][1], tok)
    top = np.stack([r.choice(n_c, k, replace=False) for _ in range(n_q)]
                   ).astype(np.int32)
    gaps = r.exponential(p["score_gap"], (n_q, k))
    scores = (p["score_top"] - np.cumsum(gaps, 1)).astype(np.float32)
    hits = np.zeros((n_q, k), bool)
    n_hits = r.integers(1, p["max_hits"] + 1, n_q)
    for i in range(n_q):
        hits[i, r.choice(k, n_hits[i], replace=False)] = True
    return {"corpus_ids": corpus, "query_ids": queries, "topk_ids": top,
            "topk_scores": scores, "hit_mask": hits}
