"""The mine -> train feedback path on token arrays (own copy of
``simxns_tpu/data/mined.py``).

:class:`MinedDataset` holds the tokenized corpus and queries and a mining
result (``topk_ids``/``topk_scores`` [Q, K] and the hit mask); batches are
assembled by array indexing. SimANS sampling runs on the mined scores, and
the joint (cross-encoder) rows splice the query tokens before the
passage's content without its CLS and trailing SEP (the ``pack_joint``
contract, ``util_wiki.py:648-658``). Batches are dicts of numpy arrays,
the input of the port's training steps.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from simxns_tpu_torch.data.sampling import sample_hard_negatives


@dataclasses.dataclass
class MinedDataset:
    corpus_ids: np.ndarray          # [N, Lc] int32, CLS...SEP padded
    query_ids: np.ndarray           # [Q, Lq] int32
    topk_ids: np.ndarray            # [Q, K] int32 mined passage ids
    topk_scores: np.ndarray         # [Q, K] f32 retriever scores
    hit_mask: np.ndarray            # [Q, K] bool — answer-bearing (positive)
    pad_id: int = 0
    sep_id: int = 2
    num_negatives: int = 15
    max_joint_length: int = 160
    simans_mode: Optional[str] = "quadratic"
    simans_a: float = 0.5
    simans_b: float = 0.0
    simans_tau: float = 3.0
    seed: int = 0

    def __post_init__(self):
        self.rng = np.random.default_rng(self.seed)
        # usable queries: at least one hit and one non-hit in top-k
        has_pos = self.hit_mask.any(axis=1)
        has_neg = (~self.hit_mask).any(axis=1)
        self.valid = np.nonzero(has_pos & has_neg)[0]

    def __len__(self) -> int:
        return len(self.valid)

    def _sample_one(self, qi: int):
        hits = self.hit_mask[qi]
        pos_ranks = np.nonzero(hits)[0]
        pos_rank = pos_ranks[0]                       # best-ranked hit
        pos_id = int(self.topk_ids[qi, pos_rank])
        pos_score = float(self.topk_scores[qi, pos_rank])
        neg_ranks = np.nonzero(~hits)[0]
        neg_ids = self.topk_ids[qi, neg_ranks].tolist()
        neg_scores = self.topk_scores[qi, neg_ranks].tolist()
        if self.simans_mode is not None:
            perm = self.rng.permutation(len(neg_ids))
            neg_ids = [neg_ids[i] for i in perm]
            neg_scores = [neg_scores[i] for i in perm]
            chosen = sample_hard_negatives(
                neg_ids, neg_scores, pos_score, self.num_negatives, self.rng,
                mode=self.simans_mode, a=self.simans_a, b=self.simans_b,
                tau=self.simans_tau)
        else:
            perm = self.rng.permutation(len(neg_ids))[: self.num_negatives]
            chosen = [neg_ids[i] for i in perm]
            if len(chosen) < self.num_negatives:
                chosen = (chosen * self.num_negatives)[: self.num_negatives]
        return pos_id, chosen

    def _joint(self, q_row: np.ndarray, ctx_rows: np.ndarray) -> np.ndarray:
        """[M, Lj] joint inputs: query tokens ++ ctx CONTENT (drop the ctx
        CLS and trailing SEP — pack_joint / util_wiki.py:648-658)."""
        lj = self.max_joint_length
        q_len = int((q_row != self.pad_id).sum())
        m, lc = ctx_rows.shape
        out = np.full((m, lj), self.pad_id, np.int32)
        out[:, :q_len] = q_row[:q_len]
        body = ctx_rows[:, 1:].copy()
        lens = (body != self.pad_id).sum(1)
        rows_i = np.arange(m)
        last = np.clip(lens - 1, 0, body.shape[1] - 1)
        is_sep = (lens > 0) & (body[rows_i, last] == self.sep_id)
        body[rows_i[is_sep], last[is_sep]] = self.pad_id
        take = min(lj - q_len, body.shape[1])
        out[:, q_len: q_len + take] = body[:, :take]
        return out

    def batches(self, batch_size: int, shuffle: bool = True,
                with_joint: bool = True) -> Iterator[Dict[str, np.ndarray]]:
        order = (self.rng.permutation(len(self.valid)) if shuffle
                 else np.arange(len(self.valid)))
        m = 1 + self.num_negatives
        lc = self.corpus_ids.shape[1]
        end = len(order) - len(order) % batch_size
        for s in range(0, end, batch_size):
            idx = self.valid[order[s: s + batch_size]]
            n = len(idx)
            ctx_ids = np.zeros((n * m, lc), np.int32)
            joint = (np.zeros((n, m, self.max_joint_length), np.int32)
                     if with_joint else None)
            for bi, qi in enumerate(idx):
                pos_id, negs = self._sample_one(int(qi))
                rows = self.corpus_ids[[pos_id] + [int(x) for x in negs]]
                ctx_ids[bi * m: (bi + 1) * m] = rows
                if with_joint:
                    joint[bi] = self._joint(self.query_ids[qi], rows)
            q = self.query_ids[idx]
            batch = {
                "q_ids": q, "q_mask": (q != self.pad_id).astype(np.int32),
                "ctx_ids": ctx_ids,
                "ctx_mask": (ctx_ids != self.pad_id).astype(np.int32),
                "positive_idx": (np.arange(n) * m).astype(np.int32),
            }
            if with_joint:
                batch["joint_ids"] = joint
                batch["joint_mask"] = (joint != self.pad_id).astype(np.int32)
            yield batch


def from_mining_result(corpus_ids: np.ndarray, query_ids: np.ndarray,
                       result, **kw) -> MinedDataset:
    """Build from a :class:`simxns_tpu_torch.index.engine.MiningResult`."""
    return MinedDataset(
        corpus_ids=corpus_ids, query_ids=query_ids,
        topk_ids=np.asarray(result.topk_ids),
        topk_scores=np.asarray(result.topk_scores),
        hit_mask=np.asarray(result.hits, dtype=bool), **kw)
