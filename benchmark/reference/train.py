"""Plain AR2 co-training: SimANS batches, the two losses, AdamW, and the
first steps of a co-training window, with no code of the program under
test.

- Batches (:class:`Batches`): the SimANS procedure of
  ``SimANS/utils/util_wiki.py:613-658`` on a mined set: queries in a
  permuted order, for each the best-ranked hit as the positive and the
  negatives drawn with weights ``exp(-a (s - s_pos + b)^2)`` (quadratic)
  or ``exp(-tau |s - s_pos|)`` (abs) by repeated weighted draws until
  enough distinct ids are collected, kept in candidate order; the joint
  row is the query's tokens, then the passage's without its CLS and its
  closing SEP. The draws follow one ``numpy.random.Generator`` in the
  order the published procedure makes them, so the same seed gives the
  same batches.
- Losses: the reranker's grouped softmax cross-entropy (positive in
  column 0), and AR2's retriever loss: ``(1 - lambda)`` times the
  cross-entropy of the retriever's softmax against the reranker's, plus
  ``lambda / world`` times the adversarial reward term (``AR2``,
  Zhang et al. 2022, eq. 6-7; ``log(p + 1e-7)`` as the published code).
- AdamW: global-norm clipping, then Adam with bias correction, eps
  outside the root, decoupled weight decay on every parameter but biases
  and LayerNorm, a constant learning rate.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchmark.reference import bert

EPS = 1e-7


# --- batches ----------------------------------------------------------------

class Batches:
    """The SimANS batches of a mined set (see the module docstring)."""

    def __init__(self, mined: dict, recipe: dict, seed: int):
        self.m = mined
        self.r = recipe
        self.rng = np.random.default_rng(seed)
        hits = mined["hit_mask"]
        self.valid = np.nonzero(hits.any(1) & (~hits).any(1))[0]

    def _weights(self, s, s_pos):
        s = np.asarray(s, np.float64)
        if self.r["simans_mode"] == "quadratic":
            return np.exp(-self.r["simans_a"]
                          * (s - s_pos + self.r["simans_b"]) ** 2)
        return np.exp(-np.abs(s - s_pos) * self.r["simans_tau"])

    def _negatives(self, ids: List[int], scores: List[float], s_pos: float,
                   k: int) -> List[int]:
        n = len(ids)
        if n < k:
            return (ids * k)[-k:]
        if s_pos == 0:
            return ids[-k:]
        w = self._weights(scores, s_pos)
        if not np.isfinite(w.sum()) or w.sum() <= 0:
            w = np.ones(n)
        w = w / w.sum()
        chosen: set = set()
        arr = np.asarray(ids)
        left = np.ones(n, bool)
        while len(chosen) < k:
            cand, p = arr[left], w[left]
            if p.sum() <= 0 or not np.isfinite(p.sum()):
                p = np.ones(len(cand))
            draws = self.rng.choice(cand, size=k, replace=True,
                                    p=p / p.sum())
            chosen.update(int(d) for d in draws)
            left = np.array([i not in chosen for i in arr.tolist()], bool)
            if not left.any():
                break
        return [i for i in ids if i in chosen][:k]

    def _joint(self, q_row, rows):
        lj = self.r["max_joint_length"]
        pad, sep = self.r["pad_id"], self.r["sep_id"]
        out = np.full((len(rows), lj), pad, np.int32)
        ql = int((q_row != pad).sum())
        for j, row in enumerate(rows):
            body = [int(t) for t in row[1:] if t != pad]
            if body and body[-1] == sep:
                body = body[:-1]
            seq = [int(t) for t in q_row[:ql]] + body
            seq = seq[:lj]
            out[j, :len(seq)] = seq
        return out

    def epoch(self, batch_size: int):
        """One pass over the queries: a generator of batches."""
        order = self.rng.permutation(len(self.valid))
        k = self.r["num_negatives"]
        m = 1 + k
        mined = self.m
        end = len(order) - len(order) % batch_size
        for s in range(0, end, batch_size):
            idx = self.valid[order[s:s + batch_size]]
            ctx, joint = [], []
            for qi in idx:
                hits = mined["hit_mask"][qi]
                pos_rank = np.nonzero(hits)[0][0]
                neg_ranks = np.nonzero(~hits)[0]
                ids = mined["topk_ids"][qi, neg_ranks].tolist()
                scores = mined["topk_scores"][qi, neg_ranks].tolist()
                perm = self.rng.permutation(len(ids))
                ids = [ids[i] for i in perm]
                scores = [scores[i] for i in perm]
                negs = self._negatives(
                    ids, scores, float(mined["topk_scores"][qi, pos_rank]), k)
                rows = mined["corpus_ids"][
                    [int(mined["topk_ids"][qi, pos_rank])] + negs]
                ctx.append(rows)
                joint.append(self._joint(mined["query_ids"][qi], rows))
            q = mined["query_ids"][idx]
            ctx = np.concatenate(ctx)
            joint = np.stack(joint)
            pad = self.r["pad_id"]
            yield {"q_ids": q, "q_mask": (q != pad).astype(np.int32),
                   "ctx_ids": ctx, "ctx_mask": (ctx != pad).astype(np.int32),
                   "positive_idx": (np.arange(len(idx)) * m).astype(np.int32),
                   "joint_ids": joint,
                   "joint_mask": (joint != pad).astype(np.int32)}


def batch_differences(got: dict, want: dict) -> int:
    """Elements that differ between two batches (a missing or reshaped
    array counts whole)."""
    n = 0
    for key, w in want.items():
        g = got.get(key)
        if g is None or np.shape(g) != np.shape(w):
            n += int(np.size(w))
        else:
            n += int((np.asarray(g) != np.asarray(w)).sum())
    return n


# --- losses -----------------------------------------------------------------

def reranker_loss(logits: torch.Tensor) -> torch.Tensor:
    """[N, M] logits, positive in column 0 -> the mean cross-entropy."""
    return -torch.log_softmax(logits.float(), 1)[:, 0].mean()


def retriever_loss(scores, teacher, adv_lambda: float, world: int,
                   n_total: int):
    """AR2's retriever loss over a block of ``scores`` [n, M] (f32) with
    the teacher's logits [n, M]; sums are divided by the whole batch's
    ``n_total`` queries, so blocks add up to the batch's loss."""
    s = scores.float()
    p_de = torch.softmax(s, 1)
    t = teacher.float()
    log_de = torch.log(p_de + EPS)
    normal = -(torch.softmax(t, 1) * log_de).sum() / n_total
    pair = torch.stack([t[:, :1].expand_as(t), t], -1)
    reward = torch.log(torch.softmax(pair, -1)[..., 0] + EPS)
    adv = (reward * log_de).sum()
    if adv_lambda != 0.0:
        return adv_lambda * adv / world + (1.0 - adv_lambda) * normal
    return normal


# --- AdamW ------------------------------------------------------------------

def decays(name: str) -> bool:
    return not (name.endswith(".bias") or "layer_norm" in name)


class AdamW:
    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 weight_decay: float, max_grad_norm: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.p = params
        self.lr, self.wd, self.clip = lr, weight_decay, max_grad_norm
        self.b1, self.b2, self.eps = b1, b2, eps
        self.m = {n: torch.zeros_like(v) for n, v in params.items()}
        self.v = {n: torch.zeros_like(v) for n, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """One update; -> the norm of each leaf's clipped gradient."""
        total = torch.sqrt(sum((g.float() ** 2).sum() for g in grads.values()))
        scale = (self.clip / total) if total >= self.clip else 1.0
        self.t += 1
        norms = {}
        for n, p in self.p.items():
            g = grads[n].float() * scale
            norms[n] = float(g.norm())
            self.m[n].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[n].mul_(self.b2).add_(g * g, alpha=1 - self.b2)
            mh = self.m[n] / (1 - self.b1 ** self.t)
            vh = self.v[n] / (1 - self.b2 ** self.t)
            upd = mh / (vh.sqrt() + self.eps)
            if decays(n):
                upd = upd + self.wd * p
            p.sub_(self.lr * upd)
        return norms


# --- the first steps ----------------------------------------------------------

def _leaves(w: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {n: t.detach().clone().requires_grad_(True) for n, t in w.items()}


def _backward_blocks(loss_of_block, n: int, block: int,
                     params: Dict[str, torch.Tensor]):
    """Sum of the blocks' losses, the gradients accumulated block by
    block (a block of queries at a time, so the step fits)."""
    for p in params.values():
        p.grad = None
    total = 0.0
    for s in range(0, n, block):
        loss = loss_of_block(slice(s, min(s + block, n)))
        loss.backward()
        total += float(loss.detach())
    return total, {k: p.grad for k, p in params.items()}


def first_steps(batches: List[dict], kinds: List[str], de_w, ce_w,
                cfg: dict, device, prec: str = "bf16",
                block: int = 8) -> dict:
    """The reference's co-training steps on ``batches``, ``kinds[i]`` the
    model step ``i`` trains ("reranker" or "retriever"); the teacher of a
    retriever step is the int8 encoder over the reranker's current
    weights. -> {"loss": [per step], "grad": {model: {leaf: norm}} of each
    model's first gradient as the optimizer takes it, "de", "ce": the
    weights after the steps}."""
    de_cfg, ce_cfg, recipe = cfg["retriever"], cfg["reranker"], cfg["recipe"]
    de, ce = _leaves(de_w), _leaves(ce_w)
    opt = {"retriever": AdamW(de, recipe["retriever_lr"],
                              recipe["weight_decay"], recipe["max_grad_norm"]),
           "reranker": AdamW(ce, recipe["reranker_lr"],
                             recipe["weight_decay"], recipe["max_grad_norm"])}
    remat = cfg.get("remat", False)
    out = {"loss": [], "grad": {}}

    def t(x):
        return torch.as_tensor(np.asarray(x), device=device).long()

    for b, kind in zip(batches, kinds):
        n, m, lj = b["joint_ids"].shape
        jid = t(b["joint_ids"]).reshape(n * m, lj)
        jmask = t(b["joint_mask"]).reshape(n * m, lj)
        if kind == "reranker":
            def block_loss(sl):
                rows = slice(sl.start * m, sl.stop * m)
                lg = bert.cross_logits(ce, jid[rows], jmask[rows], ce_cfg,
                                       prec, remat).reshape(-1, m)
                return reranker_loss(lg) * (sl.stop - sl.start) / n
            loss, grads = _backward_blocks(block_loss, n, block, ce)
        else:
            with torch.no_grad():
                teacher = torch.cat([
                    bert.int8_cross_logits(
                        ce, jid[s * m:(s + block) * m],
                        jmask[s * m:(s + block) * m], ce_cfg)
                    for s in range(0, n, block)]).reshape(n, m)
            q_ids, q_mask = t(b["q_ids"]), t(b["q_mask"])
            c_ids, c_mask = t(b["ctx_ids"]), t(b["ctx_mask"])

            def block_loss(sl):
                rows = slice(sl.start * m, sl.stop * m)
                q = bert.tower(de, "question_model.", q_ids[sl], q_mask[sl],
                               de_cfg, prec, remat)
                c = bert.tower(de, "ctx_model.", c_ids[rows], c_mask[rows],
                               de_cfg, prec, remat)
                sc = torch.einsum("bh,bmh->bm", q.float(),
                                  c.float().reshape(q.shape[0], m, -1))
                return retriever_loss(sc, teacher[sl], recipe["adv_lambda"],
                                      recipe["adv_world_size"], n)
            loss, grads = _backward_blocks(block_loss, n, block, de)
        out["loss"].append(loss)
        norms = opt[kind].step(grads)
        out["grad"].setdefault(kind, norms)
        for p in (de if kind == "retriever" else ce).values():
            p.grad = None
    out["de"] = {k: v.detach() for k, v in de.items()}
    out["ce"] = {k: v.detach() for k, v in ce.items()}
    return out
