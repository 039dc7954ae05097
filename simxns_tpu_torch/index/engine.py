"""Encode -> index -> search (port of ``simxns_tpu/index/engine.py``).

- :class:`CorpusEncoder` — chunked corpus encode with a bounded window of
  chunks in flight (the host runs ahead of the card by at most ``inflight``
  chunks; each result copy to the host is bounded by the stall watchdog).
- :class:`MIPSIndex` — a device-resident embedding matrix (bf16/f32, or
  int8 codes with per-row f32 scales, the FAISS-SQ8 analog) and its top-k
  search in ``exact``, ``approx`` or ``fused`` mode; a corpus larger than
  ``max_resident_rows`` is searched in build -> search -> free passes
  with a host merge.
- :class:`RetrievalEngine` — the mine: search, hit labeling
  (``has_answer`` over passage text, or gold ``positive_ids``), metrics
  and the SimANS train records (:func:`reform_out`).

Data parallelism (``mesh``, a :class:`~simxns_tpu_torch.parallel.mesh.Mesh`
with a group of W ranks, one per GPU; on a multislice or tensor-parallel
mesh, W is the data axis of one slice, and the index is replicated across
slices and model ranks): the encoder splits each chunk over
the ranks and all-gathers the embeddings in row order; the index holds W
row shards (rank r the global rows ``[r * shard_rows, (r + 1) *
shard_rows)``, the corpus padded as the JAX index pads it over its mesh)
and a search merges the ranks' top-k lists, so every rank gets the same
results (and the mine the same records). Buffers are updated in place
where the JAX package donates them (``update_rows``, ``build_streaming``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import sys
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from simxns_tpu_torch.evals.metrics import get_metrics, top_k_hits_accuracy
from simxns_tpu_torch.evals.qa_match import has_answer
from simxns_tpu_torch.ops.fused_ffn import quant_rows
from simxns_tpu_torch.ops.topk import blocked_mips_topk, merge_topk
from simxns_tpu_torch.parallel.collectives import all_gather_rows
from simxns_tpu_torch.parallel.mesh import Mesh, mesh_device, pad_to_multiple
from simxns_tpu_torch.parallel.sync import force_sync
from simxns_tpu_torch.parallel.watchdog import run_with_deadline


class CorpusEncoder:
    """Encode a tokenized corpus into embeddings with ``encode_fn``.

    ``encode_fn(ids, mask) -> [B, H]`` takes device tensors, typically
    ``BiEncoder.encode_passage``. Replaces the reference's per-rank encode
    and disk merge (``co_training_generate_new_train_wiki.py:239-280``).
    Under a group each rank encodes its contiguous part of every chunk
    (the chunk padded to a multiple of W rows) and the parts are
    all-gathered in row order: every rank returns the whole corpus's
    embeddings.
    """

    def __init__(self, encode_fn: Callable, device=None, chunk_size: int = 4096,
                 inflight: int = 4, stall_timeout_s: Optional[float] = None,
                 stall_retries: int = 2, mesh: Optional[Mesh] = None):
        self.encode_fn = encode_fn
        self.mesh = None if mesh is None else mesh.within_slice
        self.device = mesh_device(mesh, device)
        self.chunk_size = chunk_size
        self.inflight = inflight
        self.stall_timeout_s = stall_timeout_s
        self.stall_retries = stall_retries

    def __call__(self, token_ids: np.ndarray, attention_mask: np.ndarray,
                 out_dtype=np.float32) -> np.ndarray:
        n = token_ids.shape[0]
        pending: deque = deque()
        done = []

        def drain_one():
            emb, valid = pending.popleft()
            done.append(run_with_deadline(
                lambda: emb[:valid].float().cpu().numpy().astype(
                    out_dtype, copy=False),
                self.stall_timeout_s,
                desc=f"corpus encode pull ({n} rows)",
                retries=self.stall_retries))

        with torch.inference_mode():
            for s in range(0, n, self.chunk_size):
                ids = token_ids[s: s + self.chunk_size]
                mask = attention_mask[s: s + self.chunk_size]
                valid = ids.shape[0]
                if self.mesh is not None and self.mesh.distributed:
                    ids, mask = self._rank_rows(ids), self._rank_rows(mask)
                emb = self.encode_fn(
                    torch.from_numpy(np.ascontiguousarray(ids)).to(
                        self.device),
                    torch.from_numpy(np.ascontiguousarray(mask)).to(
                        self.device))
                pending.append((all_gather_rows(emb, self.mesh), valid))
                if len(pending) > self.inflight:
                    drain_one()
            while pending:
                drain_one()
        if not done:
            return np.zeros((0, 0), out_dtype)
        return np.concatenate(done, axis=0)

    def _rank_rows(self, x: np.ndarray) -> np.ndarray:
        """This rank's rows of a chunk padded (zeros) to a multiple of W."""
        w, r = self.mesh.world_size, self.mesh.rank
        per = -(-x.shape[0] // w)
        x = np.pad(x, ((0, per * w - x.shape[0]), (0, 0)))
        return x[r * per:(r + 1) * per]


class MIPSIndex:
    """Device-resident exact/fused MIPS index, row-sharded over a group.

    ``store_dtype=torch.int8`` keeps per-row symmetric codes + f32 scales
    (half the bytes of bf16; the fused search then runs int8 x int8 on the
    tensor cores). Rows are padded to a ``block_size`` multiple; padding
    rows are masked in every search.

    ``max_resident_rows``: the rows the device holds per search pass. A
    streaming-built corpus larger than that is not built at once: the
    token source is kept and :meth:`search` runs build -> search -> free
    per pass, merging the per-pass top-k on the host.

    ``mesh`` with a group of W ranks: ``n_shards = W``; the corpus is padded
    to a multiple of ``W * block_size`` rows (``build_streaming``: of
    ``lcm(chunk_size, W * block_size)``) and rank r holds the rows
    ``[r * shard_rows, (r + 1) * shard_rows)``. Every rank calls every
    method with the same arguments (the whole corpus, the same queries);
    a search runs on each shard with its id offset and live rows, then the
    ``[W, Q, k]`` lists are all-gathered and merged: equal scores come back
    in global-id order (shard order, then within-shard order), as
    ``jax.lax.top_k`` over the gathered lists.
    """

    def __init__(self, device=None, block_size: int = 4096,
                 store_dtype: torch.dtype = torch.bfloat16,
                 mode: str = "exact", stall_timeout_s: Optional[float] = None,
                 stall_retries: int = 2, sync_rows: int = 262144,
                 max_resident_rows: Optional[int] = None,
                 mesh: Optional[Mesh] = None):
        if mode not in ("exact", "approx", "fused"):
            raise ValueError(f"unknown search mode {mode!r}")
        # rows split over the data axis of a slice: replicated across
        # slices and model ranks (JAX: ``mesh.shape["data"]`` shards)
        self.mesh = (mesh.within_slice if mesh is not None
                     and mesh.distributed else None)
        self.device = mesh_device(mesh, device)
        self.block_size = block_size
        self.store_dtype = store_dtype
        self.quantized = store_dtype == torch.int8
        self.mode = mode
        self.stall_timeout_s = stall_timeout_s
        self.stall_retries = stall_retries
        self.sync_rows = sync_rows
        self.max_resident_rows = max_resident_rows
        self.embeddings: Optional[torch.Tensor] = None
        self.row_scales: Optional[torch.Tensor] = None
        self.num_rows = 0
        self.shard_rows = 0
        self._pass_src: Optional[dict] = None

    @property
    def n_shards(self) -> int:
        return 1 if self.mesh is None else self.mesh.world_size

    @property
    def shard_start(self) -> int:
        """The global row of this rank's first row."""
        return 0 if self.mesh is None else self.mesh.rank * self.shard_rows

    @property
    def shard_valid(self) -> int:
        """This rank's live rows (0 on a shard wholly past the corpus)."""
        if self.mesh is None:
            return self.num_rows
        return min(max(self.num_rows - self.shard_start, 0), self.shard_rows)

    @staticmethod
    def _quantize(embeddings: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Per-row symmetric int8 on the host: -> (codes i8, scales f32)."""
        x = embeddings.astype(np.float32, copy=False)
        s = np.maximum(np.abs(x).max(axis=1) / 127.0, 1e-12)
        codes = np.clip(np.rint(x / s[:, None]), -127, 127).astype(np.int8)
        return codes, s.astype(np.float32)

    def build(self, embeddings: np.ndarray) -> None:
        """Copy [N, H] host embeddings to the device (int8: quantized on the
        host first), padded to a ``n_shards * block_size`` multiple; each
        rank copies its shard."""
        n = embeddings.shape[0]
        self.num_rows = n
        self._pass_src = None
        padded = pad_to_multiple(n, self.n_shards * self.block_size)
        self.shard_rows = padded // self.n_shards
        embeddings = embeddings[self.shard_start:
                                self.shard_start + self.shard_rows]
        if embeddings.shape[0] != self.shard_rows:
            embeddings = np.pad(embeddings, (
                (0, self.shard_rows - embeddings.shape[0]), (0, 0)))
        if self.quantized:
            codes, scales = self._quantize(embeddings)
            self.embeddings = torch.from_numpy(codes).to(self.device)
            self.row_scales = torch.from_numpy(scales).to(self.device)
        else:
            self.embeddings = torch.from_numpy(
                np.ascontiguousarray(embeddings, dtype=np.float32)
            ).to(self.device).to(self.store_dtype)
            self.row_scales = None

    def build_streaming(self, encode_fn: Callable, token_ids: np.ndarray,
                        chunk_size: int = 1024, pad_id: int = 0,
                        wire_dtype=None) -> None:
        """Build the index without the embeddings visiting the host.

        Token ids go to the device in ``wire_dtype`` (uint16 fits BERT's
        30522 vocabulary), the mask is derived there (``ids != pad_id``),
        the embeddings are quantized there (the math of :meth:`update_rows`)
        and written in place into the preallocated index. A corpus larger
        than ``max_resident_rows`` is only recorded here (see
        :meth:`_search_passes`). Each rank encodes only the passages of its
        own shard.
        """
        n, _ = token_ids.shape
        self.num_rows = n
        if self.max_resident_rows is not None and n > self.max_resident_rows:
            self._pass_src = dict(encode_fn=encode_fn, token_ids=token_ids,
                                  chunk_size=chunk_size, pad_id=pad_id,
                                  wire_dtype=wire_dtype)
            self.embeddings = None
            self.row_scales = None
            return
        self._pass_src = None
        if wire_dtype is None:
            wire_dtype = token_ids.dtype
        wire_max = (np.iinfo(wire_dtype).max
                    if np.dtype(wire_dtype) != token_ids.dtype else None)
        padded = pad_to_multiple(
            n, math.lcm(chunk_size, self.n_shards * self.block_size))
        self.shard_rows = padded // self.n_shards
        start, live = self.shard_start, self.shard_valid
        self.embeddings = None
        self.row_scales = None
        beat, synced = time.monotonic(), 0
        with torch.inference_mode():
            for s in range(0, live, chunk_size):
                if time.monotonic() - beat >= 60.0:
                    print(f"[build_streaming] {s}/{live} rows of the shard "
                          "dispatched", file=sys.stderr, flush=True)
                    beat = time.monotonic()
                ids = token_ids[start + s: start + min(s + chunk_size, live)]
                if wire_max is not None and ids.max(initial=0) > wire_max:
                    raise ValueError(
                        f"token id {ids.max()} overflows wire dtype "
                        f"{np.dtype(wire_dtype).name} (rows {s}:{s + len(ids)})")
                wire = torch.from_numpy(np.ascontiguousarray(
                    ids.astype(wire_dtype, copy=False))).to(self.device)
                ids_t = wire.to(torch.int64)
                mask = (ids_t != pad_id).to(torch.int32)
                emb = encode_fn(ids_t, mask).float()
                # all-pad rows can pool to NaN; keep them out of the index
                emb = torch.where((mask.sum(dim=1) > 0)[:, None], emb,
                                  torch.zeros_like(emb))
                if self.embeddings is None:
                    self._alloc(self.shard_rows, emb.shape[1])
                rows = slice(s, s + emb.shape[0])
                if self.quantized:
                    self.embeddings[rows], self.row_scales[rows] = \
                        quant_rows(emb)
                else:
                    self.embeddings[rows] = emb.to(self.store_dtype)
                if (self.stall_timeout_s is not None
                        and s + chunk_size - synced >= self.sync_rows):
                    self._bounded_sync(f"build_streaming rows {s}/{live}")
                    synced = s + chunk_size
        width = 0 if self.embeddings is None else self.embeddings.shape[1]
        if self.mesh is not None:
            # a shard wholly past the corpus encoded nothing: take the
            # width of the others
            width = int(all_gather_rows(torch.tensor(
                [width], device=self.device), self.mesh).max())
        if self.embeddings is None:
            self._alloc(self.shard_rows, width)
        self._bounded_sync(f"build_streaming rows {live}/{live}")

    def _alloc(self, rows: int, width: int) -> None:
        self.embeddings = torch.zeros(rows, width, dtype=self.store_dtype,
                                      device=self.device)
        self.row_scales = (torch.ones(rows, dtype=torch.float32,
                                      device=self.device)
                           if self.quantized else None)

    def _bounded_sync(self, desc: str) -> None:
        run_with_deadline(lambda: force_sync(self.device),
                          self.stall_timeout_s, desc=desc,
                          retries=self.stall_retries)

    def free(self) -> None:
        """Release the device-resident rows (the next build restores them)."""
        self.embeddings = None
        self.row_scales = None

    def update_rows(self, start: int, embeddings: np.ndarray) -> None:
        """Overwrite the global rows ``[start, start + n)`` in place; int8
        rows are quantized on the device (the math of :meth:`_quantize`).
        Each rank writes the part that falls in its shard (a write may
        cross a shard boundary)."""
        n = embeddings.shape[0]
        if self._pass_src is not None:
            raise RuntimeError(
                "update_rows is not available on a multi-pass index (rows "
                "are encoded from tokens each search pass)")
        if self.embeddings is None:
            raise RuntimeError("index not built")
        if start < 0 or start + n > self.num_rows:
            raise ValueError(
                f"update_rows([{start}:{start + n}]) outside the live row "
                f"range [0:{self.num_rows}] (padding rows are not "
                "addressable)")
        lo = max(start, self.shard_start)
        hi = min(start + n, self.shard_start + self.shard_rows)
        if lo >= hi:
            return
        rows = torch.from_numpy(np.asarray(
            embeddings[lo - start:hi - start], np.float32)).to(self.device)
        local = slice(lo - self.shard_start, hi - self.shard_start)
        if self.quantized:
            self.embeddings[local], self.row_scales[local] = quant_rows(rows)
        else:
            self.embeddings[local] = rows.to(self.store_dtype)

    def query_dtype(self) -> torch.dtype:
        """Queries are cast to bf16 for an int8 index, else to its dtype."""
        return torch.bfloat16 if self.quantized else self.store_dtype

    def search_tensor(self, queries: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-k of device queries [Q, H] (already in :meth:`query_dtype`)
        -> (scores [Q, k] f32, ids [Q, k] int32) on the device; under a
        group the merge of every shard's list, the same on every rank."""
        if self.embeddings is None:
            raise RuntimeError("index not built")
        scores, ids = blocked_mips_topk(
            queries, self.embeddings, k, block_size=self.block_size,
            id_offset=self.shard_start, valid_n=self.shard_valid,
            mode=self.mode,
            row_scales=self.row_scales if self.quantized else None)
        if self.mesh is None:
            return scores, ids
        w = self.n_shards
        g_scores = all_gather_rows(scores, self.mesh)
        g_ids = all_gather_rows(ids, self.mesh)
        return merge_topk(g_scores.reshape(w, *scores.shape),
                          g_ids.reshape(w, *ids.shape), k)

    def search(self, queries: np.ndarray, k: int, query_batch: int = 1024
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k over the corpus: [Q, H] -> (scores [Q, k], ids [Q, k])."""
        if self._pass_src is not None:
            return self._search_passes(queries, k, query_batch)
        if self.embeddings is None:
            raise RuntimeError("index not built")
        q = np.asarray(queries, np.float32)
        qb = min(query_batch, pad_to_multiple(max(q.shape[0], 1), 8))
        pending = []
        with torch.inference_mode():
            for s in range(0, q.shape[0], qb):
                chunk = torch.from_numpy(np.ascontiguousarray(
                    q[s: s + qb])).to(self.device).to(self.query_dtype())
                pending.append(self.search_tensor(chunk, k))

            def pull(t):
                return run_with_deadline(
                    lambda: t.cpu().numpy(), self.stall_timeout_s,
                    desc=f"search result pull ({q.shape[0]} queries, k={k})",
                    retries=self.stall_retries)

            scores = [pull(sc) for sc, _ in pending]
            ids = [pull(i) for _, i in pending]
        if not pending:
            return (np.zeros((0, k), np.float32), np.zeros((0, k), np.int32))
        return np.concatenate(scores), np.concatenate(ids)

    def _search_passes(self, queries: np.ndarray, k: int, query_batch: int
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """Search a corpus larger than ``max_resident_rows`` in passes.

        Per pass: streaming-build the slice (encoded from its tokens; under
        a group each rank its shard of the slice), search every query
        against it, free it, and merge the per-pass top-k on the host with
        a stable sort. Exact by construction: each pass's top-k is exact
        over its rows.
        """
        src = self._pass_src
        n = src["token_ids"].shape[0]
        per = max(self.max_resident_rows
                  - self.max_resident_rows % src["chunk_size"],
                  src["chunk_size"])
        all_scores, all_ids = [], []
        try:
            for start in range(0, n, per):
                stop = min(start + per, n)
                self._pass_src = None
                self.build_streaming(
                    src["encode_fn"], src["token_ids"][start:stop],
                    chunk_size=src["chunk_size"], pad_id=src["pad_id"],
                    wire_dtype=src["wire_dtype"])
                sc, ids = self.search(queries, k, query_batch=query_batch)
                self.free()
                all_scores.append(sc)
                all_ids.append(ids.astype(np.int64) + start)
        finally:
            self._pass_src = src
            self.num_rows = n
            self.embeddings = None
            self.row_scales = None
        cat_s = np.concatenate(all_scores, axis=1)
        cat_i = np.concatenate(all_ids, axis=1)
        order = np.argsort(-cat_s, axis=1, kind="stable")[:, :k]
        return (np.take_along_axis(cat_s, order, axis=1),
                np.take_along_axis(cat_i, order, axis=1))


def reform_out(
    questions: Sequence[str],
    answers: Sequence[Sequence[str]],
    q_ids: Sequence[str],
    topk_ids: np.ndarray,
    topk_scores: np.ndarray,
    hits: Sequence[Sequence[bool]],
    passages,                                   # pid -> (text, title)
    gold_positives: Optional[Dict[str, dict]] = None,  # question -> ctx dict
) -> List[dict]:
    """The SimANS train records from search results
    (``co_training_generate_new_train_wiki.py:182-223``): retrieved hits
    become ``positive_ctxs`` (after the gold positive, whose score is
    updated if it was itself retrieved), non-hits ``hard_negative_ctxs``;
    every ctx carries the retriever score the SimANS sampler reads."""
    out = []
    gold_positives = gold_positives or {}
    for qi, question in enumerate(questions):
        positive_ctxs: List[dict] = []
        negative_ctxs: List[dict] = []
        real_true_id = None
        if question in gold_positives:
            gold = dict(gold_positives[question])
            gold.setdefault("passage_id", gold.get("id", gold.get("psg_id")))
            gold["score"] = str(0)
            if gold["passage_id"] is not None:
                real_true_id = int(gold["passage_id"])
            positive_ctxs.append(gold)
        for rank in range(topk_ids.shape[1]):
            pid = int(topk_ids[qi, rank])
            score = float(topk_scores[qi, rank])
            text, title = passages.get(pid, ("", ""))
            ctx = {"title": title, "text": text, "passage_id": pid,
                   "score": str(score)}
            if hits[qi][rank]:
                if real_true_id is not None and pid == real_true_id:
                    positive_ctxs[0]["score"] = str(score)
                else:
                    positive_ctxs.append(ctx)
            else:
                negative_ctxs.append(ctx)
        out.append({
            "q_id": str(q_ids[qi]), "question": question,
            "answers": list(answers[qi]), "positive_ctxs": positive_ctxs,
            "hard_negative_ctxs": negative_ctxs, "negative_ctxs": [],
        })
    return out


@dataclasses.dataclass
class MiningResult:
    topk_ids: np.ndarray
    topk_scores: np.ndarray
    hits: List[List[bool]]
    top_k_hits: List[float]
    metrics: Dict[str, float]
    train_examples: List[dict]


class RetrievalEngine:
    """The mine: search -> hit labels -> metrics -> train records (the
    reference's ``RenewTools``, ``co_training_generate_new_train_wiki.py:
    226-465``). ``passages`` maps pid -> (text, title); ``logger`` (a
    ``MetricLogger``) times the ``search`` and ``hit_labeling`` phases."""

    def __init__(self, index: MIPSIndex, passages, logger=None):
        self.index = index
        self.passages = passages
        self.logger = logger

    def mine(self, query_embeddings: np.ndarray, questions: Sequence[str],
             answers: Sequence[Sequence[str]],
             q_ids: Optional[Sequence[str]] = None, k: int = 100,
             gold_positives: Optional[Dict[str, dict]] = None,
             match_type: str = "string",
             positive_ids: Optional[Sequence] = None) -> MiningResult:
        """Search + label + metrics + train records.

        Hits are labeled by ``has_answer`` over the passage text (the
        wiki/NQ/TQ path) or, when ``positive_ids`` (per-query gold row ids)
        is given, by membership (the MARCO qrels path).
        """
        timed = (self.logger.timed if self.logger is not None
                 else (lambda name: contextlib.nullcontext()))
        with timed("search"):
            scores, ids = self.index.search(query_embeddings, k)
        with timed("hit_labeling"):
            if positive_ids is not None:
                gold_sets = [set(int(p) for p in pids)
                             for pids in positive_ids]
                hits = [[int(pid) in gold_sets[qi] for pid in ids[qi]]
                        for qi in range(len(questions))]
            else:
                hits = [[has_answer(answers[qi],
                                    self.passages.get(int(pid), ("", ""))[0],
                                    match_type)
                         for pid in ids[qi]]
                        for qi in range(len(questions))]
        if q_ids is None:
            q_ids = [str(i) for i in range(len(questions))]
        train = reform_out(questions, answers, q_ids, ids, scores, hits,
                           self.passages, gold_positives)
        return MiningResult(topk_ids=ids, topk_scores=scores, hits=hits,
                            top_k_hits=top_k_hits_accuracy(hits),
                            metrics=get_metrics(hits), train_examples=train)
