"""End-to-end dense-retrieval serving (port of ``simxns_tpu/serve.py``).

Tokenize -> encode with the dual encoder -> device-resident MIPS index ->
top-k search -> passage lookup, behind one object:

    retriever = DenseRetriever(model, tokenizer)         # on the card
    retriever.index_corpus(passages)       # encode + build the index
    hits = retriever.search(["who wrote hamlet?"], k=10)

With ``model`` at ``layer_impl="fused_int8"``, ``store_dtype=torch.int8``
and ``index_mode="fused"`` every encoder layer and the search run on the
port's Hopper kernels. ``from_checkpoint`` waits for the checkpoint slice.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from simxns_tpu_torch.device import resolve_device
from simxns_tpu_torch.index.engine import CorpusEncoder, MIPSIndex


@dataclasses.dataclass
class SearchHit:
    passage_id: int
    score: float
    text: str
    title: str


class DenseRetriever:
    def __init__(self, model, tokenizer, device=None,
                 max_q_length: int = 32, max_ctx_length: int = 128,
                 index_mode: str = "approx", block_size: int = 8192,
                 encode_chunk: int = 1024, query_batch: int = 8,
                 store_dtype: Optional[torch.dtype] = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.tokenizer = tokenizer
        self.max_q_length = max_q_length
        self.max_ctx_length = max_ctx_length
        self.query_batch = query_batch
        index_kw = {} if store_dtype is None else {"store_dtype": store_dtype}
        self.index = MIPSIndex(self.device, block_size=block_size,
                               mode=index_mode, **index_kw)
        self._p_encoder = CorpusEncoder(self.model.encode_passage,
                                        self.device, chunk_size=encode_chunk)
        self._q_encoder = CorpusEncoder(self.model.encode_query, self.device,
                                        chunk_size=max(query_batch, 8))
        self.passages: Dict[int, Tuple[str, str]] = {}

    # --- indexing ----------------------------------------------------------
    def _tokenize(self, texts: Sequence[str], pairs: Optional[Sequence[str]],
                  length: int) -> Tuple[np.ndarray, np.ndarray]:
        ids = np.full((len(texts), length), self.tokenizer.pad_token_id,
                      np.int32)
        for i, text in enumerate(texts):
            enc = self.tokenizer.encode(
                text, text_pair=pairs[i] if pairs else None,
                max_length=length)
            ids[i, : len(enc)] = enc
        return ids, (ids != self.tokenizer.pad_token_id).astype(np.int32)

    def index_corpus(self, passages: Dict[int, Tuple[str, str]],
                     precomputed_tokens: Optional[np.ndarray] = None) -> int:
        """``{pid: (text, title)}`` -> encode + build the device index.

        Passage ids must be dense 0..N-1 (the index returns row positions).
        """
        self.passages = dict(passages)
        n = len(passages)
        if precomputed_tokens is not None:
            ids = precomputed_tokens
            mask = (ids != self.tokenizer.pad_token_id).astype(np.int32)
        else:
            texts = [passages[i][0] for i in range(n)]
            titles = [passages[i][1] for i in range(n)]
            ids, mask = self._tokenize(titles, texts, self.max_ctx_length)
        self.index.build(self._p_encoder(ids, mask))
        return n

    # --- querying ----------------------------------------------------------
    def encode_queries(self, queries: Sequence[str]) -> np.ndarray:
        ids, mask = self._tokenize(list(queries), None, self.max_q_length)
        return self._q_encoder(ids, mask)

    def _fused_search(self, ids: torch.Tensor, mask: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Query encode + top-k search, all on the device: the query
        embeddings never visit the host (bf16 before an int8 search)."""
        q_emb = self.model.encode_query(ids, mask)
        return self.index.search_tensor(q_emb.to(self.index.query_dtype()), k)

    def search(self, queries: Sequence[str], k: int = 10
               ) -> List[List[SearchHit]]:
        if self.index.embeddings is None:
            raise RuntimeError(
                "index not built — call index_corpus() first")
        ids, mask = self._tokenize(list(queries), None, self.max_q_length)
        qb = self.query_batch
        pending = []
        with torch.inference_mode():
            for s in range(0, len(queries), qb):
                pending.append(self._fused_search(
                    torch.from_numpy(ids[s:s + qb]).to(self.device),
                    torch.from_numpy(mask[s:s + qb]).to(self.device), k))
            scores = np.concatenate([sc.cpu().numpy() for sc, _ in pending])
            top = np.concatenate([i.cpu().numpy() for _, i in pending])
        out: List[List[SearchHit]] = []
        for qi in range(len(queries)):
            hits = []
            for rank in range(k):
                pid = int(top[qi, rank])
                text, title = self.passages.get(pid, ("", ""))
                hits.append(SearchHit(pid, float(scores[qi, rank]),
                                      text, title))
            out.append(hits)
        return out
