"""End-to-end dense-retrieval serving (port of ``simxns_tpu/serve.py``).

Tokenize -> encode with the dual encoder -> device-resident MIPS index ->
top-k search -> passage lookup, behind one object:

    retriever = DenseRetriever(model, tokenizer)         # on the card
    retriever.index_corpus(passages)       # encode + build the index
    hits = retriever.search(["who wrote hamlet?"], k=10)

With ``model`` at ``layer_impl="fused_int8"``, ``store_dtype=torch.int8``
and ``index_mode="fused"`` every encoder layer and the search run on the
port's Hopper kernels.

Sharded serving (``mesh``, a :class:`~simxns_tpu_torch.parallel.mesh.Mesh`
over the ranks of ``torchrun``): the index is row-split over the data axis
of the mesh, the passage encoder's chunk is ``encode_chunk`` times the
mesh's ranks (JAX: times its chips) split over that axis, and every rank
calls every method with the same arguments and returns the same hits.

``from_checkpoint`` builds one from a launcher checkpoint (a
``retriever_state-<step>`` or the final ``retriever-<step>``, written by
:mod:`simxns_tpu_torch.io.checkpoint`): the parameters are loaded into
the model on the CPU, then the model moves to the serving device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from simxns_tpu_torch.index.engine import CorpusEncoder, MIPSIndex
from simxns_tpu_torch.parallel.mesh import Mesh, mesh_device


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
                 store_dtype: Optional[torch.dtype] = None,
                 mesh: Optional[Mesh] = None):
        self.mesh = mesh
        self.device = mesh_device(mesh, device)
        self.model = model.to(self.device).eval()
        self.tokenizer = tokenizer
        self.max_q_length = max_q_length
        self.max_ctx_length = max_ctx_length
        self.query_batch = query_batch
        index_kw = {} if store_dtype is None else {"store_dtype": store_dtype}
        self.index = MIPSIndex(self.device, block_size=block_size,
                               mode=index_mode, mesh=mesh, **index_kw)
        n_chips = 1 if mesh is None else mesh.world_size * mesh.n_model
        self._p_encoder = CorpusEncoder(self.model.encode_passage,
                                        self.device,
                                        chunk_size=encode_chunk * n_chips,
                                        mesh=mesh)
        self._q_encoder = CorpusEncoder(self.model.encode_query, self.device,
                                        chunk_size=max(query_batch, 8),
                                        mesh=mesh)
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

    @staticmethod
    def from_checkpoint(ckpt_dir: str, step: int, model, tokenizer,
                        name: str = "checkpoint", device=None,
                        mesh: Optional[Mesh] = None,
                        **kw) -> "DenseRetriever":
        """A retriever over ``model`` with the parameters of the checkpoint
        ``<ckpt_dir>/<name>-<step>`` (a ``TrainState`` tree or a params-only
        one); ``device``, ``mesh`` and ``kw`` as the constructor's."""
        from simxns_tpu_torch.io.checkpoint import restore_checkpoint

        tree = restore_checkpoint(ckpt_dir, None, step, name=name)
        model.load_state_dict(tree["params"] if "params" in tree else tree)
        return DenseRetriever(model, tokenizer, device=device, mesh=mesh,
                              **kw)
