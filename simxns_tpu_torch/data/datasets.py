"""Data contracts and batch assembly (own copy of
``simxns_tpu/data/datasets.py``): the reference's file formats and its two
training datasets as one class.

- wiki/NQ/TQ JSON (``train_ce_<step>.json``): a list of ``{q_id,
  question, answers, positive_ctxs: [{title, text, passage_id, score}],
  hard_negative_ctxs: [...], negative_ctxs: []}``
  (``SimANS/utils/util_wiki.py:558-701``).
- MARCO TSV (``query_id\\tquery\\tpos_id score,...\\tneg_id score,...``)
  with the side corpus files ``para.txt`` / ``para.title.txt``
  (``SimANS/utils/MARCO_until_new.py:125-260``).
- passages (``psgs_w100.tsv``, MS-Doc ``msmarco-docs.tsv``), qrels (MARCO
  and graded TREC) and ``*.qa.csv`` question files.

Batches are numpy arrays padded to fixed lengths, as the JAX package's
(the same arrays from the same seed: :class:`RetrievalCollator` draws from
the caller's ``numpy.random.Generator`` in the same order):

- ``q_ids/q_mask``          [N, Lq]
- ``ctx_ids/ctx_mask``      [N*M, Lc]   M = 1 positive + k negatives,
                                         positive at group offset 0
- ``joint_ids/joint_mask``  [N, M, Lj]  cross-encoder inputs
- ``positive_idx``          [N]         index of positive in flattened ctx
- ``answers``               host-only list (hit labeling)
"""

from __future__ import annotations

import ast
import csv
import dataclasses
import json
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from simxns_tpu_torch.data.sampling import (sample_hard_negatives,
                                            select_negatives)
from simxns_tpu_torch.data.tokenization import Tokenizer, pack_joint, pad_to


@dataclasses.dataclass
class Passage:
    passage_id: int
    score: float
    title: str
    text: str


@dataclasses.dataclass
class RetrievalExample:
    q_id: str
    question: str
    answers: List[str]
    positives: List[Passage]
    negatives: List[Passage]


def normalize_question(q: str) -> str:
    # util_wiki.py strips trailing '?' before encoding
    return q[:-1] if q.endswith("?") else q


def load_wiki_json(path: str, require_negatives: bool = True) -> List[RetrievalExample]:
    """``train_ce_<step>.json`` loader with the reference's filtering
    (drop examples without positives / hard negatives, ``util_wiki.py:573-580``)."""
    with open(path, "r", encoding="utf-8") as f:
        raw = json.load(f)
    out = []
    for r in raw:
        if not r.get("positive_ctxs"):
            continue
        if require_negatives and not r.get("hard_negative_ctxs"):
            continue

        def mk(ctx):
            # gold positives dumped with title/text only (passage_id None)
            # take the id -1 (the reference never int()s positive ids)
            pid = ctx.get("passage_id")
            return Passage(int(pid) if pid is not None else -1,
                           float(ctx.get("score", 0)),
                           ctx.get("title") or "", ctx.get("text") or "")

        out.append(RetrievalExample(
            q_id=str(r.get("q_id", r.get("id", ""))),
            question=r["question"],
            answers=list(r.get("answers", [])),
            positives=[mk(c) for c in r["positive_ctxs"]],
            negatives=[mk(c) for c in r.get("hard_negative_ctxs", [])],
        ))
    return out


def load_marco_tsv(
    path: str,
    corpus_text: Dict[int, str],
    corpus_title: Optional[Dict[int, str]] = None,
) -> List[RetrievalExample]:
    """``train_ce_*.tsv``: ``qid\\tquery\\tpos_id score,...\\tneg_id score,...``."""
    out = []
    title = corpus_title or {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) != 4:
                continue
            qid, query, pos_field, neg_field = parts

            def mk(field):
                res = []
                for pair in field.split(","):
                    bits = pair.split()
                    if not bits:
                        continue
                    pid = int(bits[0])
                    score = float(bits[1]) if len(bits) > 1 else 0.0
                    res.append(Passage(pid, score, title.get(pid, "-"),
                                       corpus_text.get(pid, "")))
                return res

            out.append(RetrievalExample(qid, query, [], mk(pos_field), mk(neg_field)))
    return out


def load_passages_tsv(path: str, id_minus_one: bool = True) -> List[Tuple[int, str, str]]:
    """``psgs_w100.tsv``: ``id\\ttext\\ttitle`` -> [(id, text, title)].

    The reference stores wiki ids as ``int(id) - 1``
    (``co_training_generate_new_train_wiki.py:334-348``).
    """
    rows = []
    with open(path, "r", encoding="utf-8") as f:
        reader = csv.reader(f, delimiter="\t")
        for row in reader:
            if row[0] == "id":
                continue
            pid = int(row[0]) - 1 if id_minus_one else int(row[0])
            rows.append((pid, row[1], row[2] if len(row) > 2 else ""))
    return rows


def load_id_text(path: str) -> Dict[int, str]:
    """MARCO ``para.txt`` / ``para.title.txt``: ``id\\ttext``."""
    out = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            pid, text = line.split("\t", 1)
            out[int(pid)] = text
    return out


def load_qa_csv(path: str) -> List[Tuple[str, List[str]]]:
    """``*.qa.csv``: ``question\\t"['a1','a2']"`` (answers literal-eval'd,
    the reference uses ``eval()`` — we use ``ast.literal_eval``)."""
    out = []
    with open(path, "r", encoding="utf-8") as f:
        reader = csv.reader(f, delimiter="\t")
        for row in reader:
            out.append((row[0], list(ast.literal_eval(row[1]))))
    return out


@dataclasses.dataclass
class RetrievalCollator:
    """Tokenize + pack one batch of examples into static-shape arrays."""

    tokenizer: Tokenizer
    num_negatives: int = 1
    max_q_length: int = 32
    max_ctx_length: int = 128
    max_joint_length: int = 160
    # SimANS sampling knobs (mode=None -> plain selection via neg_type)
    simans_mode: Optional[str] = "quadratic"
    simans_a: float = 0.5
    simans_b: float = 0.0
    simans_tau: float = 3.0
    neg_type: str = "random"
    shuffle_negatives: bool = True      # reference shuffles before sampling
    shuffle_positives: bool = False
    is_training: bool = True

    def _pick_passages(self, ex: RetrievalExample, rng: np.random.Generator
                       ) -> Tuple[Passage, List[Passage]]:
        if self.shuffle_positives and self.is_training and len(ex.positives) > 1:
            pos = ex.positives[int(rng.integers(len(ex.positives)))]
        else:
            pos = ex.positives[0]
        negs = list(ex.negatives)
        if self.is_training and self.shuffle_negatives:
            perm = rng.permutation(len(negs))
            negs = [negs[i] for i in perm]
        by_id = {}
        for p in negs:
            by_id.setdefault(p.passage_id, p)
        ids = [p.passage_id for p in negs]
        scores = [p.score for p in negs]
        if self.simans_mode is not None and self.is_training:
            chosen = sample_hard_negatives(
                ids, scores, pos.score, self.num_negatives, rng,
                mode=self.simans_mode, a=self.simans_a, b=self.simans_b,
                tau=self.simans_tau)
        else:
            chosen = select_negatives(ids, scores, self.num_negatives, rng,
                                      neg_type=self.neg_type)
        return pos, [by_id[i] for i in chosen]

    def __call__(self, examples: Sequence[RetrievalExample],
                 rng: np.random.Generator) -> Dict[str, np.ndarray]:
        tok = self.tokenizer
        n = len(examples)
        m = 1 + self.num_negatives
        q_ids = np.zeros((n, self.max_q_length), np.int32)
        ctx_ids = np.zeros((n * m, self.max_ctx_length), np.int32)
        joint_ids = np.zeros((n, m, self.max_joint_length), np.int32)
        answers = []
        for i, ex in enumerate(examples):
            q_enc = tok.encode(normalize_question(ex.question),
                               max_length=self.max_q_length)
            q_ids[i] = pad_to(q_enc, self.max_q_length, tok.pad_token_id)
            pos, negs = self._pick_passages(ex, rng)
            for j, p in enumerate([pos] + negs):
                c_enc = tok.encode(p.title, text_pair=p.text.strip(),
                                   max_length=self.max_ctx_length)
                ctx_ids[i * m + j] = pad_to(c_enc, self.max_ctx_length,
                                            tok.pad_token_id)
                joint = pack_joint(q_enc, c_enc, tok.sep_token_id,
                                   self.max_joint_length)
                joint_ids[i, j] = pad_to(joint, self.max_joint_length,
                                         tok.pad_token_id)
            answers.append(ex.answers)
        pad = self.tokenizer.pad_token_id
        return {
            "q_ids": q_ids, "q_mask": (q_ids != pad).astype(np.int32),
            "ctx_ids": ctx_ids, "ctx_mask": (ctx_ids != pad).astype(np.int32),
            "joint_ids": joint_ids,
            "joint_mask": (joint_ids != pad).astype(np.int32),
            "positive_idx": (np.arange(n) * m).astype(np.int32),
            "answers": answers,
        }


class RetrievalDataset:
    """Examples + collator + epoch iteration with a seeded numpy RNG."""

    def __init__(self, examples: List[RetrievalExample],
                 collator: RetrievalCollator, seed: int = 0):
        self.examples = examples
        self.collator = collator
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.examples)

    def batches(self, batch_size: int, shuffle: bool = True,
                drop_last: bool = True) -> Iterator[Dict[str, np.ndarray]]:
        order = (self.rng.permutation(len(self.examples)) if shuffle
                 else np.arange(len(self.examples)))
        end = len(order) - (len(order) % batch_size if drop_last else 0)
        for s in range(0, end, batch_size):
            idx = order[s: s + batch_size]
            yield self.collator([self.examples[i] for i in idx], self.rng)


def load_qrels(path: str) -> Dict[str, list]:
    """MARCO qrels: ``qid\\tpid`` 2-col (the reference's preprocessed form,
    ``inference_DE_marco.py:446-464``) or official 4-col TREC
    ``qid 0 pid rel`` (rel>0 rows only; official qrels are SPACE-separated
    — split on any whitespace like load_trec_qrels). Returns qid -> [pids].
    """
    out: Dict[str, list] = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 4:
                qid, pid, rel = parts[0], parts[2], int(parts[3])
                if rel <= 0:
                    continue
            elif len(parts) >= 2:
                qid, pid = parts[0], parts[1]
            else:
                continue
            out.setdefault(qid, []).append(int(pid))
    return out


def load_trec_qrels(path: str) -> Dict[str, Dict[int, int]]:
    """Graded TREC qrels (``qid 0 pid grade``, space or tab separated) for
    nDCG evaluation (``CAPSTONE/utils/evaluate_trec.py``)."""
    out: Dict[str, Dict[int, int]] = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if len(parts) < 4:
                continue
            qid, _, pid, grade = parts[:4]
            out.setdefault(qid, {})[int(pid)] = int(grade)
    return out


def pack_msdoc_text(url: str, title: str, body: str,
                    sep: str = "<sep>") -> str:
    """MS-Doc passage text = ``url<sep>title<sep>body``
    (``Doc_training/co_training_generate_new_train.py:385-396``); the
    reference truncates to 128 tokens downstream via max_ctx_length."""
    return f"{url}{sep}{title}{sep}{body}"


def load_msdoc_tsv(path: str) -> List[Tuple[int, str]]:
    """``msmarco-docs.tsv``: ``id\turl\ttitle\tbody`` -> [(pid, packed text)].
    Document ids like ``D12345`` are mapped to their integer part."""
    rows = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 4:
                continue
            raw_id = parts[0]
            pid = int(raw_id[1:]) if raw_id[:1] == "D" else int(raw_id)
            rows.append((pid, pack_msdoc_text(parts[1], parts[2], parts[3])))
    return rows
