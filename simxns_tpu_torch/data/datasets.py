"""File readers of the launcher's real-data path (own copy of part of
``simxns_tpu/data/datasets.py``): passage text for ``has_answer`` hit
labeling (``psgs_w100.tsv``, MARCO ``para.txt``) and qrels for id
labeling. The JSON dataset and collator classes wait for a later slice.
"""

from __future__ import annotations

import csv
from typing import Dict, List, Tuple


def load_passages_tsv(path: str, id_minus_one: bool = True
                      ) -> List[Tuple[int, str, str]]:
    """``psgs_w100.tsv``: ``id\\ttext\\ttitle`` -> [(id, text, title)].

    The reference stores wiki ids as ``int(id) - 1``
    (``co_training_generate_new_train_wiki.py:334-348``).
    """
    rows = []
    with open(path, "r", encoding="utf-8") as f:
        for row in csv.reader(f, delimiter="\t"):
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


def load_qrels(path: str) -> Dict[str, list]:
    """MARCO qrels: ``qid\\tpid`` (2 columns) or TREC ``qid 0 pid rel``
    (rows with rel > 0 only), split on any whitespace. -> qid -> [pids]."""
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
