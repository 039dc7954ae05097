"""PROD data-progressive tooling (port of ``simxns_tpu/data/division.py``):
rank-bucket division and subset selection.

Replaces ``PROD/ProD_KD/utils/dataset_division_{marco,nq,marcodoc}.py``:
each query is bucketed by the rank of its first relevant passage in a
model's top-k list, then the "teacher good / student bad" subset (student
rank in 2..15 while the teacher's is 1, ``dataset_division_marco.py:
175-176``) is selected for the final LwF round. Bucket names and bounds are
the reference's (``divide_data`` :57-150), overlapping buckets included.
Plain Python: no tensors.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping, Sequence, Set

# name -> [lo, hi) over the 0-based rank of the first relevant passage
BUCKETS = {
    "top1": (0, 1),
    "2ti": (1, 2),
    "2t5": (1, 5),
    "2t10": (1, 10),
    "2t15": (1, 15),
    "6t20": (5, 20),
    "21t50": (20, 50),
    "51t100": (50, 100),
    "101tall": (100, 1000),
}


def first_relevant_rank(ranked: Sequence[int], relevant: Iterable[int]) -> int:
    """0-based rank of the first relevant pid, or -1 if none is ranked."""
    rel = set(relevant)
    return next((i for i, pid in enumerate(ranked) if pid in rel), -1)


def divide_data(qid_to_ranked: Mapping[str, Sequence[int]],
                qrels: Mapping[str, Iterable[int]]) -> Dict[str, Set[str]]:
    """Bucket the qids that have qrels by their first relevant rank."""
    out: Dict[str, Set[str]] = {name: set() for name in BUCKETS}
    for qid, ranked in qid_to_ranked.items():
        if qid not in qrels:
            continue
        r = first_relevant_rank(ranked, qrels[qid])
        if r < 0:
            continue
        for name, (lo, hi) in BUCKETS.items():
            if lo <= r < hi:
                out[name].add(qid)
    return out


def teacher_better_qids(student_ranked: Mapping[str, Sequence[int]],
                        teacher_ranked: Mapping[str, Sequence[int]],
                        qrels: Mapping[str, Iterable[int]],
                        student_bucket: str = "2t15",
                        teacher_bucket: str = "top1") -> Set[str]:
    """The queries the teacher ranks right and the student does not: the
    LwF round's training subset (``CE24_top2t15_better.json``)."""
    return (divide_data(student_ranked, qrels)[student_bucket]
            & divide_data(teacher_ranked, qrels)[teacher_bucket])


def select_examples(examples: Sequence, qids: Set[str]) -> list:
    """The examples (anything with a ``q_id``) of a qid subset; both sides
    compared as ``str`` (unpickled reference files key qids as ints)."""
    wanted = {str(q) for q in qids}
    return [ex for ex in examples if str(ex.q_id) in wanted]
