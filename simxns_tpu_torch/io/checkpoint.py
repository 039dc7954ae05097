"""Step-indexed checkpoints (port of ``simxns_tpu/io/checkpoint.py``).

The reference writes ``checkpoint-<step>`` files with ``torch.save`` and
resumes from the highest step it finds (``co_training_wiki_train.py:
319-367``, ``run_progressive_distill_marco.py:167-180``). Here each
checkpoint is a directory ``<dir>/<name>-<step>/`` holding ``state.pt``,
a ``torch.save`` of a tree of CPU tensors and numbers (for a train state,
``TrainState.state_dict()``: parameters, AdamW moments and count, step).
A checkpoint is written under a temporary name and renamed into place, so
a crash never leaves a half-written one that :func:`latest_step` would
offer for a resume.

Under data parallelism (``mesh`` with a group) rank 0 writes and every
rank waits at a barrier until the checkpoint is in place; a failed write
raises on every rank. Every rank restores (the ranks share a filesystem).
"""

from __future__ import annotations

import os
import re
import shutil
import threading
from typing import Any, Optional

import torch

from simxns_tpu_torch.parallel.collectives import barrier

_FILE = "state.pt"


def _path(directory: str, name: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"{name}-{step}")


def save_checkpoint(directory: str, tree: Any, step: int,
                    name: str = "checkpoint", mesh=None) -> str:
    """Write ``tree`` (CPU tensors, numbers, nested dicts) as
    ``<name>-<step>``, replacing an earlier one of the same name. With a
    ``mesh``, rank 0 writes and every rank returns once it is written."""
    path = _path(directory, name, step)
    failed = None
    if mesh is None or mesh.rank == 0:
        try:
            tmp = f"{path}.tmp-{os.getpid()}-{threading.get_ident()}"
            os.makedirs(tmp, exist_ok=True)
            torch.save(tree, os.path.join(tmp, _FILE))
            if os.path.isdir(path):
                shutil.rmtree(path)
            os.replace(tmp, path)
        except BaseException as e:  # every rank raises below
            failed = e
    if mesh is not None:
        barrier(mesh, failed is not None, f"checkpoint write {path}")
    if failed is not None:
        raise failed
    return path


def restore_checkpoint(directory: str, target, step: int,
                       name: str = "checkpoint"):
    """Load ``<name>-<step>`` into ``target`` (a ``TrainState``, in place on
    its device) and return it; ``target=None`` returns the tree."""
    tree = torch.load(os.path.join(_path(directory, name, step), _FILE),
                      map_location="cpu", weights_only=True)
    return tree if target is None else target.load_state_dict(tree)


def latest_step(directory: str, name: str = "checkpoint") -> Optional[int]:
    """Highest checkpointed step (the reference's resume scan)."""
    if not os.path.isdir(directory):
        return None
    pat = re.compile(rf"^{re.escape(name)}-(\d+)$")
    steps = [int(m.group(1)) for f in os.listdir(directory)
             if (m := pat.match(f))]
    return max(steps) if steps else None


def export_encoder_only(state: dict, drop_prefixes: Optional[tuple] = None
                        ) -> dict:
    """MASTER's artifact: a Condenser state_dict (flat ``name -> tensor``,
    or a ``{"params": ...}`` tree) without the decoder heads, so the
    released checkpoint is the plain BERT encoder and its MLM head
    (``save_pretrained`` deleting the heads, ``MASTER/pretrain/modeling.py:
    199-207``). The default prefixes are the Condenser's ``HEAD_NAMES``,
    so a new head never ships in the artifact. The ``encoder.`` entries
    load into a ``BiEncoder`` tower (:func:`encoder_into`)."""
    if drop_prefixes is None:
        from simxns_tpu_torch.models.condenser import HEAD_NAMES
        drop_prefixes = HEAD_NAMES
    if "params" in state and isinstance(state["params"], dict):
        state = state["params"]
    return {k: v for k, v in state.items()
            if not any(k.split(".", 1)[0].startswith(p)
                       for p in drop_prefixes)}


def encoder_into(exported: dict, tower: Any) -> None:
    """Load an exported encoder's ``encoder.*`` weights into ``tower``'s
    ``encoder`` (a ``BiEncoder`` tower, a ``CrossEncoder``, a
    ``ColBERT``), strictly: every encoder weight must be present."""
    prefix = "encoder."
    tower.encoder.load_state_dict(
        {k[len(prefix):]: v for k, v in exported.items()
         if k.startswith(prefix)})
