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
"""

from __future__ import annotations

import os
import re
import shutil
import threading
from typing import Any, Optional

import torch

_FILE = "state.pt"


def _path(directory: str, name: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"{name}-{step}")


def save_checkpoint(directory: str, tree: Any, step: int,
                    name: str = "checkpoint") -> str:
    """Write ``tree`` (CPU tensors, numbers, nested dicts) as
    ``<name>-<step>``, replacing an earlier one of the same name."""
    path = _path(directory, name, step)
    tmp = f"{path}.tmp-{os.getpid()}-{threading.get_ident()}"
    os.makedirs(tmp, exist_ok=True)
    torch.save(tree, os.path.join(tmp, _FILE))
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
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
