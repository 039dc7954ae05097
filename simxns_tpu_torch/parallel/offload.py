"""Stash a train state in host memory while a mine runs (port of
``simxns_tpu/parallel/offload.py``).

The AR2 loop alternates two working sets on one device: the train window
holds both train states; the mine holds the index and the retriever. The
reranker's state (parameters, AdamW moments) is dead weight during the
mine. :class:`HostStash` copies it to host memory (pinned, on a side
stream) and frees its device memory; ``restore()`` puts it back.

Freeing keeps every ``Parameter`` object: each parameter's ``.data`` is
moved (to the host copy, then back to the device), never the module, so a
view that shares those Parameters (``int8_view``, the retriever step's
teacher) follows; its cached int8 weights are dropped with the state and
quantized again at the next encode. A stash is not a checkpoint: it dies
with the process (``io/checkpoint.py`` survives one).
"""

from __future__ import annotations

from typing import Optional

import torch

from simxns_tpu_torch.train.state import TrainState

__all__ = ["HostStash", "host_copy", "ready_event"]


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def ready_event(device: torch.device) -> Optional[torch.cuda.Event]:
    """An event after all work queued so far on ``device``'s current stream
    (None on the CPU): a copy made later on another thread waits for it and
    for nothing queued after it."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


def host_copy(tree, device: torch.device,
              ready: Optional[torch.cuda.Event] = None):
    """``tree`` with every tensor copied to host memory; returns when the
    copies have landed.

    On a card the copies run on a stream of their own into pinned memory,
    after ``ready`` (default: everything queued on the caller's current
    stream), so they overlap work queued later on other streams.
    """
    if device.type != "cuda":
        return _map(tree, lambda t: t.detach().clone())
    stream = torch.cuda.Stream(device)
    if ready is None:
        ready = ready_event(device)
    stream.wait_event(ready)
    with torch.cuda.stream(stream):
        out = _map(tree, lambda t: torch.empty(
            t.shape, dtype=t.dtype, pin_memory=True).copy_(
                t.detach(), non_blocking=True))
    stream.synchronize()
    return out


class HostStash:
    """Move a :class:`TrainState` to host memory, freeing its device copy.

    >>> stash = HostStash(ce_state)      # device memory released here
    >>> ... run the mine phase ...
    >>> ce_state = stash.restore()       # the same object, back on device

    ``ready`` orders the copy after that event when the stash is made on
    another thread than the one that queued the state's last update. The
    caller must not touch the state between the stash and ``restore()``,
    which may be called once.
    """

    def __init__(self, state: TrainState,
                 ready: Optional[torch.cuda.Event] = None):
        self._state = state
        self._device = next(state.module.parameters()).device
        self._host = host_copy(state.state_dict(), self._device, ready)
        for m in state.module.modules():
            if hasattr(m, "drop_quantized"):
                m.drop_quantized()
        self._point_at(self._host)
        self._restored = False

    def _point_at(self, tree) -> None:
        for n, p in self._state.module.named_parameters():
            p.data = tree["params"][n]
        for key in ("mu", "nu"):
            self._state.opt_state[key] = dict(tree["opt_state"][key])

    def state_dict(self) -> dict:
        """The stashed state as a tree of host tensors (the JAX stash's
        ``numpy_tree``), without copying it back: the checkpoint writer
        saves it. Read-only; valid after :meth:`restore` too."""
        if self._restored:
            raise RuntimeError("state_dict() after restore(): capture the "
                               "tree before handing the stash back")
        return self._host

    @property
    def nbytes(self) -> int:
        """Host bytes held (== device bytes released)."""
        return sum(t.numel() * t.element_size()
                   for group in (self._host["params"],
                                 self._host["opt_state"]["mu"],
                                 self._host["opt_state"]["nu"])
                   for t in group.values())

    def restore(self) -> TrainState:
        """Copy the state back to its device; returns the same state."""
        if self._restored:
            raise RuntimeError("HostStash.restore() called twice: the host "
                               "copy was already handed back")
        # a copy even on the CPU: a checkpoint writer may still be saving
        # the host tree while training updates the state in place
        self._point_at(_map(self._host, lambda t: t.to(
            self._device, non_blocking=True, copy=True)))
        self._restored = True
        self._host = None
        return self._state
