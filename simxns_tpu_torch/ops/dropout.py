"""Inverted dropout on explicit generators (flax ``nn.Dropout`` and the
probabilities' dropout of ``simxns_tpu/ops/attention.py:47-53``).

Every mask of the port comes from :func:`keep_mask`, and only
:func:`dropout` calls it (tests replace it to feed both packages the same
masks). A module never draws from PyTorch's global generator: the encoder
draws one seed per layer from the caller's generator, and each layer
builds its own generator from that seed (:func:`generator`), so a
checkpointed layer draws the same masks again when it is recomputed.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def seeds(gen: torch.Generator, n: int) -> List[int]:
    """``n`` seeds drawn from ``gen`` (a CPU generator costs no device
    synchronisation)."""
    return torch.randint(0, 2 ** 62, (n,), generator=gen,
                         device=gen.device).tolist()


def keep_mask(gen: torch.Generator, keep_prob: float, shape: Sequence[int],
              device) -> torch.Tensor:
    """A bool mask of ``shape``, each element True with ``keep_prob``."""
    return torch.rand(tuple(shape), generator=gen, device=device) < keep_prob


def dropout(x: torch.Tensor, rate: float,
            gen: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``Dropout(rate)`` in train mode: kept elements scaled by
    ``1 / (1 - rate)`` in ``x``'s dtype, the others 0; ``x`` itself when
    ``rate`` is 0 or ``gen`` is None (eval mode)."""
    if rate == 0.0 or gen is None:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    keep_prob = 1.0 - rate
    keep = keep_mask(gen, keep_prob, x.shape, x.device)
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))
