"""Device synchronization for honest phase timing.

The JAX package proves execution with a host transfer
(``simxns_tpu.parallel.sync.force_sync``); on CUDA a stream synchronize is
that proof.
"""

from __future__ import annotations

import torch


def force_sync(device: torch.device) -> None:
    """Block until all work queued on ``device`` has executed (no-op on the
    CPU, where PyTorch runs synchronously)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
