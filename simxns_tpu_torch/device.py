"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the card. A CUDA device that is absent raises; the
    port never moves to the CPU unless the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a CUDA device was requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run the plain PyTorch path")
        # bf16 GEMMs keep f32 partial sums (flax Dense(dtype=bf16)): no
        # split-K reduction in bf16
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
    return dev
