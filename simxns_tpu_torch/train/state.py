"""Training state (port of ``simxns_tpu/train/state.py``).

The module (whose ``Parameter`` objects are the params), the optimizer
state and the step count. Unlike the JAX pytree it is updated in place:
``apply_gradients`` changes the parameters and returns the same object.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from simxns_tpu_torch.train.optim import AdamW


@dataclasses.dataclass
class TrainState:
    module: nn.Module
    opt_state: dict
    step: int = 0

    @classmethod
    def create(cls, module: nn.Module, tx: AdamW) -> "TrainState":
        return cls(module=module,
                   opt_state=tx.init(dict(module.named_parameters())))

    @property
    def params(self) -> Dict[str, nn.Parameter]:
        return dict(self.module.named_parameters())

    def apply_gradients(self, grads: Dict[str, Optional[torch.Tensor]],
                        tx: AdamW) -> "TrainState":
        tx.update_(self.params, grads, self.opt_state)
        self.step += 1
        return self
