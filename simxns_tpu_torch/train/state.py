"""Training state (port of ``simxns_tpu/train/state.py``).

The module (whose ``Parameter`` objects are the params), the optimizer
state and the step count. Unlike the JAX pytree it is updated in place:
``apply_gradients`` changes the parameters and returns the same object.
:meth:`TrainState.state_dict` and :meth:`TrainState.load_state_dict` give
the tree that checkpoints and host stashes hold.
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

    def state_dict(self) -> dict:
        """``{"params", "opt_state": {"count", "mu", "nu"}, "step"}`` over
        this state's own tensors (not copies)."""
        return {"params": {n: p.detach()
                           for n, p in self.module.named_parameters()},
                "opt_state": {"count": self.opt_state["count"],
                              "mu": dict(self.opt_state["mu"]),
                              "nu": dict(self.opt_state["nu"])},
                "step": self.step}

    @torch.no_grad()
    def load_state_dict(self, tree: dict) -> "TrainState":
        """Copy a :meth:`state_dict` tree (from any device) into this state
        in place; returns it. Every parameter's version moves, so encode
        views that cache quantized weights quantize again."""
        for n, p in self.module.named_parameters():
            p.copy_(tree["params"][n])
        for key in ("mu", "nu"):
            for n, t in self.opt_state[key].items():
                t.copy_(tree["opt_state"][key][n])
        self.opt_state["count"] = int(tree["opt_state"]["count"])
        self.step = int(tree["step"])
        return self
