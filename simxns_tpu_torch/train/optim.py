"""AdamW and LAMB with the JAX package's semantics (port of
``simxns_tpu/train/optim.py``).

``make_adamw`` is ``optax.chain(clip_by_global_norm(max_grad_norm),
adamw(schedule, mask=_decay_mask))`` written out, because
``torch.optim.AdamW`` and ``clip_grad_norm_`` differ from optax:

- clipping scales by ``max_norm / norm`` only when ``norm >= max_norm``,
  with no ``+1e-6``;
- the schedule is read at the step count before the increment, so with
  ``warmup_steps > 0`` the first update is exactly 0;
- moments: ``mu = b1 mu + (1 - b1) g``, ``nu = b2 nu + (1 - b2) g^2``; bias
  correction ``/ (1 - b^t)`` with t from 1; ``eps`` outside the root;
- weight decay ``lr * wd * p`` only where :func:`_decay_mask` says so;
- a parameter with no gradient takes a zero gradient (its moments decay
  and it still decays), as JAX's dense gradients do.

``make_lamb`` is ``optax.chain(clip_by_global_norm(max_grad_norm),
lamb(schedule, weight_decay, mask=_decay_mask))``: the same clipping and
Adam moments at ``optax.lamb``'s ``eps=1e-6``, the masked weight decay
added to the update, then each parameter's update scaled by its trust
ratio ``||p|| / ||u||`` (1 where either norm is 0), then by the learning
rate.

Updates are made in place under ``no_grad``, which bumps each parameter's
version: encode-only views that cache quantized weights see the change.
Under tensor parallelism (``tp``: the model group and the names of the
split parameters, ``parallel.tp.tensor_parallel_of``) every norm of a
split parameter is the norm of the whole one: the squares are summed over
the model group.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, Optional, Union

import numpy as np
import torch

Schedule = Callable[[int], float]


def linear_warmup_schedule(lr: float, warmup_steps: int,
                           total_steps: int) -> Schedule:
    """HF ``get_linear_schedule_with_warmup``: 0 -> lr over the warmup, then
    linear decay to 0 at ``total_steps``; evaluated in f32 like the JAX
    schedule."""
    f32 = np.float32

    def schedule(step: int) -> float:
        t = f32(step)
        if t < warmup_steps:
            factor = t / f32(max(1.0, warmup_steps))
        else:
            factor = max(f32(0.0), (f32(total_steps) - t)
                         / f32(max(1.0, total_steps - warmup_steps)))
        return float(f32(lr) * factor)

    return schedule


def _decay_mask(names: Iterable[str]) -> Dict[str, bool]:
    """True for the parameters that get weight decay: everything except
    biases and LayerNorm parameters (the reference's ``no_decay`` list)."""
    mask = {}
    for name in names:
        joined = name.lower()
        mask[name] = not (name.rsplit(".", 1)[-1] in ("bias", "b")
                          or "layer_norm" in joined or "layernorm" in joined)
    return mask


def _sq_sum_over_model(sq: torch.Tensor, split: torch.Tensor, tp
                      ) -> torch.Tensor:
    """Squared norms [n] with the split entries summed over the model
    group (the whole parameters' are equal on every model rank)."""
    from simxns_tpu_torch.parallel.collectives import all_reduce_sum

    return torch.where(split, all_reduce_sum(sq * split, tp[0]), sq)


def _global_norm(gs, names, tp) -> torch.Tensor:
    norms = torch._foreach_norm(gs)
    if tp is None:
        return torch.linalg.vector_norm(torch.stack(norms))
    sq = torch.stack(norms).double() ** 2
    split = torch.tensor([n in tp[1] for n in names], device=sq.device)
    return _sq_sum_over_model(sq, split, tp).sum().sqrt().float()


class _Adam:
    """The clipping and Adam moments both optimizers share; the subclass
    turns the bias-corrected ratio into the update."""

    def init(self, params: Dict[str, torch.Tensor]) -> dict:
        return {"count": 0,
                "mu": {n: torch.zeros_like(p) for n, p in params.items()},
                "nu": {n: torch.zeros_like(p) for n, p in params.items()}}

    def _moments(self, params, grads, state, tp):
        """-> (names, params, the Adam ratios mu_hat / (sqrt(nu_hat) +
        eps), this step's learning rate); the moments and count move."""
        names = list(params)
        ps = [params[n] for n in names]
        gs = [grads[n] if grads.get(n) is not None else torch.zeros_like(p)
              for n, p in zip(names, ps)]
        if self.max_grad_norm is not None:
            norm = _global_norm(gs, names, tp)
            clip = torch.where(norm < self.max_grad_norm,
                               torch.ones_like(norm),
                               self.max_grad_norm / norm)
            gs = torch._foreach_mul(gs, clip)
        mu = [state["mu"][n] for n in names]
        nu = [state["nu"][n] for n in names]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, gs, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, torch._foreach_mul(gs, gs),
                            alpha=1.0 - self.b2)
        lr = self.learning_rate
        step_lr = lr(state["count"]) if callable(lr) else lr
        state["count"] += 1
        t = np.float32(state["count"])
        bc1 = float(np.float32(1) - np.float32(self.b1) ** t)
        bc2 = float(np.float32(1) - np.float32(self.b2) ** t)
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(mu, bc1)
        torch._foreach_div_(upd, den)
        del den
        decay = _decay_mask(names)
        pairs = [(u, p) for n, u, p in zip(names, upd, ps) if decay[n]]
        if pairs and self.weight_decay:
            us, dps = zip(*pairs)
            torch._foreach_add_(list(us), list(dps), alpha=self.weight_decay)
        return names, ps, upd, step_lr


@dataclasses.dataclass(frozen=True)
class AdamW(_Adam):
    """The optimizer's constants; its state is a separate dict
    (:meth:`init`), as optax keeps it in the train state."""

    learning_rate: Union[float, Schedule]
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    max_grad_norm: Optional[float] = 1.0

    @torch.no_grad()
    def update_(self, params: Dict[str, torch.Tensor],
                grads: Dict[str, Optional[torch.Tensor]], state: dict,
                tp=None) -> None:
        """One step: ``params`` and ``state`` change in place."""
        _, ps, upd, step_lr = self._moments(params, grads, state, tp)
        torch._foreach_add_(ps, upd, alpha=-step_lr)


@dataclasses.dataclass(frozen=True)
class Lamb(_Adam):
    """``optax.lamb`` behind the global-norm clipping (its ``eps=1e-6``);
    the state is AdamW's."""

    learning_rate: Union[float, Schedule]
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-6
    weight_decay: float = 0.0
    max_grad_norm: Optional[float] = 1.0

    @torch.no_grad()
    def update_(self, params: Dict[str, torch.Tensor],
                grads: Dict[str, Optional[torch.Tensor]], state: dict,
                tp=None) -> None:
        """One step: ``params`` and ``state`` change in place."""
        names, ps, upd, step_lr = self._moments(params, grads, state, tp)
        p_norm = torch.stack(torch._foreach_norm(ps)).double()
        u_norm = torch.stack(torch._foreach_norm(upd)).double()
        if tp is not None:
            split = torch.tensor([n in tp[1] for n in names],
                                 device=p_norm.device)
            p_norm = _sq_sum_over_model(p_norm ** 2, split, tp).sqrt()
            u_norm = _sq_sum_over_model(u_norm ** 2, split, tp).sqrt()
        p_norm, u_norm = p_norm.float(), u_norm.float()
        ratio = torch.where((p_norm == 0) | (u_norm == 0),
                            torch.ones_like(p_norm), p_norm / u_norm)
        torch._foreach_mul_(upd, list(ratio.unbind()))
        torch._foreach_add_(ps, upd, alpha=-step_lr)


def make_adamw(lr: float, warmup_steps: int = 0,
               total_steps: int = 1_000_000, weight_decay: float = 0.01,
               eps: float = 1e-8, max_grad_norm: Optional[float] = 1.0,
               b1: float = 0.9, b2: float = 0.999) -> AdamW:
    """The JAX ``make_adamw``: a constant ``lr`` when ``total_steps`` is 0,
    else the linear warmup/decay schedule."""
    schedule = (linear_warmup_schedule(lr, warmup_steps, total_steps)
                if total_steps else lr)
    return AdamW(schedule, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                 max_grad_norm=max_grad_norm)


def make_lamb(lr: float, warmup_steps: int = 0,
              total_steps: int = 1_000_000, weight_decay: float = 0.01,
              max_grad_norm: Optional[float] = 1.0) -> Lamb:
    """The JAX ``make_lamb``: clipping, then ``optax.lamb`` with the decay
    mask, on the same schedule as :func:`make_adamw`."""
    schedule = (linear_warmup_schedule(lr, warmup_steps, total_steps)
                if total_steps else lr)
    return Lamb(schedule, weight_decay=weight_decay,
                max_grad_norm=max_grad_norm)
