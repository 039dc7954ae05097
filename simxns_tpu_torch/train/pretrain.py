"""MASTER pre-training steps (port of ``simxns_tpu/train/pretrain.py``): the
Condenser's 8-loss objective and its ELECTRA variant, in place of the
HF-Trainer wiring of ``MASTER/pretrain/run_pre_training.py`` and
``trainer.py``. bf16 activations stand in for the reference's fp16 AMP.

A step is ``step(state, batch) -> (state, metrics)`` over a
``CondenserCollator`` batch (numpy arrays or tensors), with the loss and
each part as metrics. ``dropout=True`` trains in train mode with the
step's :func:`~simxns_tpu_torch.train.steps.dropout_generator`. Under a
group (``mesh``) each rank passes its rows. Every part is a mean over the
masked positions of its stream in the whole batch (JAX's mean over the
global batch), so a rank's share of a part is its sum over the global
count: its local mean times (local count / global count), the counts
summed over the group from the labels before the forward. The gradients
are summed, as in the other steps, and the reported loss and parts are
the global ones (the shares summed).
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from simxns_tpu_torch.models.condenser import (IGNORE_INDEX,
                                               generate_replaced_ids)
from simxns_tpu_torch.parallel.collectives import (all_gather_rows,
                                                   all_reduce_sum)
from simxns_tpu_torch.parallel.mesh import Mesh, dp_size, mesh_device
from simxns_tpu_torch.train.optim import AdamW
from simxns_tpu_torch.train.state import TrainState
from simxns_tpu_torch.train.steps import (_apply, _check_on,
                                          dropout_generator, to_device)

# the labels each part's mean runs over
_LABELS = {"mlm": "labels", "c_head": "decoder_labels",
           "query": "query_labels", "gpt": "gpt_labels",
           "next_encoder": "next_encoder_labels",
           "next": "next_decoder_labels",
           "overlap_encoder": "overlap_encoder_labels",
           "overlap": "overlap_decoder_labels"}


def _shares(parts, batch, mesh):
    """Each part's share of its global mean: x (local count / global
    count), both at least 1 as the means divide (the part itself without a
    group)."""
    if dp_size(mesh) == 1:
        return parts
    names = list(parts)
    local = torch.stack([(batch[_LABELS[n]] != IGNORE_INDEX).sum().float()
                         for n in names])
    glob = all_reduce_sum(local, mesh)
    w = local.clamp(min=1.0) / glob.clamp(min=1.0)
    return {n: parts[n] * w[i] for i, n in enumerate(names)}


def _make(tx: AdamW, device, mesh: Optional[Mesh], dropout: bool,
          dropout_seed: int, electra_mask_id: Optional[int]) -> Callable:
    dev = mesh_device(mesh, device)

    def step(state: TrainState, batch: dict):
        _check_on(state.module, dev)
        batch = to_device(batch, dev)
        model = state.module
        if electra_mask_id is not None:
            batch = dict(batch)
            gather = rank = None
            if dp_size(mesh) > 1:
                rank = mesh.rank
                gather = functools.partial(all_gather_rows, mesh=mesh)
            batch["decoder_input_ids"], batch["input_ids"] = (
                generate_replaced_ids(model, batch, electra_mask_id, gather,
                                      rank or 0))
        gen = dropout_generator(dropout, dropout_seed, state.step,
                                0 if mesh is None else mesh.rank)
        forward = model.electra_forward if electra_mask_id is not None else (
            model)
        _, parts = forward(batch, generator=gen)
        parts = _shares(parts, batch, mesh)
        return _apply(state, sum(parts.values()), parts, tx, mesh)

    return step


def make_condenser_step(tx: AdamW, device=None, dropout: bool = False,
                        dropout_seed: int = 3,
                        mesh: Optional[Mesh] = None) -> Callable:
    """The Condenser's 8-loss step (``modeling.py:53-160``)."""
    return _make(tx, device, mesh, dropout, dropout_seed, None)


def make_electra_step(tx: AdamW, mask_id: int, device=None,
                      dropout: bool = False, dropout_seed: int = 4,
                      mesh: Optional[Mesh] = None) -> Callable:
    """The ELECTRA Condenser step (``MASTER/pretrain/trainer.py:35-93`` and
    ``ELECTRACondenserForPretraining.forward``): each step first corrupts
    the batch without gradient (the c_head's argmax at the [MASK]
    positions, conditioned on the nearest example's CLS in the global
    batch), then trains the 4-loss ELECTRA objective on the replaced
    inputs."""
    return _make(tx, device, mesh, dropout, dropout_seed, mask_id)
