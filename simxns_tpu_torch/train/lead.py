"""LEAD joint distillation step (port of ``simxns_tpu/train/lead.py``): up
to four models in one backward.

The reference trains or freezes any subset of {the student dual encoder
(db), a dual-encoder teacher (de), ColBERT (col), a cross-encoder (ce)} in
one step with one combined loss and an optimizer per model
(``LEAD/run_LEAD.py:43-276``). The terms (``LEAD/util.py:distill_loss``):

- the task NLL of each *trained* model (in-batch for db/de/col; grouped
  when a CE takes part, ``util.py:704-706``);
- the KL between db and each teacher's score distribution (both ways when
  the teacher trains too, ``:750-756``);
- the layer-reweighted KL over the selected layers' CLS-score
  distributions (``:539-559``), LEAD's core;
- the VIRT attention-map MSE between per-layer query x doc maps
  (``:531-537``) and, with a CE, the CE -> student attention-map KL.

The layer selections are index tensors (``index_select`` over the stacked
[L, ...] hiddens), so a re-draw every ``save_steps`` changes data, not the
program. A frozen model runs under ``torch.no_grad()`` (a ``frozen_views``
entry, e.g. a frozen CE's ``int8_view``, takes its forward); the trained
ones share one backward, and each is updated by its own optimizer.

Data parallelism (``mesh`` with a group): every model output is gathered
over the group (with gradients to every shard for a trained model, as
``all_gather_full_grad``), so each rank computes the global loss of the
JAX step over the whole batch; its share is that loss over W, and the
gradients are summed over the group (one all-reduce per trained model),
as in the other steps. The reported metrics are the global values.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from simxns_tpu_torch.losses.lead import (attention_map_kl, grouped_slice,
                                          layer_score_distill_loss,
                                          layer_scores_from_cls, pair_kl,
                                          query_doc_attention_maps, virt_loss)
from simxns_tpu_torch.models.colbert import maxsim_score
from simxns_tpu_torch.parallel.collectives import (all_gather_full_grad,
                                                   all_gather_rows,
                                                   all_reduce_grads)
from simxns_tpu_torch.parallel.mesh import Mesh, dp_size, mesh_device
from simxns_tpu_torch.train.state import TrainState
from simxns_tpu_torch.train.steps import _check_on, to_device

NAMES = ("db", "de", "col", "ce")


def ce_attention_targets(ce_attn_sel: torch.Tensor,  # [Lsel, B*M, H, Lj, Lj]
                         q_len: torch.Tensor,         # [B] incl CLS + SEP
                         d_len: torch.Tensor,         # [B*M] doc token count
                         sq: int, sd: int
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The CE attention maps' (query x doc) region at static shapes: the
    reference's ``att[:, 1:qlen-1, qlen:dend]`` (``LEAD/util.py:685-700``)
    as gathers with per-instance offsets, heads averaged first. -> (targets
    [Lsel, B*M, sq, sd], q_valid [B*M, sq], d_valid [B*M, sd]); the valid
    rows and columns are the content tokens (lengths less CLS and SEP)."""
    att = ce_attn_sel.mean(dim=2)                  # [Lsel, B*M, Lj, Lj]
    lsel, bm, lj = att.shape[0], att.shape[1], att.shape[-1]
    dev = att.device
    q_len_bm = q_len.repeat_interleave(bm // q_len.shape[0])
    rows = torch.clamp(1 + torch.arange(sq, device=dev), 0, lj - 1)
    cols = torch.clamp(q_len_bm[:, None] + torch.arange(sd, device=dev),
                       0, lj - 1)                  # [B*M, sd]
    picked = att[:, :, rows, :]                    # [Lsel, B*M, sq, Lj]
    targets = torch.gather(picked, 3, cols[None, :, None, :].expand(
        lsel, bm, sq, sd))
    q_valid = torch.arange(sq, device=dev)[None, :] < (q_len_bm - 2)[:, None]
    d_valid = torch.arange(sd, device=dev)[None, :] < (d_len - 2)[:, None]
    return targets, q_valid, d_valid


@dataclasses.dataclass(frozen=True)
class LeadConfig:
    distill_db: bool = True
    distill_de: bool = True
    distill_col: bool = False
    distill_ce: bool = False
    train_db: bool = True
    train_de: bool = False
    train_col: bool = False
    train_ce: bool = False
    layer_score: bool = True            # per-layer reweighted KL
    attention: bool = False             # VIRT attention MSE
    reweight: bool = True               # LEAD layer reweighting on
    temperature: float = 1.0
    layer_temperature: float = 1.0
    para_task: float = 1.0              # distill_para_db/de/col/ce
    para_dis: float = 1.0               # model-level KL weight
    para_layer: float = 1.0             # per-layer KL weight (no reweight)
    para_attention: float = 1.0


def make_lead_step(models: Dict[str, nn.Module], txs: Dict, cfg: LeadConfig,
                   frozen_views: Optional[Dict[str, nn.Module]] = None,
                   device=None, mesh: Optional[Mesh] = None) -> Callable:
    """``step(states, batch, sel_student, sel_teacher) -> (states,
    metrics)``: ``states`` a dict of ``TrainState`` (one per key of
    ``models``, each over that model), ``sel_*`` the selected layers'
    indices (lists or int tensors, of one length; the JAX factory's
    ``num_distill_layers`` is their length). The batch holds ``q_*``,
    ``ctx_*`` (M passages per query) and, with a CE, ``joint_*`` [N, M,
    Lj]. ``frozen_views`` substitutes a module for a FROZEN model's
    forward over the same parameters (the frozen CE's ``int8_view`` under
    ``--fast-teacher``; the reference wraps frozen models without DDP,
    ``LEAD/run_LEAD.py:65-73``)."""
    trained = [k for k in NAMES if getattr(cfg, f"train_{k}") and k in models]
    active = [k for k in NAMES if getattr(cfg, f"distill_{k}") and k in models]
    for k in frozen_views or {}:
        if k in trained:
            raise ValueError(
                f"frozen_views[{k!r}]: model is TRAINED — a quantized view "
                "has zero/failing gradients; views are for frozen models")
    dev = mesh_device(mesh, device)
    world = dp_size(mesh)

    def gather(x, name):
        if world == 1:
            return x
        return (all_gather_full_grad(x, mesh) if name in trained
                else all_gather_rows(x, mesh))

    def gather_layers(x, name):       # [Lsel, B, ...] over B
        return gather(x.transpose(0, 1).contiguous(), name).transpose(0, 1)

    def encoder_outputs(name, module, batch, sel):
        """Final scores, selected-layer scores, the selected layers'
        hiddens (db/de) or attention maps (ce), over the global batch."""
        if name == "ce":
            n, m, lj = batch["joint_ids"].shape
            out = module(batch["joint_ids"].reshape(n * m, lj),
                         batch["joint_mask"].reshape(n * m, lj),
                         group_size=m, output_attentions=cfg.attention)
            attn = None
            if cfg.attention:
                attn = gather_layers(torch.stack(out["attentions"])
                                     .index_select(0, sel), name)
            return {"final": gather(out["logits"], name),
                    "layer": gather_layers(out["per_layer_logits"]
                                           .index_select(0, sel), name),
                    "q_hid": None, "d_hid": None, "attn": attn}
        if name == "col":
            q_tok, d_tok = module(batch["q_ids"], batch["q_mask"],
                                  batch["ctx_ids"], batch["ctx_mask"])
            final = maxsim_score(gather(q_tok, name), gather(d_tok, name))
            return {"final": final, "layer": None, "q_hid": None,
                    "d_hid": None, "attn": None}
        q_emb, q_out = module.encode_query(batch["q_ids"], batch["q_mask"],
                                           output_hidden_states=True)
        d_emb, d_out = module.encode_passage(
            batch["ctx_ids"], batch["ctx_mask"], output_hidden_states=True)
        final = gather(q_emb, name).float() @ gather(d_emb, name).float().T
        q_sel = gather_layers(torch.stack(q_out.hidden_states[1:])
                              .index_select(0, sel), name)   # [Lsel,Q,Sq,H]
        d_sel = gather_layers(torch.stack(d_out.hidden_states[1:])
                              .index_select(0, sel), name)
        return {"final": final,
                "layer": layer_scores_from_cls(q_sel[:, :, 0], d_sel[:, :, 0]),
                "q_hid": q_sel, "d_hid": d_sel, "attn": None}

    def loss_fn(states, batch, sel_s, sel_t):
        q_mask = gather(batch["q_mask"], "")
        ctx_mask = gather(batch["ctx_mask"], "")
        n = q_mask.shape[0]
        m = ctx_mask.shape[0] // n
        use_grouped = cfg.distill_ce and "ce" in models
        target = (torch.zeros(n, dtype=torch.long, device=dev) if use_grouped
                  else torch.arange(n, device=dev) * m)

        outs = {}
        for name in active:
            sel = sel_s if name == "db" else sel_t
            module = (frozen_views or {}).get(name, states[name].module)
            with torch.set_grad_enabled(name in trained):
                o = encoder_outputs(name, module, batch, sel)
            if use_grouped and name != "ce":
                o["final"] = grouped_slice(o["final"], m)
                if o["layer"] is not None:
                    o["layer"] = grouped_slice(o["layer"], m)
            outs[name] = o

        loss = torch.zeros((), device=dev)
        metrics = {}

        def task_nll(scores):
            logp = torch.log_softmax(scores.float(), dim=1)
            return -logp.gather(1, target[:, None]).mean()

        for name in active:
            if name in trained:
                nll = task_nll(outs[name]["final"])
                metrics[f"loss_{name}"] = nll
                loss = loss + cfg.para_task * nll

        if "db" not in active:
            return loss, metrics
        db = outs["db"]
        for t_name in (k for k in active if k != "db"):
            t = outs[t_name]
            l_ts = pair_kl(db["final"], t["final"], cfg.temperature)
            metrics[f"loss_{t_name}_db_dis"] = l_ts
            term = l_ts
            if t_name in trained:
                l_st = pair_kl(t["final"], db["final"], cfg.temperature)
                metrics[f"loss_db_{t_name}_dis"] = l_st
                term = term + l_st
            loss = loss + cfg.para_dis * term

            if (cfg.layer_score and t["layer"] is not None
                    and db["layer"] is not None):
                l_layer, _ = layer_score_distill_loss(
                    t["layer"], db["layer"], target, cfg.temperature,
                    cfg.layer_temperature, cfg.reweight, cfg.para_layer)
                metrics[f"loss_{t_name}_db_layer_dis"] = l_layer
                loss = loss + l_layer

            if (cfg.attention and t["q_hid"] is not None
                    and db["q_hid"] is not None):
                q_len, d_len = q_mask.sum(-1), ctx_mask.sum(-1)
                l_att = virt_loss(
                    query_doc_attention_maps(t["q_hid"], t["d_hid"], q_len,
                                             d_len),
                    query_doc_attention_maps(db["q_hid"], db["d_hid"], q_len,
                                             d_len),
                    cfg.para_attention)
                metrics[f"loss_{t_name}_db_attention"] = l_att
                loss = loss + l_att

            if (cfg.attention and t_name == "ce" and t["attn"] is not None
                    and db["q_hid"] is not None):
                # CE attention -> the student's q x d map: the targets index
                # content tokens (joint row 1+i, doc column q_len+j); the
                # student towers carry CLS at 0, dropped on both sides
                q_hid = db["q_hid"][:, :, 1:]          # [Lsel, Q, Sq-1, H]
                d_hid = db["d_hid"][:, :, 1:]          # [Lsel, Q*m, Sd-1, H]
                lsel, qn, sq, hh = q_hid.shape
                sd = d_hid.shape[2]
                s_maps = torch.einsum(
                    "lqsh,lqmth->lqmst", q_hid.float(),
                    d_hid.reshape(lsel, qn, m, sd, hh).float()
                ).reshape(lsel, qn * m, sq, sd)
                targets, q_valid, d_valid = ce_attention_targets(
                    t["attn"], q_mask.sum(-1), ctx_mask.sum(-1), sq, sd)
                l_map = cfg.para_attention * attention_map_kl(
                    s_maps, targets, q_valid, d_valid)
                metrics["loss_ce_db_attention_map"] = l_map
                loss = loss + l_map
        return loss, metrics

    def step(states: Dict[str, TrainState], batch: dict, sel_s, sel_t):
        for k in trained:
            _check_on(states[k].module, dev)
        batch = to_device(batch, dev)
        sel_s = torch.as_tensor(sel_s, dtype=torch.long, device=dev)
        sel_t = torch.as_tensor(sel_t, dtype=torch.long, device=dev)
        for k in trained:
            for p in states[k].module.parameters():
                p.grad = None
        loss, metrics = loss_fn(states, batch, sel_s, sel_t)
        # this rank's share of the global loss; one backward for every model
        (loss / world).backward()
        new_states = dict(states)
        for k in trained:
            module = states[k].module
            grads = all_reduce_grads(
                {n: p.grad for n, p in module.named_parameters()}, mesh)
            new_states[k] = states[k].apply_gradients(grads, txs[k])
            for p in module.parameters():
                p.grad = None
        return new_states, {"loss": loss.detach(),
                            **{k: v.detach() for k, v in metrics.items()}}

    def step_loss(states, batch, sel_s, sel_t):
        """The step's combined loss and metrics, with no backward and no
        update (gradient checks)."""
        return loss_fn(states, to_device(batch, dev),
                       torch.as_tensor(sel_s, dtype=torch.long, device=dev),
                       torch.as_tensor(sel_t, dtype=torch.long, device=dev))

    step.loss = step_loss
    return step


__all__ = ["LeadConfig", "ce_attention_targets",
           "make_lead_step"]
