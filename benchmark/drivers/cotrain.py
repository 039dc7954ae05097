"""Traffic kind ``cotrain``: the steps of an AR2 co-training window.

Set-up makes the mined set and both models' weights from the seed, and
builds the program's co-training loop as a launcher does:
``AR2CoTrainer`` over ``make_reranker_step`` and
``make_ar2_retriever_step`` (the teacher is the live reranker's
``int8_view``), fed by ``MinedDataset.batches`` with SimANS negatives.
It drives that same trainer, with the window's settings (no logging, so
no per-step synchronisation, and the step functions as built), through
its first three steps (the steps the reference follows; they run both
kinds of step at the only shapes the traffic has), then to the end of
the step cycle. The first steps run in the fewest calls of
``AR2CoTrainer.run`` that let each model's first gradient be read from
Adam's first moment before its second step (:func:`segments`); each
call draws a new epoch, as each of the window's calls does. The window
runs whole step cycles (``iteration_step`` steps: the recipe's
reranker-to-retriever mix), one ``run`` call each, until ``--seconds``
have passed, and ends with a synchronisation.

The check, once the window has closed and the program is freed: the
reference draws the batches again and must find the same ones, then
trains its own copies of the seed's weights through the same three
steps. Compared (each the worst case, as a share):

- ``batches``: elements of the first three batches that differ;
- ``grad``: per leaf, the gap between the norms of each model's first
  gradient as the optimizer takes it (read from Adam's first moment
  after one update), over the larger of the reference leaf's norm and
  the median leaf's; the worst leaf of either model;
- ``grad_median``: the same gaps' median over each model's leaves, the
  larger of the two models' (the worst leaf is a different small leaf on
  every seed; the median is steady);
- ``reranker_grad_p90``: the same gaps' 90th percentile over the
  reranker's leaves. The reranker trains first, so its first gradient
  comes from the seed's weights and the first batch alone; the
  retriever's comes a step later through the int8 teacher quantized from
  the updated reranker, whose codes turn on the rounding of that update,
  and reads up to twice as far from the reference on some seeds. fp8
  products move most the leaves with the largest gradients (the output
  projections, the FFN's second product), which the 90th percentile
  reaches and the median does not;
- ``update``: the worst leaf's gap of each leaf's change after the three
  steps, leaves whose reference gradient is under a thousandth of the
  median leaf's left out (they move by round-off alone);
- ``moved_rows``: per token embedding table (a row per vocabulary id),
  the rows that the three steps moved, a row counted where its largest
  change passes a twentieth of the reference table's largest row change;
  the gap between the program's count and the reference's over the
  reference's, the worst table. A token's row moves only where the
  batches hold the token (Adam moves every element it has a gradient for
  by about the learning rate, weight decay alone by a few thousandths of
  that), so the count says which tokens of the batches the steps took
  in: a step that leaves out queries leaves their tokens' rows still,
  which the norms hardly see, Adam's first steps being of about the
  learning rate per element whatever the gradient.

Each step's loss is not read: the window's settings log none, and a
retriever step's loss on random weights takes the log of softmax tails
that rounding moves by 0.3-3.5%, so it would separate nothing.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark import data, weights, work
from benchmark.build import initial_weights, models, seeds
from benchmark.trace import TimedIterator

B1 = 0.9


def step_kinds(cfg: dict, n: int, start: int = 0):
    """The model each of steps ``start .. start + n - 1`` trains, by the
    recipe's window: the first ``iteration_reranker_step + 1`` of each
    ``iteration_step`` train the reranker (the reference's flag rule)."""
    r = cfg["recipe"]
    return ["reranker" if (s % r["iteration_step"]) <= r["iteration_reranker_step"]
            else "retriever" for s in range(start, start + n)]


def segments(kinds: list) -> list:
    """The lengths of the ``run`` calls that drive steps of ``kinds``: a
    call ends before a model's second step where its first step ran in
    the same call, so that each model's first moment is read after one
    update."""
    lengths, start, pending, seen = [], 0, set(), set()
    for i, k in enumerate(kinds):
        if k in pending:
            lengths.append(i - start)
            start, pending = i, set()
        if k not in seen:
            seen.add(k)
            pending.add(k)
    lengths.append(len(kinds) - start)
    return lengths


def _first_moment_norms(state):
    """The names of the leaves of Adam's first moment and their norms,
    left on the device (no synchronisation between steps)."""
    names = list(state.opt_state["mu"])
    return names, torch.stack(torch._foreach_norm(
        [state.opt_state["mu"][n] for n in names]))


def row_moves(names: list, diffs: list, tower: dict) -> dict:
    """Per token embedding table of a model (``tower``: its configuration),
    each row's largest absolute change, on the host."""
    return {n: d.abs().amax(1).float().cpu() for n, d in zip(names, diffs)
            if d.dim() == 2 and d.shape[0] == tower["vocab_size"]}


def _half(batch: dict) -> dict:
    """A planted fault: the first half of the queries only."""
    n = batch["q_ids"].shape[0] // 2
    m = batch["ctx_ids"].shape[0] // batch["q_ids"].shape[0]
    out = {k: v[:n] for k, v in batch.items()
           if k not in ("ctx_ids", "ctx_mask", "positive_idx")}
    out["ctx_ids"], out["ctx_mask"] = (batch["ctx_ids"][:n * m],
                                       batch["ctx_mask"][:n * m])
    out["positive_idx"] = batch["positive_idx"][:n]
    return out


def _alter_token(batch: dict) -> dict:
    """A planted fault: one token of each passage row changed where the
    data layer produces it."""
    out = dict(batch)
    for k in ("ctx_ids", "joint_ids"):
        a = np.array(batch[k])
        a[..., 3] ^= 1
        out[k] = a
    return out


def setup(cell):
    from simxns_tpu_torch.data.mined import MinedDataset
    from simxns_tpu_torch.models import cross_encoder
    from simxns_tpu_torch.train import (TrainState, make_adamw,
                                        make_ar2_retriever_step,
                                        make_reranker_step)
    from simxns_tpu_torch.train.driver import AR2Config, AR2CoTrainer

    cfg, p, dev = cell.config, cell.params, cell.device
    lengths, tok, recipe = cfg["lengths"], cfg["tokens"], cfg["recipe"]
    mined = data.mined_set(cell.seed, p["mined"], tok, lengths["query"],
                           lengths["passage"])
    cell.say("mined set made")
    de, ce = models(cfg, dev)
    cell.say("program imported, models built")
    for module, which in ((de, "retriever"), (ce, "reranker")):
        w = initial_weights(cfg, cell.seed, dev, which)
        weights.load_into(module, w)
        del w
    cell.say("weights made and loaded")

    def adamw(lr):
        return make_adamw(lr, total_steps=0,
                          weight_decay=recipe["weight_decay"],
                          max_grad_norm=recipe["max_grad_norm"])

    tx_de, tx_ce = adamw(recipe["retriever_lr"]), adamw(recipe["reranker_lr"])
    r_step = make_ar2_retriever_step(
        tx_de, temperature=1.0, adv_lambda=recipe["adv_lambda"],
        adv_world_size=recipe["adv_world_size"], device=dev)
    c_step = make_reranker_step(tx_ce, device=dev)
    if "half_batch" in cell.faults:
        r_inner, c_inner = r_step, c_step
        r_step = lambda s, t, b: r_inner(s, t, _half(b))   # noqa: E731
        c_step = lambda s, b: c_inner(s, _half(b))         # noqa: E731
    if "step_unchanged" in cell.faults:
        def r_step(s, t, b):
            return s, {"loss": torch.zeros(())}

        def c_step(s, b):
            return s, {"loss": torch.zeros(())}
    ds = MinedDataset(
        corpus_ids=mined["corpus_ids"], query_ids=mined["query_ids"],
        topk_ids=mined["topk_ids"], topk_scores=mined["topk_scores"],
        hit_mask=mined["hit_mask"], pad_id=tok["pad_id"],
        sep_id=tok["sep_id"], num_negatives=recipe["num_negatives"],
        max_joint_length=lengths["joint"], simans_mode=recipe["simans_mode"],
        simans_a=recipe["simans_a"], simans_b=recipe["simans_b"],
        simans_tau=recipe["simans_tau"], seed=seeds(cell.seed)["dataset"])
    kept: list = []
    alter = _alter_token if "alter_token" in cell.faults else None
    n_q = cfg["batch"]["queries"]

    def batches():
        return TimedIterator(ds.batches(n_q), cell.spans, "data.batch",
                             keep=kept, keep_max=3, alter=alter)

    de_state = TrainState.create(de, tx_de)
    ce_state = TrainState.create(ce, tx_ce)
    trainer = AR2CoTrainer(
        AR2Config(iteration_step=recipe["iteration_step"],
                  iteration_reranker_step=recipe["iteration_reranker_step"],
                  max_steps=1 << 62, batch_size=n_q, log_every=1 << 62),
        de_state, ce_state, r_step, c_step, batches,
        teacher=cross_encoder.int8_view(ce))
    cell.say("weights, traffic and trainer built")

    # the first three steps, through the window's own call: each model's
    # first gradient is read from Adam's first moment after its first
    # update, before its second
    kinds = step_kinds(cfg, 3)
    first: dict = {}
    for n in segments(kinds):
        done = trainer.global_step
        trainer.run(num_steps=n)
        for kind in kinds[done:done + n]:
            if kind not in first:
                st = trainer.ce_state if kind == "reranker" else \
                    trainer.de_state
                first[kind] = _first_moment_norms(st)
    first_grad = {k: {n: v / (1.0 - B1)
                      for n, v in zip(names, norms.tolist())}
                  for k, (names, norms) in first.items()}
    cell.say("first three steps done")
    change, rows = {}, {}
    for module, which in ((de, "retriever"), (ce, "reranker")):
        w0 = initial_weights(cfg, cell.seed, dev, which)
        names = sorted(w0)
        params = dict(module.named_parameters())
        diffs = torch._foreach_sub([params[n].detach() for n in names],
                                   [w0[n] for n in names])
        change[which] = dict(zip(names, torch.stack(
            torch._foreach_norm(diffs)).tolist()))
        rows[which] = row_moves(names, diffs, cfg[which])
        del w0, diffs
    # the first steps ran both kinds at the only shapes there are; the
    # rest of the cycle brings the window to a cycle's start
    cycle = recipe["iteration_step"]
    trainer.run(num_steps=(cycle - 3) % cycle)
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()
    return {"trainer": trainer, "mined": mined, "kept": kept,
            "first_grad": first_grad, "change": change, "rows": rows,
            "n_q": n_q}


def window(cell, state, seconds: float) -> dict:
    trainer = state["trainer"]
    cycle = cell.config["recipe"]["iteration_step"]
    on_card = torch.device(cell.device).type == "cuda"
    start = trainer.global_step
    t0 = time.perf_counter()
    while True:
        trainer.run(num_steps=cycle)
        if time.perf_counter() - t0 >= seconds:
            break
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = trainer.global_step - start
    kinds = step_kinds(cell.config, steps, start)
    counts = {k: kinds.count(k) for k in ("reranker", "retriever")}
    ops = {"bf16": 0.0, "int8": 0.0}
    for kind, n in counts.items():
        w = work.cotrain_step_work(cell.config, kind)
        ops["bf16"] += n * w["bf16"]
        ops["int8"] += n * w["int8"]
    return {"window_s": wall, "attempted": steps, "failed": 0,
            "e2e": {"train_step_ms": wall * 1e3 / steps},
            "work": {"steps": counts, "ops": ops}}


def _worst_leaf_gap(got: dict, want: dict, keep=None) -> float:
    """max over leaves of |got - want| / max(want, median of want)."""
    names = [n for n in want if keep is None or keep(n)]
    med = float(np.median([want[n] for n in names]))
    worst = 0.0
    for n in names:
        g = got.get(n, 0.0)
        worst = max(worst, abs(g - want[n]) / max(want[n], med, 1e-30))
    return worst


def _leaf_gap_quantile(got: dict, want: dict, q: float) -> float:
    """The ``q`` quantile over leaves of |got - want| / max(want, median of
    want)."""
    med = float(np.median(list(want.values())))
    return float(np.quantile([abs(got.get(n, 0.0) - w) / max(w, med, 1e-30)
                              for n, w in want.items()], q))


MOVED = 0.05


def _moved(rows: torch.Tensor, want: torch.Tensor) -> int:
    """Rows of a table whose largest change passes ``MOVED`` times the
    largest in the reference's ``want``."""
    return int((rows > MOVED * float(want.max())).sum())


def _moved_rows(got: dict, want: dict) -> float:
    """The worst table's gap between the rows moved in ``got`` and in
    ``want`` (per table, each row's largest change), over ``want``'s."""
    return max((abs((_moved(got[n], w) if n in got else 0) - _moved(w, w))
                / max(_moved(w, w), 1) for n, w in want.items()),
               default=0.0)


def _kept(grad: dict):
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's (the others move by round-off alone)."""
    med = float(np.median(list(grad.values())))
    return lambda n: grad[n] >= 1e-3 * med


def numbers(got: dict, ref: dict, batch_diff: int) -> dict:
    """The compared numbers of a run ``got`` ({"first_grad", "change",
    "rows"}) against the reference's ``ref`` ({"grad", "change",
    "rows"})."""
    grad = max(_worst_leaf_gap(got["first_grad"].get(k, {}), ref["grad"][k])
               for k in ref["grad"])
    grad_median = max(_leaf_gap_quantile(got["first_grad"].get(k, {}),
                                         ref["grad"][k], 0.5)
                      for k in ref["grad"])
    reranker_p90 = _leaf_gap_quantile(got["first_grad"].get("reranker", {}),
                                      ref["grad"]["reranker"], 0.9)
    upd = max(_worst_leaf_gap(got["change"][k], ref["change"][k],
                              keep=_kept(g)) for k, g in ref["grad"].items())
    rows = max(_moved_rows(got["rows"][k], ref["rows"][k])
               for k in ref["rows"])
    return {"batches": float(batch_diff), "grad": grad,
            "grad_median": grad_median, "reranker_grad_p90": reranker_p90,
            "update": upd, "moved_rows": rows}


def reference(cell, mined: dict, prec: str = "bf16"):
    """The reference's batches and its first three steps at ``prec``,
    the batches drawn as the program's calls draw them (a new epoch a
    call, :func:`segments`). -> (batches, {"loss", "grad", "change",
    "rows"})."""
    from benchmark.reference import bert
    from benchmark.reference.train import Batches, first_steps

    cfg, dev = cell.config, cell.device
    bert.set_precision()
    recipe = dict(cfg["recipe"], pad_id=cfg["tokens"]["pad_id"],
                  sep_id=cfg["tokens"]["sep_id"],
                  max_joint_length=cfg["lengths"]["joint"])
    draw = Batches(mined, recipe, seeds(cell.seed)["dataset"])
    kinds = step_kinds(cfg, 3)
    batches = []
    for n in segments(kinds):
        epoch = draw.epoch(cfg["batch"]["queries"])
        batches += [next(epoch) for _ in range(n)]
    de_w = initial_weights(cfg, cell.seed, dev, "retriever")
    ce_w = initial_weights(cfg, cell.seed, dev, "reranker")
    out = first_steps(batches, kinds, de_w, ce_w, cfg, dev, prec,
                      block=cell.params["check"]["block_queries"])
    change, rows = {}, {}
    for which, w0, w1 in (("retriever", de_w, out["de"]),
                          ("reranker", ce_w, out["ce"])):
        names = sorted(w0)
        diffs = [w1[n] - w0[n] for n in names]
        change[which] = {n: float(d.norm()) for n, d in zip(names, diffs)}
        rows[which] = row_moves(names, diffs, cfg[which])
    return batches, {"loss": out["loss"], "grad": out["grad"],
                     "change": change, "rows": rows}


def free_program(state) -> None:
    state.pop("trainer", None)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def check(cell, state) -> list:
    from benchmark.reference.train import batch_differences

    free_program(state)
    batches, ref = reference(cell, state["mined"])
    diff = sum(batch_differences(g, w)
               for g, w in zip(state["kept"], batches))
    if len(state["kept"]) < len(batches):
        diff += 1
    nums = numbers(state, ref, diff)
    state["ref"] = ref
    limits = cell.params["limits"]
    return [{"name": k, "value": v, "limit": limits[k]}
            for k, v in nums.items()]


def _gaps(got: dict, want: dict, keep=None) -> dict:
    names = [n for n in want if keep is None or keep(n)]
    med = float(np.median([want[n] for n in names]))
    gaps = {n: abs(got.get(n, 0.0) - want[n]) / max(want[n], med, 1e-30)
            for n in names}
    worst = max(gaps, key=gaps.get)
    return {"median_leaf": float(np.median(list(gaps.values()))),
            "p90_leaf": float(np.quantile(list(gaps.values()), 0.9)),
            "worst_leaf": worst, "worst": gaps[worst],
            "worst_got": got.get(worst, 0.0), "worst_want": want[worst],
            "median_want": med}


def details(state: dict) -> dict:
    """:func:`compare_details` of the program's readings (after
    :func:`check`)."""
    return compare_details(state, state["ref"])


def compare_details(got: dict, ref: dict) -> dict:
    """What lies under the compared numbers (for the calibration): each
    step's loss gap where ``got`` has losses (the control), and per model
    the median, 90th-percentile and worst leaf of the gradient and change
    gaps, and per token table the moved rows (``got``'s, the reference's,
    all)."""
    out = {}
    if "losses" in got:
        out["loss_by_step"] = [abs(a - b) / max(abs(b), 1e-30)
                               for a, b in zip(got["losses"], ref["loss"])]
    for k, g in ref["grad"].items():
        out["grad." + k] = _gaps(got["first_grad"].get(k, {}), g)
        out["update." + k] = _gaps(got["change"][k], ref["change"][k],
                                   keep=_kept(g))
        out["rows." + k] = {n: [_moved(got["rows"][k][n], w), _moved(w, w),
                                len(w)]
                            for n, w in ref["rows"][k].items()}
    return out


def control(cell, state) -> dict:
    """The control's numbers: the reference computed with fp8 products
    in the program's place, against the reference (after :func:`check`)."""
    _, ctrl = reference(cell, state["mined"], "fp8")
    got = {"losses": ctrl["loss"], "first_grad": ctrl["grad"],
           "change": ctrl["change"], "rows": ctrl["rows"]}
    state["control_details"] = compare_details(got, state["ref"])
    return numbers(got, state["ref"], 0)
