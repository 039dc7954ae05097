"""A pool of gloo ranks for the tests that hold the port's data parallelism
to the JAX package's multi-device mesh, and the tasks the ranks run.

:class:`Pool` starts W worker processes (plain Python: no JAX, no pytest;
one torch thread each) in one gloo group, and in subgroups of the first w
ranks for every w < W, so that one pool serves every world size a test
file needs. ``pool.run(task, *args, world=w)`` calls ``task(mesh, *args)``
on ranks 0 .. w-1 (``mesh`` over the group of those w ranks) and returns
their results in rank order. A task is a function of this module, so a
worker imports nothing but torch, numpy and the port.
"""

import datetime
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import traceback
from multiprocessing.connection import Client, Listener

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
_KEY = b"simxns-torch-dist-tests"
# a stalled collective raises after this long in every rank of its group
GROUP_TIMEOUT_S = 120


class Pool:
    """W gloo ranks serving tasks; ``close()`` stops them."""

    def __init__(self, world: int, timeout_s: float = 120.0):
        self.world = world
        self.timeout_s = timeout_s
        old = socket.getdefaulttimeout()
        socket.setdefaulttimeout(timeout_s)   # bounds accept() below
        try:
            self._listener = Listener(("localhost", 0), authkey=_KEY)
        finally:
            socket.setdefaulttimeout(old)
        host, port = self._listener.address
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join([HERE, ROOT]))
        # the group meets in a file (no port to race for)
        self._dir = tempfile.mkdtemp(prefix="torch_dist_")
        store = os.path.join(self._dir, "store")
        self._procs = [subprocess.Popen(
            [sys.executable, "-c", "import torch_dist; torch_dist._serve()",
             host, str(port), str(rank), str(world), store],
            cwd=ROOT, env=env) for rank in range(world)]
        conns = {}
        try:
            for _ in range(world):
                conn = self._listener.accept()
                conns[conn.recv()] = conn
        except BaseException:
            self._kill()
            shutil.rmtree(self._dir, ignore_errors=True)
            raise
        self._conns = [conns[r] for r in range(world)]

    def run(self, task, *args, world=None, timeout_s=None):
        return self.submit(task, *args, world=world)(timeout_s)

    def submit(self, task, *args, world=None):
        """Start ``task`` on the ranks; -> ``wait(timeout_s=None)``, which
        returns what :meth:`run` returns (the caller may work meanwhile)."""
        w = self.world if world is None else world
        for conn in self._conns:
            conn.send((task, args, w))
        return lambda timeout_s=None: self._collect(w, timeout_s)

    def _collect(self, w, timeout_s):
        out = []
        for rank, conn in enumerate(self._conns):
            if not conn.poll(timeout_s or 4 * self.timeout_s):
                self._kill()
                raise TimeoutError(f"rank {rank} gave no answer")
            out.append(conn.recv())
        errors = [msg for kind, msg in out if kind == "error"]
        if errors:
            raise RuntimeError("\n".join(errors))
        return [msg for _, msg in out[:w]]

    def _kill(self):
        for p in self._procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    def close(self):
        for conn in getattr(self, "_conns", []):
            try:
                conn.send(None)
            except OSError:
                pass
        for p in self._procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        self._listener.close()
        shutil.rmtree(self._dir, ignore_errors=True)


def _serve():
    host, port, rank, world, store = sys.argv[1:6]
    rank, world = int(rank), int(world)
    import torch
    import torch.distributed as dist

    from simxns_tpu_torch.parallel.mesh import Mesh

    torch.set_num_threads(1)
    conn = Client((host, int(port)), authkey=_KEY)
    conn.send(rank)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    meshes = {world: Mesh.of_group(None, "cpu")}
    for w in range(1, world):        # every rank makes every group, in order
        group = dist.new_group(list(range(w)))
        if rank < w:
            meshes[w] = Mesh.of_group(group, "cpu")
    while True:
        msg = conn.recv()
        if msg is None:
            break
        task, args, w = msg
        try:
            out = task(meshes[w], *args) if rank < w else None
            conn.send(("ok", out))
        except BaseException:
            conn.send(("error", f"rank {rank}:\n{traceback.format_exc()}"))
    dist.destroy_process_group()


# --- the tasks --------------------------------------------------------------

def _local(x, mesh):
    from simxns_tpu_torch.parallel.mesh import shard_batch

    return shard_batch(x, mesh)


def gather_order(mesh, rows):
    """The full-grad gather of this rank's rows of ``arange(rows)``."""
    import torch

    from simxns_tpu_torch.parallel import all_gather_full_grad

    x = _local(torch.arange(rows, dtype=torch.float32).reshape(rows, 1), mesh)
    return all_gather_full_grad(x, mesh)[:, 0].numpy()


def gather_grads(mesh, x, w, mode):
    """d/dx of the group's sum of ``sum(gather(x_r) * w)`` for this rank's
    rows x_r of ``x``: each rank's term, backward through the gather."""
    import torch

    from simxns_tpu_torch.parallel import gather_in_batch_negatives

    xs = torch.from_numpy(_local(x, mesh)).requires_grad_(True)
    g = gather_in_batch_negatives(xs, mesh, mode)
    (g * torch.from_numpy(w)).sum().backward()
    return xs.grad.numpy()


def positive_offsets(mesh, local_batch):
    import torch

    from simxns_tpu_torch.parallel import gather_positive_offsets

    pos = torch.zeros(local_batch, dtype=torch.int32)
    return gather_positive_offsets(pos, local_batch, mesh).numpy()


def global_in_batch_nll(mesh, q, c, pos):
    """The in-batch NLL over the gathered contexts, summed over the group
    and divided by the global batch; the global count of correct."""
    import torch

    from simxns_tpu_torch.losses.contrastive import in_batch_nll
    from simxns_tpu_torch.parallel import all_gather_full_grad
    from simxns_tpu_torch.parallel.collectives import all_reduce_sum

    qs, cs, ps = (torch.from_numpy(_local(a, mesh)) for a in (q, c, pos))
    loss, correct = in_batch_nll(qs, all_gather_full_grad(cs, mesh), ps,
                                 reduction="sum")
    return (float(all_reduce_sum(loss, mesh)) / q.shape[0],
            int(all_reduce_sum(correct, mesh)))


def numpy_state(module):
    """A module's state as numpy arrays (what a task takes: tensors would
    cross the pipe as shared memory)."""
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def _model(kind_cfg, state):
    import torch

    from simxns_tpu_torch.models import (BiEncoder, BiEncoderConfig,
                                         ColBERT, ColBERTConfig, Condenser,
                                         CondenserConfig, CrossEncoder,
                                         CrossEncoderConfig)

    cls = {BiEncoderConfig: BiEncoder, CrossEncoderConfig: CrossEncoder,
           ColBERTConfig: ColBERT, CondenserConfig: Condenser}[type(kind_cfg)]
    model = cls(kind_cfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return model.eval()


def _flat_params(module):
    return {n: p.detach().numpy().copy() for n, p in module.named_parameters()}


def train_steps(mesh, kind, cfg, state, batches, tx_kw, step_kw,
                teacher=None):
    """``len(batches)`` steps of ``kind`` (``biencoder``, ``reranker`` or
    ``retriever``) on this rank's rows of each global batch. -> (metrics
    per step, the parameters after the last)."""
    from simxns_tpu_torch.parallel.mesh import shard_batch
    from simxns_tpu_torch.train import (TrainState, make_adamw,
                                        make_ar2_retriever_step,
                                        make_biencoder_step,
                                        make_reranker_step)

    model = _model(cfg, state)
    tx = make_adamw(**tx_kw)
    factory = {"biencoder": make_biencoder_step,
               "reranker": make_reranker_step,
               "retriever": make_ar2_retriever_step}[kind]
    step = factory(tx, device="cpu", mesh=mesh, **step_kw)
    ts = TrainState.create(model, tx)
    extra = () if teacher is None else (_model(*teacher),)
    metrics = []
    for b in batches:
        ts, m = step(ts, *extra, shard_batch(b, mesh))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, _flat_params(model)


def accum_step(mesh, cfg, state, batch, micro_steps, tx_kw):
    """One reranker update from ``with_grad_accum`` over this rank's rows,
    the gradients summed over the group. -> (global loss, parameters)."""
    import torch

    from simxns_tpu_torch.parallel import all_reduce_grads
    from simxns_tpu_torch.parallel.collectives import all_reduce_sum
    from simxns_tpu_torch.train import TrainState, make_adamw, steps

    model = _model(cfg, state)
    tx = make_adamw(**tx_kw)
    ts = TrainState.create(model, tx)
    vg = steps.with_grad_accum(
        lambda m, b: steps.reranker_loss(m, b, mesh=mesh), micro_steps)
    local = steps.to_device(_local(batch, mesh), torch.device("cpu"))
    (loss, _), grads = vg(model, local)
    ts.apply_gradients(all_reduce_grads(grads, mesh), tx)
    return float(all_reduce_sum(loss, mesh)), _flat_params(model)


def _index(mesh, store, mode, block_size):
    import torch

    from simxns_tpu_torch.index import MIPSIndex

    return MIPSIndex("cpu", block_size=block_size, mode=mode, mesh=mesh,
                     store_dtype={"f32": torch.float32,
                                  "int8": torch.int8}[store])


def index_build_update_search(mesh, store, mode, block_size, emb, queries,
                              k, updates):
    """build, search; then each ``(start, rows)`` of ``updates`` and a
    search after each. -> [(scores, ids), ...], this shard's row count."""
    idx = _index(mesh, store, mode, block_size)
    idx.build(emb)
    out = [idx.search(queries, k)]
    for start, rows in updates:
        idx.update_rows(start, rows)
        out.append(idx.search(queries, k))
    return out, idx.embeddings.shape[0]


def table_encode(table):
    """The tests' stand-in passage encoder: the table row of the second
    token over the live length (the JAX twin is the same expression)."""
    import torch

    table = torch.from_numpy(table)

    def encode(ids, mask):
        return table[ids[:, 1]] / mask.sum(dim=1, keepdim=True).float()

    return encode


def index_streaming_search(mesh, store, block_size, table, ids, chunk_size,
                           queries, k, max_resident_rows=None):
    """build_streaming from token ids (each rank its shard), then search.
    -> ((scores, ids), this shard's stored rows as f32, its live rows)."""
    idx = _index(mesh, store, "exact", block_size)
    idx.max_resident_rows = max_resident_rows
    idx.build_streaming(table_encode(table), ids, chunk_size=chunk_size,
                        wire_dtype=np.uint16)
    got = idx.search(queries, k)
    rows = (None if idx.embeddings is None
            else idx.embeddings.float().numpy())
    return got, rows, idx.shard_valid


def mine_records(mesh, emb, queries, texts, answers, k):
    """The mine over the sharded index (f32, exact) and what the launcher
    decides from it: -> (train records, top-k accuracy, each RecallGuard
    reading's verdict over the readings [top-1, then top-1 halved])."""
    from simxns_tpu_torch.index import MIPSIndex, RetrievalEngine
    from simxns_tpu_torch.train.driver import RecallGuard

    index = MIPSIndex("cpu", block_size=16, mode="exact", mesh=mesh)
    index.build(emb)
    passages = {i: (t, f"title{i}") for i, t in enumerate(texts)}
    res = RetrievalEngine(index, passages).mine(queries, [f"q{i}" for i in
                                                          range(len(answers))],
                                                answers, k=k)
    guard = RecallGuard()
    top1 = res.top_k_hits[0]
    verdicts = [guard.update(top1), guard.update(top1 / 2 - 1e-9)]
    return res.train_examples, res.top_k_hits, verdicts


def corpus_encode(mesh, table, ids, mask, chunk_size):
    from simxns_tpu_torch.index import CorpusEncoder

    enc = CorpusEncoder(table_encode(table), "cpu", chunk_size=chunk_size,
                        inflight=2, mesh=mesh)
    return enc(ids, mask)


def run_launcher(mesh, argv, die_after=None):
    """``simxns_tpu_torch.run.main(argv)`` on this rank (the group is the
    pool's whole world). ``die_after``: the co-training loop stops after
    that many steps and the run raises, as a crash would (rank 0's
    checkpoint write is let finish), -> None."""
    import threading

    from simxns_tpu_torch import run
    from simxns_tpu_torch.train import driver

    if die_after is None:
        return run.main(argv)
    real = driver.AR2CoTrainer.run

    def dying_run(self, num_steps=None):
        real(self, num_steps=die_after)
        raise KeyboardInterrupt("simulated crash")

    driver.AR2CoTrainer.run = dying_run
    try:
        run.main(argv)
    except KeyboardInterrupt:
        for t in threading.enumerate():
            if t.name.startswith("ckpt-"):
                t.join(timeout=120)
    finally:
        driver.AR2CoTrainer.run = real
    return None


# --- the rest of the mesh: tensor parallelism, multislice, serving ---------

_MESHES = {}


def _mesh_of(kind, *sizes):
    """The ``create_mesh(n_data, n_model)`` (``kind="tp"``) or
    ``create_multislice_mesh(n_slices, ...)`` (``"slices"``) of the pool's
    whole world, built once per worker (every rank makes the same
    subgroups in the same order)."""
    from simxns_tpu_torch.parallel import create_mesh, create_multislice_mesh

    key = (kind, sizes)
    if key not in _MESHES:
        if kind == "tp":
            n_data, n_model = sizes
            _MESHES[key] = create_mesh("cpu", n_data=n_data, n_model=n_model)
        else:
            _MESHES[key] = create_multislice_mesh(*sizes, device="cpu")
    return _MESHES[key]


def _split(cfg, state, mesh):
    from simxns_tpu_torch.parallel.tp import shard_params

    return shard_params(_model(cfg, state), mesh)


def tp_layout(mesh, cfg, state, n_data, n_model):
    """{name: split dim} of the module on this rank of (n_data, n_model),
    after checking that its split keeps 1 / n_model of each split dim."""
    from simxns_tpu_torch.parallel.tp import tp_param_shardings

    tp = _mesh_of("tp", n_data, n_model)
    model = _model(cfg, state)
    dims = tp_param_shardings(model, tp)
    full = {n: p.shape for n, p in model.named_parameters()}
    for name, p in _split(cfg, state, tp).named_parameters():
        want = list(full[name])
        if dims[name] is not None:
            want[dims[name]] //= n_model
        assert list(p.shape) == want, name
    return dims


def tp_train_steps(mesh, kind, cfg, state, batches, tx_kw, n_data, n_model,
                   teacher=None):
    """``biencoder`` or ``retriever`` steps with ``auto_state=True`` on a
    module split over the model axis (the teacher split too), this rank's
    rows of each global batch. -> (metrics per step, the full parameters
    gathered over the model group (rank 0), this rank's local shapes, the
    largest difference across model ranks of a whole parameter's gradient
    on the first batch)."""
    import torch

    from simxns_tpu_torch.parallel.mesh import shard_batch
    from simxns_tpu_torch.parallel.tp import (_all_gather, full_state_dict,
                                              tensor_parallel_of)
    from simxns_tpu_torch.train import (TrainState, make_adamw,
                                        make_ar2_retriever_step,
                                        make_biencoder_step, steps)

    tp = _mesh_of("tp", n_data, n_model)
    model = _split(cfg, state, tp)
    tx = make_adamw(**tx_kw)
    if kind == "biencoder":
        step = make_biencoder_step(tx, device="cpu", mesh=tp,
                                   auto_state=True)
        extra = ()
    else:
        step = make_ar2_retriever_step(tx, temperature=1.0, adv_lambda=0.5,
                                       device="cpu", mesh=tp,
                                       auto_state=True)
        extra = (_split(*teacher, tp),)
    ts = TrainState.create(model, tx)
    metrics = []
    for b in batches:
        ts, m = step(ts, *extra, shard_batch(b, tp))
        metrics.append({k: float(v) for k, v in m.items()})
    local = {n: tuple(p.shape) for n, p in model.named_parameters()}
    full = full_state_dict(ts)["params"]
    # a whole parameter's gradient is the same on every model rank
    b = steps.to_device(shard_batch(batches[0], tp), torch.device("cpu"))
    if kind == "biencoder":
        loss, _ = steps.biencoder_loss(model, b, mesh=tp)
    else:
        loss, _ = steps.retriever_loss(model, extra[0], b, 1.0, 0.5,
                                       adv_world_size=tp.world_size, mesh=tp)
    grads = steps.gradients(model, loss)
    split = tensor_parallel_of(model)[1]
    worst = 0.0
    for n, g in grads.items():
        if n in split or g is None:
            continue
        parts = _all_gather(g[None], tp.model_mesh, 0)
        worst = max(worst, float((parts - parts[0]).abs().max()))
    full = ({n: t.numpy() for n, t in full.items()}
            if tp.rank == 0 and tp.model_mesh.rank == 0 else None)
    return metrics, full, local, worst


def tp_paths(mesh, case, cfg, state, batch, n_model):
    """One forward and backward of the split module against the same
    module whole on this rank: ``attention`` (heads not divisible by the
    model size: q, k, v gathered), ``ffn_knob`` (the fused FFN on the
    gathered weights), ``int8_view`` (the fused-int8 encode view, no
    gradient) and ``mlm`` (an untied MLM head split over the vocabulary).
    -> (largest output difference, the output's largest magnitude,
    largest gradient difference, the largest gradient's magnitude)."""
    import torch

    from simxns_tpu_torch.models import BertEncoder, MLMHead
    from simxns_tpu_torch.models.dual_encoder import int8_view
    from simxns_tpu_torch.parallel.tp import _all_gather, _split_dim

    tp = _mesh_of("tp", mesh.world_size // n_model, n_model)
    ids = torch.from_numpy(batch["q_ids"]).long()
    mask = torch.from_numpy(batch["q_mask"]).long()
    if case == "mlm":
        bert = cfg

        def build():
            enc, head = BertEncoder(bert), MLMHead(bert, tied=False)
            enc.load_state_dict({k[4:]: torch.from_numpy(v)
                                 for k, v in state.items()
                                 if k.startswith("enc.")})
            head.load_state_dict({k[5:]: torch.from_numpy(v)
                                  for k, v in state.items()
                                  if k.startswith("head.")})
            return torch.nn.ModuleDict({"enc": enc, "head": head})

        def run(m):
            return m["head"](m["enc"](ids, mask).last_hidden_state)

        whole, split = build(), build()
    else:
        whole, split = _model(cfg, state), _model(cfg, state)

        def run(m):
            if case == "int8_view":
                with torch.no_grad():
                    return int8_view(m).encode_query(ids, mask)
            return m.encode_query(ids, mask)

    from simxns_tpu_torch.parallel.tp import shard_params

    shard_params(split, tp)
    want, got = run(whole), run(split)
    out_err = float((got - want).detach().abs().max())
    grad_err = grad_scale = 0.0
    if case != "int8_view":
        w = torch.linspace(-1, 1, want.numel()).reshape(want.shape)
        (want * w).sum().backward()
        (got * w).sum().backward()
        for (n, pw), (_, ps) in zip(whole.named_parameters(),
                                    split.named_parameters()):
            gs = ps.grad
            if gs is None and pw.grad is None:
                continue                 # the other tower
            dim = _split_dim(n, ps.ndim)
            if dim is not None:
                gs = _all_gather(gs, tp.model_mesh, dim)
            grad_err = max(grad_err, float((gs - pw.grad).abs().max()))
            grad_scale = max(grad_scale, float(pw.grad.abs().max()))
    return out_err, float(want.detach().abs().max()), grad_err, grad_scale


def tp_checkpoint(mesh, cfg, state, batch, tx_kw, directory, n_data, n_model):
    """One split step, then its full state written by rank 0; every rank
    loads it back into a fresh split state (``load_full_state``). ->
    (global loss, whether the reloaded slices and moments equal the live
    ones bit for bit)."""
    import torch

    from simxns_tpu_torch.io import restore_checkpoint, save_checkpoint
    from simxns_tpu_torch.parallel.collectives import barrier
    from simxns_tpu_torch.parallel.mesh import shard_batch
    from simxns_tpu_torch.parallel.tp import full_state_dict, load_full_state
    from simxns_tpu_torch.train import (TrainState, make_adamw,
                                        make_biencoder_step)

    tp = _mesh_of("tp", n_data, n_model)
    tx = make_adamw(**tx_kw)
    ts = TrainState.create(_split(cfg, state, tp), tx)
    ts, m = make_biencoder_step(tx, device="cpu", mesh=tp, auto_state=True)(
        ts, shard_batch(batch, tp))
    tree = full_state_dict(ts)
    if tp.rank == 0 and tp.model_mesh.rank == 0:
        save_checkpoint(directory, tree, 1, name="tp_state")
    barrier(mesh)
    fresh = TrainState.create(_split(cfg, state, tp), tx)
    load_full_state(fresh, restore_checkpoint(directory, None, 1,
                                              name="tp_state"))
    a, b = ts.state_dict(), fresh.state_dict()
    same = (all(torch.equal(a["params"][n], b["params"][n])
                for n in a["params"])
            and all(torch.equal(a["opt_state"][k][n], b["opt_state"][k][n])
                    for k in ("mu", "nu") for n in a["params"])
            and b["step"] == 1 and b["opt_state"]["count"] == 1)
    return float(m["loss"]), same


def multislice_facts(mesh):
    """The (2, W/2, 1) mesh's axes, sizes and place of this rank, and the
    error of a slice count the world does not divide by."""
    from simxns_tpu_torch.parallel import (create_multislice_mesh, dp_axes,
                                           dp_size)

    ms = _mesh_of("slices", 2)
    try:
        create_multislice_mesh(3, device="cpu")
        err = None
    except ValueError as e:
        err = str(e)
    return {"axis_names": ms.axis_names, "shape": ms.shape,
            "dp_axes": dp_axes(ms), "dp_size": dp_size(ms),
            "rank": ms.rank, "replica": ms.replica_index,
            "slice_rank": ms.within_slice.rank,
            "slice_size": ms.within_slice.world_size, "error": err}


def multislice_steps(mesh, cfg, state, batches, tx_kw, step_kw, flat):
    """Bi-encoder steps on the flat mesh of the pool's world (``flat``) or
    on 2 slices. -> (metrics per step, the parameters after the last)."""
    from simxns_tpu_torch.parallel.mesh import shard_batch
    from simxns_tpu_torch.train import (TrainState, make_adamw,
                                        make_biencoder_step)

    ms = mesh if flat else _mesh_of("slices", 2)
    model = _model(cfg, state)
    tx = make_adamw(**tx_kw)
    step = make_biencoder_step(tx, device="cpu", mesh=ms, **step_kw)
    ts = TrainState.create(model, tx)
    metrics = []
    for b in batches:
        ts, m = step(ts, shard_batch(b, ms))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, _flat_params(model)


def multislice_index(mesh, corpus, queries, k, block_size):
    """The exact f32 index on 2 slices: -> ((scores, ids), this rank's
    shard rows, its first global row)."""
    import torch

    from simxns_tpu_torch.index import MIPSIndex

    idx = MIPSIndex("cpu", block_size=block_size, mode="exact",
                    store_dtype=torch.float32, mesh=_mesh_of("slices", 2))
    idx.build(corpus)
    return idx.search(queries, k), idx.embeddings.shape[0], idx.shard_start


def sharded_retriever(mesh, cfg, state, passages, queries, k, block_size):
    """``DenseRetriever(mesh=...)`` over the pool's group of this task:
    index the passages, search the queries. -> hits as (id, score)."""
    from simxns_tpu_torch.data import HashTokenizer
    from simxns_tpu_torch.serve import DenseRetriever

    r = DenseRetriever(_model(cfg, state), HashTokenizer(vocab_size=1024),
                       mesh=mesh, max_q_length=16, max_ctx_length=24,
                       index_mode="exact", block_size=block_size,
                       encode_chunk=8, query_batch=4)
    r.index_corpus(passages)
    return [[(h.passage_id, h.score) for h in hits]
            for hits in r.search(queries, k=k)], r.index.embeddings.shape[0]


def kd_steps(mesh, teacher_type, cfg, state, teachers, batches, tx_kw, kw):
    """``make_kd_step`` steps on this rank's rows of each global batch;
    ``teachers`` {name: (cfg, state)}. -> (metrics per step, the
    parameters after the last)."""
    from simxns_tpu_torch.parallel.mesh import shard_batch
    from simxns_tpu_torch.train import TrainState, make_adamw, make_kd_step

    model = _model(cfg, state)
    tx = make_adamw(**tx_kw)
    step = make_kd_step(tx, teacher_type, device="cpu", mesh=mesh, **kw)
    frozen = {k: _model(*v) for k, v in teachers.items()}
    ts = TrainState.create(model, tx)
    metrics = []
    for b in batches:
        ts, m = step(ts, frozen, shard_batch(b, mesh))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, _flat_params(model)


def lead_steps(mesh, models, batches, sels, tx_kw, cfg_kw):
    """``make_lead_step`` steps on this rank's rows of each global batch;
    ``models`` {name: (cfg, state)}, every model's AdamW at ``tx_kw``.
    -> (metrics per step, {"<name>.<param>": the parameters after the
    last})."""
    from simxns_tpu_torch.parallel.mesh import shard_batch
    from simxns_tpu_torch.train import (LeadConfig, TrainState, make_adamw,
                                        make_lead_step)

    built = {k: _model(*v) for k, v in models.items()}
    tx = make_adamw(**tx_kw)
    step = make_lead_step(built, {k: tx for k in built},
                          LeadConfig(**cfg_kw), device="cpu", mesh=mesh)
    states = {k: TrainState.create(m, tx) for k, m in built.items()}
    metrics = []
    for b, (sel_s, sel_t) in zip(batches, sels):
        states, m = step(states, shard_batch(b, mesh), sel_s, sel_t)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, {f"{k}.{n}": p for k, m in built.items()
                     for n, p in _flat_params(m).items()}


def pretrain_steps(mesh, cfg, state, batches, tx_kw, electra_mask_id=None):
    """``make_condenser_step`` (or, with a mask id, ``make_electra_step``)
    steps on this rank's rows of each global batch. -> (metrics per step,
    the parameters after the last)."""
    from simxns_tpu_torch.parallel.mesh import shard_batch
    from simxns_tpu_torch.train import (TrainState, make_adamw,
                                        make_condenser_step,
                                        make_electra_step)

    model = _model(cfg, state)
    tx = make_adamw(**tx_kw)
    step = (make_condenser_step(tx, device="cpu", mesh=mesh)
            if electra_mask_id is None else
            make_electra_step(tx, electra_mask_id, device="cpu", mesh=mesh))
    ts = TrainState.create(model, tx)
    metrics = []
    for b in batches:
        ts, m = step(ts, shard_batch(b, mesh))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, _flat_params(model)
