"""Command-line launcher of the AR2 co-training, PROD and LEAD distillation
and MASTER pre-training runs (port of ``simxns_tpu/run.py``).

    python -m simxns_tpu_torch.run --recipe nq_ar2_simans --synthetic
    python -m simxns_tpu_torch.run --recipe nq_ar2_simans --synthetic \\
        --device cpu --steps 12 --batch 8 --corpus-size 64 --num-queries 24
    python -m simxns_tpu_torch.run --recipe nq_ar2_simans \\
        --corpus corpus.npz --queries queries.npz \\
        --passages-tsv psgs_w100.tsv --output-dir runs/nq
    python -m simxns_tpu_torch.run --recipe prod_kd_marco --synthetic \\
        --device cpu --steps 8 --batch 8 --corpus-size 48 --num-queries 16

:func:`run_ar2` runs warm-up -> mine -> co-training windows -> a mine and
a checkpoint at each window boundary -> a final eval, on the card unless
``--device cpu``. Real data comes from ``scripts/prepare_data.py`` (packed
``.npz`` token arrays and a ``.qa.json`` sidecar); mined hits are labeled
by ``--passages-tsv``/``--para`` text (``has_answer``) or ``--qrels``
gold ids. Without ``--corpus`` a synthetic corpus is generated.

Outputs in ``--output-dir``: ``metrics.jsonl``, ``retriever_state-<step>``
and ``reranker_state-<step>`` checkpoints at each boundary (what
``--resume auto`` continues from), the final ``retriever``/``reranker``
parameters and ``eval.json``.

On N GPUs, one process per GPU, launched by ``torchrun``:

    python -m torch.distributed.run --standalone --nproc-per-node N \
        -m simxns_tpu_torch.run --recipe nq_ar2_simans ...

Each rank takes ``cuda:LOCAL_RANK`` (an explicit ``--device cuda:0`` keeps
that card on every rank), joins the group (``--dist-backend``: ``nccl`` on
cards, ``gloo`` on the CPU by default), iterates the same global batches
from the same seed and steps on its rows of each (the global batch must
divide by N); the index is sharded over the ranks and every rank mines the
same records. Rank 0 writes the metrics, checkpoints and outputs; every
rank restores on ``--resume auto``. The global batch, the losses and the
checkpoints are those of one device over the whole batch.

:func:`run_kd` runs a PROD distillation stage (``prod_kd_marco``,
``prod_kd_nq``, ``prod_kd_marcodoc``): the CE teacher (the student's BERT
at 12 layers, grouped small-S attention) warms up on reranker steps, then
the student dual encoder distils from it (``--fast-teacher``: through the
teacher's fused-int8 view). Outputs: ``kd_teacher_state-0``,
``student_state-<step>`` every ``steps // 5`` (what ``--resume auto``
continues from, with the warmed teacher restored), the final ``student``
parameters and ``eval.json``; under ``torchrun`` as ``run_ar2``.

:func:`run_lead` runs LEAD joint distillation (``lead_ms_distill``): the
6-layer student dual encoder and the 12-layer CE teacher warm up on
single-model steps, then train together under the joint step with a layer
re-draw every ``save_steps``; ``--freeze-teachers`` trains the student
alone and, with ``--fast-teacher``, runs the frozen CE through its
fused-int8 view. Outputs: ``lead_db_state``/``lead_ce_state`` at each
re-draw (what ``--resume auto`` continues from), the final ``student`` and
``teacher_ce`` and ``eval.json`` (the student's retrieval eval).

:func:`run_pretrain` runs MASTER pre-training (``master_pretrain``): the
8-stream masking collator (its native path when ``g++`` builds
``native/fast_collator.cc``) feeds the Condenser's multi-decoder
objective. Outputs: ``pretrain_state`` every ``steps // 5``, the
``encoder`` export (the Condenser without its heads) and ``eval.json``.
Both run under ``torchrun`` as ``run_ar2``.

    python -m simxns_tpu_torch.run --recipe lead_ms_distill --synthetic \
        --device cpu --steps 8 --batch 8 --corpus-size 48 --num-queries 16
    python -m simxns_tpu_torch.run --recipe master_pretrain --synthetic \
        --device cpu --steps 4 --batch 8

:func:`run_allies` runs ALLIES beam-search QA (``allies_qa``) over a tiny
dual encoder warmed on the synthetic corpus's gold pairs and a scripted
LLM; it writes ``eval.json`` (EM, F1, API calls and retrievals a
question).

    python -m simxns_tpu_torch.run --recipe allies_qa --synthetic \
        --device cpu --corpus-size 64 --num-queries 16

``--init-checkpoint`` warm-starts the AR2 retriever's towers, the KD and
LEAD students, the MASTER encoder (with its MLM head) and the CAPSTONE
dual encoder from a HF checkpoint (``hf_import``; BERT, RoBERTa, ELECTRA,
DistilBERT).

:func:`run_capstone` runs CAPSTONE's curriculum (``capstone_curriculum``):
a dual encoder trained on passages expanded with one doc2query query each,
chosen by the gradual curriculum, then evaluated over the corpus expanded
with its top-k queries. The queries come from ``--query-tsv``, from a T5
``--init-checkpoint`` with ``--t5-tokenizer`` (generated inline by
``models.t5``; the tokenizer loads through ``transformers``), or, on the
synthetic corpus, three made-up queries a passage. Outputs:
``curriculum_state-<step>`` every ``steps // 5``, the final ``retriever``
and ``eval.json`` (with ``--qrels`` the TREC metrics too).

    python -m simxns_tpu_torch.run --recipe capstone_curriculum \
        --synthetic --device cpu --steps 8 --batch 8 --corpus-size 48 \
        --num-queries 16 --query-tsv doc2query.tsv
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import sys
import threading
import time

import numpy as np
import torch

from simxns_tpu_torch.config import (AlliesRecipeConfig, AR2RecipeConfig,
                                     CapstoneRecipeConfig, KDRecipeConfig,
                                     LeadRecipeConfig, MasterPretrainConfig,
                                     RECIPES)
from simxns_tpu_torch.data import (CondenserCollator, HashTokenizer,
                                   TokenMeta, from_mining_result)
from simxns_tpu_torch.data.datasets import (load_id_text, load_passages_tsv,
                                            load_qrels)
from simxns_tpu_torch.index import CorpusEncoder, MIPSIndex, RetrievalEngine
from simxns_tpu_torch.io import (MetricLogger, export_encoder_only,
                                 latest_step, restore_checkpoint,
                                 save_checkpoint)
from simxns_tpu_torch.models import (BertConfig, BiEncoder, BiEncoderConfig,
                                     Condenser, CondenserConfig,
                                     CrossEncoder, CrossEncoderConfig,
                                     truncate_layers)
from simxns_tpu_torch.models import cross_encoder, dual_encoder
from simxns_tpu_torch.parallel.collectives import (all_gather_rows, barrier,
                                                   broadcast_int)
from simxns_tpu_torch.parallel.mesh import (create_mesh, local_batch_size,
                                            shard_batch)
from simxns_tpu_torch.parallel.offload import HostStash, host_copy, ready_event
from simxns_tpu_torch.parallel.sync import force_sync
from simxns_tpu_torch.parallel.watchdog import retry_on_stall
from simxns_tpu_torch.losses.lead import select_layers
from simxns_tpu_torch.train import (LeadConfig, TrainState, make_adamw,
                                    make_ar2_retriever_step,
                                    make_biencoder_step, make_kd_step,
                                    make_condenser_step, make_lamb,
                                    make_lead_step, make_reranker_step)
from simxns_tpu_torch.train.driver import (AR2Config, AR2CoTrainer,
                                           RecallGuard, check_teacher_warmth)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m simxns_tpu_torch.run",
        description="Run a SimXNS recipe (AR2/SimANS co-training, PROD and "
                    "LEAD distillation, MASTER pre-training, CAPSTONE, "
                    "ALLIES) on a CUDA card (or the CPU with --device "
                    "cpu).")
    ap.add_argument("--recipe", required=True, choices=sorted(RECIPES),
                    help="named configuration from simxns_tpu_torch.config."
                         "RECIPES")
    ap.add_argument("--corpus", default=None,
                    help="packed corpus .npz from scripts/prepare_data.py")
    ap.add_argument("--queries", default=None,
                    help="packed queries .npz (+ .qa.json sidecar)")
    ap.add_argument("--passages-tsv", default=None,
                    help="original psgs_w100.tsv (id/text/title) for "
                         "has_answer hit labeling on a prepared corpus")
    ap.add_argument("--para", default=None,
                    help="MARCO para.txt (id\\ttext) for hit labeling")
    ap.add_argument("--titles", default=None,
                    help="MARCO para.title.txt (id\\ttitle)")
    ap.add_argument("--qrels", default=None,
                    help="qrels file (qid\\tpid or TREC 4-col): label mined "
                         "hits by gold ids instead of string match")
    ap.add_argument("--query-tsv", default=None,
                    help="doc2query TSV (psg_id\\tq1\\tq2...) for the "
                         "capstone_curriculum recipe (what models.t5."
                         "doc2query_tsv writes)")
    ap.add_argument("--synthetic", action="store_true",
                    help="force the synthetic corpus even if --corpus given")
    ap.add_argument("--output-dir", default=None,
                    help="metrics.jsonl + checkpoints directory")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default cuda: under "
                         "torchrun cuda:LOCAL_RANK; an explicit index is "
                         "kept; the CPU runs each kernel's plain PyTorch "
                         "version)")
    ap.add_argument("--dist-backend", default=None,
                    help="torch.distributed backend under torchrun (default "
                         "nccl on cards, gloo on the CPU)")
    ap.add_argument("--steps", type=int, default=None,
                    help="override the recipe's max_steps")
    ap.add_argument("--batch", type=int, default=None,
                    help="override the recipe's global batch")
    ap.add_argument("--lr", type=float, default=None,
                    help="override the primary learning rate")
    ap.add_argument("--topk", type=int, default=None,
                    help="override mining depth k")
    ap.add_argument("--full-size", action="store_true",
                    help="use the recipe's full model shapes even on the "
                         "synthetic corpus (default: tiny models there)")
    ap.add_argument("--tiny-models", action="store_true",
                    help="force tiny model shapes even with a real corpus")
    ap.add_argument("--corpus-size", type=int, default=256,
                    help="synthetic corpus passage count (above 20,000 the "
                         "passages keep the recipe's token lengths)")
    ap.add_argument("--num-queries", type=int, default=64,
                    help="synthetic query count")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--int8-index", action="store_true",
                    help="int8 index storage (per-row codes + scales)")
    ap.add_argument("--index-mode", choices=["exact", "approx", "fused"],
                    default=None,
                    help="MIPS search mode (default: fused kernel on a card, "
                         "exact scan on the CPU)")
    ap.add_argument("--stall-timeout", type=float, default=None,
                    help="watchdog deadline in seconds for index build and "
                         "search syncs (default 600 for --full-size runs, "
                         "off otherwise; 0 disables)")
    ap.add_argument("--max-resident-rows", type=int, default=None,
                    help="index rows resident per search pass; a larger "
                         "corpus is searched in build->search->free passes "
                         "with a host top-k merge")
    ap.add_argument("--fast-encode", action="store_true",
                    help="mine through the fused int8 encode kernels (a view "
                         "over the training dual encoder's parameters)")
    ap.add_argument("--stream-build", choices=["auto", "on", "off"],
                    default="auto",
                    help="build the index on the device (encode -> quantize "
                         "-> write in place; uint16 token ids on the wire); "
                         "auto = on")
    ap.add_argument("--offload-mine",
                    choices=["auto", "on", "off", "overlap"], default="auto",
                    help="reranker state during mines: 'on' = synchronous "
                         "host stash; 'overlap' = the stash copy runs on a "
                         "worker thread under the index build; 'off' = "
                         "resident. auto = overlap for --full-size runs")
    ap.add_argument("--fast-teacher", action="store_true",
                    help="run the frozen reranker's forward (the AR2 "
                         "retriever step's teacher, the KD teacher) through "
                         "the fused int8 view of its parameters")
    ap.add_argument("--freeze-teachers", action="store_true",
                    help="LEAD: freeze the CE teacher (train only the "
                         "student, LEAD/run_LEAD.py:65-73); combine with "
                         "--fast-teacher for the int8 teacher view")
    ap.add_argument("--remat", choices=["recipe", "de", "ce", "both", "none"],
                    default="recipe",
                    help="activation checkpointing per model: 'ce' "
                         "recomputes only the reranker's layers in the "
                         "backward pass, 'de' only the retriever's, 'both' "
                         "and 'none' likewise; 'recipe' keeps the config")
    ap.add_argument("--warm-epochs", type=int, default=None,
                    help="override the warm-up epoch count; 0 skips warm-up")
    ap.add_argument("--resume", choices=["auto", "never"], default="auto",
                    help="auto: continue from the highest *_state checkpoint "
                         "in --output-dir; never: start fresh")
    ap.add_argument("--init-checkpoint", default=None,
                    help="HF PyTorch checkpoint (a pytorch_model.bin or its "
                         "directory) to warm-start the encoders from: the "
                         "AR2 retriever, the KD and LEAD students, the "
                         "MASTER encoder (and its MLM head), the CAPSTONE "
                         "dual encoder; a T5 artifact is CAPSTONE's "
                         "doc2query generator")
    ap.add_argument("--t5-tokenizer", default=None,
                    help="local HF T5 tokenizer directory that decodes the "
                         "doc2query generations (capstone_curriculum with a "
                         "T5 --init-checkpoint; needs transformers)")
    return ap


def _stall_timeout(args):
    timeout = args.stall_timeout
    if timeout is None:
        timeout = 600.0 if args.full_size else None
    elif timeout <= 0:
        timeout = None
    return timeout


def _index_kwargs(args, device: torch.device) -> dict:
    return {"mode": args.index_mode or ("fused" if device.type == "cuda"
                                        else "exact"),
            "stall_timeout_s": _stall_timeout(args),
            "max_resident_rows": args.max_resident_rows}


def _build_index(index: MIPSIndex, encode_fn, token_ids: np.ndarray,
                 mask: np.ndarray, vocab_size: int, args) -> None:
    """Build the index from token ids: on the device (encode -> quantize ->
    write in place, uint16 ids on the wire) unless ``--stream-build off``,
    which encodes through the host. ``mask`` is ``token_ids != 0``, what
    the device path derives, so the two paths are interchangeable."""
    chunk = min(1024, max(64, len(token_ids) // 4))
    if args.stream_build != "off":
        index.build_streaming(
            encode_fn, token_ids, chunk_size=chunk,
            wire_dtype=np.uint16 if vocab_size <= 0xFFFF else np.int32)
    else:
        enc = CorpusEncoder(encode_fn, index.device, chunk_size=chunk,
                            stall_timeout_s=_stall_timeout(args),
                            mesh=index.mesh)
        index.build(enc(token_ids, mask))


def _bert_cfg(recipe_bert: BertConfig, tiny: bool, vocab: int,
              joint: bool = False) -> BertConfig:
    if tiny:
        # 256 positions: the vectorized synthetic corpus keeps the recipe's
        # token lengths (joint rows reach 160)
        return BertConfig.tiny(vocab_size=vocab, max_position_embeddings=256)
    cfg = recipe_bert.replace(vocab_size=max(recipe_bert.vocab_size, vocab))
    if joint and cfg.small_s_attn is None:
        # joint (cross-encoder) rows below 256 tokens take the grouped
        # attention kernels (K5/K6), as the JAX launcher's CE towers do
        cfg = cfg.replace(small_s_attn="group")
    return cfg


def _load_init_checkpoint(args):
    """``--init-checkpoint``: load a HF PyTorch checkpoint once (a
    directory means its ``pytorch_model.bin``; tensors only, on the CPU)
    and convert it to the port's names. The reference warm-starts every
    published config from such an artifact (ERNIE-2.0/BERT, RoBERTa,
    ELECTRA, DistilBERT); the family is read from the keys. -> None
    without the flag, else ``{"family", "encoder", "mlm", "sd"}``."""
    if not args.init_checkpoint:
        return None
    from simxns_tpu_torch.models.hf_import import (convert_hf_auto,
                                                   sniff_hf_family)

    path = args.init_checkpoint
    if os.path.isdir(path):
        path = os.path.join(path, "pytorch_model.bin")
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if sniff_hf_family(sd) == "t5":
        # the docT5query generator: no encoder warm start
        print("init-checkpoint: t5 (doc2query generator)", file=sys.stderr)
        return {"family": "t5", "encoder": None, "mlm": None, "sd": sd}
    family, enc, mlm = convert_hf_auto(sd)
    n = len({k.split(".")[1] for k in enc if k.startswith("layers.")})
    print(f"init-checkpoint: {family} encoder, {n} layers", file=sys.stderr)
    return {"family": family, "encoder": enc, "mlm": mlm, "sd": sd}


def _init_bert_cfg(init, base_cfg: BertConfig, data_vocab: int) -> BertConfig:
    """A recipe's BertConfig reshaped around the warm-start artifact: every
    shape from the checkpoint, except the recipe's depth where it is the
    shallower (the PROD student takes a deeper model's first layers)."""
    from simxns_tpu_torch.models.hf_import import config_from_hf_params

    if init["family"] == "t5":
        raise SystemExit(
            "--init-checkpoint is a T5 (doc2query generator) artifact — "
            "it cannot warm-start a BERT-family encoder. Only "
            "capstone_curriculum consumes T5 checkpoints (to generate "
            "the expansion query TSV).")
    new = config_from_hf_params(init["encoder"], init["family"],
                                base=base_cfg)
    if base_cfg.num_layers < new.num_layers:
        new = new.replace(num_layers=base_cfg.num_layers)
    if new.hidden_size % new.num_heads:
        raise SystemExit(
            f"--init-checkpoint hidden_size {new.hidden_size} is not "
            f"divisible by the recipe's num_heads {new.num_heads}")
    if data_vocab > new.vocab_size:
        raise SystemExit(
            f"--init-checkpoint vocab ({new.vocab_size}) is smaller than "
            f"the corpus vocab ({data_vocab}) — the data was packed with a "
            "different tokenizer than the checkpoint's")
    return new


def _graft_encoder(model: torch.nn.Module, init, prefixes,
                   num_layers: int) -> None:
    """Copy the artifact's encoder (its first ``num_layers`` layers) into
    each encoder of ``model`` named by ``prefixes`` (e.g.
    ``"question_model.encoder"``), in place; the names must match
    exactly."""
    enc = truncate_layers(init["encoder"], num_layers)
    own = model.state_dict()
    graft = {}
    for prefix in prefixes:
        have = {k[len(prefix) + 1:] for k in own
                if k.startswith(prefix + ".")}
        if have != set(enc):
            raise ValueError(
                f"--init-checkpoint: {prefix} has parameters "
                f"{sorted(have ^ set(enc))[:4]} that the artifact does not "
                "match")
        graft.update({f"{prefix}.{k}": v for k, v in enc.items()})
    model.load_state_dict(graft, strict=False)


class _Corpus:
    """Token arrays and QA labels, from prepared .npz files or synthesized.

    ``positive_rows`` (optional) carries per-query gold row ids (qrels
    labeling); ``passages`` maps corpus row -> (text, title);
    ``tokenizer`` (synthetic text corpora only) encodes new text the way
    the corpus was encoded (ALLIES's expanded questions).
    """

    def __init__(self, corpus_ids, query_ids, questions, answers, passages,
                 vocab_size, sep_id, positive_rows=None, tokenizer=None):
        self.corpus_ids = corpus_ids
        self.query_ids = query_ids
        self.questions = questions
        self.answers = answers
        self.passages = passages
        self.vocab_size = vocab_size
        self.sep_id = sep_id
        self.positive_rows = positive_rows
        self.tokenizer = tokenizer

    @property
    def corpus_mask(self):
        return (self.corpus_ids != 0).astype(np.int32)

    @property
    def query_mask(self):
        return (self.query_ids != 0).astype(np.int32)


def _load_prepared(args) -> _Corpus:
    """Prepared token arrays and the labeling source for real mining:
    passage text (``has_answer``) or qrels gold ids. A token-only corpus
    with neither labels every hit False, so it warns."""
    corpus = np.load(args.corpus)
    queries = np.load(args.queries)
    corpus_ids = corpus["ids"].astype(np.int32)
    query_ids = queries["ids"].astype(np.int32)
    corpus_pids = (corpus["pids"] if "pids" in corpus
                   else np.arange(len(corpus_ids)))
    qa_path = args.queries + ".qa.json"
    if os.path.exists(qa_path):
        with open(qa_path, encoding="utf-8") as f:
            qa = json.load(f)
        questions = [r["question"] for r in qa]
        answers = [r["answers"] for r in qa]
    else:
        questions = [f"q{i}" for i in range(len(query_ids))]
        answers = [[] for _ in range(len(query_ids))]

    text_by_pid = None
    if args.passages_tsv:
        text_by_pid = {pid: (text, title) for pid, text, title
                       in load_passages_tsv(args.passages_tsv)}
    elif args.para:
        body = load_id_text(args.para)
        titles = load_id_text(args.titles) if args.titles else {}
        text_by_pid = {pid: (t, titles.get(pid, ""))
                       for pid, t in body.items()}
    passages = ({row: text_by_pid.get(int(pid), ("", ""))
                 for row, pid in enumerate(corpus_pids)}
                if text_by_pid is not None else {})

    positive_rows = None
    if args.qrels:
        qrels = load_qrels(args.qrels)
        pid_to_row = {int(p): r for r, p in enumerate(corpus_pids)}
        qids = (queries["pids"] if "pids" in queries
                else np.arange(len(query_ids)))
        positive_rows = [[pid_to_row[p] for p in qrels.get(str(int(q)), [])
                          if p in pid_to_row] for q in qids]
        n_labeled = sum(1 for r in positive_rows if r)
        print(f"qrels: {n_labeled}/{len(positive_rows)} queries have gold "
              "passages in this corpus", file=sys.stderr)

    if text_by_pid is None and positive_rows is None:
        print("WARNING: corpus is token-only and no --passages-tsv/--para "
              "or --qrels was given: mined hit labels will be ALL-FALSE. "
              "Pass the original text for has_answer matching or qrels for "
              "id labeling.", file=sys.stderr)

    vocab = int(max(corpus_ids.max(), query_ids.max())) + 1
    # the packer records its separator id; older files were packed with 2
    sep_id = int(corpus["sep_id"]) if "sep_id" in corpus else 2
    return _Corpus(corpus_ids, query_ids, questions, answers, passages,
                   vocab_size=max(vocab, 512), sep_id=sep_id,
                   positive_rows=positive_rows)


def _gold_warm(data: _Corpus, k: int):
    """A synthetic "gold" mining result for the warm-up: each query leads
    with its gold row (``positive_rows``) or, without labels, row i (the
    demo corpus's diagonal), then the next k-1 rows modulo the corpus."""
    n_c = len(data.corpus_ids)
    nq = len(data.query_ids)
    pos = data.positive_rows
    leads, labeled = [], []
    for i in range(nq):
        if pos is not None:
            leads.append(int(pos[i][0]) if pos[i] else 0)
            labeled.append(bool(pos[i]))
        else:
            leads.append(i % n_c)
            labeled.append(True)
    return type("R", (), {
        "topk_ids": np.stack(
            [np.r_[p, (np.arange(1, k) + p) % n_c] for p in leads]),
        "topk_scores": np.tile(np.linspace(5, 1, k, dtype=np.float32),
                               (nq, 1)),
        "hits": [[j == 0 and lab for j in range(k)] for lab in labeled]})()


class _FactPassages:
    """Lazy row -> (text, title) of the vectorized synthetic corpus (an
    eager dict of formatted strings would cost gigabytes at full scale)."""

    def __init__(self, n: int):
        self.n = n

    def _make(self, i: int):
        return (f"document {i} mentions fact{i} and topic{i % 7}",
                f"title{i}")

    def __getitem__(self, i):
        if not 0 <= i < self.n:
            raise KeyError(i)
        return self._make(int(i))

    def get(self, i, default=("", "")):
        return self._make(int(i)) if 0 <= i < self.n else default

    def __len__(self):
        return self.n

    def __contains__(self, i):
        return 0 <= i < self.n


def _synthesize_vectorized(args, data_cfg) -> _Corpus:
    """Synthetic corpus at the recipe's token lengths (``max_ctx_length``,
    ``max_q_length``): passage i carries a unique 4-digit base-64 token
    signature that its query repeats over a common low-entropy background,
    and the lazy text carries ``fact{i}``, so mined hits label through the
    same ``has_answer`` match as a real corpus."""
    n, q = args.corpus_size, min(args.num_queries, args.corpus_size)
    lc = data_cfg.max_ctx_length
    lq = data_cfg.max_q_length
    CLS, SEP, BASE = 1, 3, 5
    JUNK_LO, JUNK_HI = BASE + 4 * 64, BASE + 4 * 64 + 16
    rng = np.random.default_rng(args.seed)

    def signature(idx):
        digits = [(idx // 64 ** d) % 64 for d in range(4)]
        return np.stack([BASE + d * 64 + dig
                         for d, dig in enumerate(digits)], axis=-1)

    corpus_ids = rng.integers(JUNK_LO, JUNK_HI, size=(n, lc)).astype(np.int32)
    corpus_ids[:, 0] = CLS
    corpus_ids[:, 1:5] = signature(np.arange(n))
    corpus_ids[:, lc - 1] = SEP
    q_rows = rng.permutation(n)[:q]
    query_ids = rng.integers(JUNK_LO, JUNK_HI, size=(q, lq)).astype(np.int32)
    query_ids[:, 0] = CLS
    query_ids[:, 1:5] = signature(q_rows)
    take = min(lq - 6, lc - 5)
    if take > 0:
        query_ids[:, 5:5 + take] = corpus_ids[q_rows, 5:5 + take]
    query_ids[:, lq - 1] = SEP
    questions = [f"document {p} fact{p}" for p in q_rows]
    answers = [[f"fact{p}"] for p in q_rows]
    return _Corpus(corpus_ids, query_ids, questions, answers,
                   _FactPassages(n), vocab_size=512, sep_id=SEP,
                   positive_rows=[[int(p)] for p in q_rows])


def _synthesize(args, data_cfg) -> _Corpus:
    """Topic-structured synthetic corpus: query i's answer is ``fact{i}``.
    Passages are capped at 32 tokens and queries at 16; above 20,000
    passages :func:`_synthesize_vectorized` keeps the recipe's lengths."""
    if args.corpus_size > 20_000:
        return _synthesize_vectorized(args, data_cfg)
    tok = HashTokenizer(vocab_size=2048)
    n, q = args.corpus_size, min(args.num_queries, args.corpus_size)
    lc = min(data_cfg.max_ctx_length, 32)
    lq = min(data_cfg.max_q_length, 16)
    passages = {i: (f"document {i} mentions fact{i} and topic{i % 7}",
                    f"title{i}") for i in range(n)}
    corpus_ids = np.zeros((n, lc), np.int32)
    for i in range(n):
        enc = tok.encode(passages[i][1], text_pair=passages[i][0],
                         max_length=lc)
        corpus_ids[i, : len(enc)] = enc
    questions = [f"document {i} fact{i}" for i in range(q)]
    answers = [[f"fact{i}"] for i in range(q)]
    query_ids = np.zeros((q, lq), np.int32)
    for i, text in enumerate(questions):
        enc = tok.encode(text, max_length=lq)
        query_ids[i, : len(enc)] = enc
    return _Corpus(corpus_ids, query_ids, questions, answers, passages,
                   vocab_size=2048, sep_id=tok.sep_token_id, tokenizer=tok)


def _get_corpus(args, data_cfg) -> _Corpus:
    if args.corpus and args.queries and not args.synthetic:
        return _load_prepared(args)
    if args.corpus or args.queries:
        print("note: --corpus/--queries incomplete; using synthetic corpus",
              file=sys.stderr)
    return _synthesize(args, data_cfg)


def _resume_step(args, name: str, mesh=None):
    """Highest saved ``<name>-<step>`` in --output-dir from a run of the
    same recipe, or None (``--resume never``, no directory, or another
    recipe's checkpoints: restoring those would be silent corruption).
    Under a group rank 0 decides and every rank gets its answer."""
    if not args.output_dir or args.resume == "never":
        return None
    step = -1
    if mesh is None or mesh.rank == 0:
        found = _scan_resume(args, name)
        step = -1 if found is None else found
    step = broadcast_int(step, mesh)
    return None if step < 0 else step


def _scan_resume(args, name: str):
    meta_path = os.path.join(args.output_dir, "run_meta.json")
    prev = None
    if os.path.exists(meta_path):
        with open(meta_path, encoding="utf-8") as f:
            prev = json.load(f).get("recipe")
    step = latest_step(args.output_dir, name=name)
    if step is not None and prev != args.recipe:
        print(f"note: {args.output_dir} holds checkpoints from recipe "
              f"{prev!r}, not {args.recipe!r}; starting fresh",
              file=sys.stderr)
        step = None
    with open(meta_path, "w", encoding="utf-8") as f:
        json.dump({"recipe": args.recipe}, f)
    return step


def _make_optim(optim_cfg, lr_override=None, steps=None):
    lr = lr_override if lr_override is not None else optim_cfg.learning_rate
    total = steps if steps is not None else optim_cfg.total_steps
    factory = make_lamb if optim_cfg.optimizer == "lamb" else make_adamw
    return factory(lr, warmup_steps=min(optim_cfg.warmup_steps, total // 4),
                   total_steps=total, weight_decay=optim_cfg.weight_decay,
                   max_grad_norm=optim_cfg.max_grad_norm)


def _int8_view(model, make_view):
    """The fused-int8 encode view of ``model``, or ``model`` itself when
    its config cannot take it (the kernels compute exact erf GELU)."""
    if model.cfg.bert.gelu != "exact":
        print("WARNING: --fast-encode/--fast-teacher need gelu='exact' (the "
              "fused kernels compute erf); staying on the bf16 composition.",
              file=sys.stderr)
        return model
    return make_view(model)


def init_models(de_cfg: BiEncoderConfig, ce_cfg: CrossEncoderConfig,
                seed: int):
    """The initial dual encoder and reranker (AR2; KD's student and
    teacher), with the JAX package's initializers drawn from
    ``torch.Generator``s seeded ``seed`` and ``seed + 1``."""
    de = BiEncoder(de_cfg, generator=torch.Generator().manual_seed(seed))
    ce = CrossEncoder(ce_cfg,
                      generator=torch.Generator().manual_seed(seed + 1))
    return de, ce


def run_kd(name: str, cfg: KDRecipeConfig, args) -> dict:
    """PROD progressive distillation stage (``PROD/README.md`` pipeline): a
    student dual encoder distilled from a warmed cross-encoder teacher."""
    t_start = time.time()
    mesh = create_mesh(args.device, backend=args.dist_backend,
                       timeout_s=_stall_timeout(args))
    device = mesh.device
    lead = mesh.rank == 0
    say = print if lead else (lambda *a, **kw: None)
    data = _get_corpus(args, cfg.data)
    tiny = args.tiny_models or (
        not args.full_size and not (args.corpus and not args.synthetic))
    logger = MetricLogger(args.output_dir, rank=mesh.rank)
    steps = args.steps if args.steps is not None else (
        60 if tiny else cfg.max_steps)
    batch_size = min(args.batch or cfg.global_batch, len(data.query_ids))
    local_batch_size(batch_size, mesh)      # raises unless W divides it
    negs = min(cfg.data.num_negatives, 7, len(data.corpus_ids) - 1)
    lj = min(cfg.data.max_joint_length,
             data.query_ids.shape[1] + data.corpus_ids.shape[1] + 1)

    s_bert = _bert_cfg(cfg.student.bert, tiny, data.vocab_size)
    # the teacher: the student's BERT at 12 layers, a joint tower
    t_bert = _bert_cfg(cfg.student.bert.replace(num_layers=12), tiny,
                       data.vocab_size, joint=True)
    if args.remat != "recipe":
        s_bert = s_bert.replace(remat=args.remat in ("de", "both"))
        t_bert = t_bert.replace(remat=args.remat in ("ce", "both"))
    # --init-checkpoint: the PROD student init, the first layers of a
    # deeper HF checkpoint (ERNIE-2.0, ProD_KD/model/models.py:33-60)
    init = _load_init_checkpoint(args)
    if init is not None:
        s_bert = _init_bert_cfg(init, s_bert, data.vocab_size)
    # the student at seed, the teacher at seed + 1, as the JAX launcher
    student, teacher = init_models(BiEncoderConfig(bert=s_bert),
                                   CrossEncoderConfig(bert=t_bert), args.seed)
    if init is not None:
        _graft_encoder(student, init, ("question_model.encoder",
                                       "ctx_model.encoder"),
                       s_bert.num_layers)
    student, teacher = student.to(device), teacher.to(device)
    kd_lr = args.lr if args.lr is not None else (1e-3 if tiny else None)
    tx = _make_optim(cfg.optim, kd_lr, steps)
    state = TrainState.create(student, tx)

    gold = _gold_warm(data, negs + 1)
    ds = from_mining_result(data.corpus_ids, data.query_ids, gold,
                            num_negatives=negs, max_joint_length=lj,
                            sep_id=data.sep_id, seed=args.seed,
                            simans_mode=None)

    # teacher warm-up (the pipeline's CE stage precedes distillation); a
    # relaunch restores the warmed teacher instead (the reference reloads
    # --teacher_model_path)
    t_tx = _make_optim(cfg.optim, kd_lr, steps)
    t_state = TrainState.create(teacher, t_tx)
    resume_step = _resume_step(args, "student_state", mesh)
    writer = bool(args.output_dir) and lead
    group = mesh if mesh.distributed else None

    def save(st: TrainState, step: int, ckpt: str, params_only=False):
        if not args.output_dir:
            return
        tree = None
        if writer:
            tree = host_copy(st.state_dict(), device)
            if params_only:
                tree = {"params": tree["params"]}
        save_checkpoint(args.output_dir, tree, step, name=ckpt, mesh=group)

    if resume_step is not None:
        restore_checkpoint(args.output_dir, t_state, 0,
                           name="kd_teacher_state")
        say(f"[{name}] resumed at step {resume_step}")
    else:
        ce_step = _on_shard(make_reranker_step(t_tx, device, mesh=mesh),
                            mesh)
        with logger.timed("teacher_warmup"):
            for _ in range(max(1, steps // 8)):
                for b in ds.batches(batch_size=batch_size):
                    t_state, _ = ce_step(t_state, {
                        "joint_ids": b["joint_ids"],
                        "joint_mask": b["joint_mask"]})
            force_sync(device)
        save(t_state, 0, "kd_teacher_state")

    # --fast-teacher: the frozen teacher's forwards run through the fused
    # int8 view of its Parameters
    kd_teacher = (_int8_view(teacher, cross_encoder.int8_view)
                  if args.fast_teacher else teacher)
    step = _on_shard(make_kd_step(
        tx, cfg.teacher_type, kd_type=cfg.kd_type,
        temperature=cfg.temperature, ce_weight=cfg.ce_weight,
        kd_weight=cfg.kd_weight, lwf_weight=cfg.lwf_weight,
        dkd_alpha=cfg.dkd_alpha, dkd_beta=cfg.dkd_beta, device=device,
        mesh=mesh), mesh)
    # the JAX launcher passes the CE teacher alone: the recipe's LwF term
    # (lwf_weight 1.0) has no "student_init" teacher and stays 0
    teachers = {"ce": kd_teacher}
    done, last = 0, float("nan")
    save_every = max(1, steps // 5)
    if resume_step is not None:
        restore_checkpoint(args.output_dir, state, resume_step,
                           name="student_state")
        done = resume_step
    with logger.timed("kd"):
        while done < steps:
            for b in ds.batches(batch_size=batch_size):
                state, m = step(state, teachers, b)
                done += 1
                last = float(m["loss"])
                if done % max(1, steps // 10) == 0:
                    logger.log(done, {"loss": last}, phase="kd")
                if done % save_every == 0:
                    save(state, done, "student_state")
                if done >= steps:
                    break
    out = {"recipe": name, "steps": done, "final_loss": last,
           "total_s": time.time() - t_start,
           "phase_times_s": dict(logger.phase_times),
           "world_size": mesh.world_size}
    if device.type == "cuda":
        out["max_memory_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    save(state, done, "student", params_only=True)
    if writer:
        with open(os.path.join(args.output_dir, "eval.json"), "w",
                  encoding="utf-8") as f:
            json.dump(out, f, indent=1)
    logger.close()
    say(f"[{name}] distilled {done} steps, loss={last:.4f}")
    return out


def run_ar2(name: str, cfg: AR2RecipeConfig, args) -> dict:
    """AR2/SimANS co-training: warm-up -> mine -> alternating co-training
    with a mine at every window boundary -> final eval
    (``SimANS/train_NQ_AR2.sh:15-50``, ``co_training_wiki_train.py:
    606-693``)."""
    t_start = time.time()
    # under torchrun: this rank's card and the group; else a world of one
    mesh = create_mesh(args.device, backend=args.dist_backend,
                       timeout_s=_stall_timeout(args))
    device = mesh.device
    lead = mesh.rank == 0
    say = print if lead else (lambda *a, **kw: None)
    data = _get_corpus(args, cfg.data)
    tiny = args.tiny_models or (
        not args.full_size and not (args.corpus and not args.synthetic))
    logger = MetricLogger(args.output_dir, rank=mesh.rank)
    steps = args.steps if args.steps is not None else (
        60 if tiny else cfg.max_steps)
    batch_size = args.batch if args.batch is not None else cfg.global_batch
    batch_size = min(batch_size, len(data.query_ids))
    local_batch_size(batch_size, mesh)      # raises unless W divides it
    topk = args.topk if args.topk is not None else cfg.topk
    topk = min(topk, len(data.corpus_ids))
    # tiny models cannot rank 15 hard negatives from scratch; the synthetic
    # demo's working point is 3
    negs = min(cfg.data.num_negatives, topk - 1, 3 if tiny else 10**9)

    de_bert = _bert_cfg(cfg.retriever.bert, tiny, data.vocab_size)
    ce_bert = _bert_cfg(cfg.reranker.bert, tiny, data.vocab_size, joint=True)
    if args.remat != "recipe":
        de_bert = de_bert.replace(remat=args.remat in ("de", "both"))
        ce_bert = ce_bert.replace(remat=args.remat in ("ce", "both"))
    # --init-checkpoint warms the retriever's towers (the reference's DE
    # warm starts: ERNIE/BERT for wiki and MARCO, RoBERTa for MS-Doc); the
    # reranker keeps the recipe's config (its warm start is a trained CE)
    init = _load_init_checkpoint(args)
    if init is not None:
        de_bert = _init_bert_cfg(init, de_bert, data.vocab_size)
    # the RobertaDot projection head only for full-size runs: an extra
    # random layer stalls the tiny from-scratch warm-up
    proj = None if tiny else cfg.retriever.projection_dim
    de, ce = init_models(
        BiEncoderConfig(bert=de_bert, share_weight=cfg.retriever.share_weight,
                        pooling=cfg.retriever.pooling, projection_dim=proj),
        CrossEncoderConfig(bert=ce_bert,
                           binary_head=cfg.reranker.binary_head),
        args.seed)
    if init is not None:
        _graft_encoder(de, init, ("question_model.encoder",) if
                       cfg.retriever.share_weight else
                       ("question_model.encoder", "ctx_model.encoder"),
                       de_bert.num_layers)
    de, ce = de.to(device), ce.to(device)
    lj = min(cfg.data.max_joint_length,
             data.query_ids.shape[1] + data.corpus_ids.shape[1] + 1)

    # the recipe learning rates assume warm checkpoints; the tiny synthetic
    # run trains from scratch at warm-up-scale rates, co-training 10x lower
    de_lr = args.lr if args.lr is not None else (3e-3 if tiny else None)
    ce_lr = (args.lr if args.lr is not None else 1e-3) if tiny else None
    if tiny:
        tx_de = make_adamw(de_lr * 0.1, total_steps=0)
        tx_ce = make_adamw(ce_lr * 0.1, total_steps=0)
    else:
        tx_de = _make_optim(cfg.retriever_optim, de_lr, steps)
        tx_ce = _make_optim(cfg.reranker_optim, ce_lr, steps)
    # warm-up has its own constant-lr optimizers (a separate job in the
    # reference; the co-training schedule would decay it to zero)
    tx_warm_de = make_adamw(de_lr or cfg.retriever_optim.learning_rate,
                            total_steps=0)
    tx_warm_ce = make_adamw(ce_lr or cfg.reranker_optim.learning_rate,
                            total_steps=0)
    # the resume scan runs before warm-up: a relaunch skips it
    resume_step = _resume_step(args, "retriever_state", mesh)
    de_state = TrainState.create(de, tx_warm_de)
    ce_state = TrainState.create(ce, tx_warm_ce)

    store = (torch.int8 if args.int8_index
             else torch.bfloat16 if device.type == "cuda" else torch.float32)
    index = MIPSIndex(device,
                      block_size=min(8192, max(32, len(data.corpus_ids) // 4)),
                      store_dtype=store, mesh=mesh,
                      **_index_kwargs(args, device))
    engine = RetrievalEngine(index, data.passages, logger=logger)
    # --fast-encode: mine through a fused-int8 view of the same Parameters;
    # training stays on the bf16 composition
    enc_model = (_int8_view(de, dual_encoder.int8_view) if args.fast_encode
                 else de)
    q_enc = CorpusEncoder(enc_model.encode_query, device,
                          chunk_size=min(1024, max(64, len(data.query_ids))),
                          stall_timeout_s=_stall_timeout(args), mesh=mesh)
    offload_mode = (args.offload_mine if args.offload_mine != "auto"
                    else ("overlap" if args.full_size else "off"))

    def mine(pre_search=None):
        # a build or search that the stall watchdog gives up on is re-run
        # from scratch once (the build re-allocates, the search only reads)
        def build():
            with logger.timed("encode_corpus"):
                _build_index(index, enc_model.encode_passage,
                             data.corpus_ids, data.corpus_mask,
                             data.vocab_size, args)
                force_sync(device)

        retry_on_stall(build, attempts=2, desc="index build",
                       cleanup=index.free)
        if pre_search is not None:
            pre_search()      # overlap mode: the reranker leaves first

        def encode_queries():
            with logger.timed("encode_queries"):
                return q_enc(data.query_ids, data.query_mask)

        q_emb = retry_on_stall(encode_queries, attempts=2,
                               desc="query encode")
        return retry_on_stall(
            lambda: engine.mine(q_emb, data.questions, data.answers, k=topk,
                                positive_ids=data.positive_rows),
            attempts=2, desc="mine search")

    # overlap mode: the boundary's checkpoint writer takes the reranker's
    # host tree from the stash the refresh pulled
    stash_for_ckpt: queue.Queue = queue.Queue()

    def start_stash_overlap(ce_s):
        """Stash ``ce_s`` on a worker thread (its copy on a side stream,
        after the work queued so far); join() -> the HostStash. The main
        thread does not touch ``ce_s`` until join() has returned."""
        box = {"stash": None, "err": None}
        done = threading.Event()
        ready = ready_event(device)

        def pull():
            try:
                box["stash"] = HostStash(ce_s, ready)
            except BaseException as e:  # re-raised at join()
                box["err"] = e
            finally:
                done.set()

        threading.Thread(target=pull, name="stash-overlap",
                         daemon=True).start()

        def join():
            with logger.timed("offload_stash_join"):
                done.wait()
            if box["err"] is not None:
                raise box["err"]
            return box["stash"]

        return join

    def mine_offloaded(ce_s):
        """mine() with the reranker state stashed in host memory for the
        duration (per ``--offload-mine``); -> (result, reranker state)."""
        if offload_mode == "off":
            return mine(), ce_s
        if offload_mode == "overlap":
            join = start_stash_overlap(ce_s)
            holder = {}

            def pre_search():
                holder["stash"] = join()

            r = mine(pre_search=pre_search)
            index.free()
            with logger.timed("offload_restore"):
                return r, holder["stash"].restore()
        with logger.timed("offload_stash"):
            stash = HostStash(ce_s)
        r = mine()
        # free the index before the reranker comes back: peak memory stays
        # at index + DE, never index + DE + CE
        index.free()
        with logger.timed("offload_restore"):
            return r, stash.restore()

    def dataset_from(res, seed):
        with logger.timed("dataset_build"):
            ds = from_mining_result(
                data.corpus_ids, data.query_ids, res, num_negatives=negs,
                max_joint_length=lj, sep_id=data.sep_id, seed=seed,
                simans_mode=cfg.data.simans_mode, simans_a=cfg.data.simans_a,
                simans_b=cfg.data.simans_b, simans_tau=cfg.data.simans_tau)
        index.free()     # dead weight next to the train window
        return ds

    # -- warm-up: both models start trained (the reference loads finetuned
    #    DE and reranker checkpoints before co-training) -------------------
    gold = _gold_warm(data, topk)
    warm_ds = dataset_from(gold, args.seed)
    guard = RecallGuard()
    if resume_step is None:
        warm_de = _on_shard(make_biencoder_step(tx_warm_de, device,
                                                mesh=mesh), mesh)
        warm_ce = _on_shard(make_reranker_step(tx_warm_ce, device,
                                               mesh=mesh), mesh)
        warm_epochs = (args.warm_epochs if args.warm_epochs is not None
                       else 40 if tiny else max(1, min(25, steps // 4)))
        with logger.timed("warmup"):
            for _ in range(warm_epochs):
                for b in warm_ds.batches(batch_size=batch_size,
                                         with_joint=False):
                    de_state, _ = warm_de(de_state, b)
            # the reranker must be a competent teacher: warm it harder (the
            # +20 tiny bonus only when warm-up was asked for)
            ce_warm_steps = 0
            for _ in range(warm_epochs + 20 if (tiny and warm_epochs)
                           else warm_epochs):
                for b in warm_ds.batches(batch_size=batch_size):
                    ce_state, _ = warm_ce(ce_state, {
                        "joint_ids": b["joint_ids"],
                        "joint_mask": b["joint_mask"]})
                    ce_warm_steps += 1
            force_sync(device)
        if warm_epochs:
            check_teacher_warmth(ce_warm_steps)
        res, ce_state = mine_offloaded(ce_state)
        guard.update(res.top_k_hits[0])
        logger.log(0, {"top1": res.top_k_hits[0],
                       "mrr10": res.metrics.get("MRR_n@_10", 0.0)},
                   phase="warmup_eval")
        say(f"[{name}] warmup: top1={res.top_k_hits[0]:.3f}")
        # co-training: fresh optimizer states on the recipe schedule
        de_state = TrainState.create(de, tx_de)
        ce_state = TrainState.create(ce, tx_ce)
        first_seed = 0
    else:
        # relaunch: restore the full states of the last window boundary and
        # continue the co-training loop where it ended
        de_state = restore_checkpoint(args.output_dir,
                                      TrainState.create(de, tx_de),
                                      resume_step, name="retriever_state")
        ce_state = restore_checkpoint(args.output_dir,
                                      TrainState.create(ce, tx_ce),
                                      resume_step, name="reranker_state")
        res, ce_state = mine_offloaded(ce_state)
        guard.update(res.top_k_hits[0])
        logger.log(resume_step, {"top1": res.top_k_hits[0]},
                   phase="resume_eval")
        say(f"[{name}] resumed at step {resume_step}: "
            f"top1={res.top_k_hits[0]:.3f}")
        first_seed = resume_step
    # --fast-teacher: the retriever step's frozen reranker forward runs
    # through the fused int8 view of the live reranker's Parameters
    teacher = (_int8_view(ce, cross_encoder.int8_view) if args.fast_teacher
               else ce)
    r_step = _on_shard(make_ar2_retriever_step(
        tx_de, temperature=cfg.temperature_normal, adv_lambda=cfg.adv_lambda,
        # --scale_simmila: softmax(scores / sqrt(H))
        scale_scores=(1.0 / float(de_bert.hidden_size) ** 0.5
                      if cfg.scale_simmila else None),
        device=device, mesh=mesh), mesh)
    c_step = _on_shard(make_reranker_step(tx_ce, device, mesh=mesh), mesh)
    # rank 0 writes the checkpoints; every rank meets it at join_saves
    writer = bool(args.output_dir) and lead
    history = [res.top_k_hits[0]]

    def refresh(state, gstep):
        pre_search = None
        holder = {}
        if offload_mode == "overlap":
            # the boundary's stash rides under the index build, and its
            # host tree feeds the checkpoint writer
            join = start_stash_overlap(trainer.ce_state)

            def pre_search():
                stash = join()
                if writer:
                    stash_for_ckpt.put(stash.state_dict())
                holder["stash"] = stash

        r = mine(pre_search=pre_search)
        history.append(r.top_k_hits[0])
        guard.update(r.top_k_hits[0])
        logger.log(gstep, {"top1": r.top_k_hits[0]}, phase="refresh")
        ds = dataset_from(r, gstep)
        if "stash" in holder:
            with logger.timed("offload_restore"):
                trainer.ce_state = holder["stash"].restore()
        # the checkpoint pulls must land before training updates the
        # states in place again
        join_pulls()
        if len(ds) < batch_size:
            return None
        return lambda: ds.batches(batch_size=batch_size)

    iteration = min(cfg.iteration_step, max(4, steps // 2) if tiny
                    else cfg.iteration_step)
    # the first window reuses the warm-up (or resume) mine; the dataset seed
    # is the global step the window starts at, as refresh would use
    first_ds = dataset_from(res, first_seed)
    first_batches = (
        (lambda: first_ds.batches(batch_size=batch_size))
        if len(first_ds) >= batch_size
        else (lambda: warm_ds.batches(batch_size=batch_size)))

    pending_saves: list = []
    save_errors: list = []

    def join_saves():
        # a failed background write must not pass for a resumable run; under
        # a group every rank waits here for rank 0's write, and raises if it
        # failed
        while pending_saves:
            pending_saves.pop().join()
        err = save_errors[0] if save_errors else None
        if err is not None:
            print(f"[{name}] FATAL: background checkpoint write failed: "
                  f"{err!r}", file=sys.stderr, flush=True)
        try:
            barrier(mesh, err is not None, "background checkpoint write")
        except RuntimeError as e:
            raise RuntimeError("background checkpoint write failed") from (
                err or e)

    pending_pulls: list = []

    def join_pulls():
        with logger.timed("checkpoint_pull_join"):
            while pending_pulls:
                pending_pulls.pop().wait()

    def checkpoint(de_s, ce_s, gstep):
        """Window-boundary states (what ``--resume auto`` restores),
        written on a background thread under the mine that follows.

        With a stash (``--offload-mine on``) the reranker's host tree is
        the stash's and the retriever is copied here; otherwise the writer
        copies the resident states on a side stream (after the work queued
        so far) while the mine runs, and ``join_pulls`` holds training
        until the copies have landed. In overlap mode the reranker's tree
        comes from the refresh's stash.
        """
        if not args.output_dir:
            return
        with logger.timed("checkpoint"):
            join_saves()   # one write in flight at a time
            if not writer:
                return
            stashed = isinstance(ce_s, HostStash)
            de_host = (host_copy(de_s.state_dict(), device) if stashed
                       else None)
            ce_host = ce_s.state_dict() if stashed else None
            ready = ready_event(device)
            pulled = threading.Event()
            if stashed:
                pulled.set()
            else:
                pending_pulls.append(pulled)

            def write():
                try:
                    if stashed:
                        d, c = de_host, ce_host
                    elif offload_mode == "overlap":
                        d = host_copy(de_s.state_dict(), device, ready)
                        pulled.set()
                        c = stash_for_ckpt.get(timeout=7200)
                    else:
                        d = host_copy(de_s.state_dict(), device, ready)
                        c = host_copy(ce_s.state_dict(), device, ready)
                        pulled.set()
                    save_checkpoint(args.output_dir, d, gstep,
                                    name="retriever_state")
                    save_checkpoint(args.output_dir, c, gstep,
                                    name="reranker_state")
                except BaseException as e:  # surfaced by join_saves()
                    save_errors.append(e)
                finally:
                    pulled.set()   # never leave join_pulls waiting

            t = threading.Thread(target=write, name=f"ckpt-{gstep}")
            t.start()
            pending_saves.append(t)

    trainer = AR2CoTrainer(
        AR2Config(iteration_step=iteration,
                  iteration_reranker_step=min(cfg.iteration_reranker_step,
                                              max(2, (2 * iteration) // 5)),
                  max_steps=steps, batch_size=batch_size,
                  log_every=max(1, steps // 10)),
        de_state, ce_state, r_step, c_step, batches=first_batches,
        teacher=teacher, refresh_fn=refresh, checkpoint_fn=checkpoint,
        metric_logger=logger, offload_refresh=offload_mode == "on")
    if resume_step is not None:
        trainer.global_step = resume_step
    trainer.run()

    final, trainer.ce_state = mine_offloaded(trainer.ce_state)
    total_s = time.time() - t_start
    phases = dict(logger.phase_times)
    phases["train_steps_and_overhead"] = max(
        0.0, total_s - sum(logger.phase_times.values()))
    say(f"[{name}] phase split ({total_s:.1f}s total):")
    for k, v in sorted(phases.items(), key=lambda kv: -kv[1]):
        say(f"    {k:24s} {v:9.1f}s  {100 * v / total_s:5.1f}%")
    out = {"recipe": name, "steps": steps,
           "top1": final.top_k_hits[0],
           "top5": final.top_k_hits[min(4, topk - 1)],
           "mrr10": final.metrics.get("MRR_n@_10", 0.0),
           "history_top1": history,
           "total_s": total_s,
           "phase_times_s": phases,
           "world_size": mesh.world_size}
    if device.type == "cuda":
        peak = torch.tensor([torch.cuda.max_memory_allocated(device) / 1e9],
                            dtype=torch.float64, device=device)
        out["max_memory_gb_by_rank"] = all_gather_rows(peak, mesh).tolist()
    if args.output_dir:
        for state, ckpt in ((trainer.de_state, "retriever"),
                            (trainer.ce_state, "reranker")):
            tree = ({"params": host_copy(state.state_dict()["params"],
                                         device)} if writer else None)
            save_checkpoint(args.output_dir, tree, steps, name=ckpt,
                            mesh=mesh if mesh.distributed else None)
        if writer:
            with open(os.path.join(args.output_dir, "eval.json"), "w",
                      encoding="utf-8") as f:
                json.dump(out, f, indent=1)
    # the last boundary's write must land before exit; joined after
    # eval.json so a failed boundary write cannot lose the final outputs
    join_saves()
    logger.close()
    say(f"[{name}] final: top1={out['top1']:.3f} mrr10={out['mrr10']:.3f}")
    return out


def init_condenser(cfg: CondenserConfig, seed: int) -> Condenser:
    """The initial Condenser, with the JAX package's initializers drawn
    from a ``torch.Generator`` seeded ``seed``."""
    return Condenser(cfg, generator=torch.Generator().manual_seed(seed))


def run_pretrain(name: str, cfg: MasterPretrainConfig, args) -> dict:
    """MASTER bottlenecked-MAE pre-training (``MASTER/pretrain``): the
    8-stream masking collator -> the Condenser's multi-decoder objective ->
    the encoder-only export."""
    t_start = time.time()
    mesh = create_mesh(args.device, backend=args.dist_backend,
                       timeout_s=_stall_timeout(args))
    device = mesh.device
    lead = mesh.rank == 0
    say = print if lead else (lambda *a, **kw: None)
    if args.corpus or args.queries:
        print("WARNING: master_pretrain trains on generated synthetic "
              "token streams; --corpus/--queries are ignored by this "
              "recipe (the reference pretrains from its own preprocessed "
              "MASTER corpus format).", file=sys.stderr)
    tiny = not args.full_size      # the synthetic config is tiny already
    logger = MetricLogger(args.output_dir, rank=mesh.rank)
    steps = args.steps if args.steps is not None else (
        50 if tiny else cfg.optim.total_steps)
    batch_size = args.batch if args.batch is not None else cfg.global_batch
    if tiny and args.batch is None:
        batch_size = min(batch_size, 16)   # never clamp an explicit --batch
    local_batch_size(batch_size, mesh)     # raises unless W divides it

    meta = TokenMeta.for_hash_tokenizer(HashTokenizer(vocab_size=2048))
    seq = min(cfg.max_seq_length, 64 if tiny else cfg.max_seq_length)
    coll = CondenserCollator(meta, max_seq_length=seq,
                             mlm_probability=cfg.mlm_probability,
                             decoder_mlm_probability=(
                                 cfg.decoder_mlm_probability),
                             seed=args.seed)
    say(f"[{name}] collator: the {coll.path} path")
    rng = np.random.default_rng(args.seed)

    def examples(n):
        return [{"text": rng.integers(5, 2000, size=int(
                     rng.integers(24, seq - 4))).tolist(),
                 "queries": [rng.integers(5, 2000, size=6).tolist()],
                 "next": [rng.integers(5, 2000, size=20).tolist()]}
                for _ in range(n)]

    bert = _bert_cfg(cfg.bert, tiny, 2048)
    if tiny:
        bert = bert.replace(max_position_embeddings=max(seq, 64))
    # --init-checkpoint: MASTER pretrains from bert-base-uncased
    # (MASTER/README.md --model_name_or_path): the encoder, and the MLM
    # head when the artifact has one
    init = _load_init_checkpoint(args)
    if init is not None:
        bert = _init_bert_cfg(init, bert, 2048)
    model = init_condenser(CondenserConfig(
        bert=bert, n_head_layers=cfg.n_head_layers), args.seed)
    if init is not None:
        _graft_encoder(model, init, ("encoder",), bert.num_layers)
        if init["mlm"] is not None:
            model.mlm.load_state_dict(init["mlm"])
    model = model.to(device)
    # the JAX launcher initializes from one collated batch of 2 examples:
    # drawn here too, so both streams stay in step with its run
    coll(examples(2))
    pt_lr = args.lr if args.lr is not None else (1e-3 if tiny else None)
    tx = _make_optim(cfg.optim, pt_lr, steps)
    state = TrainState.create(model, tx)
    step = _on_shard(make_condenser_step(tx, device, mesh=mesh), mesh)
    writer = bool(args.output_dir) and lead
    group = mesh if mesh.distributed else None

    start = 0
    resume_step = _resume_step(args, "pretrain_state", mesh)
    if resume_step is not None:
        # the state resumes; the synthetic example stream is reseeded, not
        # replayed (HF Trainer's resume without its batch-skip replay)
        restore_checkpoint(args.output_dir, state, resume_step,
                           name="pretrain_state")
        start = resume_step
        rng = np.random.default_rng(args.seed + resume_step)
        say(f"[{name}] resumed at step {resume_step}")
    save_every = max(1, steps // 5)
    last = float("nan")
    with logger.timed("pretrain"):
        for i in range(start, steps):
            state, m = step(state, coll(examples(batch_size)))
            last = float(m["loss"])
            if (i + 1) % max(1, steps // 10) == 0:
                logger.log(i + 1, {"loss": last}, phase="pretrain")
            if (i + 1) % save_every == 0 and args.output_dir:
                save_checkpoint(args.output_dir,
                                host_copy(state.state_dict(), device)
                                if writer else None, i + 1,
                                name="pretrain_state", mesh=group)
    out = {"recipe": name, "steps": steps, "final_loss": last,
           "collator_path": coll.path, "total_s": time.time() - t_start,
           "phase_times_s": dict(logger.phase_times),
           "world_size": mesh.world_size}
    if device.type == "cuda":
        out["max_memory_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    if args.output_dir:
        tree = None
        if writer:
            tree = {"params": export_encoder_only(
                host_copy(state.state_dict(), device)["params"])}
        save_checkpoint(args.output_dir, tree, steps, name="encoder",
                        mesh=group)
        if writer:
            with open(os.path.join(args.output_dir, "eval.json"), "w",
                      encoding="utf-8") as f:
                json.dump(out, f, indent=1)
    logger.close()
    say(f"[{name}] pretrained {steps} steps, loss={last:.4f}")
    return out


def run_lead(name: str, cfg: LeadRecipeConfig, args) -> dict:
    """LEAD joint distillation: the student DE and the CE teacher warm up
    on single-model steps, then train together under the joint step with
    layer-score reweighting and a layer re-draw every ``save_steps``
    (``LEAD/run_LEAD.py:43-276`` with the ``distill_from_12ce_to_6de.sh:
    40-71`` flags); ``--freeze-teachers`` trains the student alone, and with
    ``--fast-teacher`` the frozen CE runs through its fused-int8 view."""
    t_start = time.time()
    mesh = create_mesh(args.device, backend=args.dist_backend,
                       timeout_s=_stall_timeout(args))
    device = mesh.device
    lead = mesh.rank == 0
    say = print if lead else (lambda *a, **kw: None)
    data = _get_corpus(args, cfg.data)
    tiny = args.tiny_models or (
        not args.full_size and not (args.corpus and not args.synthetic))
    logger = MetricLogger(args.output_dir, rank=mesh.rank)
    steps = args.steps if args.steps is not None else (
        30 if tiny else cfg.max_steps)
    batch_size = min(args.batch or cfg.global_batch, len(data.query_ids))
    local_batch_size(batch_size, mesh)      # raises unless W divides it
    negs = min(cfg.data.num_negatives, len(data.corpus_ids) - 1)
    m = 1 + negs
    lj = min(cfg.data.max_joint_length,
             data.query_ids.shape[1] + data.corpus_ids.shape[1] + 1)

    db_cfg = _bert_cfg(cfg.student.bert, tiny, data.vocab_size)
    ce_cfg = _bert_cfg(cfg.teacher_ce.bert, tiny, data.vocab_size,
                       joint=True)
    if args.remat != "recipe":
        db_cfg = db_cfg.replace(remat=args.remat in ("de", "both"))
        ce_cfg = ce_cfg.replace(remat=args.remat in ("ce", "both"))
    # --init-checkpoint: the LEAD student's warm start (DistilBERT,
    # LEAD/modeling_distilbert.py, distill_from_12ce_to_6de.sh)
    init = _load_init_checkpoint(args)
    if init is not None:
        db_cfg = _init_bert_cfg(init, db_cfg, data.vocab_size)
    # the student at seed, the CE at seed + 1, as the JAX launcher
    db, ce = init_models(
        BiEncoderConfig(bert=db_cfg, share_weight=cfg.student.share_weight),
        CrossEncoderConfig(bert=ce_cfg, per_layer_logits=True), args.seed)
    if init is not None:
        _graft_encoder(db, init, ("question_model.encoder",) if
                       cfg.student.share_weight else
                       ("question_model.encoder", "ctx_model.encoder"),
                       db_cfg.num_layers)
    db, ce = db.to(device), ce.to(device)
    lr = args.lr if args.lr is not None else (
        1e-3 if tiny else cfg.optim.learning_rate)

    # the gold warm dataset (the reference starts both models from trained
    # single-model checkpoints, run_LEAD.py DISTILL_CE_PATH/DISTILL_DB_PATH)
    nq = len(data.query_ids)
    ds = from_mining_result(data.corpus_ids, data.query_ids,
                            _gold_warm(data, m), num_negatives=negs,
                            max_joint_length=lj, sep_id=data.sep_id,
                            seed=args.seed, simans_mode=None)
    resume_step = _resume_step(args, "lead_db_state", mesh)
    writer = bool(args.output_dir) and lead
    group = mesh if mesh.distributed else None

    def save(st: TrainState, step: int, ckpt: str, params_only=False):
        if not args.output_dir:
            return
        tree = None
        if writer:
            tree = host_copy(st.state_dict(), device)
            if params_only:
                tree = {"params": tree["params"]}
        save_checkpoint(args.output_dir, tree, step, name=ckpt, mesh=group)

    tx_warm = make_adamw(lr, total_steps=0)
    if resume_step is None:
        db_state = TrainState.create(db, tx_warm)
        ce_state = TrainState.create(ce, tx_warm)
        warm_db = _on_shard(make_biencoder_step(tx_warm, device, mesh=mesh),
                            mesh)
        warm_ce = _on_shard(make_reranker_step(tx_warm, device, mesh=mesh),
                            mesh)
        warm_epochs = 30 if tiny else max(1, steps // 10)
        with logger.timed("warmup"):
            for _ in range(warm_epochs):
                for b in ds.batches(batch_size=batch_size, with_joint=False):
                    db_state, _ = warm_db(db_state, b)
            for _ in range(warm_epochs):
                for b in ds.batches(batch_size=batch_size):
                    ce_state, _ = warm_ce(ce_state, {
                        "joint_ids": b["joint_ids"],
                        "joint_mask": b["joint_mask"]})
            force_sync(device)

    # the joint phase: fresh optimizers per model on the recipe schedule
    warmup = int(cfg.warmup_ratio * steps)
    tx_db = make_adamw(lr * (0.1 if tiny else 1.0), warmup_steps=warmup,
                       total_steps=steps)
    tx_ce = make_adamw(lr * (0.1 if tiny else 1.0), warmup_steps=warmup,
                       total_steps=steps)
    states = {"db": TrainState.create(db, tx_db),
              "ce": TrainState.create(ce, tx_ce)}
    if resume_step is not None:
        for key in ("db", "ce"):
            restore_checkpoint(args.output_dir, states[key], resume_step,
                               name=f"lead_{key}_state")
        say(f"[{name}] resumed at step {resume_step}")
    train_ce = cfg.train_ce and not args.freeze_teachers
    lead_cfg = LeadConfig(
        distill_db=True, distill_ce=True, train_db=True, train_ce=train_ce,
        layer_score=True, reweight=cfg.reweight,
        temperature=cfg.temperature,
        layer_temperature=cfg.layer_temperature)
    k = min(cfg.num_distill_layers, db_cfg.num_layers, ce_cfg.num_layers)
    # --fast-teacher on a FROZEN CE: its forwards run through the fused-int8
    # view of the live (warmed) Parameters, every layer's logit included
    frozen_views = None
    if args.fast_teacher and not train_ce:
        view = _int8_view(ce, cross_encoder.int8_view)
        if view is not ce:
            frozen_views = {"ce": view}
    step = make_lead_step({"db": db, "ce": ce}, {"db": tx_db, "ce": tx_ce},
                          lead_cfg, frozen_views=frozen_views, device=device,
                          mesh=mesh)
    rng = np.random.default_rng(args.seed)

    def draw():
        return select_layers(rng, db_cfg.num_layers, ce_cfg.num_layers, k,
                             cfg.layer_selection)

    sel_s, sel_t = draw()
    done, last = 0, float("nan")
    if resume_step is not None:
        # replay the draws the dead run consumed, so the selection stream
        # continues as an uninterrupted run's (re-drawn every save_steps)
        for _ in range(resume_step // cfg.save_steps):
            sel_s, sel_t = draw()
        done = resume_step
    with logger.timed("lead"):
        while done < steps:
            for b in ds.batches(batch_size=batch_size):
                if (done % cfg.save_steps == 0 and done > 0
                        and done != resume_step):
                    # the re-draw (run_LEAD.py:260), and the states it
                    # resumes from; the resume boundary's draw was replayed
                    sel_s, sel_t = draw()
                    save(states["db"], done, "lead_db_state")
                    save(states["ce"], done, "lead_ce_state")
                states, metrics = step(states, shard_batch(b, mesh)
                                       if mesh.distributed else b,
                                       sel_s, sel_t)
                done += 1
                last = float(metrics["loss"])
                if done % max(1, steps // 10) == 0:
                    logger.log(done, {"loss": last}, phase="lead")
                if done >= steps:
                    break
        force_sync(device)

    # the final retrieval eval with the distilled student
    index = MIPSIndex(device,
                      block_size=min(8192, max(32, len(data.corpus_ids) // 4)),
                      mesh=mesh, **_index_kwargs(args, device))
    engine = RetrievalEngine(index, data.passages, logger=logger)
    q_enc = CorpusEncoder(db.encode_query, device,
                          chunk_size=min(1024, max(64, nq)),
                          stall_timeout_s=_stall_timeout(args), mesh=mesh)
    with logger.timed("eval"):
        _build_index(index, db.encode_passage, data.corpus_ids,
                     data.corpus_mask, data.vocab_size, args)
        res = engine.mine(q_enc(data.query_ids, data.query_mask),
                          data.questions, data.answers,
                          k=min(args.topk or 10, len(data.corpus_ids)),
                          positive_ids=data.positive_rows)
    out = {"recipe": name, "steps": done, "final_loss": last,
           "top1": res.top_k_hits[0],
           "mrr10": res.metrics.get("MRR_n@_10", 0.0),
           "total_s": time.time() - t_start,
           "phase_times_s": dict(logger.phase_times),
           "world_size": mesh.world_size}
    if device.type == "cuda":
        out["max_memory_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    save(states["db"], done, "student", params_only=True)
    save(states["ce"], done, "teacher_ce", params_only=True)
    if writer:
        with open(os.path.join(args.output_dir, "eval.json"), "w",
                  encoding="utf-8") as f:
            json.dump(out, f, indent=1)
    logger.close()
    say(f"[{name}] joint-distilled {done} steps, loss={last:.4f} "
        f"top1={out['top1']:.3f}")
    return out


def run_allies(name: str, cfg: AlliesRecipeConfig, args) -> dict:
    """ALLIES beam-search QA over a trained retriever and a scripted LLM
    (``ALLIES/main.py:11-160``): per question, the beam search of
    :func:`simxns_tpu_torch.allies.allies_answer` with retrieval-grounded
    answers, scored by EM and F1. The LLM is the deterministic
    :class:`~simxns_tpu_torch.allies.EvidenceLLM` (the run is offline); a
    real client takes its place in production. The retriever is a tiny
    dual encoder warmed for 30 epochs on the gold pairs (the reference
    loads a fine-tuned DPR and its precomputed embeddings), behind the
    launcher's index (``--int8-index``: int8 rows)."""
    from simxns_tpu_torch.allies import (ALLIESConfig, EvidenceLLM,
                                         allies_answer, exact_match,
                                         f1_score)
    from simxns_tpu_torch.config import DataConfig

    t_start = time.time()
    device = create_mesh(args.device, backend=args.dist_backend,
                         timeout_s=_stall_timeout(args)).device
    data = _get_corpus(args, DataConfig())
    if data.tokenizer is None:
        raise SystemExit("allies_qa needs a text corpus with a tokenizer; "
                         "run --synthetic at demo scale (<= 20000 passages)")
    tok = data.tokenizer
    logger = MetricLogger(args.output_dir)
    lq = data.query_ids.shape[1]

    model = BiEncoder(BiEncoderConfig(bert=_bert_cfg(None, True,
                                                     data.vocab_size)),
                      generator=torch.Generator().manual_seed(args.seed))
    model = model.to(device)
    tx = make_adamw(3e-3, total_steps=0)
    state = TrainState.create(model, tx)
    step = make_biencoder_step(tx, device, grad_mode="full")
    ds = from_mining_result(data.corpus_ids, data.query_ids,
                            _gold_warm(data, 2), num_negatives=1,
                            sep_id=data.sep_id, seed=args.seed,
                            simans_mode=None)
    batch_size = min(args.batch or 16, len(data.query_ids))
    with logger.timed("warmup"):
        for _ in range(30):
            for b in ds.batches(batch_size=batch_size, with_joint=False):
                state, _ = step(state, b)

    store = (torch.int8 if args.int8_index
             else torch.bfloat16 if device.type == "cuda" else torch.float32)
    index = MIPSIndex(device,
                      block_size=min(8192, max(32, len(data.corpus_ids) // 4)),
                      store_dtype=store, **_index_kwargs(args, device))
    model.eval()
    with logger.timed("encode_corpus"), torch.no_grad():
        _build_index(index, model.encode_passage, data.corpus_ids,
                     data.corpus_mask, data.vocab_size, args)

    def retrieve(question: str, k: int):
        enc = tok.encode(question, max_length=lq)
        ids = np.zeros((1, lq), np.int32)
        ids[0, : len(enc)] = enc
        with torch.inference_mode():
            emb = model.encode_query(
                torch.from_numpy(ids).to(device),
                torch.from_numpy((ids != 0).astype(np.int32)).to(device))
        _, top = index.search(emb.float().cpu().numpy(),
                              min(k, len(data.corpus_ids)), query_batch=8)
        return [data.passages.get(int(p), ("", ""))[0] for p in top[0]]

    llm = EvidenceLLM()
    allies_cfg = ALLIESConfig(
        beam_size=cfg.beam_size, beam_depth=cfg.beam_depth,
        threshold=cfg.threshold, top_k=cfg.topk,
        retrieval_type=cfg.retrieval_type, summarize=cfg.summarize)
    n_eval = min(len(data.questions),
                 args.steps if args.steps is not None else 16)
    ems, f1s, api_calls, retrievals = [], [], 0, 0
    with logger.timed("allies"):
        for qi in range(n_eval):
            answer, _, counters = allies_answer(
                data.questions[qi], llm, allies_cfg, retrieve)
            ems.append(exact_match(answer, data.answers[qi]))
            f1s.append(f1_score(answer, data.answers[qi]))
            api_calls += counters["api_calls"]
            retrievals += counters["retrievals"]
    out = {"recipe": name, "questions": n_eval,
           "em": float(np.mean(ems)), "f1": float(np.mean(f1s)),
           "api_calls_per_q": api_calls / max(n_eval, 1),
           "retrievals_per_q": retrievals / max(n_eval, 1),
           "wall_s": time.time() - t_start}
    if args.output_dir:
        with open(os.path.join(args.output_dir, "eval.json"), "w") as f:
            json.dump(out, f, indent=1)
    logger.log(n_eval, {"em": out["em"], "f1": out["f1"]}, phase="allies")
    logger.close()
    print(f"[{name}] {n_eval} questions: EM={out['em']:.3f} "
          f"F1={out['f1']:.3f}")
    return out


def load_t5_tokenizer(path: str):
    """``--t5-tokenizer``: a HF tokenizer from a local directory, offline
    (``transformers``' ``AutoTokenizer``; nothing is downloaded)."""
    os.environ.setdefault("HF_HUB_OFFLINE", "1")
    os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")
    try:
        from transformers import AutoTokenizer
    except ImportError as err:
        raise SystemExit(
            "--t5-tokenizer loads the tokenizer through the transformers "
            "package, which is not installed here; pass --query-tsv with "
            "a generated TSV instead") from err
    return AutoTokenizer.from_pretrained(path)


def _doc2query_generate(t5_init, data: _Corpus, args, cfg, device,
                        mesh) -> str:
    """The docT5query expansion TSV from a T5 artifact, generated inline
    (the reference's stage ``CAPSTONE/models/generate_query.py:115-235``):
    ``cfg.total_part`` queries a passage, written to
    ``<output-dir>/doc2query.tsv``. The generated ids are decoded by the
    T5 tokenizer (``--t5-tokenizer``; the corpus's tokenizer cannot decode
    T5 ids). Under a group rank 0 generates and the others wait."""
    from simxns_tpu_torch.models.bert import from_state_dict
    from simxns_tpu_torch.models.hf_import import (convert_hf_t5,
                                                   t5_config_from_state_dict)
    from simxns_tpu_torch.models.t5 import T5, doc2query_tsv

    if not args.t5_tokenizer:
        raise SystemExit(
            "--init-checkpoint is a T5 (doc2query) artifact; pass "
            "--t5-tokenizer <local dir> so generated ids can be decoded")
    out = os.path.join(args.output_dir or ".", "doc2query.tsv")
    n = len(data.corpus_ids)
    failed = None
    if mesh.rank == 0:
        try:
            tok = load_t5_tokenizer(args.t5_tokenizer)
            model = from_state_dict(
                T5, t5_config_from_state_dict(t5_init["sd"]),
                convert_hf_t5(t5_init["sd"]))
            doc2query_tsv(
                model.to(device).eval(), tok,
                ((i, data.passages.get(i, ("", ""))[0]) for i in range(n)),
                out, num_queries=cfg.total_part, seed=args.seed)
            del model
        except BaseException as e:  # every rank raises below
            failed = e
    barrier(mesh, failed is not None, "doc2query generation")
    if failed is not None:
        raise failed
    if mesh.rank == 0:
        print(f"[capstone] doc2query TSV written: {out} ({n} passages x "
              f"{cfg.total_part} queries)", file=sys.stderr)
    return out


def init_dual_encoder(cfg: BiEncoderConfig, seed: int) -> BiEncoder:
    """CAPSTONE's initial dual encoder, with the JAX package's initializers
    drawn from a ``torch.Generator`` seeded ``seed``."""
    return BiEncoder(cfg, generator=torch.Generator().manual_seed(seed))


def run_capstone(name: str, cfg: CapstoneRecipeConfig, args) -> dict:
    """CAPSTONE curriculum training of a dual encoder over doc2query-expanded
    passages (``CAPSTONE/models/run_de_model_ernie.py:56-396``): every
    positive and negative passage is expanded with one generated query,
    chosen by the gradual curriculum (least to most gold-similar as
    training progresses); the eval searches the corpus expanded with its
    top-k queries. The queries come from ``--query-tsv``, from a T5
    ``--init-checkpoint`` (generated inline), or, on the synthetic corpus,
    three made-up queries a passage. A coCondenser or BERT artifact
    warm-starts the towers. Outputs: ``curriculum_state`` every ``steps //
    5`` (what ``--resume auto`` continues from, the sampling stream
    reseeded at ``seed + step``), the final ``retriever`` and
    ``eval.json``; under ``torchrun`` as ``run_ar2``."""
    from simxns_tpu_torch.data.curriculum import (QueryExpander,
                                                  gradual_bucket)

    t_start = time.time()
    mesh = create_mesh(args.device, backend=args.dist_backend,
                       timeout_s=_stall_timeout(args))
    device = mesh.device
    lead = mesh.rank == 0
    say = print if lead else (lambda *a, **kw: None)
    data = _get_corpus(args, cfg.data)
    if data.tokenizer is None:
        raise SystemExit(
            "capstone_curriculum re-tokenizes expanded passage text per "
            "batch; prepared token-only corpora are not supported — run "
            "--synthetic at demo scale (<= 20000 passages; larger synthetic "
            "corpora are vectorized token-only), or extend _load_prepared "
            "with a text corpus + tokenizer")
    tok = data.tokenizer
    tiny = not args.full_size
    logger = MetricLogger(args.output_dir, rank=mesh.rank)
    steps = args.steps if args.steps is not None else (
        40 if tiny else cfg.max_steps)
    batch_size = min(args.batch or cfg.global_batch, len(data.query_ids))
    local_batch_size(batch_size, mesh)      # raises unless W divides it
    n_corpus = len(data.corpus_ids)
    negs = min(cfg.data.num_negatives, 3 if tiny else 10 ** 9, n_corpus - 1)
    m = 1 + negs
    lc = data.corpus_ids.shape[1]

    # --init-checkpoint: CAPSTONE starts the DE from coCondenser
    # (run_de_model_ernie.sh --model_name_or_path co-condenser-marco); a
    # T5 artifact is the docT5query generator of the expansion queries
    init = _load_init_checkpoint(args)
    t5_init = None
    if init is not None and init["family"] == "t5":
        t5_init, init = init, None

    delim = " [SEP] " if cfg.delimiter == "sep" else " "
    if args.query_tsv:
        expander = QueryExpander.from_tsv(
            args.query_tsv, total_part=cfg.total_part, delimiter=delim)
    elif t5_init is not None:
        with logger.timed("doc2query"):
            tsv = _doc2query_generate(t5_init, data, args, cfg, device,
                                      mesh)
        expander = QueryExpander.from_tsv(
            tsv, total_part=cfg.total_part, delimiter=delim)
    else:
        # made-up doc2query output: queries of varying gold similarity, so
        # the curriculum has something to order
        queries = {i: [f"document {i} fact{i}",           # near the gold
                       f"what does document {i} say",     # midway
                       f"unrelated noise {i * 7 % 97}"]   # far
                   for i in range(n_corpus)}
        expander = QueryExpander(queries=queries, total_part=cfg.total_part,
                                 delimiter=delim)

    bert = _bert_cfg(cfg.retriever.bert, tiny, data.vocab_size)
    if init is not None:
        bert = _init_bert_cfg(init, bert, data.vocab_size)
    model = init_dual_encoder(BiEncoderConfig(
        bert=bert, share_weight=cfg.retriever.share_weight,
        pooling=cfg.retriever.pooling), args.seed)
    if init is not None:
        _graft_encoder(model, init, ("question_model.encoder",) if
                       cfg.retriever.share_weight else
                       ("question_model.encoder", "ctx_model.encoder"),
                       bert.num_layers)
    model = model.to(device)
    lr = args.lr if args.lr is not None else (
        3e-3 if tiny else cfg.optim.learning_rate)
    tx = make_adamw(lr, warmup_steps=min(cfg.optim.warmup_steps, steps // 4),
                    total_steps=steps)
    state = TrainState.create(model, tx)
    step = _on_shard(make_biencoder_step(tx, device, mesh=mesh,
                                         grad_mode="full"), mesh)
    writer = bool(args.output_dir) and lead
    group = mesh if mesh.distributed else None

    def save(tree_of, step_no: int, ckpt: str) -> None:
        if args.output_dir:
            save_checkpoint(args.output_dir, tree_of() if writer else None,
                            step_no, name=ckpt, mesh=group)

    rng = np.random.default_rng(args.seed)
    nq = len(data.query_ids)
    start = 0
    resume_step = _resume_step(args, "curriculum_state", mesh)
    if resume_step is not None:
        # the bucket is a function of the step, so a resumed run re-enters
        # the same bucket; the sampling stream is reseeded (fresh draws,
        # the same distribution)
        restore_checkpoint(args.output_dir, state, resume_step,
                           name="curriculum_state")
        start = resume_step
        rng = np.random.default_rng(args.seed + resume_step)
        say(f"[{name}] resumed at step {resume_step}")
    save_every = max(1, steps // 5)

    def expanded_ctx_row(row: int, question: str, bucket: int,
                         gold_prob: float) -> np.ndarray:
        text, title = data.passages.get(row, ("", ""))
        mode = f"{max(bucket, 1)}-part" if bucket > 0 else "first"
        q_sel = (question if bucket == 0
                 else expander.select_query(row, question, mode, rng,
                                            gold_query_prob=gold_prob))
        body = expander.expand_passage(text, q_sel)
        enc = tok.encode(title, text_pair=body, max_length=lc)
        out = np.zeros((lc,), np.int32)
        out[: len(enc)] = enc
        return out

    last = float("nan")
    for it in range(start, steps):
        with logger.timed("expand"):
            bucket, gold_prob = gradual_bucket(
                it, steps, cfg.total_part, cfg.select_generated_query)
            # batch_size <= nq (clamped above): no replacement is safe
            q_idx = rng.choice(nq, size=batch_size, replace=False)
            ctx_ids = np.zeros((batch_size * m, lc), np.int32)
            for bi, qi in enumerate(q_idx):
                neg_rows = [(int(qi) + 1 + int(r)) % n_corpus
                            for r in rng.choice(n_corpus - 1, size=negs,
                                                replace=False)]
                for j, row in enumerate([int(qi)] + neg_rows):
                    ctx_ids[bi * m + j] = expanded_ctx_row(
                        row, data.questions[qi], bucket, gold_prob)
            q = data.query_ids[q_idx]
            batch = {"q_ids": q, "q_mask": (q != 0).astype(np.int32),
                     "ctx_ids": ctx_ids,
                     "ctx_mask": (ctx_ids != 0).astype(np.int32),
                     "positive_idx": (np.arange(batch_size) * m).astype(
                         np.int32)}
        with logger.timed("curriculum"):
            state, metrics = step(state, batch)
            last = float(metrics["loss"])
        if (it + 1) % max(1, steps // 10) == 0:
            logger.log(it + 1, {"loss": last, "bucket": bucket},
                       phase="curriculum")
        if (it + 1) % save_every == 0:
            save(lambda: host_copy(state.state_dict(), device), it + 1,
                 "curriculum_state")

    # the eval over the corpus expanded with its top-k queries
    # (run_de_model_expand_corpus_cocondenser.sh:44-60 --top_k_query)
    exp_corpus = np.zeros_like(data.corpus_ids)
    for i in range(n_corpus):
        text, title = data.passages.get(i, ("", ""))
        body = expander.expand_corpus_entry(i, text, cfg.top_k_query)
        enc = tok.encode(title, text_pair=body, max_length=lc)
        exp_corpus[i, : len(enc)] = enc
    store = (torch.int8 if args.int8_index
             else torch.bfloat16 if device.type == "cuda" else torch.float32)
    index = MIPSIndex(device, block_size=min(8192, max(32, n_corpus // 4)),
                      store_dtype=store, mesh=mesh,
                      **_index_kwargs(args, device))
    engine = RetrievalEngine(index, data.passages, logger=logger)
    q_enc = CorpusEncoder(model.encode_query, device,
                          chunk_size=min(1024, max(64, nq)),
                          stall_timeout_s=_stall_timeout(args), mesh=mesh)
    with logger.timed("eval"):
        _build_index(index, model.encode_passage, exp_corpus,
                     (exp_corpus != 0).astype(np.int32), data.vocab_size,
                     args)
        res = engine.mine(q_enc(data.query_ids, data.query_mask),
                          data.questions, data.answers,
                          k=min(args.topk or 10, n_corpus),
                          positive_ids=data.positive_rows)
    out = {"recipe": name, "steps": steps, "final_loss": last,
           "top1": res.top_k_hits[0],
           "mrr10": res.metrics.get("MRR_n@_10", 0.0)}
    if args.qrels:
        # the reference's TREC surface: nDCG@10, map_cut_10, recip_rank and
        # recall_N from graded qrels (CAPSTONE/utils/evaluate_trec.py:72-107)
        from simxns_tpu_torch.data import load_trec_qrels
        from simxns_tpu_torch.evals import trec_eval_all

        topk_ids = np.asarray(res.topk_ids)
        ranked = {str(i): [int(p) for p in topk_ids[i]]
                  for i in range(nq)}
        out["trec"] = trec_eval_all(ranked, load_trec_qrels(args.qrels),
                                    k=10, recall_k=topk_ids.shape[1])
    out.update(total_s=time.time() - t_start,
               phase_times_s=dict(logger.phase_times),
               world_size=mesh.world_size)
    if device.type == "cuda":
        out["max_memory_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    save(lambda: {"params": host_copy(state.state_dict(), device)["params"]},
         steps, "retriever")
    if writer:
        with open(os.path.join(args.output_dir, "eval.json"), "w",
                  encoding="utf-8") as f:
            json.dump(out, f, indent=1)
    logger.close()
    say(f"[{name}] curriculum-trained {steps} steps, top1={out['top1']:.3f}")
    return out


def _on_shard(step, mesh):
    """``step`` called with this rank's rows of each global batch (its last
    argument); ``step`` itself without a group."""
    if not mesh.distributed:
        return step

    def sharded(*args):
        return step(*args[:-1], shard_batch(args[-1], mesh))

    return sharded


# the runner of each recipe config
_RUNNERS = {AR2RecipeConfig: run_ar2, KDRecipeConfig: run_kd,
            LeadRecipeConfig: run_lead, MasterPretrainConfig: run_pretrain,
            AlliesRecipeConfig: run_allies,
            CapstoneRecipeConfig: run_capstone}


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    cfg = RECIPES[args.recipe]
    runner = _RUNNERS[type(cfg)]
    if args.output_dir:
        os.makedirs(args.output_dir, exist_ok=True)
    import torch.distributed as dist

    ours = not (dist.is_available() and dist.is_initialized())
    try:
        return runner(args.recipe, cfg, args)
    finally:
        # a group this run started (under torchrun) ends with it
        if ours and dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
