"""Command-line launcher of the AR2 co-training run (port of
``simxns_tpu/run.py``).

    python -m simxns_tpu_torch.run --recipe nq_ar2_simans --synthetic
    python -m simxns_tpu_torch.run --recipe nq_ar2_simans --synthetic \\
        --device cpu --steps 12 --batch 8 --corpus-size 64 --num-queries 24
    python -m simxns_tpu_torch.run --recipe nq_ar2_simans \\
        --corpus corpus.npz --queries queries.npz \\
        --passages-tsv psgs_w100.tsv --output-dir runs/nq

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

Only the AR2 recipes run here; the other runners, ``--init-checkpoint``
and LAMB raise ``NotImplementedError`` (ROADMAP.md Queue 1).
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

from simxns_tpu_torch.config import AR2RecipeConfig, RECIPES
from simxns_tpu_torch.data import HashTokenizer, from_mining_result
from simxns_tpu_torch.data.datasets import (load_id_text, load_passages_tsv,
                                            load_qrels)
from simxns_tpu_torch.device import resolve_device
from simxns_tpu_torch.index import CorpusEncoder, MIPSIndex, RetrievalEngine
from simxns_tpu_torch.io import (MetricLogger, latest_step,
                                 restore_checkpoint, save_checkpoint)
from simxns_tpu_torch.models import (BertConfig, BiEncoder, BiEncoderConfig,
                                     CrossEncoder, CrossEncoderConfig)
from simxns_tpu_torch.models import cross_encoder, dual_encoder
from simxns_tpu_torch.parallel.offload import HostStash, host_copy, ready_event
from simxns_tpu_torch.parallel.sync import force_sync
from simxns_tpu_torch.parallel.watchdog import retry_on_stall
from simxns_tpu_torch.train import (TrainState, make_adamw,
                                    make_ar2_retriever_step,
                                    make_biencoder_step, make_reranker_step)
from simxns_tpu_torch.train.driver import (AR2Config, AR2CoTrainer,
                                           RecallGuard, check_teacher_warmth)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m simxns_tpu_torch.run",
        description="Run a SimXNS AR2/SimANS co-training recipe on a CUDA "
                    "card (or the CPU with --device cpu).")
    ap.add_argument("--recipe", required=True, choices=sorted(RECIPES),
                    help="named configuration from simxns_tpu_torch.config."
                         "RECIPES (only the AR2 recipes run in this port)")
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
    ap.add_argument("--synthetic", action="store_true",
                    help="force the synthetic corpus even if --corpus given")
    ap.add_argument("--output-dir", default=None,
                    help="metrics.jsonl + checkpoints directory")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default cuda; the CPU "
                         "runs each kernel's plain PyTorch version)")
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
                    help="run the retriever step's frozen reranker forward "
                         "through the fused int8 view of its parameters")
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
                    help="HF checkpoint to warm-start the encoders from "
                         "(not ported yet)")
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
                            stall_timeout_s=_stall_timeout(args))
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


class _Corpus:
    """Token arrays and QA labels, from prepared .npz files or synthesized.

    ``positive_rows`` (optional) carries per-query gold row ids (qrels
    labeling); ``passages`` maps corpus row -> (text, title).
    """

    def __init__(self, corpus_ids, query_ids, questions, answers, passages,
                 vocab_size, sep_id, positive_rows=None):
        self.corpus_ids = corpus_ids
        self.query_ids = query_ids
        self.questions = questions
        self.answers = answers
        self.passages = passages
        self.vocab_size = vocab_size
        self.sep_id = sep_id
        self.positive_rows = positive_rows

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
                   vocab_size=2048, sep_id=tok.sep_token_id)


def _get_corpus(args, data_cfg) -> _Corpus:
    if args.corpus and args.queries and not args.synthetic:
        return _load_prepared(args)
    if args.corpus or args.queries:
        print("note: --corpus/--queries incomplete; using synthetic corpus",
              file=sys.stderr)
    return _synthesize(args, data_cfg)


def _resume_step(args, name: str):
    """Highest saved ``<name>-<step>`` in --output-dir from a run of the
    same recipe, or None (``--resume never``, no directory, or another
    recipe's checkpoints: restoring those would be silent corruption)."""
    if not args.output_dir or args.resume == "never":
        return None
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
    if optim_cfg.optimizer == "lamb":
        raise NotImplementedError("LAMB is not ported yet (ROADMAP.md "
                                  "Queue 1, item 11)")
    lr = lr_override if lr_override is not None else optim_cfg.learning_rate
    total = steps if steps is not None else optim_cfg.total_steps
    return make_adamw(lr, warmup_steps=min(optim_cfg.warmup_steps, total // 4),
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
    """The initial dual encoder and reranker, with the JAX package's
    initializers drawn from ``torch.Generator``s seeded ``seed`` and
    ``seed + 1``."""
    de = BiEncoder(de_cfg, generator=torch.Generator().manual_seed(seed))
    ce = CrossEncoder(ce_cfg,
                      generator=torch.Generator().manual_seed(seed + 1))
    return de, ce


def run_ar2(name: str, cfg: AR2RecipeConfig, args) -> dict:
    """AR2/SimANS co-training: warm-up -> mine -> alternating co-training
    with a mine at every window boundary -> final eval
    (``SimANS/train_NQ_AR2.sh:15-50``, ``co_training_wiki_train.py:
    606-693``)."""
    t_start = time.time()
    device = resolve_device(args.device)
    data = _get_corpus(args, cfg.data)
    tiny = args.tiny_models or (
        not args.full_size and not (args.corpus and not args.synthetic))
    logger = MetricLogger(args.output_dir)
    steps = args.steps if args.steps is not None else (
        60 if tiny else cfg.max_steps)
    batch_size = args.batch if args.batch is not None else cfg.global_batch
    batch_size = min(batch_size, len(data.query_ids))
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
    if args.init_checkpoint:
        raise NotImplementedError("--init-checkpoint (HF warm starts) is not "
                                  "ported yet (ROADMAP.md Queue 1, item 14)")
    # the RobertaDot projection head only for full-size runs: an extra
    # random layer stalls the tiny from-scratch warm-up
    proj = None if tiny else cfg.retriever.projection_dim
    de, ce = init_models(
        BiEncoderConfig(bert=de_bert, share_weight=cfg.retriever.share_weight,
                        pooling=cfg.retriever.pooling, projection_dim=proj),
        CrossEncoderConfig(bert=ce_bert,
                           binary_head=cfg.reranker.binary_head),
        args.seed)
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
    resume_step = _resume_step(args, "retriever_state")
    de_state = TrainState.create(de, tx_warm_de)
    ce_state = TrainState.create(ce, tx_warm_ce)

    store = (torch.int8 if args.int8_index
             else torch.bfloat16 if device.type == "cuda" else torch.float32)
    index = MIPSIndex(device,
                      block_size=min(8192, max(32, len(data.corpus_ids) // 4)),
                      store_dtype=store, **_index_kwargs(args, device))
    engine = RetrievalEngine(index, data.passages, logger=logger)
    # --fast-encode: mine through a fused-int8 view of the same Parameters;
    # training stays on the bf16 composition
    enc_model = (_int8_view(de, dual_encoder.int8_view) if args.fast_encode
                 else de)
    q_enc = CorpusEncoder(enc_model.encode_query, device,
                          chunk_size=min(1024, max(64, len(data.query_ids))),
                          stall_timeout_s=_stall_timeout(args))
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
        warm_de = make_biencoder_step(tx_warm_de, device)
        warm_ce = make_reranker_step(tx_warm_ce, device)
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
        print(f"[{name}] warmup: top1={res.top_k_hits[0]:.3f}")
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
        print(f"[{name}] resumed at step {resume_step}: "
              f"top1={res.top_k_hits[0]:.3f}")
        first_seed = resume_step
    # --fast-teacher: the retriever step's frozen reranker forward runs
    # through the fused int8 view of the live reranker's Parameters
    teacher = (_int8_view(ce, cross_encoder.int8_view) if args.fast_teacher
               else ce)
    r_step = make_ar2_retriever_step(
        tx_de, temperature=cfg.temperature_normal, adv_lambda=cfg.adv_lambda,
        # --scale_simmila: softmax(scores / sqrt(H))
        scale_scores=(1.0 / float(de_bert.hidden_size) ** 0.5
                      if cfg.scale_simmila else None),
        device=device)
    c_step = make_reranker_step(tx_ce, device)
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
                if args.output_dir:
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
        # a failed background write must not pass for a resumable run
        while pending_saves:
            pending_saves.pop().join()
        if save_errors:
            err = save_errors[0]
            print(f"[{name}] FATAL: background checkpoint write failed: "
                  f"{err!r}", file=sys.stderr, flush=True)
            raise RuntimeError("background checkpoint write failed") from err

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
    print(f"[{name}] phase split ({total_s:.1f}s total):")
    for k, v in sorted(phases.items(), key=lambda kv: -kv[1]):
        print(f"    {k:24s} {v:9.1f}s  {100 * v / total_s:5.1f}%")
    out = {"recipe": name, "steps": steps,
           "top1": final.top_k_hits[0],
           "top5": final.top_k_hits[min(4, topk - 1)],
           "mrr10": final.metrics.get("MRR_n@_10", 0.0),
           "history_top1": history,
           "total_s": total_s,
           "phase_times_s": phases}
    if args.output_dir:
        for state, ckpt in ((trainer.de_state, "retriever"),
                            (trainer.ce_state, "reranker")):
            save_checkpoint(args.output_dir, {"params": host_copy(
                state.state_dict()["params"], device)}, steps, name=ckpt)
        with open(os.path.join(args.output_dir, "eval.json"), "w",
                  encoding="utf-8") as f:
            json.dump(out, f, indent=1)
    # the last boundary's write must land before exit; joined after
    # eval.json so a failed boundary write cannot lose the final outputs
    join_saves()
    logger.close()
    print(f"[{name}] final: top1={out['top1']:.3f} mrr10={out['mrr10']:.3f}")
    return out


# the JAX package's other runners and the ROADMAP.md Queue 1 items that
# bring them to the port
_NOT_PORTED = {
    "KDRecipeConfig": ("run_kd (PROD distillation)", 11),
    "MasterPretrainConfig": ("run_pretrain (MASTER pre-training)", 13),
    "LeadRecipeConfig": ("run_lead (LEAD joint distillation)", 12),
    "CapstoneRecipeConfig": ("run_capstone (CAPSTONE curriculum)", 15),
    "AlliesRecipeConfig": ("run_allies (ALLIES beam-search QA)", 16),
}


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    cfg = RECIPES[args.recipe]
    if not isinstance(cfg, AR2RecipeConfig):
        what, item = _NOT_PORTED[type(cfg).__name__]
        raise NotImplementedError(f"recipe {args.recipe}: {what} is not "
                                  f"ported yet (ROADMAP.md Queue 1, item "
                                  f"{item})")
    if args.output_dir:
        os.makedirs(args.output_dir, exist_ok=True)
    return run_ar2(args.recipe, cfg, args)


if __name__ == "__main__":
    main()
