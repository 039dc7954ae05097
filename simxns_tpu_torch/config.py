"""One typed config tree shared by every phase (own copy of
``simxns_tpu/config.py`` over the port's :class:`BertConfig`).

:data:`RECIPES` records the published launcher settings, so a run is
reproducible from a name:

- ``nq_ar2_simans``   — ``SimANS/train_NQ_AR2.sh:19-33`` (ERNIE-base DE +
  ERNIE-large CE, 8x8 batch, lr 1e-5 / 1e-6, 15 SimANS negatives,
  iteration 2000/500, adv_lambda 0, b=1.0)
- ``marco_ar2_simans``— ``SimANS/train_MS_Pas_AR2.sh`` (abs-mode sampler,
  tau=3)
- ``master_ms_ft``    — ``MASTER/finetune/ft_MS_MASTER.sh:10-22``
- ``prod_kd_marco``, ``prod_kd_nq``, ``prod_kd_marcodoc`` — PROD
  distillation stages (``PROD/README.md:210-225``)
- ``master_pretrain`` — ``MASTER/pretrain`` defaults
- ``tq_ar2_simans``   — ``SimANS/train_TQ_AR2.sh:15-50``
- ``msdoc_ar2_simans``— ``SimANS/train_MS_Doc_AR2.sh:10-50`` (RobertaDot
  towers + STAR BPE, seq 512, iteration 5000/1000, adv_lambda 1)
- ``lead_ms_distill``, ``capstone_curriculum``, ``allies_qa``

The port's launcher runs the AR2 recipes; the others keep their configs
here so that ``--recipe`` keeps its choices, and their runners raise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from simxns_tpu_torch.models.bert import BertConfig


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    learning_rate: float = 1e-5
    warmup_steps: int = 0
    total_steps: int = 30_000
    weight_decay: float = 0.01
    adam_epsilon: float = 1e-8
    max_grad_norm: float = 1.0
    optimizer: str = "adamw"            # "adamw" | "lamb"


@dataclasses.dataclass(frozen=True)
class DataConfig:
    train_path: str = ""
    dev_path: str = ""
    passage_path: str = ""
    qa_paths: tuple = ()
    max_q_length: int = 32
    max_ctx_length: int = 128
    max_joint_length: int = 160
    num_negatives: int = 15
    # SimANS sampler (mode None -> plain neg_type selection)
    simans_mode: Optional[str] = "quadratic"
    simans_a: float = 0.5
    simans_b: float = 0.0
    simans_tau: float = 3.0
    neg_type: str = "random"


@dataclasses.dataclass(frozen=True)
class RetrieverConfig:
    bert: BertConfig = dataclasses.field(default_factory=BertConfig)
    share_weight: bool = False
    pooling: str = "cls"
    projection_dim: Optional[int] = None
    score_scale: float = 1.0            # 20.0 for the _daya variant


@dataclasses.dataclass(frozen=True)
class RerankerConfig:
    bert: BertConfig = dataclasses.field(default_factory=lambda: BertConfig(
        num_layers=24, hidden_size=1024, num_heads=16,
        intermediate_size=4096))        # ERNIE-large shape
    binary_head: bool = False
    per_layer_logits: bool = False


@dataclasses.dataclass(frozen=True)
class AR2RecipeConfig:
    """One AR2+SimANS co-training run (train + mine phases)."""
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    retriever: RetrieverConfig = dataclasses.field(
        default_factory=RetrieverConfig)
    reranker: RerankerConfig = dataclasses.field(
        default_factory=RerankerConfig)
    retriever_optim: OptimConfig = dataclasses.field(
        default_factory=lambda: OptimConfig(learning_rate=1e-5,
                                            warmup_steps=2000))
    reranker_optim: OptimConfig = dataclasses.field(
        default_factory=lambda: OptimConfig(learning_rate=1e-6,
                                            warmup_steps=2000))
    global_batch: int = 64               # 8 GPUs x 8 per device
    iteration_step: int = 2000
    iteration_reranker_step: int = 500
    max_steps: int = 30_000
    topk: int = 100
    temperature_normal: float = 1.0
    adv_lambda: float = 0.0              # launcher uses 0 w/ --normal_loss
    scale_simmila: bool = False


@dataclasses.dataclass(frozen=True)
class KDRecipeConfig:
    """PROD progressive distillation stage.

    Hyperparameters are the published 12CE->6DE distill command
    (``PROD/README.md:210-225``): lr 5e-5, warmup 4000, 40k steps,
    global batch 8x8, ``--number_neg 15 --open_LwF --KD_type KD_softmax
    --CE_WEIGHT 0.1 --KD_WEIGHT 0.9 --TEMPERATURE 4.0 --LwF_WEIGHT 1.0
    --teacher_type cross_encoder``. The three dataset launchers share one
    flag surface (``run_progressive_distill_{marco,nq,marcodoc}.py`` —
    README.md:62 swaps only the dataset name); recipes differ in data
    shapes only.
    """
    data: DataConfig = dataclasses.field(default_factory=lambda: DataConfig(
        simans_mode=None, num_negatives=15, max_joint_length=160))
    student: RetrieverConfig = dataclasses.field(
        default_factory=lambda: RetrieverConfig(
            bert=BertConfig(num_layers=6)))
    optim: OptimConfig = dataclasses.field(
        default_factory=lambda: OptimConfig(learning_rate=5e-5,
                                            warmup_steps=4000))
    teacher_type: str = "cross_encoder"
    kd_type: str = "KD_softmax"
    temperature: float = 4.0
    ce_weight: float = 0.1
    kd_weight: float = 0.9
    lwf_weight: float = 1.0
    dkd_alpha: float = 1.0
    dkd_beta: float = 1.0
    global_batch: int = 64
    max_steps: int = 40_000


@dataclasses.dataclass(frozen=True)
class MasterPretrainConfig:
    bert: BertConfig = dataclasses.field(default_factory=BertConfig)
    n_head_layers: int = 2
    mlm_probability: float = 0.30
    decoder_mlm_probability: float = 0.50
    max_seq_length: int = 128
    # run_pretrain.sh: lr 3e-4, warmup_ratio 0.1, per-device 128 x 8 GPUs
    # x grad-accum 2 = global batch 2048, 40 epochs (total_steps here is a
    # step-count stand-in for the epoch budget; warmup = 10% of it)
    optim: OptimConfig = dataclasses.field(
        default_factory=lambda: OptimConfig(learning_rate=3e-4,
                                            warmup_steps=8_000,
                                            total_steps=80_000))
    global_batch: int = 2048


@dataclasses.dataclass(frozen=True)
class LeadRecipeConfig:
    """LEAD joint distillation: 12-layer CE teacher + 6-layer DE student
    trained TOGETHER (``distill_from_12ce_to_6de.sh:40-71``: --distill_ce
    --train_ce --distill_db --train_db --distill_ce_db_layer_score
    --layer_selection_random --layer_score_reweight --share_weight)."""
    data: DataConfig = dataclasses.field(default_factory=lambda: DataConfig(
        num_negatives=1, simans_mode=None, max_joint_length=160))
    student: RetrieverConfig = dataclasses.field(
        default_factory=lambda: RetrieverConfig(
            bert=BertConfig(num_layers=6), share_weight=True))
    teacher_ce: RerankerConfig = dataclasses.field(
        default_factory=lambda: RerankerConfig(
            bert=BertConfig(), per_layer_logits=True))
    optim: OptimConfig = dataclasses.field(
        default_factory=lambda: OptimConfig(learning_rate=5e-5))
    temperature: float = 1.0
    layer_temperature: float = 10.0
    num_distill_layers: int = 3
    layer_selection: str = "random"
    reweight: bool = True
    train_ce: bool = True                # False = distill from a FROZEN
                                         # trained CE (the reference wraps
                                         # frozen models without DDP,
                                         # LEAD/run_LEAD.py:65-73); frozen
                                         # teachers take the --fast-teacher
                                         # fused-int8 view
    save_steps: int = 10                 # layer re-draw interval
    grad_accum: int = 10
    warmup_ratio: float = 0.1
    global_batch: int = 64
    max_steps: int = 100_000


@dataclasses.dataclass(frozen=True)
class CapstoneRecipeConfig:
    """CAPSTONE curriculum DE training over a doc2query-expanded corpus
    (``run_de_model_expand_corpus_cocondenser.sh:14-40``)."""
    data: DataConfig = dataclasses.field(default_factory=lambda: DataConfig(
        num_negatives=31, simans_mode=None, max_q_length=32,
        max_ctx_length=144))
    retriever: RetrieverConfig = dataclasses.field(
        default_factory=RetrieverConfig)
    optim: OptimConfig = dataclasses.field(
        default_factory=lambda: OptimConfig(learning_rate=5e-6,
                                            warmup_steps=2000,
                                            total_steps=20_000))
    select_generated_query: str = "gradual"
    total_part: int = 3
    delimiter: str = "sep"               # "sep" -> ' [SEP] ', "blank" -> ' '
    gold_query_prob: float = 0.0
    top_k_query: int = 1                 # inference-time corpus expansion
    shuffle_positives: bool = True
    global_batch: int = 64
    max_steps: int = 20_000


@dataclasses.dataclass(frozen=True)
class AlliesRecipeConfig:
    """ALLIES beam-search QA over a dense retriever + LLM
    (``ALLIES/main.py:11-160`` argparse defaults)."""
    beam_size: int = 2
    beam_depth: int = 2
    threshold: float = 0.8
    retrieval_type: str = "retrieve"     # "retrieve" | "generate"
    summarize: bool = False
    topk: int = 5
    ask_question_num: int = 2


RECIPES = {
    "nq_ar2_simans": AR2RecipeConfig(
        data=DataConfig(num_negatives=15, simans_mode="quadratic",
                        simans_a=0.5, simans_b=1.0, max_ctx_length=128),
        adv_lambda=0.0, temperature_normal=1.0),
    "marco_ar2_simans": AR2RecipeConfig(
        data=DataConfig(num_negatives=15, simans_mode="abs", simans_tau=3.0,
                        max_ctx_length=128, max_joint_length=160),
        retriever_optim=OptimConfig(learning_rate=5e-6, warmup_steps=2000),
        reranker_optim=OptimConfig(learning_rate=1e-6, warmup_steps=2000)),
    "master_ms_ft": AR2RecipeConfig(
        data=DataConfig(num_negatives=31, simans_mode=None,
                        max_ctx_length=128),
        retriever_optim=OptimConfig(learning_rate=5e-6, warmup_steps=1000,
                                    total_steps=30_000),
        max_steps=30_000),
    "prod_kd_marco": KDRecipeConfig(),
    # NQ progressive distillation (run_progressive_distill_nq.py): same
    # published pipeline (README.md:62 — "just modify the data set name"),
    # DPR-style passages at seq 128 (:874), question budget 32
    "prod_kd_nq": KDRecipeConfig(
        data=DataConfig(simans_mode=None, num_negatives=15,
                        max_q_length=32, max_ctx_length=128,
                        max_joint_length=160)),
    # MARCO-Document progressive distillation
    # (run_progressive_distill_marcodoc.py): documents are
    # url<sep>title<sep>body (utils/marco_until.py:209-212) at seq 256
    # (inference_DE_marcodoc.py:650), query budget 32 (marco_until.py:72);
    # the CE joint window widens to hold the doc + query
    "prod_kd_marcodoc": KDRecipeConfig(
        data=DataConfig(simans_mode=None, num_negatives=15,
                        max_q_length=32, max_ctx_length=256,
                        max_joint_length=288)),
    "master_pretrain": MasterPretrainConfig(),
    # TriviaQA co-training (train_TQ_AR2.sh:15-50): NQ structure with
    # lr 5e-6, 10k steps, warmup 1000, SimANS b=0
    "tq_ar2_simans": AR2RecipeConfig(
        data=DataConfig(num_negatives=15, simans_mode="quadratic",
                        simans_a=0.5, simans_b=0.0, max_ctx_length=128),
        retriever_optim=OptimConfig(learning_rate=5e-6, warmup_steps=1000,
                                    total_steps=10_000),
        reranker_optim=OptimConfig(learning_rate=1e-6, warmup_steps=1000,
                                   total_steps=10_000),
        max_steps=10_000, adv_lambda=0.0, temperature_normal=1.0),
    # MS-MARCO Doc co-training (train_MS_Doc_AR2.sh:10-50): RobertaDot
    # projection towers over STAR BPE, seq 512, 32x8 batch, distill loss
    # (adv_lambda 1), iteration 5000/1000
    "msdoc_ar2_simans": AR2RecipeConfig(
        data=DataConfig(num_negatives=15, simans_mode="abs", simans_tau=3.0,
                        max_q_length=32, max_ctx_length=512,
                        max_joint_length=512),
        retriever=RetrieverConfig(
            bert=BertConfig(vocab_size=50265), projection_dim=768),
        reranker=RerankerConfig(bert=BertConfig(vocab_size=50265)),
        retriever_optim=OptimConfig(learning_rate=5e-6, warmup_steps=2000,
                                    total_steps=40_000),
        reranker_optim=OptimConfig(learning_rate=1e-6, warmup_steps=2000,
                                   total_steps=40_000),
        global_batch=256, iteration_step=5000,
        iteration_reranker_step=1000, max_steps=40_000, adv_lambda=1.0),
    "lead_ms_distill": LeadRecipeConfig(),
    "capstone_curriculum": CapstoneRecipeConfig(),
    "allies_qa": AlliesRecipeConfig(),
}
