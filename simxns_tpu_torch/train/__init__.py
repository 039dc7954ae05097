from simxns_tpu_torch.train.lead import LeadConfig, make_lead_step
from simxns_tpu_torch.train.kd import (make_ce_kd_step, make_kd_step,
                                      soft_kd_loss)
from simxns_tpu_torch.train.optim import (AdamW, Lamb, linear_warmup_schedule,
                                          make_adamw, make_lamb)
from simxns_tpu_torch.train.pipeline import (Pipeline, Stage, division_stage,
                                             refresh_stage, train_stage)
from simxns_tpu_torch.train.state import TrainState
from simxns_tpu_torch.train.pretrain import (make_condenser_step,
                                             make_electra_step)
from simxns_tpu_torch.train.steps import (make_ar2_retriever_step,
                                          make_biencoder_step,
                                          make_colbert_step,
                                          make_reranker_step)

__all__ = ["AdamW", "Lamb", "LeadConfig", "Pipeline", "Stage", "TrainState",
           "division_stage", "linear_warmup_schedule", "make_adamw",
           "make_ar2_retriever_step", "make_biencoder_step",
           "make_ce_kd_step", "make_colbert_step", "make_condenser_step",
           "make_electra_step", "make_kd_step", "make_lamb",
           "make_lead_step", "make_reranker_step", "refresh_stage",
           "soft_kd_loss", "train_stage"]
