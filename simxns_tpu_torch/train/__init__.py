from simxns_tpu_torch.train.optim import (AdamW, linear_warmup_schedule,
                                          make_adamw)
from simxns_tpu_torch.train.state import TrainState
from simxns_tpu_torch.train.steps import (make_ar2_retriever_step,
                                          make_biencoder_step,
                                          make_reranker_step)

__all__ = ["AdamW", "TrainState", "linear_warmup_schedule", "make_adamw",
           "make_ar2_retriever_step", "make_biencoder_step",
           "make_reranker_step"]
