from simxns_tpu_torch.losses.contrastive import (grouped_nll, in_batch_nll,
                                                 similarity_scores)
from simxns_tpu_torch.losses.distill import ar2_retriever_loss

__all__ = ["ar2_retriever_loss", "grouped_nll", "in_batch_nll",
           "similarity_scores"]
