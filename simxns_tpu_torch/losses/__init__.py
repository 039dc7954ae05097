from simxns_tpu_torch.losses.contrastive import (grouped_nll, in_batch_nll,
                                                 similarity_scores)
from simxns_tpu_torch.losses.distill import (ar2_retriever_loss,
                                             bi_logit_loss,
                                             colbert_teacher_scores,
                                             dkd_loss, embedding_mse_loss,
                                             kd_logit_mse_loss,
                                             kd_softmax_loss, mixed_kd_loss,
                                             multi_teacher_kd_loss,
                                             prob_loss)

__all__ = ["ar2_retriever_loss", "bi_logit_loss", "colbert_teacher_scores",
           "dkd_loss", "embedding_mse_loss", "grouped_nll", "in_batch_nll",
           "kd_logit_mse_loss", "kd_softmax_loss", "mixed_kd_loss",
           "multi_teacher_kd_loss", "prob_loss", "similarity_scores"]
