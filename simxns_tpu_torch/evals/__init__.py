"""Host-side evaluation: hit labeling and retrieval metrics (no rerank
module here: the JAX package's imports JAX)."""

from simxns_tpu_torch.evals.metrics import (get_metrics, map_n, mrr_n,
                                            ndcg_n, p_n, top_k_hits_accuracy)
from simxns_tpu_torch.evals.qa_match import (SimpleTokenizer, check_answer,
                                             has_answer)

__all__ = ["SimpleTokenizer", "check_answer", "get_metrics", "has_answer",
           "map_n", "mrr_n", "ndcg_n", "p_n", "top_k_hits_accuracy"]
