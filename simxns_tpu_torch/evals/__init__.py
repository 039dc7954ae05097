"""Host-side evaluation: hit labeling, the retrieval metrics (DPR, MS
MARCO, TREC) and cross-encoder reranking of top-k lists."""

from simxns_tpu_torch.evals.metrics import (dcg_n, get_metrics, map_n,
                                            marco_mrr_at_k,
                                            marco_recall_at_k, mrr_n, ndcg_n,
                                            p_n, top_k_hits_accuracy,
                                            trec_eval_all, trec_map_at_k,
                                            trec_ndcg_at_k, trec_recall_at_k,
                                            trec_recip_rank,
                                            write_eval_result)
from simxns_tpu_torch.evals.qa_match import (SimpleTokenizer, check_answer,
                                             has_answer)
from simxns_tpu_torch.evals.rerank import build_joint_inputs, rerank_topk

__all__ = ["SimpleTokenizer", "build_joint_inputs", "check_answer",
           "dcg_n", "get_metrics", "has_answer", "map_n", "marco_mrr_at_k",
           "marco_recall_at_k", "mrr_n", "ndcg_n", "p_n", "rerank_topk",
           "top_k_hits_accuracy", "trec_eval_all", "trec_map_at_k",
           "trec_ndcg_at_k", "trec_recall_at_k", "trec_recip_rank",
           "write_eval_result"]
