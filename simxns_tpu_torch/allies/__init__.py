from simxns_tpu_torch.allies.beam import (ALLIESConfig, BeamNode, LLMClient,
                                          allies_answer)
from simxns_tpu_torch.allies.qa_metrics import exact_match, f1_score, rouge_l
from simxns_tpu_torch.allies.scripted import EvidenceLLM

__all__ = ["ALLIESConfig", "BeamNode", "EvidenceLLM", "LLMClient",
           "allies_answer", "exact_match", "f1_score", "rouge_l"]
