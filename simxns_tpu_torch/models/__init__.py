from simxns_tpu_torch.models.bert import (BertConfig, BertEncoder, MLMHead,
                                          truncate_layers)
from simxns_tpu_torch.models.colbert import (ColBERT, ColBERTConfig,
                                             maxsim_score,
                                             maxsim_score_paired)
from simxns_tpu_torch.models.condenser import (Condenser, CondenserConfig,
                                               cocondenser_span_loss,
                                               mlm_loss_from_logits)
from simxns_tpu_torch.models.convert import params_from_jax
from simxns_tpu_torch.models.cross_encoder import (CrossEncoder,
                                                   CrossEncoderConfig,
                                                   int8_view)
from simxns_tpu_torch.models.dual_encoder import BiEncoder, BiEncoderConfig

__all__ = ["BertConfig", "BertEncoder", "BiEncoder", "BiEncoderConfig",
           "ColBERT", "ColBERTConfig", "Condenser", "CondenserConfig",
           "CrossEncoder", "CrossEncoderConfig", "MLMHead",
           "cocondenser_span_loss", "int8_view", "maxsim_score",
           "maxsim_score_paired", "mlm_loss_from_logits", "params_from_jax",
           "truncate_layers"]
