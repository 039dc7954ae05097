from simxns_tpu_torch.models.bert import BertConfig, BertEncoder
from simxns_tpu_torch.models.convert import params_from_jax
from simxns_tpu_torch.models.cross_encoder import (CrossEncoder,
                                                   CrossEncoderConfig,
                                                   int8_view)
from simxns_tpu_torch.models.dual_encoder import BiEncoder, BiEncoderConfig

__all__ = ["BertConfig", "BertEncoder", "BiEncoder", "BiEncoderConfig",
           "CrossEncoder", "CrossEncoderConfig", "int8_view",
           "params_from_jax"]
