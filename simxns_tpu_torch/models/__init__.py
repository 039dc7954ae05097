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
from simxns_tpu_torch.models.hf_import import (as_biencoder_params,
                                               config_from_hf_params,
                                               convert_hf_auto,
                                               convert_hf_bert,
                                               convert_hf_distilbert,
                                               convert_hf_electra,
                                               convert_hf_roberta,
                                               load_hf_bert_encoder,
                                               robertadot_projection,
                                               sniff_hf_family,
                                               convert_hf_t5,
                                               t5_config_from_state_dict)
from simxns_tpu_torch.models.reader import Reader, ReaderConfig, reader_loss
from simxns_tpu_torch.models.seq2seq import (Seq2Seq, Seq2SeqConfig,
                                             queries_to_tsv, seq2seq_lm_loss)
from simxns_tpu_torch.models.seq2seq import generate as seq2seq_generate
from simxns_tpu_torch.models.t5 import T5, T5Config, doc2query_tsv
from simxns_tpu_torch.models.t5 import generate as t5_generate

__all__ = ["BertConfig", "BertEncoder", "BiEncoder", "BiEncoderConfig",
           "ColBERT", "ColBERTConfig", "Condenser", "CondenserConfig",
           "CrossEncoder", "CrossEncoderConfig", "MLMHead",
           "cocondenser_span_loss", "int8_view", "maxsim_score",
           "maxsim_score_paired", "mlm_loss_from_logits", "params_from_jax",
           "Reader", "ReaderConfig", "as_biencoder_params",
           "config_from_hf_params", "convert_hf_auto", "convert_hf_bert",
           "convert_hf_distilbert", "convert_hf_electra",
           "convert_hf_roberta", "load_hf_bert_encoder", "reader_loss",
           "robertadot_projection", "sniff_hf_family", "truncate_layers",
           "Seq2Seq", "Seq2SeqConfig", "seq2seq_generate", "queries_to_tsv",
           "seq2seq_lm_loss", "T5", "T5Config", "doc2query_tsv",
           "t5_generate", "convert_hf_t5", "t5_config_from_state_dict"]
