from simxns_tpu_torch.data.collator import CondenserCollator, TokenMeta
from simxns_tpu_torch.data.datasets import (load_id_text, load_passages_tsv,
                                            load_qrels)
from simxns_tpu_torch.data.mined import MinedDataset, from_mining_result
from simxns_tpu_torch.data.sampling import (sample_hard_negatives,
                                            select_negatives, simans_weights)
from simxns_tpu_torch.data.tokenization import HashTokenizer, Tokenizer, pad_to

__all__ = ["CondenserCollator", "HashTokenizer", "MinedDataset", "TokenMeta",
           "Tokenizer", "from_mining_result", "load_id_text",
           "load_passages_tsv", "load_qrels", "pad_to",
           "sample_hard_negatives", "select_negatives", "simans_weights"]
