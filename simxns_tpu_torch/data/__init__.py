from simxns_tpu_torch.data.collator import CondenserCollator, TokenMeta
from simxns_tpu_torch.data.datasets import (Passage, RetrievalCollator,
                                            RetrievalDataset,
                                            RetrievalExample, load_id_text,
                                            load_marco_tsv, load_msdoc_tsv,
                                            load_passages_tsv, load_qa_csv,
                                            load_qrels, load_trec_qrels,
                                            load_wiki_json,
                                            normalize_question,
                                            pack_msdoc_text)
from simxns_tpu_torch.data.mined import MinedDataset, from_mining_result
from simxns_tpu_torch.data.sampling import (sample_hard_negatives,
                                            select_negatives, simans_weights)
from simxns_tpu_torch.data.star_bpe import (StarRobertaTokenizer,
                                            load_star_tokenizer)
from simxns_tpu_torch.data.tokenization import (HashTokenizer, Tokenizer,
                                                load_hf_tokenizer, pack_joint,
                                                pad_to)

__all__ = ["CondenserCollator", "HashTokenizer", "MinedDataset", "Passage",
           "RetrievalCollator", "RetrievalDataset", "RetrievalExample",
           "StarRobertaTokenizer", "TokenMeta", "Tokenizer",
           "from_mining_result", "load_hf_tokenizer", "load_id_text",
           "load_marco_tsv", "load_msdoc_tsv", "load_passages_tsv",
           "load_qa_csv", "load_qrels", "load_star_tokenizer",
           "load_trec_qrels", "load_wiki_json", "normalize_question",
           "pack_joint", "pack_msdoc_text", "pad_to",
           "sample_hard_negatives", "select_negatives", "simans_weights"]
