from simxns_tpu_torch.data.tokenization import HashTokenizer, Tokenizer, pad_to

__all__ = ["HashTokenizer", "Tokenizer", "pad_to"]
