from simxns_tpu_torch.index.engine import CorpusEncoder, MIPSIndex

__all__ = ["CorpusEncoder", "MIPSIndex"]
