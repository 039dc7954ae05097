from simxns_tpu_torch.index.engine import (CorpusEncoder, MIPSIndex,
                                           MiningResult, RetrievalEngine,
                                           reform_out)

__all__ = ["CorpusEncoder", "MIPSIndex", "MiningResult", "RetrievalEngine",
           "reform_out"]
