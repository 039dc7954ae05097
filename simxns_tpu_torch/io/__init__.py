from simxns_tpu_torch.io.checkpoint import (latest_step, restore_checkpoint,
                                            save_checkpoint)
from simxns_tpu_torch.io.logging import MetricLogger

__all__ = ["MetricLogger", "latest_step", "restore_checkpoint",
           "save_checkpoint"]
