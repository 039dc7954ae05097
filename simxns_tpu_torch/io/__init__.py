from simxns_tpu_torch.io.checkpoint import (encoder_into,
                                            export_encoder_only, latest_step,
                                            restore_checkpoint,
                                            save_checkpoint)
from simxns_tpu_torch.io.logging import MetricLogger

__all__ = ["MetricLogger", "encoder_into", "export_encoder_only",
           "latest_step", "restore_checkpoint", "save_checkpoint"]
