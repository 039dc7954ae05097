from simxns_tpu_torch.parallel.mesh import pad_to_multiple
from simxns_tpu_torch.parallel.sync import force_sync
from simxns_tpu_torch.parallel.watchdog import (StallError, retry_on_stall,
                                                run_with_deadline)

__all__ = ["StallError", "force_sync", "pad_to_multiple", "retry_on_stall",
           "run_with_deadline"]
