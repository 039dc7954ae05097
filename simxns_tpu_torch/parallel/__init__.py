from simxns_tpu_torch.parallel.collectives import (all_gather_full_grad,
                                                   all_gather_local_grad,
                                                   all_reduce_grads,
                                                   gather_in_batch_negatives,
                                                   gather_positive_offsets)
from simxns_tpu_torch.parallel.mesh import (Mesh, create_mesh, dp_size,
                                            local_batch_size, pad_to_multiple,
                                            shard_batch)
from simxns_tpu_torch.parallel.sync import force_sync
from simxns_tpu_torch.parallel.watchdog import (StallError, retry_on_stall,
                                                run_with_deadline)

__all__ = ["Mesh", "StallError", "all_gather_full_grad",
           "all_gather_local_grad", "all_reduce_grads", "create_mesh",
           "dp_size", "force_sync", "gather_in_batch_negatives",
           "gather_positive_offsets", "local_batch_size", "pad_to_multiple",
           "retry_on_stall", "run_with_deadline", "shard_batch"]
