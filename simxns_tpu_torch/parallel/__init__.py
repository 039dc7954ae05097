from simxns_tpu_torch.parallel.collectives import (all_gather_full_grad,
                                                   all_gather_local_grad,
                                                   all_reduce_grads,
                                                   gather_in_batch_negatives,
                                                   gather_positive_offsets)
from simxns_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS,
                                            REPLICA_AXIS, Mesh, create_mesh,
                                            create_multislice_mesh, dp_axes,
                                            dp_size, local_batch_size,
                                            pad_to_multiple, shard_batch)
from simxns_tpu_torch.parallel.sync import force_sync
from simxns_tpu_torch.parallel.tp import (full_state_dict, load_full_state,
                                          shard_params, tp_param_shardings)
from simxns_tpu_torch.parallel.watchdog import (StallError, retry_on_stall,
                                                run_with_deadline)

__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "REPLICA_AXIS", "StallError",
           "all_gather_full_grad", "all_gather_local_grad",
           "all_reduce_grads", "create_mesh", "create_multislice_mesh",
           "dp_axes", "dp_size", "force_sync", "full_state_dict",
           "gather_in_batch_negatives", "gather_positive_offsets",
           "load_full_state", "local_batch_size", "pad_to_multiple",
           "retry_on_stall", "run_with_deadline", "shard_batch",
           "shard_params", "tp_param_shardings"]
