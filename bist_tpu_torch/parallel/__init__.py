from bist_tpu_torch.parallel.mesh import (
    DataParallel, batch_sharding, local_devices, make_mesh, replicate, shard_batch,
)
from bist_tpu_torch.parallel.multihost import init_multihost, local_example_slice
from bist_tpu_torch.parallel.tp import (
    TensorParallel, gather_params, param_specs, shard_params, tensor_parallel,
    validate_tp_config,
)
from bist_tpu_torch.parallel.sp import (
    SequenceParallel, batch_specs, sequence_parallel, validate_sp_batch,
)
