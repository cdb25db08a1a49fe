from bist_tpu_torch.parallel.mesh import (
    DataParallel, batch_sharding, local_devices, make_mesh, replicate, shard_batch,
)
from bist_tpu_torch.parallel.multihost import init_multihost, local_example_slice
