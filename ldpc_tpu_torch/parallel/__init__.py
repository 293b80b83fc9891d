"""Process groups, meshes, sharded Monte-Carlo sweeps, sharded decoding and
data-parallel training on ``torch.distributed``."""

from ldpc_tpu_torch.parallel.mesh import (  # noqa: F401
    batch_sharding,
    distributed_init,
    make_mesh,
    replicated,
)
from ldpc_tpu_torch.parallel.sharding import (  # noqa: F401
    make_mc_trial,
    make_sharded_train_step,
    mc_sweep,
    shard_decode,
    trial_data,
    trial_generator,
)
