"""Monte-Carlo sweeps on one device; the multi-device forms wait for ROADMAP §A6."""

from ldpc_tpu_torch.parallel.sharding import (  # noqa: F401
    make_mc_trial,
    mc_sweep,
    trial_data,
    trial_generator,
)
