"""Training, checkpointing and comparative evaluation."""

from ldpc_tpu_torch.training.checkpoint import CheckpointManager  # noqa: F401
from ldpc_tpu_torch.training.evaluator import ComparativeEvaluator  # noqa: F401
from ldpc_tpu_torch.training.trainer import LDPCDecoderTrainer  # noqa: F401
