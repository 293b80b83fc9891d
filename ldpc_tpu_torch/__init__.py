"""ldpc_tpu_torch — the PyTorch and CUDA port of ``ldpc_tpu``.

A second package beside the JAX one, held against it in the tests.  It
imports torch and numpy only, never JAX or ``ldpc_tpu``:

- 5G NR base-graph registry + QC lifting           -> :mod:`ldpc_tpu_torch.codes`
- BPSK/QPSK + AWGN channel + LLR demodulation      -> :mod:`ldpc_tpu_torch.utils.channel`
- QC message-passing ops (plain PyTorch)           -> :mod:`ldpc_tpu_torch.ops.qc_msg`
- Fused decode kernels, CUDA C++ for Hopper        -> :mod:`ldpc_tpu_torch.ops.fused_minsum`
- Classical BP / scaled min-sum decoders           -> :mod:`ldpc_tpu_torch.models`
- Message-centered GNN decoder family              -> :mod:`ldpc_tpu_torch.models.message_gnn`
- Neural / offset min-sum decoders                 -> :mod:`ldpc_tpu_torch.models.neural_min_sum`
- Node-centered GNN decoder                        -> :mod:`ldpc_tpu_torch.models.gnn`
- Training, checkpoints, comparative evaluation    -> :mod:`ldpc_tpu_torch.training`
- Monte-Carlo BER/FER sweeps (one device)          -> :mod:`ldpc_tpu_torch.parallel`
- Fused GNN serving kernels, CUDA C++              -> :mod:`ldpc_tpu_torch.ops.fused_gnn`
- Fused trained min-sum kernel, CUDA C++           -> :mod:`ldpc_tpu_torch.ops.fused_neural`
- flax msgpack checkpoints -> ``state_dict``       -> :mod:`ldpc_tpu_torch.convert`
- Serving entry point (``python -m``)              -> :mod:`ldpc_tpu_torch.serve_trained_decoder`
- GNN kernel bench, aggregation probe (``-m``)     -> :mod:`ldpc_tpu_torch.tools`
- Rooflines at the H100's peaks, profiler traces  -> :mod:`ldpc_tpu_torch.utils.profiling`

Entry points take ``device`` (default ``"cuda"``) and raise without a card
unless given ``device="cpu"``; random functions take a ``torch.Generator``.
"""

__version__ = "0.1.0"

from ldpc_tpu_torch.codes import (  # noqa: F401
    BaseGraph,
    load_base_matrix,
    get_base_graph,
    expand_base_matrix,
    EdgeLayout,
    QCLayout,
)
from ldpc_tpu_torch.training import LDPCDecoderTrainer  # noqa: F401,E402
