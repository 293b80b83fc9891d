"""Decoder model families: the classical decoders and the message-centered
GNN family (fully neural, hybrid and corrected min-sum).  The neural min-sum
and node-centered GNN families follow in later slices."""

from ldpc_tpu_torch.models.classical import (  # noqa: F401
    BeliefPropagationDecoder,
    DecodeResult,
    MinSumScaledDecoder,
    decode_bp,
    decode_min_sum,
)
from ldpc_tpu_torch.models.message_gnn import (  # noqa: F401
    MessageGNNDecoder,
    MessageGNNLayer,
    create_corrected_minsum_gnn_decoder,
    create_custom_check_message_gnn_decoder,
    create_custom_minsum_message_gnn_decoder,
    create_custom_variable_message_gnn_decoder,
    create_message_gnn_decoder,
)
