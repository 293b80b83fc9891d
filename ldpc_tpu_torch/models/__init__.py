"""Decoder model families: the classical decoders, the neural min-sum
decoders and the message-centered GNN family (fully neural, hybrid and
corrected min-sum).  The node-centered GNN follows in a later slice."""

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
from ldpc_tpu_torch.models.neural_min_sum import (  # noqa: F401
    NeuralMinSumDecoder,
    make_standard_decoder,
    make_tied_decoder,
)
