"""Decoder model families.  This slice ports the classical decoders; the
neural min-sum and GNN families follow in later slices."""

from ldpc_tpu_torch.models.classical import (  # noqa: F401
    BeliefPropagationDecoder,
    DecodeResult,
    MinSumScaledDecoder,
    decode_bp,
    decode_min_sum,
)
