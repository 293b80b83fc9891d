"""Utilities: channel simulation, metrics, profiling and rooflines."""

from ldpc_tpu_torch.utils.channel import (  # noqa: F401
    awgn_channel,
    bpsk_awgn_llr,
    bpsk_modulate,
    compute_ber_fer,
    error_counts,
    qpsk_awgn_llr,
    qpsk_demodulate,
    qpsk_modulate,
    snr_db_to_linear,
)
