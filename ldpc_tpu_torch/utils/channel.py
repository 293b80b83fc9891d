"""Modulation, AWGN channel simulation, LLR demodulation, and error metrics
(counterpart of ``ldpc_tpu.utils.channel``).

Every random function takes an explicit ``torch.Generator`` and draws its
noise on the generator's device, which must be the device of the input bits.
The generators of torch and JAX never give the same numbers from one seed, so
the tests hold the two packages against each other with identical noise
arrays, and hold generated LLRs statistically.

QPSK symbols are real arrays of shape ``(..., n_symbols, 2)`` carrying (I, Q),
as in the JAX package.

Noise-variance convention: SNR is Es/N0 in dB.

* ``consistent`` (default): per-component noise variance sigma^2 = 1/(2*snr)
  and LLR = 2 r / sigma^2; channel and demodulator agree.
* ``reference_package``: the channel adds per-component variance 1/(2*snr)
  but the demodulator divides by sigma^2 = 1/snr, halving the LLR scale.

BPSK uses a real channel with noise std 1/sqrt(snr) and LLR = 2 r / sigma^2.
"""
from __future__ import annotations

import math

import torch


def snr_db_to_linear(snr_db, device=None) -> torch.Tensor:
    return 10.0 ** (torch.as_tensor(snr_db, dtype=torch.float32, device=device) / 10.0)


def ebn0_to_esn0(ebn0_db, code_rate: float, bits_per_symbol: int = 2) -> torch.Tensor:
    """Eb/N0 (dB) -> Es/N0 (dB): Es/N0 = Eb/N0 + 10 log10(rate * bits/sym)."""
    return torch.as_tensor(ebn0_db, dtype=torch.float32) + 10.0 * math.log10(
        code_rate * bits_per_symbol
    )


def _normal(generator: torch.Generator, like: torch.Tensor) -> torch.Tensor:
    # torch raises if the generator lives on another device than ``like``.
    return torch.randn(like.shape, generator=generator, device=like.device,
                       dtype=torch.float32)


# ---------------------------------------------------------------------------
# BPSK one-shot channel
# ---------------------------------------------------------------------------


def bpsk_modulate(bits: torch.Tensor) -> torch.Tensor:
    """0 -> +1, 1 -> -1."""
    return 1.0 - 2.0 * bits.to(torch.float32)


def bpsk_awgn_llr(generator: torch.Generator, bits: torch.Tensor, snr_db) -> torch.Tensor:
    """BPSK + AWGN + LLR in one shot.  LLR > 0 favours bit 0.

    Noise std 1/sqrt(snr_linear), LLR = 2 r / sigma^2.
    """
    snr = snr_db_to_linear(snr_db, bits.device)
    sigma = torch.rsqrt(snr)
    symbols = bpsk_modulate(bits)
    received = symbols + sigma * _normal(generator, symbols)
    return 2.0 * received / (sigma * sigma)


# ---------------------------------------------------------------------------
# QPSK pipeline (real I/Q representation)
# ---------------------------------------------------------------------------


def qpsk_modulate(bits: torch.Tensor) -> torch.Tensor:
    """Gray QPSK: even bits -> I, odd bits -> Q, each 0 -> +1/sqrt2, 1 -> -1/sqrt2.

    Odd bit counts are padded with a 0 bit.  Returns float32 of shape
    (..., ceil(n/2), 2) carrying (I, Q).
    """
    n = bits.shape[-1]
    if n % 2 == 1:
        bits = torch.nn.functional.pad(bits, (0, 1))
    symbols = (1.0 - 2.0 * bits.to(torch.float32)) / torch.sqrt(
        torch.tensor(2.0, dtype=torch.float32, device=bits.device)
    )
    return symbols.reshape(*bits.shape[:-1], -1, 2)


def awgn_channel(generator: torch.Generator, symbols: torch.Tensor, snr_db,
                 convention: str = "consistent") -> torch.Tensor:
    """Add AWGN with total noise power 1/snr per symbol (1/(2*snr) per I/Q component)."""
    del convention  # both conventions add the same noise; they differ at demod
    snr = snr_db_to_linear(snr_db, symbols.device)
    std = torch.rsqrt(2.0 * snr)
    return symbols + std * _normal(generator, symbols)


def qpsk_demodulate(received: torch.Tensor, snr_db, convention: str = "consistent") -> torch.Tensor:
    """Per-bit LLRs from received (..., n_sym, 2) QPSK symbols, I/Q interleaved."""
    snr = snr_db_to_linear(snr_db, received.device)
    if convention == "consistent":
        noise_var = 1.0 / (2.0 * snr)
    elif convention == "reference_package":
        noise_var = 1.0 / snr
    else:
        raise ValueError(f"unknown convention {convention!r}")
    llrs = 2.0 * received / noise_var  # (..., n_sym, 2): I then Q per symbol
    return llrs.reshape(*received.shape[:-2], -1)


def qpsk_awgn_llr(generator: torch.Generator, bits: torch.Tensor, snr_db,
                  convention: str = "consistent") -> torch.Tensor:
    """bits -> QPSK -> AWGN -> LLRs, truncated back to the input bit length."""
    n = bits.shape[-1]
    symbols = qpsk_modulate(bits)
    received = awgn_channel(generator, symbols, snr_db, convention)
    return qpsk_demodulate(received, snr_db, convention)[..., :n]


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------


def error_counts(tx_bits: torch.Tensor, rx_bits: torch.Tensor):
    """Raw (bit_errors, frame_errors, num_bits, num_frames) as float32 scalars.

    Counts (not rates), so that several devices' counts can be summed exactly
    before dividing.
    """
    errs = (tx_bits != rx_bits).to(torch.float32)
    bit_errors = errs.sum()
    frame_errors = (errs.sum(dim=-1) > 0).to(torch.float32).sum()
    num_bits = torch.tensor(float(errs.numel()), dtype=torch.float32, device=errs.device)
    num_frames = torch.tensor(float(errs.shape[0] if errs.ndim > 1 else 1),
                              dtype=torch.float32, device=errs.device)
    return bit_errors, frame_errors, num_bits, num_frames


def compute_ber_fer(tx_bits: torch.Tensor, rx_bits: torch.Tensor):
    """(BER, FER) means."""
    be, fe, nb, nf = error_counts(tx_bits, rx_bits)
    return be / nb, fe / nf


def theoretical_qpsk_ber(snr_db, num_frames: int = 0) -> torch.Tensor:
    """Uncoded QPSK BER overlay 0.5*exp(-snr)."""
    del num_frames  # kept for signature parity with the JAX package
    return 0.5 * torch.exp(-snr_db_to_linear(snr_db))
