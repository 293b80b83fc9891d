"""Monte-Carlo BER/FER sweeps, one device (counterpart of the one-device part
of ``ldpc_tpu.parallel.sharding``).

Each trial's data comes from a ``torch.Generator`` that is a pure function
of (seed, SNR index, trial index), as the JAX package's
``fold_in(fold_in(key(seed), i), t)`` is: a sweep, or any trial of it, gives
the same counts whenever it runs, and :func:`trial_data` lets another
statistic (``ComparativeEvaluator``'s iteration counts) see the very LLRs of
a trial.  Bits and LLRs are made on the target device, and the counts stay
there until a point of the sweep is done.

Only ``mesh=None`` is taken: the sharded sweep, ``shard_decode`` and the
sharded train step wait for ROADMAP §A6 (``torch.distributed``).
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ldpc_tpu_torch._device import resolve_device
from ldpc_tpu_torch.ops.qc_msg import QCPlan
from ldpc_tpu_torch.utils import channel as ch


def require_one_device(mesh) -> None:
    """Raise unless ``mesh`` is None: multi-device runs are not ported yet."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh= is not ported: sharded sweeps and training wait for ROADMAP §A6 "
            "(torch.distributed); pass mesh=None")


def trial_generator(seed: int, snr_index: int, trial: int, device) -> torch.Generator:
    """The generator of one trial, on ``device``: seeded from (seed,
    snr_index, trial) alone."""
    words = np.random.SeedSequence([int(seed), int(snr_index), int(trial)]).generate_state(
        2, np.uint32)
    gen = torch.Generator(device=device)
    gen.manual_seed((int(words[0]) << 31) ^ int(words[1]))
    return gen


def channel_llr(gen: torch.Generator, bits: torch.Tensor, snr_db, modulation: str = "qpsk",
                convention: str = "consistent") -> torch.Tensor:
    """(B, n) bits -> (B, n) channel LLRs with noise from ``gen``."""
    if modulation == "qpsk":
        return ch.qpsk_awgn_llr(gen, bits, snr_db, convention)
    if modulation == "bpsk":
        return ch.bpsk_awgn_llr(gen, bits, snr_db)
    raise ValueError(f"unknown modulation {modulation!r}")


def trial_data(gen: torch.Generator, n: int, batch_size: int, snr_db, modulation: str = "qpsk",
               convention: str = "consistent", encoder=None):
    """(bits, llr) of one trial on ``gen``'s device: all-zero codewords, or
    random codewords of ``encoder`` drawn from ``gen`` before the noise."""
    if encoder is None:
        bits = torch.zeros((batch_size, n), dtype=torch.float32, device=gen.device)
    else:
        bits = encoder.random_codewords(gen, batch_size)
    return bits, channel_llr(gen, bits, snr_db, modulation, convention)


def make_mc_trial(decode_bits: Callable[[torch.Tensor], torch.Tensor], n: int, batch_size: int,
                  mesh=None, modulation: str = "qpsk", convention: str = "consistent",
                  encoder=None):
    """A Monte-Carlo trial: ``trial(gen, snr_db) -> (bit_errors, frame_errors,
    bits, frames)``, float32 scalars on ``gen``'s device.

    Transmits all-zero codewords (valid for sign-symmetric decoders) or, with
    an ``encoder``, random codewords (needed for the neural decoders, which
    are not sign-symmetric).  ``decode_bits`` maps (B, n) LLRs to (B, n)
    hard bits.
    """
    require_one_device(mesh)

    def trial(gen: torch.Generator, snr_db):
        bits, llr = trial_data(gen, n, batch_size, snr_db, modulation, convention, encoder)
        return ch.error_counts(bits, decode_bits(llr))

    return trial


def mc_sweep(decode_bits: Callable[[torch.Tensor], torch.Tensor], plan: QCPlan, snr_range,
             batch_size: int, num_trials: int, mesh=None, seed: int = 4321,
             modulation: str = "qpsk", convention: str = "consistent", encoder=None,
             device="cuda") -> dict[str, list[float]]:
    """BER/FER sweep over ``snr_range``, ``num_trials`` batches a point.
    Returns {"snr", "ber", "fer"} lists."""
    dev = resolve_device(device)
    n = plan.C * plan.Z
    trial = make_mc_trial(decode_bits, n, batch_size, mesh, modulation, convention, encoder)
    bers, fers = [], []
    for i, snr_db in enumerate(snr_range):
        totals = torch.zeros(4, dtype=torch.float64, device=dev)
        for t in range(num_trials):
            totals += torch.stack(trial(trial_generator(seed, i, t, dev), float(snr_db))).double()
        be, fe, nb, nf = totals.tolist()
        bers.append(be / nb)
        fers.append(fe / nf)
    return {"snr": [float(s) for s in snr_range], "ber": bers, "fer": fers}
