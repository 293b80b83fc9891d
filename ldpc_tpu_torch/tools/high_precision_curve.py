"""The min-sum waterfall of nr_2_0_32 to BER about 1e-8 through
``fused_retire`` (counterpart of ``tools/high_precision_curve.py``).

Seven SNRs from -5 to -2 dB, BPSK all-zero codewords, scaled min-sum
(alpha 0.75) in throughput mode (``make_fused_minsum(qc, iters, 0.75,
track_convergence=False)``: every frame runs ``--iters`` iterations), about
``--bits-per-point`` decoded bits a point: ``max(1, int(bits / (B n)))``
batches of ``--batch`` frames.  Trial t of point i draws its noise from
``trial_generator(99, i, t)``; errors are counted exactly (int64) on the
device and fetched once a point.

Run:  python -m ldpc_tpu_torch.tools.high_precision_curve [--bits-per-point 1e9]
          [--batch 65536] [--iters 20] [--out nr_2_0_32_minsum_highprecision_torch.json]
          [--device cuda | cpu]

The default device is the card, where each batch is one launch of the
kernel; without one it raises.  ``--device cpu`` runs the kernel's plain
PyTorch version (for checking, not for tail statistics).  Writes the JAX
tool's keys (``snr``, ``ber``, ``fer``, ``bits_per_point``, ``iterations``,
``batch``, ``code``, ``wall_seconds``, ``decoded_bits_per_s``), here also the
error counts, the device and the card's ``nvidia-smi`` name and power limit,
to ``--out``; ``main(argv)`` returns them.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

import torch

from ldpc_tpu_torch._device import resolve_device
from ldpc_tpu_torch.codes import get_base_graph, qc_layout
from ldpc_tpu_torch.ops.fused_minsum import make_fused_minsum
from ldpc_tpu_torch.parallel import trial_generator
from ldpc_tpu_torch.utils import bpsk_awgn_llr

CODE, Z = "nr_2_0_32", 32
SNRS = [-5.0, -4.5, -4.0, -3.5, -3.0, -2.5, -2.0]
SEED = 99


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bits-per-point", type=float, default=1e9)
    ap.add_argument("--batch", type=int, default=65536)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", default="nr_2_0_32_minsum_highprecision_torch.json")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def card_name_and_power_limit(device: torch.device) -> str | None:
    """``nvidia-smi``'s name and power limit of the card (None on the CPU)."""
    if device.type != "cuda":
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    qc = qc_layout(get_base_graph(CODE), Z)
    n = qc.num_vars
    fused = make_fused_minsum(qc, args.iters, 0.75, track_convergence=False, device=dev)
    B = args.batch
    zeros = torch.zeros((B, n), dtype=torch.float32, device=dev)
    trials_per_point = max(1, int(args.bits_per_point / (B * n)))
    bits_per_point = trials_per_point * B * n
    results = {"snr": SNRS, "ber": [], "fer": [], "bits_per_point": bits_per_point,
               "iterations": args.iters, "batch": B, "code": CODE,
               "trials_per_point": trials_per_point, "bit_errors": [], "frame_errors": []}
    t_start = time.time()
    for i, snr in enumerate(SNRS):
        counts = torch.zeros(2, dtype=torch.int64, device=dev)
        for t in range(trials_per_point):
            llr = bpsk_awgn_llr(trial_generator(SEED, i, t, dev), zeros, snr)
            errs = fused(llr)[0] != 0
            counts += torch.stack([errs.sum(), errs.any(dim=1).sum()])
        be, fe = counts.tolist()  # the point's one fetch
        ber, fer = be / bits_per_point, fe / (trials_per_point * B)
        results["ber"].append(ber)
        results["fer"].append(fer)
        results["bit_errors"].append(be)
        results["frame_errors"].append(fe)
        print(f"snr {snr:+.1f}: BER {ber:.3e}  FER {fer:.3e} "
              f"({be} bit errors / {bits_per_point} bits)", flush=True)
    wall = time.time() - t_start
    results["wall_seconds"] = round(wall, 3)
    results["decoded_bits_per_s"] = round(len(SNRS) * bits_per_point / wall, 1)
    results["device"] = str(dev)
    results["nvidia_smi"] = card_name_and_power_limit(dev)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(results, indent=2))
    print(f"wrote {args.out}  ({wall:.1f} s total, {results['decoded_bits_per_s'] / 1e9:.3f} "
          f"Gbit/s sustained, {results['nvidia_smi'] or dev})")
    return results


if __name__ == "__main__":
    main()
