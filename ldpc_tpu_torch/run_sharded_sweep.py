"""Sharded BER/FER sweep of min-sum and BP on nr_2_0_32 Z=32 (counterpart of
``examples/run_sharded_sweep.py``).

Under ``torchrun`` the Monte-Carlo grid is sharded over the ranks, one rank
a card (``nccl``; ``gloo`` with ``--device cpu``), and rank 0 prints; plain
``python`` runs it unsharded.  The results are identical either way.

Run:  python -m ldpc_tpu_torch.run_sharded_sweep [--trials 10] [--batch 256]
      torchrun --nproc-per-node 4 -m ldpc_tpu_torch.run_sharded_sweep
          [--device cuda | cpu]

``main(argv)`` returns {decoder: sweep}.
"""
from __future__ import annotations

import argparse
import os

import torch.distributed as dist

from ldpc_tpu_torch.codes import get_base_graph, qc_layout
from ldpc_tpu_torch.models.classical import decode_bp, decode_min_sum
from ldpc_tpu_torch.ops import qc_msg
from ldpc_tpu_torch.parallel import distributed_init, make_mesh, mc_sweep

SNRS = [-4.0, -3.0, -2.0, -1.0, 0.0]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trials", type=int, default=10)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    mesh = None
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        distributed_init(backend="nccl" if args.device == "cuda" else "gloo")
        mesh = make_mesh()
    main_rank = mesh is None or dist.get_rank() == 0
    plan = qc_msg.make_plan(qc_layout(get_base_graph("nr_2_0_32"), 32), device=args.device)
    ranks = 1 if mesh is None else dist.get_world_size()
    if main_rank:
        print(f"ranks: {ranks} ({'sharded' if mesh is not None else 'unsharded'})")
    out = {}
    for name, decode in [
        ("min-sum(20)", lambda llr: decode_min_sum(llr, plan, 20, 0.75).bits),
        ("bp(20)", lambda llr: decode_bp(llr, plan, 20).bits),
    ]:
        out[name] = mc_sweep(decode, plan, SNRS, args.batch, args.trials, mesh=mesh,
                             modulation="bpsk", device=args.device)
        row = "  ".join(f"{s:+.0f}dB:{b:.2e}" for s, b in zip(out[name]["snr"], out[name]["ber"]))
        if main_rank:
            print(f"{name:12s} BER {row}")
    return out


if __name__ == "__main__":
    main()
