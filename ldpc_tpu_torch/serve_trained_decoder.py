"""Serve a trained decoder through its hand-written CUDA kernel.

Loads a trained flax checkpoint (the committed ``results/*.msgpack``) with
the port's own reader, builds the model family's fused serving decoder, and
reports BER, FER and decoded bits per second:

* ``--model neural_minsum``: ``NeuralMinSumDecoder`` (per-edge weights,
  learnable alpha, depth 2) through the ``fused_neural`` kernel;
* ``--model corrected_gnn``: the corrected min-sum GNN through
  ``corrected_v2``;
* ``--model message_gnn``: the fully-neural message GNN through ``msg_gnn``.

Run:  python -m ldpc_tpu_torch.serve_trained_decoder \\
          [--checkpoint results/standard_nr_2_0_4.msgpack] \\
          [--model neural_minsum | corrected_gnn | message_gnn] [--device cuda | cpu]

The default device is the card; without one it raises.  ``--device cpu``
runs the kernels' plain PyTorch versions (for checking, not for speed).
``main(argv)`` returns the numbers it prints.
"""
from __future__ import annotations

import argparse
import time

import torch

from ldpc_tpu_torch import convert
from ldpc_tpu_torch._device import resolve_device
from ldpc_tpu_torch.codes import encoder_from_H, expand_base_matrix, get_base_graph, qc_layout
from ldpc_tpu_torch.models import (NeuralMinSumDecoder, create_corrected_minsum_gnn_decoder,
                                   create_message_gnn_decoder)
from ldpc_tpu_torch.ops import fused_gnn, fused_minsum, fused_neural, qc_msg
from ldpc_tpu_torch.utils import compute_ber_fer, qpsk_awgn_llr

_REPS = 10  # batches in the throughput measurement


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--checkpoint", default="results/standard_nr_2_0_4.msgpack")
    ap.add_argument("--model", default="neural_minsum",
                    choices=["neural_minsum", "corrected_gnn", "message_gnn"])
    ap.add_argument("--code", default="nr_2_0_4")
    ap.add_argument("--Z", type=int, default=4)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--snr", type=float, default=0.0)
    ap.add_argument("--early-exit", action="store_true",
                    help="corrected_gnn only: per-frame syndrome early exit")
    ap.add_argument("--zero-codewords", action="store_true",
                    help="evaluate on the all-zero codeword (misleading for the GNN family, "
                         "which is not sign-symmetric; the default GF(2)-encoded random "
                         "codewords are the honest protocol)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def build_decoder(args, qc, plan):
    """(decode(llr) -> hard bits, description) of ``args.model`` with the
    checkpoint's weights."""
    dev = plan.edge_col.device
    if args.model == "neural_minsum":
        if not fused_minsum.fused_kernel_fits(qc):
            raise ValueError(f"{args.code} at Z={args.Z} is not served by the fused kernels")
        model = NeuralMinSumDecoder(plan, num_iterations=args.iters, depth_L=2,
                                    weight_sharing="edge", learnable_alpha=True,
                                    loss_mode="mean")
        convert.load_neural_min_sum(args.checkpoint, model)
        decode = fused_neural.make_fused_neural_minsum(qc, model, num_iterations=args.iters,
                                                       depth_L=2, device=dev)
        return decode, "fused neural min-sum kernel"
    if args.model == "corrected_gnn":
        model = create_corrected_minsum_gnn_decoder(plan, num_iterations=args.iters,
                                                    hidden_dim=args.hidden, input_injection=True)
        convert.load_message_gnn(args.checkpoint, model)
        soft_fn = fused_gnn.make_fused_corrected_gnn_decoder_v2(
            qc, model, num_iterations=args.iters, hidden_dim=args.hidden, input_injection=True,
            early_exit=args.early_exit, device=dev)
        path = "fused corrected-GNN kernel" + (" (early exit)" if args.early_exit else "")
    else:
        model = create_message_gnn_decoder(plan, num_iterations=args.iters,
                                           hidden_dim=args.hidden, input_injection=True)
        convert.load_message_gnn(args.checkpoint, model)
        soft_fn = fused_gnn.make_fused_gnn_decoder(qc, model, num_iterations=args.iters,
                                                   hidden_dim=args.hidden, input_injection=True,
                                                   device=dev)
        path = "fused message-GNN kernel"
    return (lambda llr: (soft_fn(llr) > 0.5).to(torch.float32)), path


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    qc = qc_layout(get_base_graph(args.code), args.Z)
    plan = qc_msg.make_plan(qc, dev)
    n = qc.num_vars
    decode, path = build_decoder(args, qc, plan)
    print(f"loaded {args.checkpoint}")

    if args.zero_codewords:
        def make_bits(gen):
            return torch.zeros((args.batch, n), device=dev)
    else:
        enc = encoder_from_H(expand_base_matrix(get_base_graph(args.code), args.Z))

        def make_bits(gen):
            return enc.random_codewords(gen, args.batch)

    def pipe(seed: int):
        gen = torch.Generator(device=dev).manual_seed(seed)
        bits = make_bits(gen)
        return bits, decode(qpsk_awgn_llr(gen, bits, args.snr))

    bits, hard = pipe(0)
    ber, fer = (float(x) for x in compute_ber_fer(bits, hard))
    print(f"{path}: BER {ber:.3e}  FER {fer:.3f} at {args.snr} dB")

    # Steady-state throughput: codewords, channel and decode, fresh seeds.
    if dev.type == "cuda":
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(_REPS):
            pipe(10 + i)
        end.record()
        torch.cuda.synchronize()
        seconds = start.elapsed_time(end) / 1e3 / _REPS
    else:
        t0 = time.perf_counter()
        for i in range(_REPS):
            pipe(10 + i)
        seconds = (time.perf_counter() - t0) / _REPS
    bps = args.batch * n / seconds
    unit = f"{bps / 1e9:.2f} Gbit/s" if bps >= 1e9 else f"{bps / 1e6:.3g} Mbit/s"
    print(f"throughput on {dev.type}: {unit}")
    return {"model": args.model, "path": path, "device": dev.type, "code": args.code,
            "Z": args.Z, "batch": args.batch, "snr_db": args.snr, "ber": ber, "fer": fer,
            "ms_per_batch": seconds * 1e3, "bits_per_s": bps}


if __name__ == "__main__":
    main()
