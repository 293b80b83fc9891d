"""Benchmark the fused message-GNN kernels against the module's forward on
the H100 (the counterpart of ``tools/bench_gnn_kernel.py``).

Holds each fused kernel against the port's ``MessageGNNDecoder`` forward on
the trained checkpoints, then measures steady-state decoded bits/s for:
  - the fully-neural message GNN: the module against ``msg_gnn`` (fused_v1),
    ``msg_gnn_v2``, ``msg_gnn_v3`` and ``msg_gnn_v4``;
  - the corrected GNN (flagship): the module against ``corrected`` (fused)
    and ``corrected_v2`` (fused_v2).

Run:  python -m ldpc_tpu_torch.tools.bench_gnn_kernel [--batch 2048] [--device cuda | cpu]
      python -m ldpc_tpu_torch.tools.bench_gnn_kernel --hidden 128 --kernels v2,v4 --fresh

Each variant run must be built for ``--hidden`` (``fused_gnn.KERNEL_HIDDEN_DIMS``):
all six at 16 and 64, ``fused_v2`` and ``fused_v4`` also at 128.

The default device is the card; without one it raises.  ``--device cpu``
runs the kernels' plain PyTorch versions and the module on the CPU (for
checking, not for speed).  On the card every time comes from CUDA events
after a warm-up call; each variant's is its best window over interleaved
rounds.  ``main(argv)`` returns the numbers it prints.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import torch

from ldpc_tpu_torch import convert
from ldpc_tpu_torch._device import resolve_device
from ldpc_tpu_torch.codes import get_base_graph, qc_layout
from ldpc_tpu_torch.models import create_corrected_minsum_gnn_decoder, create_message_gnn_decoder
from ldpc_tpu_torch.ops import fused_gnn, qc_msg
from ldpc_tpu_torch.utils import bpsk_awgn_llr
from ldpc_tpu_torch.utils.profiling import PEAK_BF16_TENSOR_OPS, gnn_roofline

# (variant name as the JAX tool prints it, builder, kernel name in fused_gnn.LAUNCHES)
MESSAGE_GNN = [("fused_v1", fused_gnn.make_fused_gnn_decoder, "msg_gnn"),
               ("fused_v2", fused_gnn.make_fused_gnn_decoder_v2, "msg_gnn_v2"),
               ("fused_v3", fused_gnn.make_fused_gnn_decoder_v3, "msg_gnn_v3"),
               ("fused_v4", fused_gnn.make_fused_gnn_decoder_v4, "msg_gnn_v4")]
CORRECTED_GNN = [("fused", fused_gnn.make_fused_corrected_gnn_decoder, "corrected"),
                 ("fused_v2", fused_gnn.make_fused_corrected_gnn_decoder_v2, "corrected_v2")]
CONFIDENT = 0.05  # decisions compared where the module's |p - 0.5| exceeds this
ROUNDS = 6  # interleaved timing rounds


def _seconds(fn, llrs, cuda: bool) -> float:
    """Seconds per call of ``fn`` over ``llrs`` (one window)."""
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for x in llrs:
            fn(x)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 1e3 / len(llrs)
    t0 = time.perf_counter()
    for x in llrs:
        fn(x)
    return (time.perf_counter() - t0) / len(llrs)


def bench(fn, llrs, cuda: bool) -> float:
    """Best of 3 windows over ``llrs[1:]``, after a warm-up call on ``llrs[0]``."""
    fn(llrs[0])
    if cuda:
        torch.cuda.synchronize()
    return min(_seconds(fn, llrs[1:], cuda) for _ in range(3))


def bench_interleaved(fns, llrs, cuda: bool, rounds: int | None = None) -> list[float]:
    """Each function's best window across ``rounds`` (default ``ROUNDS``)
    round-robin rounds over ``llrs[1:]``, after warming every function up on
    ``llrs[0]``: a slow phase of the card then lands in one round of every
    variant."""
    rounds = ROUNDS if rounds is None else rounds
    for fn in fns:
        fn(llrs[0])
    if cuda:
        torch.cuda.synchronize()
    best = [float("inf")] * len(fns)
    for _ in range(rounds):
        for i, fn in enumerate(fns):
            best[i] = min(best[i], _seconds(fn, llrs[1:], cuda))
    return best


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--code", default="nr_2_0_4")
    ap.add_argument("--Z", type=int, default=4)
    ap.add_argument("--fresh", action="store_true",
                    help="bench fresh (untrained) params: kernel speed does not depend on "
                         "weight values")
    ap.add_argument("--kernels", default=None,
                    help="comma list of fused variants to run (e.g. v1,v2,v4); default all")
    ap.add_argument("--gnn-checkpoint", default="results/message_gnn_nr_2_0_4.msgpack")
    ap.add_argument("--corrected-checkpoint", default="results/corrected_gnn_nr_2_0_4.msgpack")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def _wanted(fusers, kernels: str | None) -> list:
    """The variants of ``fusers`` that ``--kernels`` names (all without it)."""
    if not kernels:
        return list(fusers)
    want = {k.strip() for k in kernels.split(",")}
    return [v for v in fusers if v[0].replace("fused_", "").replace("fused", "v1") in want]


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    # --fresh benches the message GNN alone; each variant it runs must be
    # built for --hidden (msg_gnn_v2 and msg_gnn_v4 also at 128).
    families = MESSAGE_GNN + ([] if args.fresh else CORRECTED_GNN)
    for _, _, kernel in _wanted(families, args.kernels):
        if args.hidden not in fused_gnn.KERNEL_HIDDEN_DIMS[kernel]:
            raise ValueError(f"the {kernel} kernel is built for --hidden in "
                             f"{fused_gnn.KERNEL_HIDDEN_DIMS[kernel]}, got {args.hidden}")
    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    qc = qc_layout(get_base_graph(args.code), args.Z)
    plan = qc_msg.make_plan(qc, dev)
    n = qc.num_vars
    B = args.batch
    print(f"device={torch.cuda.get_device_name(dev) if cuda else 'cpu'} n={n} batch={B}")
    llrs = [bpsk_awgn_llr(torch.Generator(device=dev).manual_seed(50 + i),
                          torch.zeros((B, n), device=dev), 1.0) for i in range(6)]

    cases = []
    if args.fresh or Path(args.gnn_checkpoint).exists():
        cases.append(("message_gnn", None if args.fresh else args.gnn_checkpoint,
                      create_message_gnn_decoder, _wanted(MESSAGE_GNN, args.kernels)))
    if not args.fresh and Path(args.corrected_checkpoint).exists():
        cases.append(("corrected_gnn", args.corrected_checkpoint,
                      create_corrected_minsum_gnn_decoder, _wanted(CORRECTED_GNN, args.kernels)))

    rl = gnn_roofline(qc, args.hidden, args.iters, input_injection=True)
    bounds = rl.bound_bits_per_s(n)
    print(f"roofline (h={args.hidden}, T={args.iters}): tensor-core peak "
          f"{bounds['mxu_bound_bits_per_s'] / 1e6:.1f} Mbit/s, float32 elementwise "
          f"{bounds['vpu_bound_bits_per_s'] / 1e6:.1f}, memory "
          f"{bounds['memory_bound_bits_per_s'] / 1e6:.1f}")

    summary = {"device": torch.cuda.get_device_name(dev) if cuda else "cpu", "code": args.code,
               "Z": args.Z, "batch": B, "iterations": args.iters, "hidden_dim": args.hidden,
               "roofline": bounds, "module": {}, "variants": {}}
    for name, ckpt, factory, fusers in cases:
        model = factory(plan, num_iterations=args.iters, hidden_dim=args.hidden,
                        input_injection=True, generator=torch.Generator().manual_seed(0))
        if ckpt is not None:
            convert.load_message_gnn(ckpt, model)
        model.eval()

        @torch.no_grad()
        def module_soft(llr, model=model):
            return model(llr, plan)[0]

        dt_x = bench(module_soft, llrs, cuda)
        summary["module"][name] = {"ms_per_batch": dt_x * 1e3, "bits_per_s": B * n / dt_x}
        print(f"{name}: module {B * n / dt_x / 1e6:.1f} Mbit/s", flush=True)
        fused_list, checks = [], []
        reference = module_soft(llrs[0])
        confident = (reference - 0.5).abs() > CONFIDENT
        for fname, fuse, kernel in fusers:
            fused = fuse(qc, model, num_iterations=args.iters, hidden_dim=args.hidden,
                         input_injection=True, device=dev)
            soft = fused(llrs[0])
            same = (soft > 0.5) == (reference > 0.5)
            agree = same[confident].float().mean().item() if bool(confident.any()) else 1.0
            fused_list.append(fused)
            checks.append((fname, kernel, (soft - reference).abs().max().item(), agree))
        dts = bench_interleaved(fused_list, llrs, cuda)
        for (fname, kernel, dmax, agree), dt_f in zip(checks, dts):
            bps = B * n / dt_f
            mfu = bps * rl.mxu_flops_per_frame / n / PEAK_BF16_TENSOR_OPS
            summary["variants"][f"{name}/{fname}"] = {
                "kernel": kernel, "ms_per_batch": dt_f * 1e3, "bits_per_s": bps,
                "speedup_vs_module": dt_x / dt_f, "mfu": mfu, "max_abs_diff": dmax,
                "decision_agreement": agree, "confident_share": confident.float().mean().item()}
            print(f"{name}/{fname}: {bps / 1e6:.1f} Mbit/s  speedup_vs_module {dt_x / dt_f:.1f}x  "
                  f"MFU {mfu * 100:.2f}%  |diff| max {dmax:.4f}  "
                  f"decision agreement {agree:.6f}", flush=True)
    return summary


if __name__ == "__main__":
    main()
