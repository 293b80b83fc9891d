"""How many ``retire_zlane_sumproduct`` blocks an SM should keep resident.

``retire_zlane_sumproduct_kernel`` (``csrc/fused_retire.cu``) keeps each
frame's c2v, K*Z floats, in its block's slice of a global scratch, which the
L2 is to hold.  The wrapper's plan caps the resident blocks an SM at
``fused_minsum._ZLANE_SUMPRODUCT_BLOCKS_PER_SM`` (1): at NR BG2 Z=384, 132
slices are 40 MB of the H100's 50 MB L2.  This tool times, at each ``--z``
of nr_2_0_32 and for every parts count, the kernel under that cap against
the same kernel with the cap raised to 2, where the occupancy query allows
two blocks: a batch of ``--batch`` frames at ``--snr`` dB, 20 iterations,
tracked, the variants interleaved in ``--rounds`` rounds of ``--reps``
launches each, outputs identical (bits and conv_iter, ``torch.equal``).  It
also prints the card's L2 size and the bytes of the slices in flight.

Run:  python -m ldpc_tpu_torch.tools.probe_zlane_blocks [--z 224 256 288 384]

Needs the card and nvcc.  Prints one JSON object and the card's name and
power limit; ``main(argv)`` returns the object.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch

ITERATIONS = 20


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--z", type=int, nargs="+", default=[224, 256, 288, 384])
    parser.add_argument("--batch", type=int, default=512)
    parser.add_argument("--snr", type=float, default=3.0)
    parser.add_argument("--rounds", type=int, default=5)
    parser.add_argument("--reps", type=int, default=5)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_zlane_blocks needs a CUDA card")

    from ldpc_tpu_torch.codes import get_base_graph, qc_layout
    from ldpc_tpu_torch.ops import fused_minsum as fm
    from ldpc_tpu_torch.utils import bpsk_awgn_llr

    props = torch.cuda.get_device_properties(0)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def time_ms(fn) -> float:
        torch.cuda.synchronize()
        start.record()
        for _ in range(args.reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.reps

    default_cap = fm._ZLANE_SUMPRODUCT_BLOCKS_PER_SM
    cases = {}
    for Z in args.z:
        qc = qc_layout(get_base_graph("nr_2_0_32"), Z)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(Z)
        llr = bpsk_awgn_llr(gen, torch.zeros((args.batch, qc.num_vars), device="cuda"),
                            args.snr)
        slice_bytes = fm.retire_zlane_sumproduct_scratch_bytes(qc)
        # Variant name -> (launch, resident blocks an SM).  A decoder makes
        # its plan for each parts count at that count's first launch, under
        # the cap in force then.
        variants = {}
        try:
            for cap in (1, 2):
                fm._ZLANE_SUMPRODUCT_BLOCKS_PER_SM = cap
                dec = fm.make_fused_minsum_zlane(qc, ITERATIONS, 1.0, mode="sumproduct")
                for p in fm.retire_zlane_sumproduct_plans(qc):
                    per_sm = fm.retire_zlane_sumproduct_plan(qc, True, p)[1]
                    if cap == 2 and per_sm < 2:
                        continue
                    dec._launch_retire(llr, parts=p)
                    variants[f"parts={p} blocks_per_sm={per_sm}"] = (
                        lambda dec=dec, p=p: dec._launch_retire(llr, parts=p), per_sm)
        finally:
            fm._ZLANE_SUMPRODUCT_BLOCKS_PER_SM = default_cap
        ref = fm.make_fused_minsum_zlane(qc, ITERATIONS, 1.0, mode="sumproduct")(llr)
        for name, (fn, _) in variants.items():
            out = fn()
            if not (torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])):
                raise AssertionError(f"retire_zlane_sumproduct Z={Z} {name} differs from the plan")
        rounds = {name: [] for name in variants}
        for _ in range(args.rounds):
            for name, (fn, _) in variants.items():
                rounds[name].append(time_ms(fn))
        cases[f"Z={Z}"] = {
            "plan": fm.retire_zlane_sumproduct_plan(qc, True),
            "slice_bytes": slice_bytes,
            "slices_in_flight_bytes": {name: per_sm * props.multi_processor_count * slice_bytes
                                       for name, (_, per_sm) in variants.items()},
            "median_ms": {name: statistics.median(ms) for name, ms in rounds.items()},
            "rounds_ms": rounds,
            "mean_conv_iter": float(ref[1].float().mean().item())}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    out = {"tool": "probe_zlane_blocks", "device": torch.cuda.get_device_name(0),
           "nvidia_smi": smi, "l2_bytes": props.L2_cache_size,
           "sms": props.multi_processor_count, "batch": args.batch, "snr_db": args.snr,
           "iterations": ITERATIONS, "default_blocks_per_sm": default_cap, "cases": cases}
    print(json.dumps(out), flush=True)
    print(smi, flush=True)
    return out


if __name__ == "__main__":
    main()
