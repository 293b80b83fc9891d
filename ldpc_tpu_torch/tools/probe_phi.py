"""What one phi costs on the card: ``csrc/probe_phi.cu``.

The sum-product kernels (``retire_sumproduct_kernel`` in
``csrc/fused_retire.cu``, ``fused_minsum_kernel`` in ``csrc/fused_minsum.cu``)
compute phi(x) = -log(tanh(x / 2) + 1e-30) twice a member and iteration with
accurate ``tanhf`` and ``logf`` (``csrc/phi.cuh``).  The bound counts a phi as
two special-function operations.  This tool reads, for the accurate phi and
for one on the special-function unit's approximations (``tanh.approx.f32``,
``__logf``; no decoder uses it):

* its SASS instructions (``cuobjdump -sass``): a kernel that stores one phi a
  thread, less one that copies, and the ``MUFU`` instructions among them;
* its rate on the card: a chain of ``--reps`` phi a thread (each argument
  clamped to [1e-7, 20] as the check pass clamps it) over ``--n`` threads,
  timed with CUDA events in ``--rounds`` rounds, the two interleaved;
* how far the approximate phi is from the accurate one over [1e-7, 20]
  (one phi of each point of a log-spaced and a linear grid).

Run:  python -m ldpc_tpu_torch.tools.probe_phi [--n 4194304] [--reps 64]

Needs the card and nvcc.  Prints one JSON object and the card's name and
power limit; ``main(argv)`` returns the object.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
from pathlib import Path

import torch

from ldpc_tpu_torch.ops import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # x, y, n, kind (0 once, 1 chain, 2 copy), reps, mufu, stream
    "ldpc_probe_phi": ([_P, _P] + [_I] * 4 + [_P], _I),
    "ldpc_probe_phi_error_string": ([_I], ctypes.c_char_p),
}
_ONCE, _CHAIN, _COPY = 0, 1, 2


def sass_counts() -> dict:
    """SASS instructions (NOP padding left out) and MUFU instructions of
    each kernel of the built probe, by the kernel's mangled name."""
    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(_build.library_path("probe_phi"))],
                          capture_output=True, text=True, check=True, timeout=120).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = {"instructions": 0, "mufu": 0}
        elif name is not None and line.strip().startswith("/*") and "*/" in line:
            text = line.split("*/", 1)[1].strip()
            if text and not text.startswith("/*") and not text.startswith("NOP"):
                counts[name]["instructions"] += 1
                counts[name]["mufu"] += "MUFU" in text
    return counts


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1 << 22, help="threads of the timed chain")
    ap.add_argument("--reps", type=int, default=64, help="phi a thread in the timed chain")
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("probe_phi needs an NVIDIA card")
    lib = _build.load("probe_phi", _SIGNATURES)
    stream = torch.cuda.current_stream().cuda_stream

    def launch(x, kind, mufu, reps=1):
        y = torch.empty_like(x)
        rc = lib.ldpc_probe_phi(x.data_ptr(), y.data_ptr(), x.numel(), kind, reps, int(mufu),
                                stream)
        if rc != 0:
            raise RuntimeError(f"probe_phi launch failed: {lib.ldpc_probe_phi_error_string(rc)}")
        return y

    # SASS: one phi is the phi_once kernel less the copy kernel.
    counts = sass_counts()
    copy = next(v for k, v in counts.items() if "copy_kernel" in k)
    sass = {}
    for mufu in (False, True):
        once = next(v for k, v in counts.items()
                    if "phi_once_kernel" in k and ("ILb1E" in k) == mufu)
        sass["mufu" if mufu else "accurate"] = {
            "instructions": once["instructions"] - copy["instructions"],
            "mufu_instructions": once["mufu"] - copy["mufu"]}

    # Agreement over the check pass's domain.
    grid = torch.cat([torch.logspace(-7, float(torch.log10(torch.tensor(20.0))), 1 << 20),
                      torch.linspace(1e-7, 20.0, 1 << 20)]).cuda()
    accurate, approx = launch(grid, _ONCE, False), launch(grid, _ONCE, True)
    diff = (approx - accurate).abs()
    positive = accurate > 0
    agreement = {"points": grid.numel(), "max_abs_diff": diff.max().item(),
                 "max_rel_diff": (diff[positive] / accurate[positive]).max().item(),
                 "identical_share": (approx == accurate).double().mean().item()}

    # Rate: chains of reps phi, the two variants interleaved in rounds.
    x = torch.rand(args.n, device="cuda") * 20.0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    rounds = {"accurate": [], "mufu": []}
    for mufu in (False, True):
        launch(x, _CHAIN, mufu, args.reps)  # warm-up
    for _ in range(args.rounds):
        for mufu in (False, True):
            torch.cuda.synchronize()
            start.record()
            launch(x, _CHAIN, mufu, args.reps)
            end.record()
            torch.cuda.synchronize()
            rounds["mufu" if mufu else "accurate"].append(start.elapsed_time(end))
    rate = {name: args.n * args.reps / (statistics.median(ms) / 1e3)
            for name, ms in rounds.items()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    out = {"tool": "probe_phi", "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "sass_per_phi": sass, "agreement": agreement, "n": args.n, "reps": args.reps,
           "rounds_ms": rounds, "phi_per_s": rate,
           "accurate_over_mufu": rate["mufu"] / rate["accurate"]}
    print(json.dumps(out), flush=True)
    print(smi, flush=True)
    return out


if __name__ == "__main__":
    main()
