"""Where ``retire_layered_sumproduct_wide`` should keep a row's phi.

``layered_sp_row_wide`` (``csrc/fused_retire.cu``) runs rows of more than 12
members with run-time loops: the fold computes each member's phi_j once and
keeps it in a per-thread array, 58 slots on the 64-bit state word, which
lives in local memory; the update reads it back.  This tool builds a copy of
the source whose update recomputes phi_j instead, from the member's belief
and old c2v read again (one more phi a member and no array), and times both
builds of ``retire_layered_sumproduct_wide`` on phase ``wide_rows``'s code
(chip_smoke.py: a (6, 32) array of Z=64 circulants, shift (r*c) mod 64) at
``--batch`` frames and ``--snr`` dB, 20 iterations, tracked, in
``--rounds`` interleaved rounds; the two outputs must be identical.  Each
build's registers, spills and stack frame come from its ``ptxas -v``
report.

Run:  python -m ldpc_tpu_torch.tools.probe_wide_phi [--snr 6.0]

Needs the card and nvcc.  Prints one JSON object and the card's name and
power limit; ``main(argv)`` returns the object.  Builds go to
``ops/build/`` (ignored by git).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from ldpc_tpu_torch.ops import _build, fused_minsum as fm

ITERATIONS = 20
# The fold keeps no phi; the update computes it again from what it reads.
_RECOMPUTE = [
    ("  float ph[kSignBits<Word>];\n  float S = 0.0f;\n  Word neg = 0u;\n",
     "  float S = 0.0f;\n  Word neg = 0u;\n"),
    ("    ph[j] = v2c_phi(x);\n    S = S + ph[j];\n  }\n  const unsigned sp = odd(neg) << 31;\n"
     "  for (int j = 0; j < d; ++j) {\n    const int2 m = mem[j];\n"
     "    const int p = rolled<POW2>(z, m.y, m.x, Z);\n"
     "    const float v = c2v_out(S, ph[j], sp, neg, j);\n"
     "    bel[p] = (bel[p] + v) - (first ? 0.0f : c2v[j * Z]);\n",
     "    S = S + v2c_phi(x);\n  }\n  const unsigned sp = odd(neg) << 31;\n"
     "  for (int j = 0; j < d; ++j) {\n    const int2 m = mem[j];\n"
     "    const int p = rolled<POW2>(z, m.y, m.x, Z);\n"
     "    const float old = first ? 0.0f : c2v[j * Z];\n    const float b = bel[p];\n"
     "    const float v = c2v_out(S, v2c_phi(b - old), sp, neg, j);\n"
     "    bel[p] = (b + v) - old;\n"),
]
_KERNEL = "retire_layered_sumproduct_kernelILb1ELb1EyE"  # tracked, Z a power of two, 64-bit


def _build_recompute() -> tuple[Path, str]:
    src = (Path(fm.__file__).parent / "csrc" / "fused_retire.cu").read_text()
    for text, replacement in _RECOMPUTE:
        if src.count(text) != 1:
            raise RuntimeError(f"expected one {text!r} in fused_retire.cu, found {src.count(text)}")
        src = src.replace(text, replacement)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / "probe_wide_phi_recompute.cu"
    cu.write_text(src)
    lib = cu.with_suffix(".so")
    csrc = Path(fm.__file__).parent / "csrc"
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, f"-I{csrc}", "-o", str(lib),
                           str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the recompute build:\n{proc.stdout}")
    return lib, proc.stdout


def _ptxas(report: str) -> dict:
    """Registers, spill bytes and stack frame of the timed instantiation."""
    name, out = None, {}
    for line in report.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and _KERNEL in name:
            words = [int(w) for w in line.replace(",", "").split() if w.isdigit()]
            if "stack frame" in line:
                out["stack_frame_bytes"], out["spill_store_bytes"], out["spill_load_bytes"] = \
                    words[:3]
            elif "registers" in line:
                out["registers"] = int(line.split("Used ")[1].split()[0])
    return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=65536)
    parser.add_argument("--snr", type=float, default=6.0)
    parser.add_argument("--rounds", type=int, default=5)
    parser.add_argument("--reps", type=int, default=5)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_wide_phi needs a CUDA card")
    import numpy as np

    from ldpc_tpu_torch.codes import BaseGraph, qc_layout
    from ldpc_tpu_torch.utils import bpsk_awgn_llr

    with ThreadPoolExecutor(2) as pool:
        base = pool.submit(_build.build, "fused_retire")
        recompute_lib, recompute_log = pool.submit(_build_recompute).result()
        base.result()
    libs = {"local_array": fm.retire_kernel_library()}
    variant = ctypes.CDLL(str(recompute_lib))
    for name, (argtypes, restype) in fm._RETIRE_SIGNATURES.items():
        getattr(variant, name).argtypes, getattr(variant, name).restype = argtypes, restype
    libs["recompute"] = variant
    r, c = np.meshgrid(np.arange(6), np.arange(32), indexing="ij")
    qc = qc_layout(BaseGraph("ieee_6x32", (r * c) % 64), 64)
    gen = torch.Generator(device="cuda").manual_seed(8)
    llr = bpsk_awgn_llr(gen, torch.zeros((args.batch, qc.num_vars), device="cuda"), args.snr)
    # A decoder a build: the wrapper launches whatever library _build holds
    # for "fused_retire" when a decoder makes its plan and launches.
    decs, outs = {}, {}
    for name, lib in libs.items():
        _build._LOADED["fused_retire"] = lib
        decs[name] = fm.make_fused_minsum(qc, ITERATIONS, 1.0, mode="sumproduct",
                                          schedule="layered")
        assert decs[name].route == "retire_layered_sumproduct_wide"
        outs[name] = decs[name](llr)
    _build._LOADED["fused_retire"] = libs["local_array"]
    torch.cuda.synchronize()
    identical = all(torch.equal(a, b) for a, b in zip(outs["local_array"], outs["recompute"]))
    if not identical:
        raise RuntimeError("the recompute build's output differs")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    rounds = {name: [] for name in decs}
    for _ in range(args.rounds):
        for name, dec in decs.items():
            _build._LOADED["fused_retire"] = libs[name]
            torch.cuda.synchronize()
            start.record()
            for _ in range(args.reps):
                dec(llr)
            end.record()
            torch.cuda.synchronize()
            rounds[name].append(start.elapsed_time(end) / args.reps)
    _build._LOADED["fused_retire"] = libs["local_array"]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    result = {"kernel": "retire_layered_sumproduct_wide", "batch": args.batch, "snr_db": args.snr,
              "iterations": ITERATIONS,
              "mean_conv_iter": float(outs["local_array"][1].float().mean().item()),
              "identical": identical,
              "median_ms": {name: statistics.median(r) for name, r in rounds.items()},
              "rounds_ms": rounds,
              "ptxas": {"local_array": _ptxas(_build.build_log("fused_retire")),
                        "recompute": _ptxas(recompute_log)},
              "nvidia_smi": smi}
    print(json.dumps(result))
    print(smi)
    return result


if __name__ == "__main__":
    main()
