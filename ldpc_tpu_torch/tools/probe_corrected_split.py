"""Where B5's time goes: ablated builds of ``corrected_tc_kernel`` timed on
the card.

B5 (``csrc/fused_gnn_tc.cu``, the unfolded corrected GNN) runs each
correction as one fused pass, so no trace splits it.  This tool builds
copies of the source, each with one named textual edit of
``pass_unfolded``, and times a decode of ``chip_smoke.py``'s ``gnn_main``
batch (nr_2_0_32 Z=32, h=64, injection, the T=10 checkpoint, 2048 frames at
0 dB) with a fixed T=10 (no early exit, so every build does the same number
of corrections).  An ablated build computes wrong values; only its time is
read.  What a part costs is the base time less the time without it.

  base         the source as it is
  no_rebuild   the check means are not rebuilt (rmean is 0)
  no_second    the second layer's two products are skipped (the first
               layer's outputs stay live through an xor into the accumulator)
  no_bias      the per-edge bias rows are not read from L2 (0 instead)
  no_slots     the per-message loop does not run (min-sum, vmean, pre_col
               and pre_llr only)
  8_warps      the source as it is, launched with 8 warps a block
  8_warps_255  kMaxWarps = 8: the launch bound lets a thread keep 255
               registers, so the spill of the 12-warp build goes; launched
               with 8 warps.  Against 8_warps: what the spill costs there.

Each build's registers and spill bytes come from its ``ptxas -v`` report.

Run:  python -m ldpc_tpu_torch.tools.probe_corrected_split [--rounds 5]

Needs the card and nvcc.  Prints one JSON object a build and the card's
name and power limit; builds go to ``ops/build/`` (ignored by git).
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

from ldpc_tpu_torch import convert
from ldpc_tpu_torch.codes import get_base_graph, qc_layout
from ldpc_tpu_torch.models import create_corrected_minsum_gnn_decoder
from ldpc_tpu_torch.ops import _build, fused_gnn as fg, qc_msg
from ldpc_tpu_torch.utils import bpsk_awgn_llr

_ROOT = Path(__file__).resolve().parents[2]
CHECKPOINT = _ROOT / "results" / "corrected10_gnn_nr_2_0_32_ft3.msgpack"
T, H, BATCH, SNR = 10, 64, 2048, 0.0

_NO_SLOTS = ("    for (int s = 0; s < dmax; ++s) {\n"
             "      const bool ok0 = s < r0.d, ok1 = s < r1.d;\n"
             "      const int k0 = ok0 ? gr.col_edge[r0.j0 + s] : 0;\n"
             "      const int k1 = ok1 ? gr.col_edge[r1.j0 + s] : 0;\n"
             "      const int e0 = k0 * Z + r0.z, e1 = k1 * Z + r1.z;\n\n"
             "      // rmean")
_KEEP_H = "acc[2 * p][0] = __fadd_rn(acc[2 * p][0], __uint_as_float(h[0] ^ h[1] ^ h[2] ^ h[3]));"
# name -> ([(text, replacement, occurrences)], warps a block or None for the plan's)
VARIANTS = {
    "base": ([], None),
    "no_rebuild": ([("for (int j = 0; j < jmax; ++j) {", "for (int j = 0; j < 0; ++j) {", 1)],
                   None),
    "no_second": ([("product_ktile<H>(acc, h, W2c, p, lane);", _KEEP_H, 1),
                   ("product_ktile<H>(acc, h, W2v, p, lane);", _KEEP_H, 1)], None),
    "no_bias": ([(f"__ldg(reinterpret_cast<const float2*>({row} + q))",
                  "make_float2(0.0f, 0.0f)", 1) for row in ("bc0", "bc1", "bv0", "bv1")],
                None),
    "no_slots": ([(_NO_SLOTS, _NO_SLOTS.replace("s < dmax", "s < 0", 1), 1)], None),
    "8_warps": ([], 8),
    "8_warps_255": ([("constexpr int kMaxWarps = 12;", "constexpr int kMaxWarps = 8;", 1)], 8),
}


def _build_variant(name: str, edits) -> tuple[Path, str]:
    """Compile the edited copy of fused_gnn_tc.cu; (library, ptxas report)."""
    src = (Path(fg.__file__).parent / "csrc" / "fused_gnn_tc.cu").read_text()
    for text, replacement, count in edits:
        if src.count(text) != count:
            raise RuntimeError(f"{name}: expected {count} of {text!r} in fused_gnn_tc.cu, "
                               f"found {src.count(text)}")
        src = src.replace(text, replacement)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / f"probe_corrected_{name}.cu"
    lib = cu.with_suffix(".so")
    cu.write_text(src)
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}")
    return lib, proc.stdout


def _ptxas(report: str) -> dict:
    """Registers and spill bytes of corrected_tc_kernel<64, true>."""
    name, out = None, {}
    for line in report.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and "corrected_tc_kernelILi64ELb1E" in name:
            if "spill stores" in line:
                words = [int(w) for w in line.replace(",", "").split() if w.isdigit()]
                out["spill_store_bytes"], out["spill_load_bytes"] = words[1], words[2]
            elif "registers" in line:
                out["registers"] = int(line.split("Used ")[1].split()[0])
    return out


def _time_ms(launch, reps: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        launch()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("probe_corrected_split needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)

    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(lambda kv: _build_variant(kv[0], kv[1][0]),
                                            VARIANTS.items())))
    qc = qc_layout(get_base_graph("nr_2_0_32"), 32)
    model = create_corrected_minsum_gnn_decoder(qc_msg.make_plan(qc), num_iterations=T,
                                                hidden_dim=H, input_injection=True)
    convert.load_message_gnn(CHECKPOINT, model)
    dec = fg.make_fused_corrected_gnn_decoder(qc, model, T, H, input_injection=True)
    tb = dec.tables
    gen = torch.Generator(device="cuda").manual_seed(2)
    llr = bpsk_awgn_llr(gen, torch.zeros((BATCH, qc.num_vars), device="cuda"), SNR)
    soft = torch.empty_like(llr)
    counter = torch.zeros((1,), dtype=torch.int32, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    dims = (qc.Z, qc.num_base_rows, qc.num_base_cols, qc.num_base_edges, qc.num_edge_types)
    tables = (tb.graph.data_ptr(), tb.inv.data_ptr(), tb.w_bf16.data_ptr(), tb.tab.data_ptr(),
              tb.small.data_ptr(), tb.emb.data_ptr())

    runs = {}
    for name, (lib_path, report) in built.items():
        lib = ctypes.CDLL(str(lib_path))
        for fn_name, (argtypes, restype) in fg._CORRECTED_TC_SIGNATURES.items():
            getattr(lib, fn_name).argtypes, getattr(lib, fn_name).restype = argtypes, restype
        warps, blocks = ctypes.c_int(0), ctypes.c_int(0)
        rc = lib.ldpc_corrected_tc_plan(1, H, 1, *dims, ctypes.addressof(warps),
                                        ctypes.addressof(blocks))
        if rc != 0 or blocks.value < 1:
            raise RuntimeError(f"{name}: plan failed (CUDA error {rc}, {blocks.value} blocks)")
        forced = VARIANTS[name][1]
        w = forced or warps.value
        grid = min(BATCH, sms * blocks.value)

        def launch(lib=lib, w=w, grid=grid):
            counter.zero_()
            err = lib.ldpc_corrected_gnn(1, H, llr.data_ptr(), soft.data_ptr(), None,
                                         counter.data_ptr(), *tables, BATCH, *dims, T, 1, 0,
                                         tb.w_ch, tb.alpha, grid, w, None)
            if err != 0:
                raise RuntimeError(f"{name}: launch failed, CUDA error {err}")

        launch()
        torch.cuda.synchronize()
        runs[name] = dict(launch=launch, warps=w, plan_warps=warps.value,
                          blocks_per_sm=blocks.value, ptxas=_ptxas(report), ms=[])
    for _ in range(args.rounds):  # interleaved, so drift reaches every build alike
        for run in runs.values():
            run["ms"].append(_time_ms(run["launch"], args.reps))
    out = []
    for name, run in runs.items():
        row = {"variant": name, "warps": run["warps"], "plan_warps": run["plan_warps"],
               "blocks_per_sm": run["blocks_per_sm"], **run["ptxas"],
               "ms": [round(t, 3) for t in run["ms"]], "median_ms": statistics.median(run["ms"])}
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


if __name__ == "__main__":
    main()
