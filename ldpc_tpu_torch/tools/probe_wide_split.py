"""Where the time of B7 and B9 at h=128 goes: ablated builds of
``msg_gnn_wide_tc_kernel`` timed on the card.

B7 and B9 at h=128 (``csrc/fused_msg_gnn_tc.cu``) run a whole decode in one
launch, so no trace splits them.  This tool builds copies of the source,
each with one named textual edit of the h=128 kernel, and times one decode
at two shapes:

  path   the ft-floor path's (nr_2_0_4 Z=4, T=10, injection, batch 4096)
  main   msg_gnn_main's at h=128 (nr_2_0_32 Z=32, T=20, no injection,
         batch 2048)

on seeded random weights (no part of the kernel depends on their values).
An ablated build computes wrong values; only its time is read.  What a part
costs is the base time less the time without it.

  base          the source as it is
  no_means      phase 1 (the variable and check means) skipped
  no_gather     a warpgroup gathers its first tile's rows only
  no_mean_mma   the first layer's vmean and rmean products skipped (f and
                lf only: the A reads of the means from shared memory)
  no_second     the second layer's products skipped (the ReLU outputs stay
                live through an xor into the accumulator)
  no_restream   after a layer's first kWideStages chunks every refill of
                the ring copies 16 bytes (no weights streamed from L2)

and other shapes of the same design, whose results must equal base's (a
shape whose block does not fit a card's shared memory is reported and
skipped):

  groups_3      three warpgroups a block (kWideGroups = 3)
  stages_3      three chunk buffers in the ring (kWideStages = 3)
  means_2       phase 1 with two items a thread at once (kWideMeans = 2)
  means_6       six items a thread at once
  warp_release  each warp counts its release of a chunk buffer (8 counts a
                chunk, no warpgroup barrier)
  defer_second  the second layer's wait moved to the next chunk's first
                layer, the buffer released a chunk later

Every build, base included, compiles the h=128 instantiations alone (the
h=16 and h=64 cases of ``pick_kernel`` are cut), which keeps the builds
short.  Each build's registers and spill bytes come from its ``ptxas -v``
report.  ``--variants base`` times the tree's own kernel alone: run from
another checkout of the repository (``PYTHONPATH`` at its root) it times that
tree's kernel, so two designs compare in one call.

Run:  python -m ldpc_tpu_torch.tools.probe_wide_split [--rounds 3]
      [--variants base,no_second] [--kinds msg_gnn_v2,msg_gnn_v4]
      PYTHONPATH=<other checkout> python ldpc_tpu_torch/tools/probe_wide_split.py \
          --variants base

Needs the card and nvcc.  Prints one JSON object a build and shape, and the
card's name and power limit; builds go to ``ops/build/`` (ignored by git).
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

from ldpc_tpu_torch.codes import get_base_graph, qc_layout
from ldpc_tpu_torch.models import create_message_gnn_decoder
from ldpc_tpu_torch.ops import _build, fused_gnn as fg, qc_msg
from ldpc_tpu_torch.utils import bpsk_awgn_llr

H = 128
# shape -> (code, Z, T, injection, batch, SNR in dB)
SHAPES = {"path": ("nr_2_0_4", 4, 10, True, 4096, 1.0),
          "main": ("nr_2_0_32", 32, 20, False, 2048, 3.0)}
KINDS = {"msg_gnn_v2": (fg.make_fused_gnn_decoder_v2, 7),
         "msg_gnn_v4": (fg.make_fused_gnn_decoder_v4, 9)}

# Every build: only the h=128 instantiations.
_COMMON = [(f"    case {h}: return inject ? pick_variant<{h}, true>(V) : "
            f"pick_variant<{h}, false>(V);\n", "", 1) for h in (16, 64)]
_NONE = "for (int kt = 0; kt < 0; ++kt) {}"
# name -> [(text, replacement, occurrences)]
VARIANTS = {
    "base": [],
    "no_means": [("  means_wide(b, tid, nthreads);  // phase 1\n", "", 1)],
    "no_gather": [("        load_means_wide(b, A, tile + kWideGroups, rows0, lane);\n"
                   "        load_feats_wide(b, A, tile + kWideGroups, rows0, lane);\n", "", 1)],
    "no_mean_mma": [("    wgmma_n16(pm, wg_desc(A + MAT, H, kt), wg_desc(Bva, H, kt));\n", "", 1),
                    ("    wgmma_n16(pr, wg_desc(A + 2 * MAT, H, kt), wg_desc(Bca, H, kt));\n", "",
                     1)],
    "no_second": [("        wgmma_n128_rs(acc, h1[0], wg_desc(W2, 2 * kWideChunk, 0));\n"
                   "        wgmma_n128_rs(acc, h1[1], wg_desc(W2, 2 * kWideChunk, 1));",
                   "        acc[0][0] = __fadd_rn(acc[0][0], __uint_as_float("
                   "h1[0][0] ^ h1[0][1] ^ h1[0][2] ^ h1[0][3] ^ h1[1][0] ^ h1[1][1] ^ "
                   "h1[1][2] ^ h1[1][3] ^ "
                   "static_cast<uint32_t>(W2 - wc)));", 1)],
    "no_restream": [("static_cast<size_t>(s % NCH) * CW, 2 * CW, &full[st]);",
                     "static_cast<size_t>(s % NCH) * CW, s < kWideStages ? 2 * CW : 16, "
                     "&full[st]);", 1)],
    "groups_3": [("constexpr int kWideGroups = 2;", "constexpr int kWideGroups = 3;", 1)],
    "stages_3": [("constexpr int kWideStages = 2;", "constexpr int kWideStages = 3;", 1)],
    "means_2": [("constexpr int kWideMeans = 4;", "constexpr int kWideMeans = 2;", 1)],
    "means_6": [("constexpr int kWideMeans = 4;", "constexpr int kWideMeans = 6;", 1)],
    "warp_release": [("    wg_sync(wg);\n    if ((tid & 127) == 0) {", "    if (lane == 0) {", 1),
                     ("1ull) % kWideGroups == kWideGroups - 1 &&",
                      "1ull) % kWideWarps == kWideWarps - 1 &&", 1)],
    "defer_second": [
        ("        wg_commit();\n        wg_wait();\n        wg_keep(acc);\n"
         "        release(step);\n      }\n    }\n",
         "        wg_commit();\n      }\n    }\n    wg_wait();\n    wg_keep(acc);\n"
         "    if (has && !last) release(r * NCH + NCH - 1);\n", 1),
        ("      wg_keep(pr);\n      if (c == NCH - 1",
         "      wg_keep(pr);\n      if (c > 0 && !last) release(step - 1);\n"
         "      if (c == NCH - 1", 1)],
}
# The variants that compute the kernel's function: each must equal the decoder.
EXACT = ("base", "groups_3", "stages_3", "means_2", "means_6", "warp_release", "defer_second")


def _build_variant(name: str) -> tuple[Path, str]:
    """Compile the edited copy of fused_msg_gnn_tc.cu; (library, ptxas report)."""
    src = (Path(fg.__file__).parent / "csrc" / "fused_msg_gnn_tc.cu").read_text()
    for text, replacement, count in _COMMON + VARIANTS[name]:
        if src.count(text) != count:
            raise RuntimeError(f"{name}: expected {count} of {text!r} in fused_msg_gnn_tc.cu, "
                               f"found {src.count(text)}")
        src = src.replace(text, replacement)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / f"probe_wide_{name}.cu"
    lib = cu.with_suffix(".so")
    cu.write_text(src)
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}")
    return lib, proc.stdout


def _ptxas(report: str, V: int, inject: bool) -> dict:
    """Registers and spill bytes of msg_gnn_wide_tc_kernel<inject, V>."""
    key = f"msg_gnn_wide_tc_kernelILb{int(inject)}ELi{V}E"
    name, out = None, {}
    for line in report.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and key in name:
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


def _decoders(kinds) -> dict:
    """(kind, shape) -> (decoder, LLRs on the card)."""
    out = {}
    for shape, (code, Z, T, inject, batch, snr) in SHAPES.items():
        qc = qc_layout(get_base_graph(code), Z)
        gen = torch.Generator().manual_seed(5)
        model = create_message_gnn_decoder(qc_msg.make_plan(qc), num_iterations=T, hidden_dim=H,
                                           input_injection=inject, generator=gen)
        with torch.no_grad():
            for p in model.parameters():
                p.add_((0.02 * torch.randn(p.shape, generator=gen)).to(p.device))
        cgen = torch.Generator(device="cuda").manual_seed(2)
        llr = bpsk_awgn_llr(cgen, torch.zeros((batch, qc.num_vars), device="cuda"), snr)
        for kind in kinds:
            out[kind, shape] = (KINDS[kind][0](qc, model, T, H, input_injection=inject), llr)
    return out


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--kinds", default=",".join(KINDS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("probe_wide_split needs a CUDA device")
    names = args.variants.split(",")
    kinds = args.kinds.split(",")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)

    with ThreadPoolExecutor(len(names) + 1) as pool:
        whole = pool.submit(_build.build, "fused_msg_gnn_tc")  # the decoders' own library
        built = dict(zip(names, pool.map(_build_variant, names)))
        whole.result()
    decs = _decoders(kinds)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    runs = {}
    for name, (lib_path, report) in built.items():
        lib = ctypes.CDLL(str(lib_path))
        for fn_name, (argtypes, restype) in fg._TC_SIGNATURES.items():
            getattr(lib, fn_name).argtypes, getattr(lib, fn_name).restype = argtypes, restype
        for (kind, shape), (dec, llr) in decs.items():
            qc, tb, inject = dec.qc, dec.tables, dec.input_injection
            entry = fg.TC_ENTRY[kind]
            dims = (qc.Z, qc.num_base_rows, qc.num_base_cols, qc.num_base_edges)
            warps, blocks = ctypes.c_int(0), ctypes.c_int(0)
            rc = getattr(lib, f"{entry}_tc_plan")(H, int(inject), *dims, ctypes.addressof(warps),
                                                  ctypes.addressof(blocks))
            if rc != 0:
                raise RuntimeError(f"{name} {kind}: plan failed (CUDA error {rc})")
            if blocks.value < 1:  # a shape of the design whose block does not fit
                print(json.dumps({"variant": name, "kernel": kind, "shape": shape,
                                  "fits": False}), flush=True)
                continue
            B = llr.shape[0]
            grid = min(B, sms * blocks.value)
            soft = torch.empty_like(llr)
            counter = torch.zeros((1,), dtype=torch.int32, device="cuda")
            scratch = torch.empty((grid * fg.msg_gnn_scratch_floats(qc, H, kind),),
                                  dtype=torch.float32, device="cuda")

            def launch(fn=getattr(lib, entry), dec=dec, llr=llr, soft=soft, counter=counter,
                       scratch=scratch, tb=tb, dims=dims, inject=inject, grid=grid,
                       w=warps.value, label=f"{name} {kind} {shape}"):
                counter.zero_()
                err = fn(H, llr.data_ptr(), soft.data_ptr(), counter.data_ptr(),
                         scratch.data_ptr(), tb.graph.data_ptr(), tb.inv.data_ptr(),
                         tb.w_bf16.data_ptr(), tb.tab.data_ptr(), tb.small.data_ptr(),
                         tb.emb.data_ptr(), tb.extra.data_ptr(), llr.shape[0], *dims,
                         dec.num_iterations, int(inject), grid, w, None)
                if err != 0:
                    raise RuntimeError(f"{label}: launch failed, CUDA error {err}")

            launch()
            torch.cuda.synchronize()
            if name in EXACT and not torch.equal(soft, dec(llr)):
                raise AssertionError(f"{name} {kind} {shape}: the probe's launch differs from "
                                     f"the decoder's")
            runs[name, kind, shape] = dict(launch=launch, warps=warps.value,
                                           blocks_per_sm=blocks.value,
                                           ptxas=_ptxas(report, KINDS[kind][1], inject), ms=[])
    for _ in range(args.rounds):  # interleaved, so drift reaches every build alike
        for run in runs.values():
            run["ms"].append(_time_ms(run["launch"], 1))
    out = []
    for (name, kind, shape), run in runs.items():
        row = {"variant": name, "kernel": kind, "shape": shape, "warps": run["warps"],
               "blocks_per_sm": run["blocks_per_sm"], **run["ptxas"],
               "ms": [round(t, 3) for t in run["ms"]], "median_ms": statistics.median(run["ms"])}
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


if __name__ == "__main__":
    main()
