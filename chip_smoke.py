"""Drive ldpc_tpu_torch on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, one JSON line each:

1. device  — the card's name and power limit (nvidia-smi); no card: exit 1.
2. build   — compile every CUDA source of the port with nvcc (sm_90a); the
             main-path kernels' resident blocks per SM from the runtime.
3. compare — each kernel against its plain PyTorch version on the card, for
             {minsum, sumproduct} x {flooding, layered} x {tracking,
             throughput mode, early exit}: fused at nr_2_0_4 Z=4 and
             nr_2_0_32 Z=32 (batches that are not a multiple of the block's
             frames), fused_zlane at nr_2_0_32 Z=384; plus the fused serving
             path against the tensor-op decode_min_sum.  Min-sum: bits and
             conv_iter identical.  Sum-product: bits agree on >= 99.9% and
             conv_iter within 1 (logf/tanhf round differently from torch's).
4. main    — the serving path at full width: nr_2_0_32, Z=32, batch 65536,
             20 iterations, 3 dB BPSK LLRs made on the card, through
             MinSumScaledDecoder(backend="auto") and make_fused_minsum; the
             whole batch held against the plain version, as in phase 3.
5. z384    — the large-Z path: auto resolves to fused_zlane, batch 512,
             the whole batch held against the plain version.
6. kernels — per kernel: launches in its path's run, max abs error against
             the plain version, kernel / plain time, and the bound: the
             operations the batch's frames need over their conv_iter
             iterations, or its bytes, whichever takes longer on the card.

The line before the last is the ``kernels`` JSON line; the last line is
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

# Published H100 SXM peaks (NVIDIA data sheet, full 700 W power limit):
# HBM3 bandwidth, and float32 outside the tensor cores, 67 TFLOP/s counting
# an FMA as two operations.  The decode has no FMA, so float32 operations
# run at half that; int32 has half the float32 lanes.
PEAK_BYTES = 3.35e12
PEAK_F32_OPS = 67e12 / 2
PEAK_I32_OPS = 67e12 / 4
# Operations one min-sum iteration (flooding, convergence tracked) of one
# frame needs, whatever the kernel does; derived in the header of
# ldpc_tpu_torch/ops/csrc/fused_minsum.cu.  (float32, int32) per lifted edge,
# per lifted check and per variable.
OPS_PER_EDGE = (9, 1)
OPS_PER_CHECK = (4, 1)
OPS_PER_VAR = (2, 0)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int):
    """(mean device time of fn() over reps calls after one warm-up call,
    the last call's result)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def bound_ms(qc, conv: torch.Tensor) -> tuple[float, str]:
    """Least time for this batch's decode: LLRs read and bits + conv_iter
    written once, against the operations of the iterations each frame needs
    (its conv_iter: later ones change neither its frozen bits nor conv_iter)."""
    B, n = conv.shape[0], qc.num_vars
    frame_iterations = int(conv.sum().item())
    counts = (qc.num_edges, qc.num_base_rows * qc.Z, n)
    f32, i32 = (sum(c * per[i] for c, per in zip(counts, (OPS_PER_EDGE, OPS_PER_CHECK, OPS_PER_VAR)))
                * frame_iterations for i in (0, 1))
    t_ops = (f32 / PEAK_F32_OPS + i32 / PEAK_I32_OPS) * 1e3
    t_bytes = (B * n * 4 * 2 + B * 4) / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def llrs(n: int, B: int, snr_db: float, seed: int) -> torch.Tensor:
    from ldpc_tpu_torch.utils import bpsk_awgn_llr

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return bpsk_awgn_llr(gen, torch.zeros((B, n), device="cuda"), snr_db)


def compare(dec, llr: torch.Tensor, label: str, plain_out=None) -> float:
    """Kernel vs plain version on the card (``plain_out``: the plain
    version's result on ``llr``, if already at hand); returns max |bits
    difference|."""
    bits_k, conv_k = dec(llr)
    bits_p, conv_p = plain_out if plain_out is not None else dec.plain(llr)
    torch.cuda.synchronize()
    assert bits_k.shape == bits_p.shape == llr.shape, label
    assert bool(torch.isfinite(bits_k).all()), label
    agree = (bits_k == bits_p).float().mean().item()
    dconv = (conv_k - conv_p).abs().max().item()
    err = (bits_k - bits_p).abs().max().item()
    if dec.mode == "minsum":
        ok = agree == 1.0 and dconv == 0
    else:
        ok = agree >= 0.999 and dconv <= 1
    emit({"phase": "compare", "case": label, "bit_agreement": agree,
          "max_conv_diff": dconv, "max_abs_err": err, "ok": ok})
    if not ok:
        raise AssertionError(f"kernel disagrees with its plain version: {label}")
    return err


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 1

    from ldpc_tpu_torch.codes import get_base_graph, qc_layout
    from ldpc_tpu_torch.models.classical import (
        MinSumScaledDecoder, _resolve_backend, decode_min_sum)
    from ldpc_tpu_torch.ops import _build, fused_minsum as fm, qc_msg
    from ldpc_tpu_torch.utils.metrics import decode_throughput

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # 2. build
    t0 = time.time()
    _build.build("fused_minsum")
    lib = fm.kernel_library()
    ptxas = [ln.strip() for ln in _build.build_log("fused_minsum").splitlines()
             if "registers" in ln or "spill" in ln]
    # Resident blocks per SM of the main-path kernels, from the CUDA runtime.
    occupancy = {}
    for code, Z in (("nr_2_0_32", 32), ("nr_2_0_32", 384)):
        qc = qc_layout(get_base_graph(code), Z)
        dims = (Z, qc.num_base_rows, qc.num_base_cols, qc.num_base_edges)
        if Z == 32:
            fpb = fm.pick_fused_batch_tile(qc)
            occupancy[f"fused Z={Z} frames_per_block={fpb}"] = lib.ldpc_fused_occupancy(*dims, fpb, 0, 0)
        else:
            occupancy[f"fused_zlane Z={Z}"] = lib.ldpc_zlane_occupancy(*dims, 0, 0)
    if min(occupancy.values()) < 1:
        raise AssertionError(f"a main-path kernel cannot be resident: {occupancy}")
    emit({"phase": "build", "seconds": round(time.time() - t0, 3), "ptxas": ptxas,
          "blocks_per_sm": occupancy})

    # 3. compare each kernel with its plain version
    flags = [(m, s, tr, ee) for m in ("minsum", "sumproduct") for s in ("flooding", "layered")
             for tr, ee in ((True, False), (False, False), (True, True))]
    max_err = {"fused": 0.0, "fused_zlane": 0.0}
    cases = [("fused", "nr_2_0_4", 4, 37, None, 1.0),
             ("fused", "nr_2_0_32", 32, 50, 3, 1.5),
             ("fused_zlane", "nr_2_0_32", 384, 20, 7, 1.5)]
    for kind_, code, Z, B, bt, snr in cases:
        qc = qc_layout(get_base_graph(code), Z)
        dims = (Z, qc.num_base_rows, qc.num_base_cols, qc.num_base_edges)
        if kind_ == "fused":  # the wrapper's shared-memory plan is the kernel's
            fpb = bt or fm.pick_fused_batch_tile(qc)
            assert lib.ldpc_fused_smem_bytes(*dims, fpb) == fm.fused_smem_bytes(qc, fpb)
        else:
            assert lib.ldpc_zlane_smem_bytes(*dims) == fm.zlane_smem_bytes(qc)
        llr = llrs(qc.num_vars, B, snr, seed=Z)
        build = fm.make_fused_minsum if kind_ == "fused" else fm.make_fused_minsum_zlane
        for mode, sched, tr, ee in flags:
            dec = build(qc, 20, 0.75, batch_tile=bt, mode=mode, track_convergence=tr,
                        early_exit=ee, schedule=sched)
            label = f"{kind_} {code} Z={Z} B={B} {mode} {sched} track={tr} early_exit={ee}"
            max_err[kind_] = max(max_err[kind_], compare(dec, llr, label))
    # The serving path against the tensor-op path (the JAX package's bar:
    # identical bits, conv_iter within 1 on at most 1% of frames).
    qc32 = qc_layout(get_base_graph("nr_2_0_32"), 32)
    llr = llrs(qc32.num_vars, 256, 1.5, seed=1)
    bits_k, conv_k = fm.make_fused_minsum(qc32, 20, 0.75)(llr)
    ref = decode_min_sum(llr, qc_msg.make_plan(qc32), 20, 0.75)
    dconv = (conv_k - ref.conv_iter).abs()
    ok = bool((bits_k == ref.bits).all()) and int(dconv.max()) <= 1 and \
        float((dconv > 0).float().mean()) <= 0.01
    emit({"phase": "compare", "case": "fused vs decode_min_sum nr_2_0_32 Z=32 B=256",
          "bits_identical": bool((bits_k == ref.bits).all()),
          "conv_diff_share": float((dconv > 0).float().mean()), "ok": ok})
    if not ok:
        raise AssertionError("fused kernel disagrees with decode_min_sum")

    # 4. main path: nr_2_0_32 Z=32, batch 65536, 20 iterations, 3 dB
    ITERS, B = 20, 65536
    n = qc32.num_vars
    assert _resolve_backend("auto", qc32) == "fused"
    llr = llrs(n, B, 3.0, seed=0)
    server = MinSumScaledDecoder(qc32, ITERS, 0.75, early_stopping=False, backend="auto")
    fused = fm.make_fused_minsum(qc32, ITERS, 0.75)
    for key in fm.LAUNCHES:
        fm.LAUNCHES[key] = 0
    bits_s, iters = server.decode(llr)
    bits, conv = fused(llr)
    torch.cuda.synchronize()
    launches_main = dict(fm.LAUNCHES)
    if launches_main["fused"] < 2:
        raise AssertionError(f"main path did not run the fused kernel: {launches_main}")
    assert bits.shape == (B, n) and conv.shape == (B,) and conv.dtype == torch.int32
    assert bool(torch.equal(bits, bits_s)) and iters == ITERS
    bit_errors = int(bits.sum().item())
    frame_errors = int((bits.sum(dim=1) > 0).sum().item())
    mean_conv = float(conv.float().mean().item())
    if bit_errors > B * n * 1e-6 or not 2.0 <= mean_conv <= 4.0:
        raise AssertionError(f"main path decodes wrongly: {bit_errors} bit errors, "
                             f"mean conv_iter {mean_conv}")
    ms, _ = cuda_ms(lambda: fused(llr), reps=10)
    ms_server, _ = cuda_ms(lambda: server.decode(llr), reps=5)
    plain_ms, plain_out = cuda_ms(lambda: fused.plain(llr), reps=1)
    err_main = compare(fused, llr, f"fused main path B={B}", plain_out)
    del plain_out
    bms, bby = bound_ms(qc32, conv)
    # Where the time goes: the same batch through the kernel's other flags.
    variants_ms = {
        name: cuda_ms(lambda dec=fm.make_fused_minsum(qc32, ITERS, 0.75, **kw): dec(llr), reps=3)[0]
        for name, kw in (("throughput_mode", {"track_convergence": False}),
                         ("early_exit", {"early_exit": True}),
                         ("layered", {"schedule": "layered"}))
    }
    emit({"phase": "main", "code": "nr_2_0_32", "Z": 32, "batch": B, "iterations": ITERS,
          "snr_db": 3.0, "backend": "fused", "launches": launches_main,
          "bits_per_s": decode_throughput(B, n, ms / 1e3, name="minsum"),
          "ms_per_batch": ms, "server_ms_per_batch": ms_server, "plain_ms": plain_ms,
          "variants_ms": variants_ms, "bound_ms": bms, "bound_by": bby, "bit_errors": bit_errors,
          "frame_errors": frame_errors, "mean_conv_iter": mean_conv, "nvidia_smi": smi})

    # 5. Z=384 path: auto resolves to fused_zlane
    B384 = 512
    qc384 = qc_layout(get_base_graph("nr_2_0_32"), 384)
    assert _resolve_backend("auto", qc384) == "fused_zlane"
    n384 = qc384.num_vars
    llr384 = llrs(n384, B384, 3.0, seed=3)
    server384 = MinSumScaledDecoder(qc384, ITERS, 0.75, early_stopping=False, backend="auto")
    zfused = fm.make_fused_minsum_zlane(qc384, ITERS, 0.75)
    for key in fm.LAUNCHES:
        fm.LAUNCHES[key] = 0
    bits_s, _ = server384.decode(llr384)
    bits, conv = zfused(llr384)
    torch.cuda.synchronize()
    launches_z = dict(fm.LAUNCHES)
    if launches_z["fused_zlane"] < 2:
        raise AssertionError(f"Z=384 path did not run the zlane kernel: {launches_z}")
    assert bits.shape == (B384, n384) and bool(torch.equal(bits, bits_s))
    bit_errors384 = int(bits.sum().item())
    mean_conv384 = float(conv.float().mean().item())
    if bit_errors384 > B384 * n384 * 1e-6 or not 2.0 <= mean_conv384 <= 6.0:
        raise AssertionError(f"Z=384 path decodes wrongly: {bit_errors384} bit errors, "
                             f"mean conv_iter {mean_conv384}")
    ms384, _ = cuda_ms(lambda: zfused(llr384), reps=5)
    plain_ms384, plain_out = cuda_ms(lambda: zfused.plain(llr384), reps=1)
    err_z = compare(zfused, llr384, f"fused_zlane main path Z=384 B={B384}", plain_out)
    del plain_out
    bms384, bby384 = bound_ms(qc384, conv)
    emit({"phase": "z384", "code": "nr_2_0_32", "Z": 384, "batch": B384, "iterations": ITERS,
          "snr_db": 3.0, "backend": "fused_zlane", "launches": launches_z,
          "bits_per_s": decode_throughput(B384, n384, ms384 / 1e3, name="z384"),
          "ms_per_batch": ms384, "plain_ms": plain_ms384, "bound_ms": bms384,
          "bound_by": bby384, "bit_errors": bit_errors384, "mean_conv_iter": mean_conv384,
          "nvidia_smi": smi})

    # 6. kernels
    print(smi, flush=True)
    src = "ldpc_tpu_torch/ops/csrc/fused_minsum.cu"
    emit({"kernels": [
        {"name": "fused", "route": "cuda", "source": src,
         "replaces": "ldpc_tpu/ops/pallas_minsum.py:143", "launches": launches_main["fused"],
         "max_abs_err": max(max_err["fused"], err_main), "ms": ms, "plain_ms": plain_ms,
         "bound_ms": bms, "bound_by": bby, "library_ms": None},
        {"name": "fused_zlane", "route": "cuda", "source": src,
         "replaces": "ldpc_tpu/ops/pallas_minsum.py:399",
         "launches": launches_z["fused_zlane"],
         "max_abs_err": max(max_err["fused_zlane"], err_z), "ms": ms384,
         "plain_ms": plain_ms384, "bound_ms": bms384, "bound_by": bby384,
         "library_ms": None},
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
