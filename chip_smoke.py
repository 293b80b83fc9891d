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
6. gnn_compare — the corrected-GNN kernels (corrected_v2, corrected)
             against their plain versions on perturbed seeded parameters:
             {input injection on, off} x {fixed T, early exit with
             conv_iter}, share_layers once, at toy_4x8 Z=4 h=16, nr_2_0_4
             Z=4 h=64 and nr_2_0_32 Z=32 h=64, T=2, odd batch sizes.  Bars:
             soft bits within 2e-2 on frames whose conv_iter agrees,
             decisions equal on >= 99.9% of bits, conv_iter equal on >= 99%
             of frames.  Then the noise floor at nr_2_0_32: kernel against
             plain version beside plain version on the card against itself
             on the CPU, at 1 iteration (held within 1e-5), 2 (within 2e-2)
             and 3 (measured: the iteration at which the two first differ
             and how the error grows; decisions held at every depth).
7. gnn_zero_init — untrained parameters: both kernels with early exit give
             the bits and conv_iter of the fused min-sum kernel (alpha 0.8),
             exactly, at nr_2_0_32 Z=32.
8. gnn_main — the flagship serving path at full width: nr_2_0_32 Z=32 h=64,
             trained checkpoints read from results/ by the port's own
             msgpack reader, batch 2048, 0 dB, early exit: T=10 and T=20
             through corrected_v2, T=10 through corrected; the counted
             launch's whole batch and 64 frames at -3 dB (where half the
             frames fail) against the plain version, stopped frames against
             the tensor-op syndrome check, the fixed-T kernel against the module's forward
             within 3e-2, and BER/FER on encoded random codewords.
9. nms_compare — the trained neural min-sum kernel (fused_neural) against
             its plain version on perturbed parameters: every weight
             sharing, depth 0-3, alpha and offset shared and per iteration,
             at nr_2_0_4 Z=4, nr_2_0_32 Z=32 and Z=128 (state in global
             scratch).  Bits identical.
10. nms_unit — unit weights (scalar w_ch 1, depth 0, alpha 1, offset 0)
             against fused min-sum at alpha 1 without tracking: decisions
             equal on >= 99.99% of bits (the variable update adds in another
             order), the count printed.
11. nms_main — results/oms10_per_iter_nr_2_0_32.msgpack (T=10, depth 2, per
             iteration) at nr_2_0_32 Z=32, batch 65536 GF(2)-encoded random
             codewords, QPSK at -3 dB: BER within 5% of 8.89e-3
             (results/README.md), the whole batch identical to the plain
             version.
12. msg_gnn_compare — the fully-neural kernels (msg_gnn_v2, msg_gnn)
             against their plain versions, T=2, h 16 and 64, injection and
             share_layers, seeded parameters moved by 0.02 noise: soft bits
             within 3e-2, decisions identical where the plain version is
             confident (|p - 0.5| > 0.05).  Then one T=3 model decoded to
             depth 1, 2, 3 beside the plain version's card-against-CPU
             difference (printed).
13. msg_gnn_main — bench.py section_msg_gnn at full width: nr_2_0_32 Z=32
             h=64, T=20, no injection, batch 2048, BPSK all-zero at 3 dB:
             msg_gnn_v2 (as the bench serves it) and msg_gnn, each whole
             batch against the plain version: decisions equal on >= 99.9%.
14. serve  — ldpc_tpu_torch.serve_trained_decoder with --model message_gnn
             and --model neural_minsum on the committed nr_2_0_4 checkpoints
             (defaults: batch 4096, 0 dB), BER/FER printed beside
             results/nr_2_0_4_comparison.json's; each launch counter moves.
15. kernels — per kernel: launches in its path's run, max abs error against
             the plain version, kernel / plain time, and the bound: the
             operations the batch's frames need (over their conv_iter
             iterations where they stop early), or its bytes, whichever
             takes longer on the card.

The line before the last is the ``kernels`` JSON line; the last line is
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero.
``--only classical|gnn|nms|msg_gnn`` runs the build and that part alone (for
development; the kernels line then lists that part).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

# Published H100 SXM peaks (NVIDIA data sheet, full 700 W power limit):
# HBM3 bandwidth, and float32 outside the tensor cores, 67 TFLOP/s counting
# an FMA as two operations.  The decode has no FMA, so float32 operations
# run at half that; int32 has half the float32 lanes.
PEAK_BYTES = 3.35e12
PEAK_F32_OPS = 67e12 / 2
PEAK_I32_OPS = 67e12 / 4
PEAK_BF16_TENSOR_OPS = 989e12  # dense bf16 on the tensor cores
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


def classical_phases(lib, smi: str) -> list[dict]:
    from ldpc_tpu_torch.codes import get_base_graph, qc_layout
    from ldpc_tpu_torch.models.classical import (
        MinSumScaledDecoder, _resolve_backend, decode_min_sum)
    from ldpc_tpu_torch.ops import fused_minsum as fm, qc_msg
    from ldpc_tpu_torch.utils.metrics import decode_throughput

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

    src = "ldpc_tpu_torch/ops/csrc/fused_minsum.cu"
    return [
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
    ]


# ---------------------------------------------------------------------------
# The corrected min-sum GNN path
# ---------------------------------------------------------------------------

GNN_SOFT_ATOL = 2e-2  # soft bits, kernel vs plain version, frames with equal conv_iter
GNN_MIN_BIT_AGREEMENT = 0.999
GNN_MIN_CONV_AGREEMENT = 0.99
GNN_MODULE_ATOL = 3e-2  # fixed-T kernel vs the module's forward
# Mean conv_iter the JAX package records for the same checkpoints, batch and
# SNR (BENCH_r05.json: iteration counts, not speeds), and the window held.
GNN_MEAN_CONV = {10: 4.45, 20: 3.86}
GNN_MEAN_CONV_WINDOW = 0.5


def gnn_bound_ms(qc, h: int, inject: bool, kind: str, conv: torch.Tensor) -> tuple[float, str]:
    """Least time for this batch's corrected-GNN decode, derived in the header
    of ldpc_tpu_torch/ops/csrc/fused_gnn.cu: products at the dense bf16
    tensor-core rate, elementwise and min-sum work at the float32 rate, LLRs
    read and soft bits written once; a frame needs conv_iter iterations and
    2 conv_iter - 1 corrections."""
    E, n, M = qc.num_edges, qc.num_vars, qc.num_base_rows * qc.Z
    inj = int(inject)
    iterations = float(conv.sum().item())
    corrections = float((2 * conv - 1).sum().item())
    first = 2 * h * h * (2 * E + (1 + 2 * inj) * n + M)
    if kind == "corrected_v2":
        products = first + 4 * h * E
        elementwise = (8 + inj) * h * E + (2 + 3 * inj) * h * n + 3 * h * M + E
    else:
        products = first + (4 * h * h + 2 * h) * E
        elementwise = (15 + inj) * h * E + (1 + 3 * inj) * h * n + h * M + E
    t_tensor = corrections * products / PEAK_BF16_TENSOR_OPS
    t_f32 = ((corrections * elementwise + iterations * (12 * E + 4 * M + 2 * n)) / PEAK_F32_OPS
             + iterations * (E + M) / PEAK_I32_OPS)
    t_bytes = conv.shape[0] * (8 * n + 4) / PEAK_BYTES
    t_ops = max(t_tensor, t_f32)
    return (t_ops * 1e3, "operations") if t_ops >= t_bytes else (t_bytes * 1e3, "bytes")


def gnn_compare(dec, llr: torch.Tensor, label: str, phase: str = "gnn_compare",
                kernel_out=None, plain_out=None) -> float:
    """A corrected-GNN kernel against its plain version on the card
    (``kernel_out``, ``plain_out``: their results on ``llr``, if already at
    hand); returns the max |soft difference| over frames whose conv_iter
    agrees."""
    out_k = kernel_out if kernel_out is not None else dec(llr)
    out_p = plain_out if plain_out is not None else dec.plain(llr)
    torch.cuda.synchronize()
    if dec.return_iterations:
        (soft_k, conv_k), (soft_p, conv_p) = out_k, out_p
    else:
        soft_k, soft_p = out_k, out_p
        conv_k = conv_p = torch.full((llr.shape[0],), float(dec.num_iterations), device=llr.device)
    assert soft_k.shape == soft_p.shape == llr.shape and soft_k.dtype == torch.float32, label
    assert bool(torch.isfinite(soft_k).all()) and float(soft_k.min()) >= 0.0 \
        and float(soft_k.max()) <= 1.0, label
    same = conv_k == conv_p
    conv_agreement = same.float().mean().item()
    bit_agreement = ((soft_k > 0.5) == (soft_p > 0.5)).float().mean().item()
    err = (soft_k - soft_p)[same].abs().max().item() if bool(same.any()) else 0.0
    ok = (err <= GNN_SOFT_ATOL and bit_agreement >= GNN_MIN_BIT_AGREEMENT
          and conv_agreement >= GNN_MIN_CONV_AGREEMENT)
    emit({"phase": phase, "case": label, "frames": llr.shape[0], "max_abs_err": err,
          "bit_agreement": bit_agreement, "conv_agreement": conv_agreement,
          "mean_conv_iter": conv_k.mean().item(), "ok": ok})
    if not ok:
        raise AssertionError(f"kernel disagrees with its plain version: {label}")
    return err


def add_noise(model, scale: float, gen: torch.Generator):
    """Every parameter of ``model`` moved by scale * normal noise from ``gen``."""
    with torch.no_grad():
        for param in model.parameters():
            param.add_((scale * torch.randn(param.shape, generator=gen)).to(param.device))
    return model


def perturbed_model(plan, T: int, h: int, inject: bool, share: bool, scale: float, seed: int):
    """A corrected decoder with trained-like parameters: initialised from a
    seed, then every parameter moved by scale * normal noise, so that the
    projections are non-zero and the corrections matter."""
    from ldpc_tpu_torch.models import create_corrected_minsum_gnn_decoder

    gen = torch.Generator().manual_seed(seed)
    model = create_corrected_minsum_gnn_decoder(plan, num_iterations=T, hidden_dim=h,
                                                input_injection=inject, share_layers=share,
                                                generator=gen)
    return add_noise(model, scale, gen)


def gnn_phases(smi: str) -> list[dict]:
    from ldpc_tpu_torch import convert
    from ldpc_tpu_torch.codes import encoder_from_H, expand_base_matrix, get_base_graph, qc_layout
    from ldpc_tpu_torch.models import create_corrected_minsum_gnn_decoder
    from ldpc_tpu_torch.ops import fused_gnn as fg, fused_minsum as fm, qc_msg
    from ldpc_tpu_torch.utils import bpsk_awgn_llr, compute_ber_fer
    from ldpc_tpu_torch.utils.metrics import decode_throughput

    lib = fg.kernel_library()
    builders = {"corrected_v2": fg.make_fused_corrected_gnn_decoder_v2,
                "corrected": fg.make_fused_corrected_gnn_decoder}
    max_err = {kind: 0.0 for kind in builders}

    # 6. gnn_compare
    # Frames at three SNRs each, so that some stop after one iteration, some
    # after two and some never.  The parameter noise is smaller at h=64: the
    # bf16 steps grow with the activations, and with them what one flipped
    # rounding moves.
    for code, Z, h, B, snrs, scale in (("toy_4x8", 4, 16, 37, (1.0, 3.0, 6.0), 0.05),
                                       ("nr_2_0_4", 4, 64, 21, (1.0, 4.0, 7.0), 0.02),
                                       ("nr_2_0_32", 32, 64, 13, (1.0, 4.0, 7.0), 0.02)):
        qc = qc_layout(get_base_graph(code), Z)
        plan = qc_msg.make_plan(qc)
        dims = (Z, qc.num_base_rows, qc.num_base_cols, qc.num_base_edges, qc.num_edge_types)
        llr = torch.cat([llrs(qc.num_vars, len(range(i, B, 3)), snr, seed=Z + h + i)
                         for i, snr in enumerate(snrs)])
        cases = [(inject, False, ee) for inject in (True, False) for ee in (False, True)]
        cases.append((True, True, True))  # share_layers once
        for kind, build in builders.items():
            # the wrapper's shared-memory and scratch plans are the kernel's
            assert lib.ldpc_corrected_gnn_smem_bytes(fg.VARIANT[kind], h, *dims) \
                == fg.corrected_smem_bytes(kind, qc, h)
            assert lib.ldpc_corrected_gnn_scratch_floats(h, *dims[:3]) \
                == fg.corrected_scratch_floats(qc, h)
            for inject, share, ee in cases:
                model = perturbed_model(plan, 2, h, inject, share, scale, seed=7)
                dec = build(qc, model, 2, h, share_layers=share, input_injection=inject,
                            early_exit=ee, return_iterations=ee)
                label = (f"{kind} {code} Z={Z} h={h} B={B} T=2 inject={inject} "
                         f"share={share} early_exit={ee}")
                max_err[kind] = max(max_err[kind], gnn_compare(dec, llr, label))

    # The noise floor of that comparison, at nr_2_0_32 Z=32 h=64: the plain
    # version on the card against itself on the CPU (the same function, another
    # summation order inside torch.matmul) beside the kernel against the plain
    # version.  At T=1 a single correction reaches the output and no flipped
    # bf16 rounding can cascade: there the kernel is held within 1e-5; at T=2
    # within the bar above.  T=3 is beyond that bar and is measured, not held to
    # it: one model of three iterations decoded to depth 1, 2 and 3 (a decoder of
    # depth d runs the model's first d iterations), which shows the iteration at
    # which kernel and plain version first differ by more than 1e-5, how the
    # error grows from there, and what share of the outputs it touches.  Held at
    # every depth: decisions equal on >= 99.9% of bits.
    qc32 = qc_layout(get_base_graph("nr_2_0_32"), 32)
    plan32 = qc_msg.make_plan(qc32)
    n = qc32.num_vars
    llr = llrs(n, 3, 3.0, seed=32)
    model = perturbed_model(plan32, 3, 64, True, False, 0.02, seed=7)
    for kind, build in builders.items():
        by_depth, first_differing = [], None
        for depth in (1, 2, 3):
            dec = build(qc32, model, depth, 64, input_injection=True)
            soft_k, soft_p = dec(llr), dec.plain(llr)
            soft_cpu = build(qc32, model, depth, 64, input_injection=True, device="cpu")(llr.cpu())
            diff = (soft_k - soft_p).abs()
            err = diff.max().item()
            floor = (soft_p - soft_cpu.to(llr.device)).abs().max().item()
            agreement = ((soft_k > 0.5) == (soft_p > 0.5)).float().mean().item()
            if first_differing is None and err > 1e-5:
                first_differing = depth
            by_depth.append({"iterations": depth, "max_abs_err": err,
                             "plain_card_vs_plain_cpu": floor,
                             "err_over_floor": err / floor if floor > 0 else None,
                             "outputs_above_1e-3": (diff > 1e-3).float().mean().item(),
                             "bit_agreement": agreement})
            bar = {1: 1e-5, 2: GNN_SOFT_ATOL}.get(depth)
            if agreement < GNN_MIN_BIT_AGREEMENT or (bar is not None and err > bar):
                raise AssertionError(f"{kind} kernel disagrees with its plain version at "
                                     f"{depth} iterations: {by_depth[-1]}")
            if bar is not None:
                max_err[kind] = max(max_err[kind], err)
        emit({"phase": "gnn_compare", "case": f"noise floor {kind} nr_2_0_32 h=64",
              "first_iteration_differing": first_differing, "by_depth": by_depth, "ok": True})

    # 7. gnn_zero_init: untrained corrections are zero -> exactly min-sum
    T0, B0 = 10, 512
    llr = llrs(n, B0, 1.5, seed=11)
    bits_ms, conv_ms = fm.make_fused_minsum(qc32, T0, 0.8, early_exit=True)(llr)
    untrained = create_corrected_minsum_gnn_decoder(
        plan32, num_iterations=T0, hidden_dim=64, input_injection=True,
        generator=torch.Generator().manual_seed(5))
    for kind, build in builders.items():
        soft, conv = build(qc32, untrained, T0, 64, early_exit=True, return_iterations=True)(llr)
        torch.cuda.synchronize()
        bits_same = bool(torch.equal((soft > 0.5).float(), bits_ms))
        conv_same = bool(torch.equal(conv, conv_ms.float()))
        emit({"phase": "gnn_zero_init", "kernel": kind, "batch": B0, "iterations": T0,
              "bits_identical": bits_same, "conv_iter_identical": conv_same,
              "mean_conv_iter": conv.mean().item(),
              "converged_share": (conv < T0).float().mean().item()})
        if not (bits_same and conv_same):
            raise AssertionError(f"untrained {kind} kernel is not the fused min-sum decoder")

    # 8. gnn_main: trained checkpoints, nr_2_0_32 Z=32 h=64, batch 2048, 0 dB
    H, B, SNR, HARD_SNR = 64, 2048, 0.0, -3.0
    llr = llrs(n, B, SNR, seed=2)
    llr_hard = llrs(n, 64, HARD_SNR, seed=9)
    entries = []
    results = Path(__file__).resolve().parent / "results"
    runs = (("corrected_v2", 10, "corrected10_gnn_nr_2_0_32_ft3.msgpack", True),
            ("corrected_v2", 20, "corrected20_gnn_nr_2_0_32_ft.msgpack", False),
            ("corrected", 10, "corrected10_gnn_nr_2_0_32_ft3.msgpack", True))
    models = {}
    for kind, T, ckpt, in_kernels_line in runs:  # the T=20 run is an extra reading of corrected_v2
        if T not in models:
            models[T] = create_corrected_minsum_gnn_decoder(
                plan32, num_iterations=T, hidden_dim=H, input_injection=True)
            convert.load_message_gnn(results / ckpt, models[T])  # missing file: raises
        model = models[T]
        dec = builders[kind](qc32, model, T, H, input_injection=True, early_exit=True,
                             return_iterations=True)
        for key in fg.LAUNCHES:
            fg.LAUNCHES[key] = 0
        counted_out = dec(llr)
        soft, conv = counted_out
        torch.cuda.synchronize()
        launches = dict(fg.LAUNCHES)
        if launches[kind] != 1:
            raise AssertionError(f"gnn main path did not run the {kind} kernel: {launches}")
        assert soft.shape == (B, n) and conv.shape == (B,) and conv.dtype == torch.float32
        assert bool(torch.isfinite(soft).all()) and float(soft.min()) >= 0.0 \
            and float(soft.max()) <= 1.0
        mean_conv = conv.mean().item()
        if abs(mean_conv - GNN_MEAN_CONV[T]) > GNN_MEAN_CONV_WINDOW:
            raise AssertionError(f"{kind} T={T}: mean conv_iter {mean_conv} is outside "
                                 f"{GNN_MEAN_CONV[T]} +- {GNN_MEAN_CONV_WINDOW}")
        ms, _ = cuda_ms(lambda: dec(llr), reps=3)
        # The counted launch's whole batch against the plain version's timed run
        # on the same batch: the shape at which the kernel is timed, every block
        # walking many frames.
        plain_ms, plain_out = cuda_ms(lambda: dec.plain(llr), reps=1)
        err = gnn_compare(dec, llr, f"{kind} main path T={T} whole batch", phase="gnn_main",
                          kernel_out=counted_out, plain_out=plain_out)
        del plain_out
        # At 0 dB nearly every frame stops and emits 0/1 decisions; at HARD_SNR
        # about half the frames run all T iterations and emit soft values.
        err = max(err, gnn_compare(dec, llr_hard, f"{kind} T={T} {HARD_SNR} dB, 64 frames",
                                   phase="gnn_main"))
        # A frame that stopped did so on a valid syndrome: hold that with the
        # tensor-op syndrome check, which shares nothing with the kernel.
        stopped = conv < T
        valid = qc_msg.syndrome_ok(qc_msg.llr_to_cz((soft[stopped] > 0.5).float(), plan32), plan32)
        if not bool(valid.all()):
            raise AssertionError(f"{kind} T={T}: a stopped frame is no codeword")
        bms, bby = gnn_bound_ms(qc32, H, True, kind, conv)
        # all-zero codewords: decisions of 1 are errors
        hard = (soft > 0.5).float()
        emit({"phase": "gnn_main", "kernel": kind, "checkpoint": ckpt, "code": "nr_2_0_32",
              "Z": 32, "hidden_dim": H, "iterations": T, "batch": B, "snr_db": SNR,
              "launches": launches, "ms_per_batch": ms,
              "bits_per_s": decode_throughput(B, n, ms / 1e3, name=f"{kind}_T{T}"),
              "plain_ms": plain_ms, "bound_ms": bms, "bound_by": bby,
              "mean_conv_iter": mean_conv, "converged_share": (conv < T).float().mean().item(),
              "ber_zero_codeword": hard.mean().item(),
              "fer_zero_codeword": (hard.sum(dim=1) > 0).float().mean().item(),
              "nvidia_smi": smi})
        if in_kernels_line:
            entries.append({
                "name": kind, "route": "cuda", "source": "ldpc_tpu_torch/ops/csrc/fused_gnn.cu",
                "replaces": "ldpc_tpu/ops/pallas_gnn.py:" + ("1791" if kind == "corrected_v2"
                                                            else "1341"),
                "launches": launches[kind], "max_abs_err": max(max_err[kind], err), "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bms, "bound_by": bby, "library_ms": None})

    # The fixed-T kernel against the module's own forward (bf16) on the main
    # path's LLRs and on the hard ones, within the JAX package's bar.
    model = models[10]
    fixed = fg.make_fused_corrected_gnn_decoder_v2(qc32, model, 10, H, input_injection=True)
    module_err = {}
    for label, x in (("main", llr[:64]), ("hard", llr_hard)):
        with torch.no_grad():
            soft_module, _ = model(x, plan32)
        soft_fixed = fixed(x)
        torch.cuda.synchronize()
        module_err[label] = {
            "max_abs_err": (soft_fixed - soft_module).abs().max().item(),
            "bit_agreement": ((soft_fixed > 0.5) == (soft_module > 0.5)).float().mean().item(),
            "frames_in_error": ((soft_module > 0.5).sum(dim=1) > 0).float().mean().item()}
    # BER / FER on GF(2)-encoded random codewords (the all-zero codeword
    # misleads for this family, which is not sign-symmetric).
    enc = encoder_from_H(expand_base_matrix(get_base_graph("nr_2_0_32"), 32))
    gen = torch.Generator(device="cuda").manual_seed(4)
    tx = enc.random_codewords(gen, B)
    early = fg.make_fused_corrected_gnn_decoder_v2(qc32, model, 10, H, input_injection=True,
                                                   early_exit=True, return_iterations=True)
    CODEWORD_SNR = -2.0
    soft_tx, conv_tx = early(bpsk_awgn_llr(gen, tx, CODEWORD_SNR))
    ber, fer = (float(x) for x in compute_ber_fer(tx, (soft_tx > 0.5).float()))
    ok = (max(e["max_abs_err"] for e in module_err.values()) <= GNN_MODULE_ATOL
          and min(e["bit_agreement"] for e in module_err.values()) >= GNN_MIN_BIT_AGREEMENT
          and fer < 0.2)
    emit({"phase": "gnn_main", "case": "fixed T=10 corrected_v2 vs MessageGNNDecoder forward, "
          "64 frames", "snr_db": {"main": SNR, "hard": HARD_SNR}, "module": module_err,
          "random_codewords": {"snr_db": CODEWORD_SNR, "batch": B, "ber": ber, "fer": fer,
                               "mean_conv_iter": conv_tx.mean().item()}, "ok": ok})
    if not ok:
        raise AssertionError("corrected_v2 disagrees with the module, or does not decode")
    return entries


# ---------------------------------------------------------------------------
# The trained neural min-sum path
# ---------------------------------------------------------------------------

# OMS(10, per-iter) on nr_2_0_32 Z=32 at -3 dB, QPSK, GF(2)-encoded random
# codewords, 1.0e9 bits (results/README.md, table row -3 dB), and the window held.
NMS_BER_REF = 8.89e-3
NMS_BER_WINDOW = 0.05
NMS_UNIT_MIN_AGREEMENT = 0.9999


def nms_bound_ms(qc, T: int, L: int, B: int) -> tuple[float, str]:
    """Least time for a batch of the trained min-sum decode, derived in the
    header of ldpc_tpu_torch/ops/csrc/fused_neural.cu: T check halves and
    T - 1 variable halves of float32 work (none an FMA), LLRs read and bits
    written once."""
    E, M, n = qc.num_edges, qc.num_base_rows * qc.Z, qc.num_vars
    ops = T * (7 * E + 8 * M) + (T - 1) * (4 + 2 * L) * E + E + 2 * n
    t_ops = B * ops / PEAK_F32_OPS * 1e3
    t_bytes = (B * n * 8 + T * E * 4) / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def perturbed_nms(plan, seed: int, scale: float = 0.1, **kw):
    """A NeuralMinSumDecoder with every parameter moved by scale * normal
    noise from a seed, so that weights, taps, alpha and offset all matter."""
    from ldpc_tpu_torch.models import NeuralMinSumDecoder

    model = NeuralMinSumDecoder(plan, **kw)
    gen = torch.Generator().manual_seed(seed)
    return add_noise(model, scale, gen)


def nms_phases(smi: str) -> list[dict]:
    from ldpc_tpu_torch import convert
    from ldpc_tpu_torch.codes import encoder_from_H, expand_base_matrix, get_base_graph, qc_layout
    from ldpc_tpu_torch.models import NeuralMinSumDecoder
    from ldpc_tpu_torch.ops import fused_minsum as fm, fused_neural as fn, qc_msg
    from ldpc_tpu_torch.utils import compute_ber_fer, qpsk_awgn_llr
    from ldpc_tpu_torch.utils.metrics import decode_throughput

    lib = fn.kernel_library()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # nms_compare: every weight sharing, depth 0-3, alpha and offset shared
    # and per iteration, perturbed parameters; Z=128 keeps the state in global
    # scratch, where each resident block loops over frames: the last case
    # hands every block three frames or more.  Bits identical to the plain
    # version.
    max_err = 0.0
    cases = [("nr_2_0_4", 4, 37, "scalar", 0, False, False, False),
             ("nr_2_0_4", 4, 37, "cell", 2, True, False, False),
             ("nr_2_0_4", 4, 37, "type", 1, True, False, True),
             ("nr_2_0_4", 4, 37, "edge", 2, True, True, True),
             ("nr_2_0_32", 32, 13, "edge", 2, True, True, True),
             ("nr_2_0_32", 32, 13, "type", 0, True, True, False),
             ("nr_2_0_32", 32, 13, "cell", 1, False, True, True),
             ("nr_2_0_32", 128, 5, "edge", 2, True, True, True),
             ("nr_2_0_32", 128, 5, "scalar", 3, True, False, False),
             ("nr_2_0_32", 128, None, "edge", 2, True, True, True)]
    for code, Z, B, sharing, L, learn_a, learn_o, per_it in cases:
        qc = qc_layout(get_base_graph(code), Z)
        plan = qc_msg.make_plan(qc)
        T = 5
        model = perturbed_nms(plan, seed=Z + L, num_iterations=T, depth_L=L,
                              weight_sharing=sharing, learnable_alpha=learn_a,
                              learnable_offset=learn_o, per_iteration=per_it)
        dec = fn.make_fused_neural_minsum(qc, model, T, L, per_iteration=per_it)
        dims = (Z, qc.num_base_rows, qc.num_base_cols, qc.num_base_edges, T, L)
        # the wrapper's shared-memory plan is the kernel's
        assert lib.ldpc_neural_smem_bytes(*dims, dec.frames_per_block, int(dec.shared)) == \
            fn.neural_smem_bytes(qc, T, L, dec.frames_per_block, dec.shared)
        resident = None if dec.shared else lib.ldpc_neural_occupancy(*dims, 1, 0) * sms
        if B is None:  # three frames or more for every resident block
            B = 3 * resident + 1
        llr = torch.cat([llrs(qc.num_vars, len(range(i, B, 2)), snr, seed=Z + i)
                         for i, snr in enumerate((0.5, 2.0))])
        bits_k, bits_p = dec(llr), dec.plain(llr)
        torch.cuda.synchronize()
        same = bool(torch.equal(bits_k, bits_p))
        max_err = max(max_err, (bits_k - bits_p).abs().max().item())
        emit({"phase": "nms_compare", "case": f"{code} Z={Z} B={B} T={T} {sharing} L={L} "
              f"alpha={learn_a} offset={learn_o} per_iteration={per_it}",
              "state": "shared" if dec.shared else "global", "frames_per_block":
              dec.frames_per_block, "resident_blocks": resident, "bits_identical": same,
              "bit_errors_vs_zero": int(bits_k.sum().item()), "ok": same})
        if not same:
            raise AssertionError("fused_neural kernel disagrees with its plain version")

    qc32 = qc_layout(get_base_graph("nr_2_0_32"), 32)
    plan32 = qc_msg.make_plan(qc32)
    n = qc32.num_vars

    # nms_unit: unit weights are plain min-sum at alpha 1.  The variable update
    # adds in another order than fused's ((colsum - c2v) + llr against
    # (llr + colsum) - c2v), so decisions may differ on a few bits.
    T_UNIT, B_UNIT = 10, 4096
    unit = NeuralMinSumDecoder(plan32, num_iterations=T_UNIT, depth_L=0, weight_sharing="scalar")
    llr = llrs(n, B_UNIT, 1.0, seed=21)
    bits_u = fn.make_fused_neural_minsum(qc32, unit, T_UNIT, 0)(llr)
    bits_f, _ = fm.make_fused_minsum(qc32, T_UNIT, 1.0, track_convergence=False)(llr)
    differ = int((bits_u != bits_f).sum().item())
    agreement = 1.0 - differ / bits_u.numel()
    ok = agreement >= NMS_UNIT_MIN_AGREEMENT
    emit({"phase": "nms_unit", "batch": B_UNIT, "iterations": T_UNIT, "snr_db": 1.0,
          "bits_differing": differ, "bit_agreement": agreement,
          "frame_errors_fused": int((bits_f.sum(dim=1) > 0).sum().item()), "ok": ok})
    if not ok:
        raise AssertionError("unit-weight fused_neural is not min-sum")

    # nms_main: the trained per-iteration offset min-sum of
    # tools/high_precision_flagship.py at nr_2_0_32 Z=32, -3 dB.
    T, L, B, SNR = 10, 2, 65536, -3.0
    ckpt = "oms10_per_iter_nr_2_0_32.msgpack"
    model = NeuralMinSumDecoder(plan32, num_iterations=T, depth_L=L, weight_sharing="edge",
                                learnable_alpha=True, learnable_offset=True, per_iteration=True,
                                loss_mode="mean")
    convert.load_neural_min_sum(Path(__file__).resolve().parent / "results" / ckpt, model)
    enc = encoder_from_H(expand_base_matrix(get_base_graph("nr_2_0_32"), 32))
    gen = torch.Generator(device="cuda").manual_seed(3)
    tx = enc.random_codewords(gen, B)
    llr = qpsk_awgn_llr(gen, tx, SNR)
    dec = fn.make_fused_neural_minsum(qc32, model, T, L, per_iteration=True)
    fn.LAUNCHES["fused_neural"] = 0
    bits = dec(llr)
    torch.cuda.synchronize()
    launches = fn.LAUNCHES["fused_neural"]
    if launches != 1:
        raise AssertionError(f"nms main path did not run the fused_neural kernel: {launches}")
    assert bits.shape == (B, n) and bits.dtype == torch.float32
    ber, fer = (float(x) for x in compute_ber_fer(tx, bits))
    ms, _ = cuda_ms(lambda: dec(llr), reps=5)
    plain_ms, bits_p = cuda_ms(lambda: dec.plain(llr), reps=1)
    same = bool(torch.equal(bits, bits_p))
    max_err = max(max_err, (bits - bits_p).abs().max().item())
    del bits_p
    bms, bby = nms_bound_ms(qc32, T, L, B)
    # Where the time goes: the same batch through a decoder of depth 1 (the
    # seed, one check half, the output) and through one without residual taps
    # (L=0).  A fixed T: the time depends on the shape, not on the weights.
    variants_ms = {}
    for name, depth, taps in (("depth_1", 1, L), ("no_taps", T, 0)):
        other = perturbed_nms(plan32, seed=depth + taps, num_iterations=depth, depth_L=taps,
                              weight_sharing="edge", learnable_alpha=True,
                              learnable_offset=True, per_iteration=True)
        vdec = fn.make_fused_neural_minsum(qc32, other, depth, taps, per_iteration=True)
        variants_ms[name] = cuda_ms(lambda: vdec(llr), reps=5)[0]
    variants_ms["per_iteration"] = (ms - variants_ms["depth_1"]) / (T - 1)
    ok = same and abs(ber / NMS_BER_REF - 1.0) <= NMS_BER_WINDOW
    emit({"phase": "nms_main", "checkpoint": ckpt, "code": "nr_2_0_32", "Z": 32,
          "iterations": T, "depth_L": L, "batch": B, "snr_db": SNR, "launches": launches,
          "ms_per_batch": ms, "bits_per_s": decode_throughput(B, n, ms / 1e3, name="nms"),
          "plain_ms": plain_ms, "bound_ms": bms, "bound_by": bby, "ber": ber, "fer": fer,
          "ber_reference": NMS_BER_REF, "whole_batch_identical": same, "variants_ms": variants_ms,
          "blocks_per_sm": lib.ldpc_neural_occupancy(32, qc32.num_base_rows, qc32.num_base_cols,
                                                     qc32.num_base_edges, T, L,
                                                     dec.frames_per_block, int(dec.shared)),
          "nvidia_smi": smi, "ok": ok})
    if not ok:
        raise AssertionError(f"nms main path: identical={same}, BER {ber} against "
                             f"{NMS_BER_REF} +- {NMS_BER_WINDOW:.0%}")
    return [{"name": "fused_neural", "route": "cuda",
             "source": "ldpc_tpu_torch/ops/csrc/fused_neural.cu",
             "replaces": "ldpc_tpu/ops/pallas_neural.py:111", "launches": launches,
             "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
             "bound_by": bby, "library_ms": None}]


# ---------------------------------------------------------------------------
# The fully-neural message GNN path
# ---------------------------------------------------------------------------

MSG_SOFT_ATOL = 3e-2  # the JAX package's bar (tests/test_pallas_gnn.py)
MSG_CONFIDENT = 0.05  # decisions held where the plain version has |p - 0.5| > this
MSG_MIN_BIT_AGREEMENT = 0.999
MSG_MIN_MIXED = 1e-3  # least share of each decision among confident bits, where held


def msg_bound_ms(qc, h: int, T: int, inject: bool, kind: str, B: int) -> tuple[float, str]:
    """Least time for a batch of the fully-neural decode, derived in the
    header of ldpc_tpu_torch/ops/csrc/fused_msg_gnn.cu: the (h, h) products
    at the dense bf16 tensor-core rate, elementwise work at the float32 rate
    (the two run beside each other), LLRs read and soft bits written once."""
    E, n, M = qc.num_edges, qc.num_vars, qc.num_base_rows * qc.Z
    inj = int(inject)
    products = B * T * 2 * h * h * (4 * E + n + M + 2 * inj * n)
    per_layer = (2 * E + n + M) * h + (6 + 2 * inj) * h * E \
        + (3 if kind == "msg_gnn" else 1) * h * E + (inj * n * h if kind == "msg_gnn" else 0)
    elementwise = B * (T * per_layer + (T - 1) * h * E + 2 * E * h + 2 * inj * n * h
                       + 2 * E * h + 2 * E + 4 * n)
    t_ops = max(products / PEAK_BF16_TENSOR_OPS, elementwise / PEAK_F32_OPS) * 1e3
    t_bytes = B * n * 8 / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def perturbed_msg_model(plan, T: int, h: int, inject: bool, share: bool, seed: int,
                        scale: float = 0.02):
    """A fully-neural decoder initialised from a seed, every parameter moved
    by scale * normal noise: the zero-init output projection would make the
    untrained outputs independent of the GNN."""
    from ldpc_tpu_torch.models import create_message_gnn_decoder

    gen = torch.Generator().manual_seed(seed)
    model = create_message_gnn_decoder(plan, num_iterations=T, hidden_dim=h,
                                       input_injection=inject, share_layers=share, generator=gen)
    return add_noise(model, scale, gen)


def msg_compare(soft_k: torch.Tensor, soft_p: torch.Tensor, label: str, phase: str,
                atol: float | None = MSG_SOFT_ATOL, min_agreement: float | None = None,
                mixed: bool = False) -> float:
    """Kernel against plain version: soft bits within ``atol`` and decisions
    identical where the plain version is confident; or, with
    ``min_agreement``, decisions equal on that share of all bits.  With
    ``mixed``, the plain version's confident decisions must hold both values
    (a run that decides every bit alike cannot tell a kernel from a
    constant).  Returns the largest soft difference."""
    torch.cuda.synchronize()
    assert soft_k.shape == soft_p.shape and soft_k.dtype == torch.float32, label
    assert bool(torch.isfinite(soft_k).all()) and float(soft_k.min()) >= 0.0 \
        and float(soft_k.max()) <= 1.0, label
    err = (soft_k - soft_p).abs().max().item()
    same = (soft_k > 0.5) == (soft_p > 0.5)
    confident = (soft_p - 0.5).abs() > MSG_CONFIDENT
    agreement = same.float().mean().item()
    confident_same = bool(same[confident].all())
    ones = (soft_p[confident] > 0.5).float().mean().item()
    if min_agreement is None:
        ok = (atol is None or err <= atol) and confident_same
    else:
        ok = agreement >= min_agreement
    if mixed:
        ok = ok and MSG_MIN_MIXED <= ones <= 1.0 - MSG_MIN_MIXED
    emit({"phase": phase, "case": label, "frames": soft_k.shape[0], "max_abs_err": err,
          "bit_agreement": agreement, "confident_share": confident.float().mean().item(),
          "confident_ones_share": ones, "confident_decisions_identical": confident_same,
          "ok": ok})
    if not ok:
        raise AssertionError(f"kernel disagrees with its plain version: {label}")
    return err


def msg_gnn_phases(smi: str) -> list[dict]:
    from ldpc_tpu_torch.codes import get_base_graph, qc_layout
    from ldpc_tpu_torch.ops import fused_gnn as fg, qc_msg
    from ldpc_tpu_torch.utils.metrics import decode_throughput

    lib = fg.msg_kernel_library()
    builders = {"msg_gnn_v2": fg.make_fused_gnn_decoder_v2, "msg_gnn": fg.make_fused_gnn_decoder}
    max_err = {kind: 0.0 for kind in builders}

    # msg_gnn_compare: T=2, h 16 and 64, injection and share_layers.
    for code, Z, h, B in (("toy_4x8", 4, 16, 37), ("nr_2_0_4", 4, 64, 21),
                          ("nr_2_0_32", 32, 64, 13)):
        qc = qc_layout(get_base_graph(code), Z)
        plan = qc_msg.make_plan(qc)
        dims = (Z, qc.num_base_rows, qc.num_base_cols, qc.num_base_edges)
        llr = torch.cat([llrs(qc.num_vars, len(range(i, B, 3)), snr, seed=Z + h + i)
                         for i, snr in enumerate((0.0, 2.0, 4.0))])
        for inject, share in ((False, False), (True, False), (True, True)):
            assert lib.ldpc_msg_gnn_smem_bytes(h, *dims) == fg.msg_gnn_smem_bytes(qc, h)
            assert lib.ldpc_msg_gnn_scratch_floats(h, *dims, int(inject)) == \
                fg.msg_gnn_scratch_floats(qc, h, inject)
            model = perturbed_msg_model(plan, 2, h, inject, share, seed=7)
            for kind, build in builders.items():
                dec = build(qc, model, 2, h, share_layers=share, input_injection=inject)
                label = f"{kind} {code} Z={Z} h={h} B={B} T=2 inject={inject} share={share}"
                err = msg_compare(dec(llr), dec.plain(llr), label, "msg_gnn_compare")
                max_err[kind] = max(max_err[kind], err)

    # The noise floor at nr_2_0_32 Z=32 h=64: one T=3 model decoded to depth
    # 1, 2 and 3, the kernel against the plain version beside the plain version
    # on the card against itself on the CPU.  Printed; decisions held where
    # the plain version is confident.
    qc32 = qc_layout(get_base_graph("nr_2_0_32"), 32)
    plan32 = qc_msg.make_plan(qc32)
    n = qc32.num_vars
    llr = llrs(n, 3, 2.0, seed=32)
    model = perturbed_msg_model(plan32, 3, 64, True, False, seed=7)
    for kind, build in builders.items():
        by_depth = []
        for depth in (1, 2, 3):
            dec = build(qc32, model, depth, 64, input_injection=True)
            soft_k, soft_p = dec(llr), dec.plain(llr)
            soft_cpu = build(qc32, model, depth, 64, input_injection=True, device="cpu")(llr.cpu())
            by_depth.append({"iterations": depth,
                             "max_abs_err": (soft_k - soft_p).abs().max().item(),
                             "plain_card_vs_plain_cpu":
                                 (soft_p - soft_cpu.to(llr.device)).abs().max().item()})
            msg_compare(soft_k, soft_p, f"noise floor {kind} depth {depth}", "msg_gnn_compare",
                        atol=None)
        emit({"phase": "msg_gnn_compare", "case": f"noise floor {kind} nr_2_0_32 h=64",
              "by_depth": by_depth, "ok": True})

    # msg_gnn_main: bench.py section_msg_gnn at full width.
    H, T, B, SNR = 64, 20, 2048, 3.0
    llr = llrs(n, B, SNR, seed=12)
    # The random T=20 model decides every bit 1, so its run cannot tell a
    # kernel from a constant.  First the whole batch through a T=2 model of
    # the same width, which does not saturate: every resident block decodes
    # many frames, each held within the soft bar with confident decisions
    # identical, and both decisions present.
    t2_model = perturbed_msg_model(plan32, 2, H, False, False, seed=11)
    for kind, build in builders.items():
        dec = build(qc32, t2_model, 2, H)
        err = msg_compare(dec(llr), dec.plain(llr), f"{kind} T=2 whole batch of {B}",
                          "msg_gnn_main", mixed=True)
        max_err[kind] = max(max_err[kind], err)
    model = perturbed_msg_model(plan32, T, H, False, False, seed=11)
    entries = []
    for kind in ("msg_gnn_v2", "msg_gnn"):  # v2 as the bench serves it, then v1
        dec = builders[kind](qc32, model, T, H)
        for key in fg.LAUNCHES:
            fg.LAUNCHES[key] = 0
        soft = dec(llr)
        torch.cuda.synchronize()
        launches = dict(fg.LAUNCHES)
        if launches[kind] != 1:
            raise AssertionError(f"msg_gnn main path did not run the {kind} kernel: {launches}")
        ms, _ = cuda_ms(lambda: dec(llr), reps=2)
        plain_ms, soft_p = cuda_ms(lambda: dec.plain(llr), reps=1)
        err = msg_compare(soft, soft_p, f"{kind} main path T={T} whole batch", "msg_gnn_main",
                          min_agreement=MSG_MIN_BIT_AGREEMENT)
        del soft_p
        bms, bby = msg_bound_ms(qc32, H, T, False, kind, B)
        # Where the time goes: a decoder of depth 1 (seed, one layer, output).
        shallow = builders[kind](qc32, model, 1, H)
        depth_1 = cuda_ms(lambda: shallow(llr), reps=3)[0]
        hard = (soft > 0.5).float()  # all-zero codewords: decisions of 1 are errors
        emit({"phase": "msg_gnn_main", "kernel": kind, "code": "nr_2_0_32", "Z": 32,
              "hidden_dim": H, "iterations": T, "batch": B, "snr_db": SNR,
              "launches": launches, "ms_per_batch": ms,
              "bits_per_s": decode_throughput(B, n, ms / 1e3, name=kind), "plain_ms": plain_ms,
              "bound_ms": bms, "bound_by": bby, "max_abs_err": err,
              "variants_ms": {"depth_1": depth_1, "per_layer": (ms - depth_1) / (T - 1)},
              "ber_zero_codeword": hard.mean().item(),
              "fer_zero_codeword": (hard.sum(dim=1) > 0).float().mean().item(),
              "blocks_per_sm": lib.ldpc_msg_gnn_occupancy(
                  fg.MSG_VARIANT[kind], H, 32, qc32.num_base_rows, qc32.num_base_cols,
                  qc32.num_base_edges),
              "nvidia_smi": smi})
        entries.append({
            "name": kind, "route": "cuda", "source": "ldpc_tpu_torch/ops/csrc/fused_msg_gnn.cu",
            "replaces": "ldpc_tpu/ops/pallas_gnn.py:" + ("295" if kind == "msg_gnn_v2" else "137"),
            "launches": launches[kind], "max_abs_err": max(max_err[kind], err), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": bby, "library_ms": None})
    return entries[::-1]


# Printed beside the serving entry point's numbers, not held: that file's
# protocol may differ (results/nr_2_0_4_comparison.json at 0 dB).
SERVE_REFERENCE = {"message_gnn": ("Message GNN (trained)", 0.0498, 0.959),
                   "neural_minsum": ("Neural min-sum 5it (trained)", 1.91e-3, 0.0727)}


def serve_phase() -> None:
    """The serving entry point on the committed nr_2_0_4 checkpoints, with
    its defaults (batch 4096, 0 dB, random codewords)."""
    from ldpc_tpu_torch import serve_trained_decoder
    from ldpc_tpu_torch.ops import fused_gnn as fg, fused_neural as fn

    results = Path(__file__).resolve().parent / "results"
    for model, ckpt, counters, kind in (
            ("message_gnn", "message_gnn_nr_2_0_4.msgpack", fg.LAUNCHES, "msg_gnn"),
            ("neural_minsum", "standard_nr_2_0_4.msgpack", fn.LAUNCHES, "fused_neural")):
        for key in counters:
            counters[key] = 0
        out = serve_trained_decoder.main(["--model", model, "--checkpoint",
                                          str(results / ckpt)])
        torch.cuda.synchronize()
        name, ber_ref, fer_ref = SERVE_REFERENCE[model]
        ok = counters[kind] >= 1 and out["device"] == "cuda"
        emit({"phase": "serve", "checkpoint": ckpt, "launches": counters[kind], **out,
              "reference": {"name": name, "ber": ber_ref, "fer": fer_ref}, "ok": ok})
        if not ok:
            raise AssertionError(f"serve_trained_decoder --model {model} did not run its kernel")


def build_all() -> dict:
    """Compile every CUDA source of the port, one nvcc per source, together."""
    from ldpc_tpu_torch.ops import _build

    stems = ("fused_minsum", "fused_gnn", "fused_neural", "fused_msg_gnn")
    with ThreadPoolExecutor(len(stems)) as pool:
        list(pool.map(_build.build, stems))
    return {stem: [ln.strip() for ln in _build.build_log(stem).splitlines()
                   if "registers" in ln or "spill" in ln or "Function properties" in ln]
            for stem in stems}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", choices=["classical", "gnn", "nms", "msg_gnn"], default=None)
    only = ap.parse_args(argv).only
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 1

    from ldpc_tpu_torch.codes import get_base_graph, qc_layout
    from ldpc_tpu_torch.ops import fused_gnn as fg, fused_minsum as fm, fused_neural as fn

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
    ptxas = build_all()
    lib = fm.kernel_library()
    # Resident blocks per SM of the main-path kernels, from the CUDA runtime.
    occupancy = {}
    for code, Z in (("nr_2_0_32", 32), ("nr_2_0_32", 384)):
        qc = qc_layout(get_base_graph(code), Z)
        dims = (Z, qc.num_base_rows, qc.num_base_cols, qc.num_base_edges)
        if Z == 32:
            fpb = fm.pick_fused_batch_tile(qc)
            occupancy[f"fused Z={Z} frames_per_block={fpb}"] = lib.ldpc_fused_occupancy(*dims, fpb, 0, 0)
            for name, variant in fg.VARIANT.items():
                occupancy[f"{name} Z={Z} h=64"] = fg.kernel_library().ldpc_corrected_gnn_occupancy(
                    variant, 64, *dims, qc.num_edge_types)
            for name, variant in fg.MSG_VARIANT.items():
                occupancy[f"{name} Z={Z} h=64"] = fg.msg_kernel_library().ldpc_msg_gnn_occupancy(
                    variant, 64, *dims)
            shared, fpb = fn.neural_plan(qc, 10, 2)
            occupancy[f"fused_neural Z={Z} T=10 L=2"] = fn.kernel_library().ldpc_neural_occupancy(
                *dims, 10, 2, fpb, int(shared))
        else:
            occupancy[f"fused_zlane Z={Z}"] = lib.ldpc_zlane_occupancy(*dims, 0, 0)
    if min(occupancy.values()) < 1:
        raise AssertionError(f"a main-path kernel cannot be resident: {occupancy}")
    emit({"phase": "build", "seconds": round(time.time() - t0, 3), "ptxas": ptxas,
          "blocks_per_sm": occupancy})

    entries = []
    if only in (None, "classical"):
        entries += classical_phases(lib, smi)
    if only in (None, "gnn"):
        entries += gnn_phases(smi)
    if only in (None, "nms"):
        entries += nms_phases(smi)
    if only in (None, "msg_gnn"):
        entries += msg_gnn_phases(smi)
    if only is None:
        serve_phase()

    # 15. kernels
    print(smi, flush=True)
    emit({"kernels": entries})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
