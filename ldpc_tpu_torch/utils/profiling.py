"""Profiling hooks and roofline estimates on the H100 (counterpart of
``ldpc_tpu.utils.profiling``).

``trace`` records a ``torch.profiler`` trace of the CPU and, where there is
one, the card, and writes it as a Chrome trace; ``annotate`` names a region
in it.  The roofline classes keep the JAX package's operation and byte
counts per frame; their bounds take the H100's published peaks, which are
also the peaks ``chip_smoke.py`` computes its bounds with.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from pathlib import Path

import torch

from ldpc_tpu_torch.codes.edge_layout import QCLayout

# Published H100 SXM peaks (NVIDIA data sheet, full 700 W power limit):
# HBM3 bandwidth, and float32 outside the tensor cores, 67 TFLOP/s counting
# an FMA as two operations.  The decode has no FMA, so float32 operations
# run at half that; int32 has half the float32 lanes.
PEAK_BYTES = 3.35e12
PEAK_F32_OPS = 67e12 / 2
PEAK_I32_OPS = 67e12 / 4
PEAK_BF16_TENSOR_OPS = 989e12  # dense bf16 on the tensor cores


@contextlib.contextmanager
def trace(log_dir: str | Path):
    """Record a profiler trace of the block into ``log_dir/trace.json``
    (Perfetto or chrome://tracing); yields the profiler, whose
    ``key_averages()`` sum the time by kernel."""
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Named region inside a trace (a host-side annotation)."""
    with torch.profiler.record_function(name):
        yield


@dataclass(frozen=True)
class MinSumRoofline:
    """Operation/byte counts per decode for a QC code."""

    vpu_element_ops_per_frame: float  # elementwise operations, all iterations
    hbm_bytes_per_frame: float  # LLR in + bits out (fused kernel floor)

    def bound_bits_per_s(self, n_bits: int, vpu_ops_per_s: float = PEAK_F32_OPS,
                         hbm_bytes_per_s: float = PEAK_BYTES) -> dict[str, float]:
        """Throughput bounds on one H100 (defaults: float32 operations that
        are not FMAs, HBM3 bandwidth)."""
        compute = n_bits / (self.vpu_element_ops_per_frame / vpu_ops_per_s)
        memory = n_bits / (self.hbm_bytes_per_frame / hbm_bytes_per_s)
        return {"compute_bound_bits_per_s": compute, "memory_bound_bits_per_s": memory}


@dataclass(frozen=True)
class GNNRoofline:
    """Matrix-product / elementwise / memory accounting per frame for the
    fused message-GNN kernel (the field names are the JAX package's: its
    "mxu" flops are the matrix products, here on the tensor cores)."""

    mxu_flops_per_frame: float  # bf16 matrix-product flops, all iterations
    vpu_element_ops_per_frame: float  # group means, relu, residual, output
    hbm_bytes_per_frame: float  # LLR in + soft bits out
    matmul_m: int  # per-product output rows (= hidden dim)

    def bound_bits_per_s(self, n_bits: int, mxu_flops_per_s: float = PEAK_BF16_TENSOR_OPS,
                         vpu_ops_per_s: float = PEAK_F32_OPS,
                         hbm_bytes_per_s: float = PEAK_BYTES) -> dict[str, float]:
        """Throughput bounds on one H100: the products at the dense bf16
        tensor-core rate, the elementwise work at the float32 rate, the
        LLRs and soft bits at the HBM3 rate.  The JAX package's (h/128)^2
        fill factor of the TPU's 128x128 matrix unit has no counterpart for
        the widths the kernels are built for (16 and 64: Hopper's mma tiles
        are 16 wide, wgmma's 8 to 256), so ``mxu_bound_achievable_bits_per_s``
        equals the peak bound."""
        mxu = n_bits / (self.mxu_flops_per_frame / mxu_flops_per_s)
        vpu = n_bits / (self.vpu_element_ops_per_frame / vpu_ops_per_s)
        hbm = n_bits / (self.hbm_bytes_per_frame / hbm_bytes_per_s)
        return {
            "mxu_bound_bits_per_s": mxu,
            "mxu_bound_achievable_bits_per_s": mxu,
            "vpu_bound_bits_per_s": vpu,
            "memory_bound_bits_per_s": hbm,
        }


def gnn_roofline(qc: QCLayout, hidden_dim: int, iterations: int,
                 input_injection: bool = False) -> GNNRoofline:
    """The JAX package's count of the fused GNN kernel's work
    (``pallas_gnn._kernel``), per frame:

    * products per iteration: 4 per base edge (two first-layer feature
      contractions, two second layers) + per-column precomputes (1, or 3
      with input injection) + per-row precompute, each (h, h) by (h, Z) =
      2 h^2 Z flops;
    * elementwise: group means (~2 adds per edge per hidden row),
      relu/residual (~4), seed/output (~3).
    """
    K, Z, C, R = qc.num_base_edges, qc.Z, qc.num_base_cols, qc.num_base_rows
    h = hidden_dim
    per_col = 3 if input_injection else 1
    matmuls = 4 * K + per_col * C + R
    mxu = iterations * matmuls * 2.0 * h * h * Z
    vpu = iterations * K * Z * h * 6.0 + K * Z * h * 3.0
    n = C * Z
    return GNNRoofline(
        mxu_flops_per_frame=mxu,
        vpu_element_ops_per_frame=vpu,
        hbm_bytes_per_frame=2 * n * 4.0,
        matmul_m=h,
    )


def minsum_roofline(qc: QCLayout, iterations: int) -> MinSumRoofline:
    """The JAX package's estimate for the fused min-sum kernel, per
    iteration and frame: ~8 operations per edge for the running min, second
    min and sign, ~7 for the leave-one-out writeback, ~1 add per edge for
    the column sums, ~2 per edge for parity: about 18 per edge."""
    K, Z, C = qc.num_base_edges, qc.Z, qc.num_base_cols
    edges = K * Z
    ops = iterations * edges * 18.0
    bytes_ = (C * Z) * 4.0 * 2  # LLR read + bits written once per frame
    return MinSumRoofline(vpu_element_ops_per_frame=ops, hbm_bytes_per_frame=bytes_)
