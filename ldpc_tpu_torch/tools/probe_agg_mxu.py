"""The check-relation aggregation probe on the H100 (kernel B10; the
counterpart of ``tools/probe_agg_mxu.py``).

The aggregation stage of a message-GNN layer, iterated L times over the same
features: per base row, the mean of its members' features aligned to the
check, written back to each member rolled to its variable.  Two variants of
hand-written CUDA kernels (``ops/csrc/probe_agg_mxu.cu``), each warp a task
of hidden units of one (frame, base row) for all L iterations:

* ``vpu``: the alignment by a circulant shift is an index on the CUDA cores:
  a warp shuffle between the lanes of a Z-lane segment where Z <= 32
  (:func:`vpu_in_registers`), else a read of the warp's slice of shared
  memory;
* ``mxu``: the alignment is a product with a 0/1 rotation matrix on the
  tensor cores (``mma.sync``, bf16 in, float32 accumulate), Z padded to a
  multiple of 32; the rotation fragment is built in registers from the
  shift, so no rotation matrix is stored.

Both take rows of at most ``MAX_DEG`` members (the kernels specialise on a
row's degree).

Features are (frames, K, h, Z) bf16.  The TPU tool packs them as (K*h,
ntiles*128) with frame ``tile * Bt + b`` at lane ``z * Bt + b``, Bt = 128 //
Z; ``from_tpu_layout`` and ``to_tpu_layout`` convert.  ``--ntiles`` keeps
its meaning: ntiles * (128 // Z) frames (one a tile where Z does not divide
128), so the default 32 tiles are 128 frames at Z=32.

Usage:
    python -m ldpc_tpu_torch.tools.probe_agg_mxu --check --device cpu
    python -m ldpc_tpu_torch.tools.probe_agg_mxu            # the card

The default device is the card; without one it raises.  ``--device cpu``
runs the plain PyTorch version, which the kernel repeats.  On the card each
variant is held against the plain version (``vpu`` identical, ``mxu`` within
one bf16 step, both identical on :func:`exact_features`) and timed;
``main(argv)`` returns what it prints.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import time

import numpy as np
import torch

from ldpc_tpu_torch._device import resolve_device
from ldpc_tpu_torch.codes import get_base_graph, qc_layout
from ldpc_tpu_torch.codes.edge_layout import QCLayout
from ldpc_tpu_torch.ops.fused_gnn import _PlainIndex, _r, _row_sum

VARIANTS = {"vpu": 0, "mxu": 1}
LAUNCHES: dict[str, int] = {name: 0 for name in VARIANTS}
CHECK_TOL = 2e-2  # the JAX tool's bar against its reference, times the largest |value|
EXACT_MAX = 64  # exact_features: integers in [-EXACT_MAX, EXACT_MAX]
MAX_DEG = 24  # kMaxDeg in ops/csrc/probe_agg_mxu.cu: members a row may have
TILE_ROWS = 16  # hidden units of an mxu task (kTileRows)
MXU_MAX_WARPS = 4  # mxu warps a block at most
# One thread block can use 227 KB (232,448 bytes) of shared memory on Hopper;
# 1 KB is kept back.
_SMEM_BUDGET = 232_448 - 1024

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # variant, in, out, graph, inv, frames, K, R, H, Z, max_deg, L, warps, stream
    "ldpc_probe_agg": ([_I] + [_P] * 4 + [_I] * 8 + [_P], _I),
    "ldpc_probe_smem_bytes": ([_I] * 4, ctypes.c_longlong),  # variant, Z, max_deg, warps
    "ldpc_probe_cuda_error_string": ([_I], ctypes.c_char_p),
}


def kernel_library():
    """The compiled ``ops/csrc/probe_agg_mxu.cu``, built on first use."""
    from ldpc_tpu_torch.ops import _build

    return _build.load("probe_agg_mxu", _SIGNATURES)


def vpu_in_registers(Z: int) -> bool:
    """Whether ``vpu`` keeps a row's members in registers and aligns them by
    warp shuffles (Z <= 32); else it uses a slice of shared memory a warp."""
    return Z <= 32


def smem_bytes(variant: str, Z: int, max_deg: int, warps: int = MXU_MAX_WARPS) -> int:
    """Dynamic shared memory of one block (``ldpc_probe_smem_bytes``):
    ``vpu`` in registers none, in shared memory (max_deg + 1) * Z floats for
    each of its 8 warps; ``mxu``, for each of its ``warps`` warps, the row's
    shifts (max_deg int32, rounded up to 16 bytes) and (max_deg + 1) * 16 *
    (Zp + 8) bf16 (Zp: Z rounded up to 32, rows padded by 8)."""
    if variant == "vpu":
        return 0 if vpu_in_registers(Z) else 4 * 8 * (max_deg + 1) * Z
    Zp = -(-Z // 32) * 32
    return warps * (4 * -(-max_deg // 4) * 4 + 2 * (max_deg + 1) * TILE_ROWS * (Zp + 8))


def mxu_warps(Z: int, max_deg: int) -> int:
    """Warps an ``mxu`` block takes: up to ``MXU_MAX_WARPS`` within shared
    memory (0 if one warp's slice does not fit)."""
    return max((w for w in range(1, MXU_MAX_WARPS + 1)
                if smem_bytes("mxu", Z, max_deg, w) <= _SMEM_BUDGET), default=0)


def frames_of(ntiles: int, Z: int) -> int:
    """Frames in ``ntiles`` TPU tiles of 128 lanes."""
    return ntiles * max(1, 128 // Z)


def from_tpu_layout(x: np.ndarray, K: int, h: int, Z: int) -> np.ndarray:
    """(K*h, ntiles*128) packed lanes -> (frames, K, h, Z); needs Z | 128."""
    Bt = 128 // Z
    nt = x.shape[1] // 128
    return np.ascontiguousarray(
        x.reshape(K, h, nt, Z, Bt).transpose(2, 4, 0, 1, 3).reshape(nt * Bt, K, h, Z))


def to_tpu_layout(x: np.ndarray) -> np.ndarray:
    """(frames, K, h, Z) -> (K*h, ntiles*128) packed lanes; needs Z | 128."""
    F, K, h, Z = x.shape
    Bt = 128 // Z
    return np.ascontiguousarray(
        x.reshape(F // Bt, Bt, K, h, Z).transpose(2, 3, 0, 4, 1).reshape(K * h, F // Bt * 128))


def reference(feats: torch.Tensor, qc: QCLayout, L: int, ix: _PlainIndex | None = None,
              inv_dr: torch.Tensor | None = None) -> torch.Tensor:
    """The plain PyTorch version: (frames, K, h, Z) bf16 -> the same after L
    iterations.  The sum runs in float32 over each row's members in row
    order, times float32(1 / degree), rounded to bf16, as the kernel does."""
    R, Z, K = qc.num_base_rows, qc.Z, qc.num_base_edges
    if ix is None:
        ix = _PlainIndex(qc, feats.device)
    if inv_dr is None:
        deg = np.maximum((qc.row_edges != K).sum(axis=1), 1)
        inv_dr = torch.from_numpy((1.0 / deg).astype(np.float32)).to(feats.device)
    F, _, h, _ = feats.shape
    cur = feats.to(torch.float32).transpose(-1, -2)  # (F, K, Z, h)
    for _ in range(L):
        rowm = _r(_row_sum(cur, ix, R) * inv_dr[None, :, None, None])  # (F, R, Z, h)
        cur = rowm.reshape(F, R * Z, h)[:, ix.edge_check].reshape(F, K, Z, h)
    return cur.transpose(-1, -2).to(torch.bfloat16).contiguous()


class Probe:
    """``probe(feats)``: L iterations of the aggregation stage.  Launches
    the ``variant`` kernel for a CUDA tensor and runs the plain version
    (:func:`reference`) for a CPU one; ``plain(feats)`` runs the plain
    version on any device."""

    def __init__(self, qc: QCLayout, hidden_dim: int, iterations: int, variant: str,
                 device: torch.device):
        if variant not in VARIANTS:
            raise ValueError(f"variant must be one of {tuple(VARIANTS)}, got {variant!r}")
        if hidden_dim % 16:
            raise ValueError(f"the probe kernel needs hidden_dim % 16 == 0, got {hidden_dim}")
        self.qc, self.h, self.L, self.variant = qc, hidden_dim, int(iterations), variant
        self.device = device
        K, Z = qc.num_base_edges, qc.Z
        members = [[int(k) for k in row if k != K] for row in qc.row_edges]
        self.max_deg = max(len(m) for m in members)
        if self.max_deg > MAX_DEG:
            raise ValueError(f"the probe's kernels take rows of at most {MAX_DEG} members, "
                             f"got {self.max_deg}")
        # mxu: warps a block (each with its slice of shared memory).
        self.warps = mxu_warps(Z, self.max_deg) if variant == "mxu" else 1
        if not self.warps:
            raise ValueError(f"the mxu probe's slice of one warp exceeds shared memory at "
                             f"Z={Z}, rows of {self.max_deg} members")
        row_ptr = np.cumsum([0] + [len(m) for m in members])
        # row_ptr, then each row's edges and shifts in row order.
        self.graph = torch.from_numpy(np.concatenate(
            [row_ptr, [k for m in members for k in m],
             [qc.edge_shift[k] for m in members for k in m]]).astype(np.int32)).to(device)
        deg = np.maximum(np.array([len(m) for m in members]), 1)
        self.inv_dr = torch.from_numpy((1.0 / deg).astype(np.float32)).to(device)
        self._ix = None

    def _check(self, feats: torch.Tensor) -> None:
        qc = self.qc
        want = (qc.num_base_edges, self.h, qc.Z)
        if feats.dim() != 4 or tuple(feats.shape[1:]) != want or feats.dtype != torch.bfloat16:
            raise ValueError(f"feats must be (frames, {want[0]}, {want[1]}, {want[2]}) bf16, "
                             f"got {tuple(feats.shape)} {feats.dtype}")
        if feats.device.type != self.device.type:
            raise ValueError(f"probe built for {self.device.type}, got a tensor on "
                             f"{feats.device.type}")

    def plain(self, feats: torch.Tensor) -> torch.Tensor:
        self._check(feats)
        if self._ix is None:
            self._ix = _PlainIndex(self.qc, self.device)
        return reference(feats, self.qc, self.L, self._ix, self.inv_dr)

    def __call__(self, feats: torch.Tensor) -> torch.Tensor:
        self._check(feats)
        if feats.device.type != "cuda":
            return self.plain(feats)
        if not feats.is_contiguous():
            raise ValueError("feats must be contiguous")
        out = torch.empty_like(feats)
        if feats.shape[0] == 0:
            return out
        qc, lib = self.qc, kernel_library()
        with torch.cuda.device(feats.device):
            stream = torch.cuda.current_stream(feats.device).cuda_stream
            rc = lib.ldpc_probe_agg(VARIANTS[self.variant], feats.data_ptr(), out.data_ptr(),
                                    self.graph.data_ptr(), self.inv_dr.data_ptr(),
                                    feats.shape[0], qc.num_base_edges, qc.num_base_rows,
                                    self.h, qc.Z, self.max_deg, self.L, self.warps, stream)
        if rc != 0:
            msg = lib.ldpc_probe_cuda_error_string(rc).decode()
            raise RuntimeError(f"probe {self.variant} kernel launch failed: CUDA error {rc} "
                               f"({msg})")
        LAUNCHES[self.variant] += 1
        return out


def make_probe(qc: QCLayout, hidden_dim: int, iterations: int, variant: str,
               device="cuda") -> Probe:
    """The probe of one variant for a code; the frame count comes with the
    features (the JAX builder's ``ntiles``)."""
    return Probe(qc, hidden_dim, iterations, variant, resolve_device(device))


def bf16_steps(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| in bf16 steps at the larger magnitude."""
    g, w = got.to(torch.float32), want.to(torch.float32)
    mag = torch.maximum(g.abs(), w.abs())
    step = torch.exp2(torch.floor(torch.log2(mag.clamp(min=2.0 ** -126))) - 7)
    return ((g - w).abs() / step).max().item() if g.numel() else 0.0


def random_features(qc: QCLayout, h: int, frames: int, device: torch.device,
                    seed: int = 0) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((frames, qc.num_base_edges, h, qc.Z), generator=gen,
                       device=device).to(torch.bfloat16)


def exact_features(qc: QCLayout, h: int, frames: int, device: torch.device,
                   seed: int = 0) -> torch.Tensor:
    """Integer-valued features in [-EXACT_MAX, EXACT_MAX], bf16: every row sum
    of the first iteration is an integer of at most 11 bits, and after it
    every member of a row carries the row mean, so each later sum adds deg
    equal bf16 values; each is exact in any order, and ``mxu`` must then
    equal ``vpu`` and the plain version bit for bit."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(-EXACT_MAX, EXACT_MAX + 1, (frames, qc.num_base_edges, h, qc.Z),
                         generator=gen, device=device).to(torch.bfloat16)


def _time(fn, feats, reps: int, windows: int, cuda: bool) -> list[float]:
    """Seconds per call in each of ``windows`` windows of ``reps`` calls,
    after one warm-up call (CUDA events on the card)."""
    fn(feats)
    out = []
    for _ in range(windows):
        if cuda:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn(feats)
            end.record()
            torch.cuda.synchronize()
            out.append(start.elapsed_time(end) / 1e3 / reps)
        else:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn(feats)
            out.append((time.perf_counter() - t0) / reps)
    return out


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--code", default="nr_2_0_32")
    ap.add_argument("--Z", type=int, default=32)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--ntiles", type=int, default=32)
    ap.add_argument("--reps", type=int, default=5, help="calls per timing window")
    ap.add_argument("--windows", type=int, default=3, help="timing windows (median kept)")
    ap.add_argument("--check", action="store_true",
                    help="numeric check at a tiny size (2 tiles, 3 iterations) against "
                         "reference(), no timing")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    if args.check:
        args.ntiles, args.iters = 2, 3
    qc = qc_layout(get_base_graph(args.code), args.Z)
    h, L = args.hidden, args.iters
    frames = frames_of(args.ntiles, args.Z)
    feats = random_features(qc, h, frames, dev)
    cuda = dev.type == "cuda"
    results = {}
    ref = reference(feats, qc, L)
    exact = exact_features(qc, h, frames, dev, seed=1)
    ref_exact = reference(exact, qc, L)
    scale = ref.to(torch.float32).abs().max().item()
    for variant in VARIANTS:
        probe = make_probe(qc, h, L, variant, dev)
        out = probe(feats)
        diff = (out.to(torch.float32) - ref.to(torch.float32)).abs().max().item()
        res = {"max_abs_err": diff, "identical": bool(torch.equal(out, ref)),
               "bf16_steps": bf16_steps(out, ref),
               "identical_on_exact": bool(torch.equal(probe(exact), ref_exact))}
        if args.check:
            print(f"{variant}: max|diff| {diff:.3e} (scale {scale:.3e})")
            if diff > CHECK_TOL * scale:
                raise AssertionError(f"{variant} disagrees with reference(): {diff} > "
                                     f"{CHECK_TOL} * {scale}")
        else:
            windows = _time(probe, feats, args.reps, args.windows, cuda)
            med = sorted(windows)[len(windows) // 2]
            res.update(window_ms=[w * 1e3 for w in windows], ms=med * 1e3,
                       us_per_frame_iteration=med / (frames * L) * 1e6)
            print(f"{variant}: {res['us_per_frame_iteration']:.4g} us/frame/iteration "
                  f"(windows {[round(w, 4) for w in res['window_ms']]} ms), max|diff| "
                  f"against the plain version {diff:.3e}, {res['bf16_steps']:.3g} bf16 steps",
                  flush=True)
        results[variant] = res
    summary = {"config": vars(args), "device": dev.type, "frames": frames, "results": results}
    if args.check:
        print("numerics OK")
    else:
        summary["mxu_speedup"] = (results["vpu"]["us_per_frame_iteration"]
                                  / results["mxu"]["us_per_frame_iteration"])
        print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
