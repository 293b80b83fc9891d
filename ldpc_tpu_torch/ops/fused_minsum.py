"""Fused min-sum / BP decoders: the whole decode loop in one CUDA kernel
(counterpart of ``ldpc_tpu.ops.pallas_minsum``).

Two hand-written kernels live in ``csrc/fused_minsum.cu``:

* ``fused`` (replaces ``pallas_minsum._kernel``): a few frames per thread
  block, with all decode state (c2v, beliefs, channel LLRs) in shared
  memory.  Fits while one frame's state is below the block's shared memory
  (Z=32 on NR BG2: about 42 KB a frame).
* ``fused_zlane`` (replaces ``pallas_minsum._kernel_zlane``): the same
  semantics when a frame's state exceeds shared memory (the 5G maximum
  Z=384): c2v lives in a global scratch buffer, beliefs in shared memory,
  and each block walks over frames one at a time.

Both take every flag the TPU kernels take: ``mode`` ("minsum" scaled by
``alpha``, or "sumproduct"), ``schedule`` ("flooding" or "layered"),
``track_convergence`` and ``early_exit``.  Semantics match
:func:`ldpc_tpu_torch.models.classical.decode_min_sum` (per-frame
first-valid-syndrome freezing): input (B, n) float32 LLRs, output (B, n)
float32 bits and (B,) int32 ``conv_iter``.

Each builder returns a :class:`FusedDecoder`.  Called on a CUDA tensor it
launches its kernel (and raises if the launch fails); called on a CPU tensor
it runs the kernel's plain PyTorch version, which repeats the kernel's
arithmetic in the same order (running m1/m2/sign product per base row,
sequential column sums in ``col_members`` order), so min-sum results are
bit-identical between the two.  ``FusedDecoder.plain`` runs the plain version
on any device, for comparisons.

The two kernels compute the same function, so one plain version serves both.
``LAUNCHES`` counts kernel launches per kernel name.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ldpc_tpu_torch._device import resolve_device
from ldpc_tpu_torch.codes.edge_layout import QCLayout
from ldpc_tpu_torch.ops.qc_msg import _BIG, _phi

# One thread block can use 227 KB (232,448 bytes) of shared memory on Hopper
# (opt-in above 48 KB); 1 KB is kept back for the kernels' static arrays.
_SMEM_BUDGET = 232_448 - 1024
_MAX_FRAMES_PER_BLOCK = 32  # kMaxFramesPerBlock in csrc/fused_minsum.cu
_FUSED_THREADS = 256  # kFusedThreads in csrc/fused_minsum.cu

LAUNCHES: dict[str, int] = {"fused": 0, "fused_zlane": 0}


class _Structure(NamedTuple):
    """Static base-graph structure."""

    Z: int
    R: int
    C: int
    K: int
    row_members: tuple[tuple[int, ...], ...]  # base-edge ids per check row
    col_members: tuple[tuple[int, ...], ...]  # base-edge ids per var column
    shifts: tuple[int, ...]  # circulant shift per base edge
    cols: tuple[int, ...]  # base column per base edge


def _structure(qc: QCLayout) -> _Structure:
    K = qc.num_base_edges
    row_members = tuple(
        tuple(int(k) for k in row if k != K) for row in qc.row_edges
    )
    col_members = tuple(
        tuple(int(k) for k in col if k != K) for col in qc.col_edges
    )
    return _Structure(
        Z=qc.Z,
        R=qc.num_base_rows,
        C=qc.num_base_cols,
        K=K,
        row_members=row_members,
        col_members=col_members,
        shifts=tuple(int(s) for s in qc.edge_shift),
        cols=tuple(int(c) for c in qc.edge_col),
    )


# ---------------------------------------------------------------------------
# Shared-memory plans (mirrored by the *_smem_bytes functions in the .cu file)
# ---------------------------------------------------------------------------


def _graph_words(R: int, C: int, K: int) -> int:
    """int32 words of the CSR structure a block keeps in shared memory."""
    return -(-(4 * K + R + C + 2) // 4) * 4


def fused_smem_bytes(qc: QCLayout, batch_tile: int = 1) -> int:
    """Dynamic shared memory of one ``fused`` block: structure plus, per
    frame, c2v (K*Z) and beliefs and LLRs (C*Z each), all float32."""
    K, Z, C, R = qc.num_base_edges, qc.Z, qc.num_base_cols, qc.num_base_rows
    return 4 * (_graph_words(R, C, K) + batch_tile * (K * Z + 2 * C * Z))


def zlane_smem_bytes(qc: QCLayout) -> int:
    """Dynamic shared memory of one ``fused_zlane`` block: structure plus
    one frame's float32 beliefs (c2v stays in global memory)."""
    K, Z, C, R = qc.num_base_edges, qc.Z, qc.num_base_cols, qc.num_base_rows
    return 4 * (_graph_words(R, C, K) + C * Z)


def fused_kernel_fits(qc: QCLayout, batch_tile: int = 1) -> bool:
    return fused_smem_bytes(qc, batch_tile) <= _SMEM_BUDGET


def pick_fused_batch_tile(qc: QCLayout) -> int:
    """Frames per ``fused`` block: enough lifted checks to occupy the block's
    threads, within the shared-memory budget (0 if one frame does not fit)."""
    bt = min(_MAX_FRAMES_PER_BLOCK, max(1, -(-_FUSED_THREADS // (qc.num_base_rows * qc.Z))))
    while bt and not fused_kernel_fits(qc, bt):
        bt -= 1
    return bt


def zlane_kernel_fits(qc: QCLayout) -> bool:
    return qc.Z % 8 == 0 and zlane_smem_bytes(qc) <= _SMEM_BUDGET


def _graph_array(st: _Structure) -> np.ndarray:
    """CSR structure for the kernels: row_ptr (R+1), row_edge (K),
    col_ptr (C+1), col_edge (K), shift (K), col (K), int32."""
    row_ptr = np.cumsum([0] + [len(m) for m in st.row_members])
    col_ptr = np.cumsum([0] + [len(m) for m in st.col_members])
    parts = [
        row_ptr,
        [k for m in st.row_members for k in m],
        col_ptr,
        [k for m in st.col_members for k in m],
        st.shifts,
        st.cols,
    ]
    return np.concatenate([np.asarray(p, dtype=np.int32) for p in parts])


# ---------------------------------------------------------------------------
# Plain PyTorch version of the kernels
# ---------------------------------------------------------------------------


class _PlainIndex:
    """Index tensors through which the plain version walks the structure in
    the kernels' order.  Flat layouts per frame: c2v (K*Z) var-aligned,
    beliefs (C*Z)."""

    def __init__(self, st: _Structure, device: torch.device):
        Z, R, C, K = st.Z, st.R, st.C, st.K
        z = np.arange(Z)
        dr = max(len(m) for m in st.row_members)
        dv = max(len(m) for m in st.col_members)

        # Flooding: slot j of every row at once, check-aligned (R*Z,) lanes.
        e_idx = np.zeros((dr, R, Z), np.int64)
        v_idx = np.zeros((dr, R, Z), np.int64)
        valid = np.zeros((dr, R, Z), bool)
        for r, members in enumerate(st.row_members):
            for j, k in enumerate(members):
                zz = (z + st.shifts[k]) % Z
                e_idx[j, r] = k * Z + zz
                v_idx[j, r] = st.cols[k] * Z + zz
                valid[j, r] = True
        t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
        self.e_idx = t(e_idx.reshape(dr, R * Z))
        self.v_idx = t(v_idx.reshape(dr, R * Z))
        self.valid = t(valid.reshape(dr, R * Z))
        self.vpos = [t(np.nonzero(valid[j].reshape(-1))[0]) for j in range(dr)]
        self.e_valid = [self.e_idx[j][self.vpos[j]] for j in range(dr)]

        # Column sums: slot j of every column, (C*Z,) lanes, pads add 0.
        c_idx = np.zeros((dv, C, Z), np.int64)
        c_valid = np.zeros((dv, C, Z), bool)
        for c, members in enumerate(st.col_members):
            for j, k in enumerate(members):
                c_idx[j, c] = k * Z + z
                c_valid[j, c] = True
        self.c_idx = t(c_idx.reshape(dv, C * Z))
        self.c_valid = t(c_valid.reshape(dv, C * Z))

        # Layered: per row, its members' lanes stacked (d*Z,).
        self.rows = []
        for members in st.row_members:
            zz = [(z + st.shifts[k]) % Z for k in members]
            self.rows.append((
                len(members),
                t(np.concatenate([k * Z + q for k, q in zip(members, zz)])),
                t(np.concatenate([st.cols[k] * Z + q for k, q in zip(members, zz)])),
            ))


def _sgn(x: torch.Tensor) -> torch.Tensor:
    """where(x < 0, -1, 1): sign(0) = +1, never ``torch.sign``."""
    return torch.where(x < 0, -1.0, 1.0)


def _check_update_slots(bel, c2v, ix: _PlainIndex, alpha: float, sumproduct: bool):
    """Flooding check update of every row, slot by slot, in place on c2v."""
    B = bel.shape[0]
    RZ = ix.e_idx.shape[1]
    sp = torch.ones((B, RZ), dtype=torch.float32, device=bel.device)
    if not sumproduct:
        m1 = torch.full((B, RZ), _BIG, dtype=torch.float32, device=bel.device)
        m2 = m1.clone()
        for j in range(ix.e_idx.shape[0]):
            x = bel[:, ix.v_idx[j]] - c2v[:, ix.e_idx[j]]
            # Padding slots: sign +1, magnitude BIG -> no-op in the running min.
            mag = torch.where(ix.valid[j], x.abs(), _BIG)
            sp = sp * torch.where(ix.valid[j], _sgn(x), 1.0)
            new_min = torch.minimum(mag, m1)
            m2 = torch.minimum(torch.maximum(mag, m1), m2)
            m1 = new_min
        for j in range(ix.e_idx.shape[0]):
            x = bel[:, ix.v_idx[j]] - c2v[:, ix.e_idx[j]]
            mag = x.abs()
            loo = torch.where(mag > m1, m1, m2)
            loo = torch.where(loo < _BIG, loo, 0.0)
            out = alpha * sp * _sgn(x) * loo
            c2v[:, ix.e_valid[j]] = out[:, ix.vpos[j]]
    else:
        phi_sum = torch.zeros((B, RZ), dtype=torch.float32, device=bel.device)
        for j in range(ix.e_idx.shape[0]):
            x = bel[:, ix.v_idx[j]] - c2v[:, ix.e_idx[j]]
            ph = _phi(torch.clamp(x.abs(), 1e-7, 20.0))
            # Padding slots add 0 after the row's members: the sum is unchanged.
            phi_sum = phi_sum + torch.where(ix.valid[j], ph, 0.0)
            sp = sp * torch.where(ix.valid[j], _sgn(x), 1.0)
        for j in range(ix.e_idx.shape[0]):
            x = bel[:, ix.v_idx[j]] - c2v[:, ix.e_idx[j]]
            ph = _phi(torch.clamp(x.abs(), 1e-7, 20.0))
            loo = torch.clamp(phi_sum - ph, min=1e-7)
            out = sp * _sgn(x) * _phi(loo)
            c2v[:, ix.e_valid[j]] = out[:, ix.vpos[j]]


def _layered_row(bel, c2v, row, Z: int, alpha: float, sumproduct: bool):
    """One base row of the layered schedule, in place on bel and c2v."""
    d, e_r, v_r = row
    B = bel.shape[0]
    X = (bel[:, v_r] - c2v[:, e_r]).reshape(B, d, Z)
    sp = torch.ones((B, Z), dtype=torch.float32, device=bel.device)
    if not sumproduct:
        m1 = torch.full((B, Z), _BIG, dtype=torch.float32, device=bel.device)
        m2 = m1.clone()
        for i in range(d):
            x = X[:, i]
            mag = x.abs()
            sp = sp * _sgn(x)
            new_min = torch.minimum(mag, m1)
            m2 = torch.minimum(torch.maximum(mag, m1), m2)
            m1 = new_min
        mag = X.abs()
        loo = torch.where(mag > m1[:, None], m1[:, None], m2[:, None])
        loo = torch.where(loo < _BIG, loo, 0.0)
        out = alpha * sp[:, None] * _sgn(X) * loo
    else:
        phi_sum = torch.zeros((B, Z), dtype=torch.float32, device=bel.device)
        PH = _phi(torch.clamp(X.abs(), 1e-7, 20.0))
        for i in range(d):
            phi_sum = phi_sum + PH[:, i]
            sp = sp * _sgn(X[:, i])
        loo = torch.clamp(phi_sum[:, None] - PH, min=1e-7)
        out = sp[:, None] * _sgn(X) * _phi(loo)
    out = out.reshape(B, d * Z)
    # A row's members sit in distinct columns, so these lanes are distinct.
    bel[:, v_r] = bel[:, v_r] + out - c2v[:, e_r]
    c2v[:, e_r] = out


def fused_decode_plain(llr: torch.Tensor, ix: _PlainIndex, st: _Structure,
                       max_iterations: int, alpha: float, mode: str,
                       track_convergence: bool, early_exit: bool, schedule: str):
    """Plain PyTorch version of both kernels: (B, n) -> (bits, conv_iter)."""
    B = llr.shape[0]
    Z, n, E = st.Z, st.C * st.Z, st.K * st.Z
    sumproduct = mode == "sumproduct"
    layered = schedule == "layered"
    dev = llr.device
    c2v = torch.zeros((B, E), dtype=torch.float32, device=dev)
    bel = llr.clone()
    frozen = torch.zeros((B, n), dtype=torch.float32, device=dev)
    conv = torch.zeros((B,), dtype=torch.int32, device=dev)
    for t in range(max_iterations):
        if layered:
            for row in ix.rows:
                _layered_row(bel, c2v, row, Z, alpha, sumproduct)
        else:
            _check_update_slots(bel, c2v, ix, alpha, sumproduct)
            colsum = torch.zeros((B, n), dtype=torch.float32, device=dev)
            for j in range(ix.c_idx.shape[0]):
                colsum = colsum + torch.where(ix.c_valid[j], c2v[:, ix.c_idx[j]], 0.0)
            bel = llr + colsum
        if track_convergence:
            hard = bel < 0
            parity = torch.zeros((B, ix.v_idx.shape[1]), dtype=torch.bool, device=dev)
            for j in range(ix.v_idx.shape[0]):
                parity = parity ^ (hard[:, ix.v_idx[j]] & ix.valid[j])
            newly = ~parity.any(dim=1) & (conv == 0)
            frozen = torch.where(newly[:, None], hard.to(torch.float32), frozen)
            conv = torch.where(newly, t + 1, conv).to(torch.int32)
            if early_exit and bool((conv > 0).all()):
                break
    converged = conv > 0
    bits = torch.where(converged[:, None], frozen, (bel < 0).to(torch.float32))
    conv_iter = torch.where(converged, conv, max_iterations).to(torch.int32)
    return bits, conv_iter


# ---------------------------------------------------------------------------
# Kernel launch
# ---------------------------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # llr, bits, conv, graph, B, Z, R, C, K, T, alpha,
    # sumproduct, layered, track, early_exit, frames_per_block, stream
    "ldpc_fused_minsum": ([_P, _P, _P, _P] + [_I] * 6 + [_F] + [_I] * 5 + [_P], _I),
    # llr, bits, conv, c2v_scratch, graph, B, Z, R, C, K, T, alpha,
    # sumproduct, layered, track, early_exit, grid, stream
    "ldpc_fused_zlane": ([_P] * 5 + [_I] * 6 + [_F] + [_I] * 5 + [_P], _I),
    "ldpc_fused_smem_bytes": ([_I] * 5, ctypes.c_longlong),
    "ldpc_zlane_smem_bytes": ([_I] * 4, ctypes.c_longlong),
    # Z, R, C, K, [frames_per_block,] sumproduct, layered -> blocks per SM
    "ldpc_fused_occupancy": ([_I] * 7, _I),
    "ldpc_zlane_occupancy": ([_I] * 6, _I),
    "ldpc_cuda_error_string": ([_I], ctypes.c_char_p),
}


def kernel_library():
    """The compiled ``csrc/fused_minsum.cu``, built on first use."""
    from ldpc_tpu_torch.ops import _build

    return _build.load("fused_minsum", _SIGNATURES)


def _check_llr(llr: torch.Tensor, device: torch.device, n: int) -> None:
    """The input checks every fused decoder makes before it decodes."""
    if llr.device.type != device.type:
        raise ValueError(f"decoder was built for {device}, llr is on {llr.device}")
    if llr.dtype != torch.float32:
        raise TypeError(f"llr must be float32, got {llr.dtype}")
    if llr.ndim != 2 or llr.shape[1] != n:
        raise ValueError(f"llr must be (B, {n}), got {tuple(llr.shape)}")


def _resident_grid(per_sm: int, name: str, device: torch.device) -> int:
    """Blocks that can be resident on the whole card at once, from a
    kernel's occupancy query (blocks per SM, or -cudaError_t)."""
    if per_sm < 1:
        raise RuntimeError(f"{name} kernel cannot be resident (occupancy query gave {per_sm})")
    return per_sm * torch.cuda.get_device_properties(device).multi_processor_count


def _check_rc(lib, rc: int, name: str) -> None:
    if rc != 0:
        msg = lib.ldpc_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} ({msg})")


class FusedDecoder:
    """``decode(llr) -> (bits (B, n) f32, conv_iter (B,) int32)``.

    Launches the ``kind`` kernel for CUDA tensors and runs the plain version
    for CPU tensors; ``plain(llr)`` runs the plain version on any device.
    """

    def __init__(self, kind: str, qc: QCLayout, max_iterations: int, alpha: float,
                 batch_tile: int, mode: str, track_convergence: bool, early_exit: bool,
                 schedule: str, device: torch.device):
        self.kind = kind
        self.st = _structure(qc)
        self.n = self.st.C * self.st.Z
        self.max_iterations = int(max_iterations)
        self.alpha = float(alpha)
        self.batch_tile = batch_tile
        self.mode = mode
        self.track_convergence = bool(track_convergence)
        self.early_exit = bool(early_exit)
        self.schedule = schedule
        self.device = device
        self.graph = torch.as_tensor(_graph_array(self.st), device=device)
        self._plain_index: dict[torch.device, _PlainIndex] = {}

    def __call__(self, llr: torch.Tensor):
        _check_llr(llr, self.device, self.n)
        if llr.device.type == "cuda":
            return self._launch(llr)
        return self.plain(llr)

    def plain(self, llr: torch.Tensor):
        _check_llr(llr, self.device, self.n)
        ix = self._plain_index.get(llr.device)
        if ix is None:
            ix = self._plain_index[llr.device] = _PlainIndex(self.st, llr.device)
        return fused_decode_plain(llr, ix, self.st, self.max_iterations, self.alpha,
                                  self.mode, self.track_convergence, self.early_exit,
                                  self.schedule)

    def _launch(self, llr: torch.Tensor):
        if not llr.is_contiguous():
            raise ValueError("llr must be contiguous")
        st = self.st
        B = llr.shape[0]
        bits = torch.empty_like(llr)
        conv = torch.empty((B,), dtype=torch.int32, device=llr.device)
        if B == 0:
            return bits, conv
        graph = self.graph if self.graph.device == llr.device else self.graph.to(llr.device)
        lib = kernel_library()
        flags = (int(self.mode == "sumproduct"), int(self.schedule == "layered"),
                 int(self.track_convergence), int(self.early_exit))
        with torch.cuda.device(llr.device):
            stream = torch.cuda.current_stream(llr.device).cuda_stream
            if self.kind == "fused":
                rc = lib.ldpc_fused_minsum(
                    llr.data_ptr(), bits.data_ptr(), conv.data_ptr(), graph.data_ptr(),
                    B, st.Z, st.R, st.C, st.K, self.max_iterations, self.alpha,
                    *flags, self.batch_tile, stream)
            else:
                grid = min(B, self.batch_tile or
                           2 * torch.cuda.get_device_properties(llr.device).multi_processor_count)
                scratch = torch.empty((grid * st.K * st.Z,), dtype=torch.float32,
                                      device=llr.device)
                rc = lib.ldpc_fused_zlane(
                    llr.data_ptr(), bits.data_ptr(), conv.data_ptr(), scratch.data_ptr(),
                    graph.data_ptr(), B, st.Z, st.R, st.C, st.K, self.max_iterations,
                    self.alpha, *flags, grid, stream)
        _check_rc(lib, rc, self.kind)
        LAUNCHES[self.kind] += 1
        return bits, conv


def _check_flags(mode: str, schedule: str, track_convergence: bool, early_exit: bool):
    if early_exit and not track_convergence:
        raise ValueError("early_exit requires track_convergence=True")
    if mode not in ("minsum", "sumproduct"):
        raise ValueError(f"unknown mode {mode!r}")
    if schedule not in ("flooding", "layered"):
        raise ValueError(f"unknown schedule {schedule!r}")


def make_fused_minsum(
    qc: QCLayout,
    max_iterations: int = 20,
    alpha: float = 0.75,
    batch_tile: int | None = None,
    mode: str = "minsum",
    track_convergence: bool = True,
    early_exit: bool = False,
    schedule: str = "flooding",
    device="cuda",
) -> FusedDecoder:
    """Build the fused decoder: (B, n) LLRs -> (bits (B, n), conv_iter (B,)).

    ``batch_tile`` frames decode per thread block with all state in shared
    memory (default: :func:`pick_fused_batch_tile`).  ``mode``: "minsum"
    (scaled, uses alpha) or "sumproduct" (BP).  ``track_convergence=False``
    skips the per-iteration syndrome/freeze pass (throughput mode: conv_iter
    returns max_iterations everywhere, bits are the final-iteration
    decisions).  ``early_exit=True`` (requires tracking) stops each block's
    iteration loop once all its frames have valid syndromes, with the same
    outputs.  ``schedule``: "flooding" or "layered" (each base row's new c2v
    folds into the beliefs at once).  The JAX builder's ``interpret`` flag has
    no counterpart: a CPU tensor runs the plain version.
    """
    _check_flags(mode, schedule, track_convergence, early_exit)
    Z = qc.Z
    bt = batch_tile or pick_fused_batch_tile(qc)
    if not bt or not fused_kernel_fits(qc, bt):
        need = fused_smem_bytes(qc, max(bt, 1))
        raise ValueError(
            f"fused kernel state ({need / 1024:.1f} KiB at batch_tile={max(bt, 1)}) "
            f"exceeds the {_SMEM_BUDGET / 1024:.0f} KiB of shared memory one block "
            f"can use for Z={Z}; use make_fused_minsum_zlane (backend='fused_zlane') "
            f"for large lifting factors"
        )
    if bt > _MAX_FRAMES_PER_BLOCK:
        raise ValueError(f"batch_tile must be <= {_MAX_FRAMES_PER_BLOCK}, got {bt}")
    return FusedDecoder("fused", qc, max_iterations, alpha, bt, mode, track_convergence,
                        early_exit, schedule, resolve_device(device))


def make_fused_minsum_zlane(
    qc: QCLayout,
    max_iterations: int = 20,
    alpha: float = 0.75,
    batch_tile: int | None = None,
    mode: str = "minsum",
    track_convergence: bool = True,
    early_exit: bool = False,
    schedule: str = "flooding",
    device="cuda",
) -> FusedDecoder:
    """Large-Z fused decoder: (B, n) LLRs -> (bits, conv_iter).

    Same semantics as :func:`make_fused_minsum`, for Z where one frame's state
    exceeds a block's shared memory.  ``batch_tile`` is the number of frames
    in flight, one per thread block, each with K*Z*4 bytes of global c2v
    scratch (default: two blocks per streaming multiprocessor).  Requires
    Z % 8 == 0, as the JAX builder does.
    """
    _check_flags(mode, schedule, track_convergence, early_exit)
    Z = qc.Z
    if Z % 8:
        raise ValueError(f"zlane kernel requires Z % 8 == 0, got Z={Z}")
    if not zlane_kernel_fits(qc):
        raise ValueError(
            f"zlane kernel state ({zlane_smem_bytes(qc) / 1024:.1f} KiB) exceeds the "
            f"{_SMEM_BUDGET / 1024:.0f} KiB of shared memory one block can use at Z={Z}"
        )
    if batch_tile is not None and batch_tile < 1:
        raise ValueError(f"batch_tile must be >= 1, got {batch_tile}")
    return FusedDecoder("fused_zlane", qc, max_iterations, alpha, batch_tile, mode,
                        track_convergence, early_exit, schedule, resolve_device(device))


def make_fused_bp(
    qc: QCLayout,
    max_iterations: int = 50,
    batch_tile: int | None = None,
    device="cuda",
) -> FusedDecoder:
    """Fused sum-product (belief propagation) decoder — see make_fused_minsum."""
    return make_fused_minsum(qc, max_iterations, alpha=1.0, batch_tile=batch_tile,
                             mode="sumproduct", device=device)
