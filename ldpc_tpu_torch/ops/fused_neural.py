"""Fused inference decoder for trained neural min-sum decoders: the whole
decode in one CUDA kernel (counterpart of ``ldpc_tpu.ops.pallas_neural``).

One hand-written kernel lives in ``csrc/fused_neural.cu``: ``fused_neural``
(replaces ``pallas_neural.kernel``), the min-sum loop of
:mod:`ldpc_tpu_torch.ops.fused_minsum` with a trained model's per-iteration
alpha and offset, per-edge channel weights and residual taps on a FIFO of
past messages applied.  It serves a :class:`ldpc_tpu_torch.models.
neural_min_sum.NeuralMinSumDecoder` with ``output_mode="sum_plus_input"``:
input (B, n) float32 LLRs, output (B, n) float32 hard bits of
``llr + colsum(c2v)`` after ``num_iterations`` check halves.

:func:`make_fused_neural_minsum` returns a :class:`FusedNeuralDecoder`.
Called on a CUDA tensor it launches the kernel (and raises if the launch
fails); called on a CPU tensor it runs the kernel's plain PyTorch version,
which repeats the kernel's float operations in the same order, so the two
give identical bits.  ``plain(llr)`` runs the plain version on any device.
``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from collections.abc import Mapping

import numpy as np
import torch

from ldpc_tpu_torch._device import resolve_device
from ldpc_tpu_torch.codes.edge_layout import QCLayout
from ldpc_tpu_torch.ops.fused_minsum import (_MAX_FRAMES_PER_BLOCK, _SMEM_BUDGET, _check_llr,
                                             _graph_array, _graph_words, _PlainIndex,
                                             _resident_grid, _sgn, _structure)
from ldpc_tpu_torch.ops.qc_msg import _BIG

LAUNCHES: dict[str, int] = {"fused_neural": 0}

_THREADS = 512  # kThreads in csrc/fused_neural.cu


def _np_tree(params) -> Mapping:
    """Module, state_dict or flax tree -> mapping of numpy arrays by name."""
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    if not isinstance(params, Mapping):
        raise TypeError("params must be a NeuralMinSumDecoder, its state_dict or a flax tree")
    if "params" in params and isinstance(params["params"], Mapping):
        params = params["params"]
    return {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in params.items()}


def _pack_weights(qc: QCLayout, params, num_iterations: int, depth_L: int,
                  per_iteration: bool):
    """Trained parameters -> dense per-iteration arrays, as the JAX kernel
    packs them.

    Returns (w_cols (T_eff*Zp, K), w_res (T, max(L,1)), alpha (T,), offset (T,)),
    float32: ``w_cols[t*Zp + z, k]`` is iteration t's channel weight of
    lifted edge (k, z), Zp = Z rounded up to 8, T_eff = T with
    ``per_iteration`` and 1 without.
    """
    p = _np_tree(params)
    K, Z = qc.num_base_edges, qc.Z
    T = num_iterations

    def expand_edge(w):
        """One iteration's channel weights -> (K, Z)."""
        w = np.asarray(w, np.float32)
        if w.shape == (K, Z):
            return w
        if w.shape == (K,):
            return np.repeat(w[:, None], Z, axis=1)
        if w.ndim == 1:  # per shift type
            return np.repeat(w[qc.edge_type][:, None], Z, axis=1)
        if w.ndim == 0:
            return np.full((K, Z), float(w), np.float32)
        raise ValueError(f"unsupported w_ch shape {w.shape}")

    def per_t(name, default):
        x = np.asarray(p.get(name, default), np.float32)
        if per_iteration and x.ndim >= 1 and x.shape[0] == T:
            return [x[t] for t in range(T)]
        return [x] * T

    w_ch_t = per_t("w_ch", 1.0)
    w_res_t = per_t("w_res", np.zeros((depth_L,), np.float32))
    alpha_t = per_t("alpha", 1.0)
    offset_t = per_t("offset", 0.0)

    w_full = np.stack([expand_edge(w) for w in w_ch_t])  # (T, K, Z)
    Zp = ((Z + 7) // 8) * 8
    T_eff = T if per_iteration else 1
    w_cols = np.zeros((T_eff * Zp, K), np.float32)
    for t in range(T_eff):
        w_cols[t * Zp : t * Zp + Z] = w_full[t].T
    L = max(depth_L, 1)
    w_res = np.zeros((T, L), np.float32)
    for t in range(T):
        r = np.atleast_1d(w_res_t[t])
        w_res[t, : min(r.shape[0], L)] = r[:L]
    alpha = np.array([float(a) for a in alpha_t], np.float32)
    offset = np.array([float(o) for o in offset_t], np.float32)
    return w_cols, w_res, alpha, offset


# ---------------------------------------------------------------------------
# Shared-memory plan (mirrors smem_bytes in csrc/fused_neural.cu)
# ---------------------------------------------------------------------------


def _state_floats(qc: QCLayout, depth_L: int) -> int:
    """c2v, q and the FIFO slots after the first, float32, one frame."""
    return (1 + max(depth_L, 1)) * qc.num_base_edges * qc.Z


def neural_smem_bytes(qc: QCLayout, num_iterations: int, depth_L: int, frames: int,
                      shared: bool = True) -> int:
    """Dynamic shared memory of one block: structure, alpha/offset/taps and,
    per frame, its LLRs plus (``shared``) its state; without ``shared`` the
    state lives in global scratch and the block holds one frame's LLRs."""
    K, Z, C, R = qc.num_base_edges, qc.Z, qc.num_base_cols, qc.num_base_rows
    params = -(-num_iterations * (2 + max(depth_L, 1)) // 4) * 4
    per_frame = C * Z + (_state_floats(qc, depth_L) if shared else 0)
    return 4 * (_graph_words(R, C, K) + params + (frames if shared else 1) * per_frame)


def neural_plan(qc: QCLayout, num_iterations: int, depth_L: int) -> tuple[bool, int]:
    """(state in shared memory, frames per block): as many frames as keep the
    block's threads busy while they fit; else one frame at a time with its
    state in global scratch.  Raises if not even one frame's LLRs fit."""
    per_block = -(-_THREADS // (qc.num_base_rows * qc.Z))
    fpb = min(_MAX_FRAMES_PER_BLOCK, max(1, per_block))
    while fpb and neural_smem_bytes(qc, num_iterations, depth_L, fpb) > _SMEM_BUDGET:
        fpb -= 1
    if fpb:
        return True, fpb
    need = neural_smem_bytes(qc, num_iterations, depth_L, 1, shared=False)
    if need > _SMEM_BUDGET:
        raise ValueError(f"fused_neural kernel: one frame's LLRs and the structure "
                         f"({need / 1024:.1f} KiB) exceed the {_SMEM_BUDGET / 1024:.0f} KiB of "
                         f"shared memory one block can use (Z={qc.Z})")
    return False, 1


# ---------------------------------------------------------------------------
# Plain PyTorch version of the kernel
# ---------------------------------------------------------------------------


class _Tables:
    """What a launch and the plain version read, on one device: ``w``
    (T_eff, K*Z) channel weights, ``params`` alpha (T), offset (T), w_res
    (T, max(L, 1)) flat, and the host copies the plain version loops over."""

    def __init__(self, qc: QCLayout, params, T: int, depth_L: int, per_iteration: bool,
                 device: torch.device):
        w_cols, w_res, alpha, offset = _pack_weights(qc, params, T, depth_L, per_iteration)
        K, Z = qc.num_base_edges, qc.Z
        Zp = ((Z + 7) // 8) * 8
        w = w_cols.reshape(-1, Zp, K)[:, :Z, :].transpose(0, 2, 1)  # (T_eff, K, Z)
        self.w = torch.from_numpy(np.ascontiguousarray(w).reshape(w.shape[0], K * Z)).to(device)
        self.params = torch.from_numpy(
            np.concatenate([alpha, offset, w_res.reshape(-1)]).astype(np.float32)).to(device)
        self.alpha = [float(a) for a in alpha]
        self.offset = [float(o) for o in offset]
        self.w_res = w_res.tolist()


def _check_half(q: torch.Tensor, c2v: torch.Tensor, ix: _PlainIndex, alpha: float,
                offset: float) -> None:
    """Offset / scaled min-sum check update of every row from q, slot by
    slot, in place on c2v (the kernel's running m1/m2/sign product)."""
    B, RZ = q.shape[0], ix.e_idx.shape[1]
    sp = torch.ones((B, RZ), dtype=torch.float32, device=q.device)
    m1 = torch.full((B, RZ), _BIG, dtype=torch.float32, device=q.device)
    m2 = m1.clone()
    for j in range(ix.e_idx.shape[0]):
        x = q[:, ix.e_idx[j]]
        # Padding slots: sign +1, magnitude BIG -> no-op in the running min.
        mag = torch.where(ix.valid[j], x.abs(), _BIG)
        sp = sp * torch.where(ix.valid[j], _sgn(x), 1.0)
        new_min = torch.minimum(mag, m1)
        m2 = torch.minimum(torch.maximum(mag, m1), m2)
        m1 = new_min
    for j in range(ix.e_idx.shape[0]):
        x = q[:, ix.e_idx[j]]
        loo = torch.where(x.abs() > m1, m1, m2)
        loo = torch.where(loo < _BIG, loo, 0.0)
        loo = torch.clamp(loo - offset, min=0.0)
        out = alpha * sp * _sgn(x) * loo
        c2v[:, ix.e_valid[j]] = out[:, ix.vpos[j]]


def _column_sums(c2v: torch.Tensor, ix: _PlainIndex) -> torch.Tensor:
    """(B, K*Z) -> (B, n): sums in col_members order, from 0; pads add 0."""
    colsum = torch.zeros((c2v.shape[0], ix.c_idx.shape[1]), dtype=torch.float32,
                         device=c2v.device)
    for j in range(ix.c_idx.shape[0]):
        colsum = colsum + torch.where(ix.c_valid[j], c2v[:, ix.c_idx[j]], 0.0)
    return colsum


def neural_decode_plain(llr: torch.Tensor, ix: _PlainIndex, edge_var: torch.Tensor,
                        tables: _Tables, T: int, depth_L: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (B, n) -> (B, n) hard bits.

    ``edge_var`` (K*Z,) is each lifted edge's variable.  Slot 0 of the FIFO
    is q, as in the kernel."""
    B, E = llr.shape[0], edge_var.shape[0]
    llr_e = llr[:, edge_var]
    c2v = torch.zeros((B, E), dtype=torch.float32, device=llr.device)
    slots = [llr_e.clone()] + [torch.zeros_like(c2v) for _ in range(max(depth_L, 1) - 1)]
    w = tables.w.to(llr.device)
    for t in range(T):
        _check_half(slots[0], c2v, ix, tables.alpha[t], tables.offset[t])
        if t + 1 == T:
            break  # the last variable half feeds nothing
        live = 1.0 if t > 0 else 0.0
        cs = _column_sums(c2v, ix)[:, edge_var]
        res = torch.zeros_like(c2v)
        for l in range(depth_L):
            res = res + tables.w_res[t][l] * slots[l]
        q_new = ((cs - c2v) + w[t if w.shape[0] > 1 else 0] * llr_e) + live * res
        for l in range(len(slots) - 1, 0, -1):
            slots[l] = live * slots[l - 1]
        slots[0] = q_new
    return ((llr + _column_sums(c2v, ix)) < 0).to(torch.float32)


# ---------------------------------------------------------------------------
# Kernel launch
# ---------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # llr, bits, graph, w, params, scratch, B, Z, R, C, K, T, L, per_iteration,
    # fpb, shared, grid, stream
    "ldpc_neural_minsum": ([_P] * 6 + [_I] * 11 + [_P], _I),
    "ldpc_neural_smem_bytes": ([_I] * 8, ctypes.c_longlong),
    "ldpc_neural_scratch_floats": ([_I] * 3, ctypes.c_longlong),
    # Z, R, C, K, T, L, fpb, shared -> blocks per SM
    "ldpc_neural_occupancy": ([_I] * 8, _I),
    "ldpc_neural_cuda_error_string": ([_I], ctypes.c_char_p),
}


def kernel_library():
    """The compiled ``csrc/fused_neural.cu``, built on first use."""
    from ldpc_tpu_torch.ops import _build

    return _build.load("fused_neural", _SIGNATURES)


class FusedNeuralDecoder:
    """``decode(llr) -> bits``: (B, n) float32 LLRs to (B, n) float32 hard bits.

    Launches the kernel for CUDA tensors and runs the plain version for CPU
    tensors; ``plain(llr)`` runs the plain version on any device.
    """

    def __init__(self, qc: QCLayout, params, num_iterations: int, depth_L: int,
                 per_iteration: bool, device: torch.device):
        self.qc = qc
        self.st = _structure(qc)
        self.n = qc.num_vars
        self.num_iterations = int(num_iterations)
        self.depth_L = int(depth_L)
        self.per_iteration = bool(per_iteration)
        self.shared, self.frames_per_block = neural_plan(qc, self.num_iterations, self.depth_L)
        self.tables = _Tables(qc, params, self.num_iterations, self.depth_L, self.per_iteration,
                              device)
        self.device = device
        self.graph = torch.as_tensor(_graph_array(self.st), device=device)
        z = np.arange(qc.Z)[None, :]
        self._edge_var = (qc.edge_col[:, None] * qc.Z + z).reshape(-1)
        self._plain_index: dict[torch.device, tuple] = {}
        self._grid: int | None = None

    def __call__(self, llr: torch.Tensor) -> torch.Tensor:
        _check_llr(llr, self.device, self.n)
        if llr.device.type == "cuda":
            return self._launch(llr)
        return self.plain(llr)

    def plain(self, llr: torch.Tensor) -> torch.Tensor:
        _check_llr(llr, self.device, self.n)
        index = self._plain_index.get(llr.device)
        if index is None:
            index = self._plain_index[llr.device] = (
                _PlainIndex(self.st, llr.device),
                torch.as_tensor(self._edge_var, device=llr.device))
        with torch.no_grad():
            return neural_decode_plain(llr, *index, self.tables, self.num_iterations,
                                       self.depth_L)

    def _launch(self, llr: torch.Tensor) -> torch.Tensor:
        if not llr.is_contiguous():
            raise ValueError("llr must be contiguous")
        st, tb = self.st, self.tables
        B = llr.shape[0]
        bits = torch.empty_like(llr)
        if B == 0:
            return bits
        lib = kernel_library()
        dims = (st.Z, st.R, st.C, st.K, self.num_iterations, self.depth_L)
        with torch.cuda.device(llr.device):
            grid, scratch = 0, None
            if not self.shared:
                if self._grid is None:
                    self._grid = _resident_grid(lib.ldpc_neural_occupancy(*dims, 1, 0),
                                                "fused_neural", llr.device)
                grid = min(B, self._grid)
                scratch = torch.empty((grid * _state_floats(self.qc, self.depth_L),),
                                      dtype=torch.float32, device=llr.device)
            stream = torch.cuda.current_stream(llr.device).cuda_stream
            rc = lib.ldpc_neural_minsum(
                llr.data_ptr(), bits.data_ptr(), self.graph.data_ptr(), tb.w.data_ptr(),
                tb.params.data_ptr(), None if scratch is None else scratch.data_ptr(), B, *dims,
                int(self.per_iteration), self.frames_per_block, int(self.shared), grid, stream)
        if rc != 0:
            msg = lib.ldpc_neural_cuda_error_string(rc).decode()
            raise RuntimeError(f"fused_neural kernel launch failed: CUDA error {rc} ({msg})")
        LAUNCHES["fused_neural"] += 1
        return bits


def make_fused_neural_minsum(
    qc: QCLayout,
    params,
    num_iterations: int = 5,
    depth_L: int = 2,
    batch_tile: int = 128,
    interpret: bool = False,
    per_iteration: bool = False,
    device="cuda",
) -> FusedNeuralDecoder:
    """Build the fused inference decoder of a trained NeuralMinSumDecoder:
    (B, n) LLRs -> (B, n) hard bits, with ``output_mode="sum_plus_input"``
    semantics.

    ``params``: the module, its ``state_dict`` or a flax parameter tree.
    ``num_iterations``, ``depth_L`` and ``per_iteration`` must match the
    model.  ``batch_tile`` and ``interpret`` are the JAX builder's and change
    nothing here: frames per block follow from shared memory
    (:func:`neural_plan`), and a CPU tensor runs the plain version.
    """
    del batch_tile, interpret
    if num_iterations < 1:
        raise ValueError(f"num_iterations must be >= 1, got {num_iterations}")
    if depth_L < 0:
        raise ValueError(f"depth_L must be >= 0, got {depth_L}")
    return FusedNeuralDecoder(qc, params, num_iterations, depth_L, per_iteration,
                              resolve_device(device))
