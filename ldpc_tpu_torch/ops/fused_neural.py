"""Fused inference decoder for trained neural min-sum decoders: the whole
decode in one CUDA kernel (counterpart of ``ldpc_tpu.ops.pallas_neural``).

Hand-written kernels in ``csrc/fused_neural.cu`` (and ``neural_group``'s
64-bit and 128-bit words in ``csrc/fused_neural_wide.cu`` and
``csrc/fused_neural_w128.cu``, from ``csrc/neural_group.cuh``) replace
``pallas_neural.kernel``: the min-sum loop of
:mod:`ldpc_tpu_torch.ops.fused_minsum` with a trained model's per-iteration
alpha and offset, per-edge channel weights and residual taps on a FIFO of
past messages applied.  ``neural_group`` (a frame on a group of warps,
compressed check state, v2c rebuilt in the check pass) takes every code
with rows of at most 121 members at any depth (:func:`neural_group_fits`),
on the state word that holds a row's signs (:func:`neural_group_word_bits`:
32 bits for rows of up to 27 members, route ``neural_group``; 64 for 28 to
58, ``neural_group_wide``; 128 for 59 to 121, ``neural_group_w128``), with
forms of their own for depth 0 to 4 and one form of run-time depth for
deeper FIFOs, in one of three layouts (:data:`SLICE_LAYOUTS`,
:func:`neural_group_layout`) chosen by measurement (``chip_smoke.py``
nms_large): the whole frame in shared memory wherever it fits (the slice
forms ran 19-30% slower at NR BG2 Z=32 depth 4); else its FIFO in a slice
of global scratch that stays in L2, its check state and column sums in
shared memory (form 1: NR BG2 Z=128, 201,728 B of FIFO a frame at depth 2);
else its state words in the slice too (form 2: Z=384, whose A and column
sums alone take 208,896 B).  Its only depth limit is that of its 32-bit
FIFO offsets, (depth + 1) K*Z < 2^30 words.  ``fused_neural`` takes the
rest: rows over 121 members.
They serve a :class:`ldpc_tpu_torch.models.neural_min_sum.NeuralMinSumDecoder`
with ``output_mode="sum_plus_input"``: input (B, n) float32 LLRs, output
(B, n) float32 hard bits of ``llr + colsum(c2v)`` after ``num_iterations``
check halves.

:func:`make_fused_neural_minsum` returns a :class:`FusedNeuralDecoder`.
Called on a CUDA tensor it launches its route's kernel (and raises if the
launch fails); called on a CPU tensor it runs the plain PyTorch version,
which repeats the kernels' float operations in the same order, so all
give identical bits.  ``plain(llr)`` runs the plain version on any
device.  ``LAUNCHES`` counts kernel launches by route (each
``neural_group`` route counts every layout and depth of its word).
"""
from __future__ import annotations

import ctypes
from collections.abc import Mapping

import numpy as np
import torch

from ldpc_tpu_torch._device import resolve_device
from ldpc_tpu_torch.codes.edge_layout import QCLayout
from ldpc_tpu_torch.ops.fused_minsum import (_MAX_FRAMES_PER_BLOCK, _RETIRE_MAX_GROUPS,
                                             _RETIRE_MAX_THREADS, _SMEM_BUDGET, _WORD_SUFFIX,
                                             WORD_BITS, _check_llr, _graph_array, _graph_words,
                                             _max_degree, _PlainIndex, _resident_grid,
                                             _retire_structure, _retire_structure_words,
                                             _sgn, _state_words, _structure, retire_threads)
from ldpc_tpu_torch.ops.qc_msg import _BIG

# neural_group's route on each state word (neural_group_word_bits), and the
# source (library) that builds its kernels.
GROUP_ROUTES = {bits: "neural_group" + _WORD_SUFFIX.get(bits, "") for bits in WORD_BITS}
GROUP_STEMS = {bits: "fused_neural" + _WORD_SUFFIX.get(bits, "") for bits in WORD_BITS}
LAUNCHES: dict[str, int] = {"fused_neural": 0, **{r: 0 for r in GROUP_ROUTES.values()}}

_THREADS = 512  # kThreads in csrc/fused_neural.cu
# kMaxDepth: the deepest FIFO with neural_group forms of its own; deeper ones
# run on its run-time-depth form.
_GROUP_STATIC_DEPTH = 4
# A FIFO's offsets are 32-bit: (depth + 1) K*Z words stay below 2^30
# (valid_group_plan).
_GROUP_MAX_FIFO_WORDS = 1 << 30
# Warps a group of the default plan has at most where its SM holds others:
# at nms_main (NR BG2 Z=32, depth 2, two groups an SM) 14 parts run 2-5%
# faster than 16 (PERF.md, chip_smoke.py's parts sweep).
_GROUP_PLAN_WARPS = 14


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


def _plane_words(qc: QCLayout) -> int:
    """Words of one iteration's check-aligned channel weights (K*Z floats),
    rounded up to 16 bytes (plane_words in csrc/fused_neural.cu)."""
    return -(-qc.num_base_edges * qc.Z // 4) * 4


# neural_group's layouts (``slice``): 0 keeps a whole frame in shared memory;
# the slice forms keep its FIFO (1), or its FIFO and its state words (2), in
# its slice of a global scratch.
SLICE_LAYOUTS = (0, 1, 2)


def neural_group_word_bits(qc: QCLayout) -> int | None:
    """The state word ``neural_group`` decodes the code on: the narrowest of
    :data:`WORD_BITS` that holds the signs of its widest row (27, 58 or 121
    members), or None."""
    return next((bits for bits in WORD_BITS if qc.dr_max <= _max_degree(bits)), None)


def _word(qc: QCLayout) -> int:
    bits = neural_group_word_bits(qc)
    if bits is None:
        raise ValueError(f"neural_group has no state word for rows of {qc.dr_max} members")
    return bits


def neural_group_frame_bytes(qc: QCLayout, depth_L: int, slice: int = 0) -> int:
    """Shared memory of one ``neural_group`` frame, rounded up to 16 bytes:
    its LLRs and column sums (C*Z float32 each), its compressed check state
    (A and W: 3, 4 or 6 words per lifted check on the code's 32-, 64- or
    128-bit state word) and its FIFO (``depth_L`` floats per lifted edge);
    in a slice form only its A, column sums (padded to an even count on the
    wider words, so that W after them is 8-byte aligned) and, in form 1,
    its W, the rest being in its slice (:func:`neural_group_scratch_bytes`)."""
    Z, R, C, K = qc.Z, qc.num_base_rows, qc.num_base_cols, qc.num_base_edges
    bits = _word(qc)
    state = _state_words(bits)
    cs = C * Z + (C * Z) % 2 if bits > 32 else C * Z
    words = {0: 2 * C * Z + state * R * Z + depth_L * K * Z,
             1: 2 * R * Z + cs + (state - 2) * R * Z, 2: 2 * R * Z + cs}[slice]
    return 4 * -(-words // 4) * 4


def neural_group_scratch_bytes(qc: QCLayout, depth_L: int, slice: int = 2) -> int:
    """One frame's slice of a slice form's global scratch, rounded up to 16
    bytes: its state words (R*Z words of the code's state word; form 2) and
    its FIFO (``depth_L`` planes of K*Z float32)."""
    Z, R, K = qc.Z, qc.num_base_rows, qc.num_base_edges
    w_words = (_state_words(_word(qc)) - 2) * R * Z if slice == 2 else 0
    return 4 * -(-(w_words + depth_L * K * Z) // 4) * 4


def frames_per_group(qc: QCLayout) -> int:
    """Frames a ``neural_group`` frame group decodes side by side: 32 / Z
    where Z <= 16 (a warp's lanes hold several frames), else one."""
    return 32 // qc.Z if qc.Z <= 16 else 1


def neural_group_smem_bytes(qc: QCLayout, depth_L: int, parts: int = 1, groups: int = 1,
                            staged: bool = False, slice: int = 0) -> int:
    """Dynamic shared memory of one ``neural_group`` block: the structure of
    ``parts`` parts, two weight planes if ``staged``, and ``groups`` frame
    groups of :func:`frames_per_group` frames in layout ``slice``."""
    if staged and slice:
        raise ValueError("the slice form reads its weights from L2 (staged=False)")
    return (4 * _retire_structure_words(qc, parts) + (8 * _plane_words(qc) if staged else 0)
            + groups * frames_per_group(qc) * neural_group_frame_bytes(qc, depth_L, slice))


def neural_group_plans(qc: QCLayout, depth_L: int, staged: bool = False,
                       slice: int = 0) -> list[tuple[int, int]]:
    """The (parts, frame groups per block) a ``neural_group`` launch may
    take in the layout asked for, on the code's state word: at most 15
    groups and 1024 threads a block, parts no more than the base rows or
    columns, within shared memory.  No plan is both staged and in a slice
    form; none where no word holds the code's rows."""
    if (staged and slice) or neural_group_word_bits(qc) is None:
        return []
    most = min(qc.num_base_rows, qc.num_base_cols)
    return [(p, f) for p in range(1, most + 1) for f in range(1, _RETIRE_MAX_GROUPS + 1)
            if retire_threads(qc, p, f) <= _RETIRE_MAX_THREADS
            and neural_group_smem_bytes(qc, depth_L, p, f, staged, slice) <= _SMEM_BUDGET]


def neural_group_fits(qc: QCLayout, depth_L: int) -> bool:
    """Whether ``neural_group`` takes the code: rows of at most 121 members
    (the signs its widest state word holds), a depth >= 0 whose FIFO offsets
    stay 32-bit ((depth + 1) K*Z < 2^30 words), and a plan in some layout
    (:data:`SLICE_LAYOUTS`; the slice forms keep the FIFO out of shared
    memory, so every such depth has one wherever a frame's check state
    fits)."""
    return (neural_group_word_bits(qc) is not None and depth_L >= 0
            and (depth_L + 1) * qc.num_base_edges * qc.Z < _GROUP_MAX_FIFO_WORDS
            and neural_group_layout(qc, depth_L) is not None)


def neural_group_route(qc: QCLayout, depth_L: int) -> str:
    """The route of the code and depth: ``neural_group``, ``neural_group_wide``
    or ``neural_group_w128`` (:data:`GROUP_ROUTES`) where
    :func:`neural_group_fits`, else ``fused_neural``."""
    if not neural_group_fits(qc, depth_L):
        return "fused_neural"
    return GROUP_ROUTES[neural_group_word_bits(qc)]


def neural_group_layout(qc: QCLayout, depth_L: int) -> int | None:
    """The layout ``neural_group`` decodes the code in: the first of
    :data:`SLICE_LAYOUTS` with a plan (a whole frame in shared memory where
    it fits, else the FIFO in the slices, else the FIFO and the state
    words), or None."""
    return next((s for s in SLICE_LAYOUTS if neural_group_plans(qc, depth_L, slice=s)), None)


def neural_group_plan(qc: QCLayout, depth_L: int, staged: bool, parts: int | None = None,
                      lib=None, slice: int = 0, sms: int | None = None,
                      l2_bytes: int | None = None) -> tuple[int, int, int]:
    """(parts, frame groups per block, resident blocks per SM) of
    ``neural_group`` in layout ``slice``: of :func:`neural_group_plans` (those
    with ``parts`` if given), the most resident frame groups an SM by the
    runtime's occupancy query whose slices in flight on ``sms`` SMs fit the
    ``l2_bytes`` of L2 (one group an SM always does; the current card's
    counts by default), then the most parts, then the fewest groups a block.
    Unless ``parts`` is given, a group has more than 14 warps only where it
    is its SM's only one.  Measured (PERF.md, chip_smoke.py nms_main and
    nms_large): at two groups an SM 14 parts ran 2-5% faster than 16 at Z=32;
    alone, the most warps ran fastest (32 at Z=32 depth 4, 8 parts of 4
    warps at Z=128, 2 of 12 at Z=384), and at Z=128 two groups an SM, 53 MB
    of slices, ran 27-31% slower than one."""
    word_bits = neural_group_word_bits(qc)
    lib = lib or kernel_library(word_bits)
    if sms is None or l2_bytes is None:
        props = torch.cuda.get_device_properties(torch.cuda.current_device())
        sms, l2_bytes = props.multi_processor_count, props.L2_cache_size
    dims = (qc.Z, qc.num_base_rows, qc.num_base_cols, qc.num_base_edges, depth_L)
    zw = -(-qc.Z // 32)
    group_slices = neural_group_scratch_bytes(qc, depth_L, slice) * frames_per_group(qc) \
        if slice else 0
    best, key = (0, 0, 0), None
    for p, f in neural_group_plans(qc, depth_L, staged, slice):
        if parts is not None and p != parts:
            continue
        per_sm = lib.ldpc_neural_group_occupancy(*dims, p, f, int(staged), int(slice), word_bits)
        groups = per_sm * f
        if parts is None and p * zw > _GROUP_PLAN_WARPS and groups > 1:
            continue
        fits = groups <= 1 or groups * sms * group_slices <= l2_bytes
        if per_sm > 0 and (key is None or (fits, groups, p, -f) > key):
            best, key = (p, f, per_sm), (fits, groups, p, -f)
    return best


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
        # neural_group's weights, check-aligned: the edge at row-order
        # position i (member j of row r) and check lane z is i*Z + z, the
        # var-aligned k*Z + (z + shift[k]) mod Z; each plane padded to 16 bytes.
        st = _structure(qc)
        z = np.arange(Z)
        perm = np.concatenate([k * Z + (z + st.shifts[k]) % Z
                               for members in st.row_members for k in members])
        wc = np.zeros((w.shape[0], _plane_words(qc)), np.float32)
        wc[:, :K * Z] = w.reshape(w.shape[0], K * Z)[:, perm]
        self.wc = torch.from_numpy(wc).to(device)
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
                        tables: _Tables, T: int, depth_L: int,
                        record: list | None = None) -> torch.Tensor:
    """Plain PyTorch version of the kernels: (B, n) -> (B, n) hard bits.

    ``edge_var`` (K*Z,) is each lifted edge's variable.  Slot 0 of the FIFO
    is q, as in the TPU kernel.  ``record``, if given, receives a copy of
    c2v (B, K*Z, var-aligned) after every check half."""
    B, E = llr.shape[0], edge_var.shape[0]
    llr_e = llr[:, edge_var]
    c2v = torch.zeros((B, E), dtype=torch.float32, device=llr.device)
    slots = [llr_e.clone()] + [torch.zeros_like(c2v) for _ in range(max(depth_L, 1) - 1)]
    w = tables.w.to(llr.device)
    for t in range(T):
        _check_half(slots[0], c2v, ix, tables.alpha[t], tables.offset[t])
        if record is not None:
            record.append(c2v.clone())
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
# The C entries of neural_group.cuh, in each word's library.
_GROUP_SIGNATURES = {
    # llr, bits, structure, w, params, scratch, B, Z, R, C, K, T, L,
    # per_iteration, parts, groups, staged, slice, grid, word_bits, stream
    "ldpc_neural_group": ([_P] * 6 + [_I] * 14 + [_P], _I),
    # Z, R, C, K, L, parts, groups, staged, slice, word_bits
    "ldpc_neural_group_smem_bytes": ([_I] * 10, ctypes.c_longlong),
    # Z, R, K, L, slice, word_bits -> words of one frame's slice
    "ldpc_neural_group_slice_words": ([_I] * 6, ctypes.c_longlong),
    # Z, R, C, K, L, parts, groups, staged, slice, word_bits -> blocks per SM
    "ldpc_neural_group_occupancy": ([_I] * 10, _I),
    "ldpc_neural_cuda_error_string": ([_I], ctypes.c_char_p),
}
# The 32-bit word's library also holds fused_neural's entries.
_SIGNATURES = {
    **_GROUP_SIGNATURES,
    # llr, bits, graph, w, params, scratch, B, Z, R, C, K, T, L, per_iteration,
    # fpb, shared, grid, stream
    "ldpc_neural_minsum": ([_P] * 6 + [_I] * 11 + [_P], _I),
    "ldpc_neural_smem_bytes": ([_I] * 8, ctypes.c_longlong),
    "ldpc_neural_scratch_floats": ([_I] * 3, ctypes.c_longlong),
    # Z, R, C, K, T, L, fpb, shared -> blocks per SM
    "ldpc_neural_occupancy": ([_I] * 8, _I),
}


def kernel_library(word_bits: int = 32):
    """The compiled source of ``neural_group`` on the state word of
    ``word_bits`` (:data:`GROUP_STEMS`: ``csrc/fused_neural.cu``, which also
    holds ``fused_neural``, for 32), built on first use."""
    from ldpc_tpu_torch.ops import _build

    return _build.load(GROUP_STEMS[word_bits], _SIGNATURES if word_bits == 32
                       else _GROUP_SIGNATURES)


class FusedNeuralDecoder:
    """``decode(llr) -> bits``: (B, n) float32 LLRs to (B, n) float32 hard bits.

    Launches the ``route`` kernel for CUDA tensors and runs the plain
    version for CPU tensors; ``plain(llr)`` runs the plain version on any
    device.  ``route`` is :func:`neural_group_route`'s: ``neural_group``,
    ``neural_group_wide`` or ``neural_group_w128`` by the code's state word
    (``word_bits``) where :func:`neural_group_fits` takes the code and
    depth, else ``fused_neural``; ``layout`` is ``neural_group``'s
    (:func:`neural_group_layout`), None on ``fused_neural``; ``run_time_depth``
    whether ``neural_group`` runs its form of run-time depth (depth over 4).
    """

    def __init__(self, qc: QCLayout, params, num_iterations: int, depth_L: int,
                 per_iteration: bool, device: torch.device):
        self.qc = qc
        self.st = _structure(qc)
        self.n = qc.num_vars
        self.num_iterations = int(num_iterations)
        self.depth_L = int(depth_L)
        self.per_iteration = bool(per_iteration)
        self.route = neural_group_route(qc, self.depth_L)
        self.word_bits = neural_group_word_bits(qc)
        self.layout = (neural_group_layout(qc, self.depth_L) if self.route != "fused_neural"
                       else None)
        self.run_time_depth = self.depth_L > _GROUP_STATIC_DEPTH
        self.shared, self.frames_per_block = neural_plan(qc, self.num_iterations, self.depth_L)
        self.tables = _Tables(qc, params, self.num_iterations, self.depth_L, self.per_iteration,
                              device)
        self.device = device
        self.graph = torch.as_tensor(_graph_array(self.st), device=device)
        z = np.arange(qc.Z)[None, :]
        self._edge_var = (qc.edge_col[:, None] * qc.Z + z).reshape(-1)
        self._plain_index: dict[torch.device, tuple] = {}
        self._grid: int | None = None
        # neural_group's launch plans (_plan) by (card, parts, staged,
        # layout, groups asked for).
        self._group_plans: dict[tuple, tuple] = {}

    def __call__(self, llr: torch.Tensor) -> torch.Tensor:
        _check_llr(llr, self.device, self.n)
        if llr.device.type != "cuda":
            return self.plain(llr)
        if not llr.is_contiguous():
            raise ValueError("llr must be contiguous")
        if self.route == "fused_neural":
            return self._launch_minsum(llr)
        return self._launch_group(llr)

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

    def _launch_group(self, llr: torch.Tensor, parts: int | None = None,
                      staged: bool | None = None, slice: int | None = None,
                      groups: int | None = None) -> torch.Tensor:
        """``neural_group`` on ``llr`` (contiguous, on a card) on the
        code's state word, on the plan of :meth:`_plan` with the same
        arguments; counted under the word's route (:data:`GROUP_ROUTES`)."""
        st, tb = self.st, self.tables
        B = llr.shape[0]
        bits = torch.empty_like(llr)
        if B == 0:
            return bits
        lib = kernel_library(self.word_bits)
        with torch.cuda.device(llr.device):
            p, f, stage, sliced, resident, structure = self._plan(llr.device, parts, staged,
                                                                  slice, groups)
            frames = f * frames_per_group(self.qc)
            grid = min(resident, -(-B // frames))
            scratch = None
            if sliced:
                words = grid * frames * neural_group_scratch_bytes(self.qc, self.depth_L,
                                                                   sliced) // 4
                scratch = torch.empty((max(words, 4),), dtype=torch.float32, device=llr.device)
            stream = torch.cuda.current_stream(llr.device).cuda_stream
            rc = lib.ldpc_neural_group(
                llr.data_ptr(), bits.data_ptr(), structure.data_ptr(), tb.wc.data_ptr(),
                tb.params.data_ptr(), None if scratch is None else scratch.data_ptr(), B, st.Z,
                st.R, st.C, st.K, self.num_iterations, self.depth_L, int(self.per_iteration), p, f,
                int(stage), int(sliced), grid, self.word_bits, stream)
        route = GROUP_ROUTES[self.word_bits]
        if rc != 0:
            msg = lib.ldpc_neural_cuda_error_string(rc).decode()
            raise RuntimeError(f"{route} kernel launch failed: CUDA error {rc} ({msg})")
        LAUNCHES[route] += 1
        return bits

    def _plan(self, device: torch.device, parts: int | None = None, staged: bool | None = None,
              slice: int | None = None, groups: int | None = None) -> tuple:
        """``neural_group``'s launch plan on ``device`` (a card): (parts,
        frame groups a block, staged, layout, resident blocks on the card,
        structure tensor).  ``parts`` fixes the parts a frame is split into,
        ``staged`` whether the weights are read from shared memory,
        ``slice`` the layout (:data:`SLICE_LAYOUTS`) and ``groups`` the frame
        groups a block, instead of the plan's choice (:attr:`layout`; staged
        where a plan with the two weight planes fits, since that ran 7%
        faster at nms_main; from L2 elsewhere)."""
        key = (device, parts, staged, slice, groups)
        plan = self._group_plans.get(key)
        if plan is None:
            sliced = self.layout if slice is None else slice
            if sliced is None:
                raise ValueError("neural_group does not take this code "
                                 f"(rows of {self.qc.dr_max} members, depth {self.depth_L})")
            lib = kernel_library(self.word_bits)
            with torch.cuda.device(device):
                stage = (not sliced) if staged is None else staged
                p, f, per_sm = self._group_plan(stage, parts, sliced, groups, lib)
                if staged is None and stage and not per_sm:
                    stage = False
                    p, f, per_sm = self._group_plan(False, parts, sliced, groups, lib)
                resident = _resident_grid(per_sm, "neural_group", device)
            structure = torch.as_tensor(_retire_structure(self.st, p, word_bits=self.word_bits),
                                        device=device)
            plan = self._group_plans[key] = (p, f, stage, sliced, resident, structure)
        return plan

    def _group_plan(self, staged: bool, parts: int | None, slice: int, groups: int | None,
                    lib) -> tuple[int, int, int]:
        """:func:`neural_group_plan`, or with ``groups`` the plan of that
        many groups a block (and ``parts``, else the most that fit)."""
        if groups is None:
            return neural_group_plan(self.qc, self.depth_L, staged, parts, lib, slice)
        dims = (self.qc.Z, self.qc.num_base_rows, self.qc.num_base_cols,
                self.qc.num_base_edges, self.depth_L)
        p = max((q for q, f in neural_group_plans(self.qc, self.depth_L, staged, slice)
                 if f == groups and (parts is None or q == parts)), default=0)
        if not p:
            raise ValueError(f"neural_group has no plan of {groups} groups a block"
                             f"{'' if parts is None else f' and {parts} parts'}")
        return p, groups, lib.ldpc_neural_group_occupancy(*dims, p, groups, int(staged),
                                                          int(slice), self.word_bits)

    def _launch_minsum(self, llr: torch.Tensor) -> torch.Tensor:
        """``fused_neural`` on ``llr`` (contiguous, on a card) whatever the
        route: the kernel codes ``neural_group`` does not take run on, and
        the one every code ran on before it, kept so the two can be timed
        side by side."""
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
