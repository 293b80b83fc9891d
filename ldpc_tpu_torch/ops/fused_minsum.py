"""Fused min-sum / BP decoders: the whole decode loop in one CUDA kernel
(counterpart of ``ldpc_tpu.ops.pallas_minsum``).

Hand-written kernels, each a route of its own, replace the two TPU kernels:

* ``fused_retire`` (``csrc/fused_retire.cu``, replaces
  ``pallas_minsum._kernel`` for scaled min-sum with the flooding schedule,
  the ``bench.py`` headline): a group of warps decodes a frame (ceil(Z / 32)
  warps span Z, times up to 4 parts that split its rows and columns), with
  the check state compressed to (alpha*m1, alpha*m2, argmin, signs) and the
  beliefs and LLRs in shared memory; the syndrome is folded into the next
  check pass, and a frame leaves the kernel the iteration it converges, its
  group taking the next frame from an atomic counter.
* ``retire_zlane`` (same file, replaces ``pallas_minsum._kernel_zlane`` for
  scaled min-sum with the flooding schedule, ``bench.py``'s z384 section):
  the same algorithm, one frame group a block, for Z where a whole frame
  exceeds shared memory: beliefs and (alpha*m1, alpha*m2) in shared memory,
  the argmin and sign words in the block's slice of a global scratch (L2),
  LLRs read from the input rows.  :func:`retire_zlane_fits` decides.
* ``retire_layered`` (same file, replaces ``pallas_minsum._kernel`` for
  scaled min-sum with the layered schedule): a warp per frame (times
  ceil(Z / 32)), whose lanes run one base row's Z checks and whose rows
  follow in order with only warp barriers; the same compressed check state
  and beliefs in shared memory (22,784 bytes a frame at NR BG2 Z=32), a
  parity pass over all checks after each sweep, and frames that leave the
  kernel the sweep they converge.  Rows of a row group (:func:`row_groups`:
  consecutive rows that share no column) may run side by side on more
  warps of the frame.  :func:`retire_layered_fits` decides.
* ``retire_sumproduct`` (same file, replaces ``pallas_minsum._kernel`` for
  sum-product with the flooding schedule, ``make_fused_bp`` and
  ``BeliefPropagationDecoder``): ``fused_retire``'s frame loop, with one
  float of c2v a lifted edge (check-aligned), each phi computed once and
  kept in registers, the syndrome folded into the next check pass and
  frames that leave the kernel the iteration they converge (31,872 bytes a
  frame at NR BG2 Z=32, the LLRs read from the input row, or staged in
  shared memory where the occupancy query prefers it).
  :func:`retire_sumproduct_fits` decides.
* ``retire_layered_sumproduct`` (same file, replaces ``pallas_minsum._kernel``
  for sum-product with the layered schedule): ``retire_layered``'s frame
  loop over a sum-product row update, one float of c2v a lifted edge
  (check-aligned) and each phi computed once and kept in registers, the
  beliefs and c2v in shared memory (31,872 bytes a frame at NR BG2 Z=32).
  :func:`retire_layered_sumproduct_fits` decides.
* ``fused_retire_wide``, ``retire_layered_wide``, ``retire_sumproduct_wide``
  and ``retire_layered_sumproduct_wide`` (same file, replace
  ``pallas_minsum._kernel`` on codes with rows of 28 to 58 members): the
  four kernels above on a 64-bit state word (58 output signs and a 6-bit
  argmin; 16 bytes a check's compressed min-sum state, where the 32-bit
  word's 27 signs make 12), the sum-product ones with 64-bit sign masks.
  The ``fits`` functions with ``word_bits=64`` decide.
* ``fused_retire_w128``, ``retire_layered_w128``, ``retire_sumproduct_w128``
  and ``retire_layered_sumproduct_w128`` (same file, replace
  ``pallas_minsum._kernel`` on codes with rows of 59 to 121 members, such
  as array LDPC codes): the same four kernels on a 128-bit state word of
  two 64-bit limbs (121 output signs and a 7-bit argmin; 24 bytes a check's
  compressed min-sum state), the sum-product ones with 128-bit sign masks.
  The ``fits`` functions with ``word_bits=128`` decide.
* ``fused`` (``csrc/fused_minsum.cu``, replaces ``pallas_minsum._kernel``
  on codes that the retiring kernels do not take, those with rows of more
  than 121 members): a few frames per thread block, with all decode state
  (c2v, beliefs, channel LLRs) in shared memory.  Fits while one frame's
  state is below the block's shared memory (Z=32 on NR BG2: about 42 KB a
  frame); ``fused_kernel_fits`` decides.
* ``retire_zlane_layered``, ``retire_zlane_sumproduct`` and
  ``retire_zlane_layered_sumproduct`` (same file, replace
  ``pallas_minsum._kernel_zlane`` for layered min-sum, sum-product flooding
  and layered sum-product at large Z): ``retire_layered``'s,
  ``retire_sumproduct``'s and ``retire_layered_sumproduct``'s algorithms
  with the state split as ``retire_zlane`` splits it: the beliefs in shared
  memory, the check state in an L2 slice (layered min-sum: (alpha*m1,
  alpha*m2) and the state words, a frame group's; sum-product flooding: c2v
  (K*Z floats), the block's, one block an SM; layered sum-product: c2v, a
  frame group's, as many frame groups an SM as the occupancy query allows).
  :func:`retire_zlane_layered_fits`, :func:`retire_zlane_sumproduct_fits`
  and :func:`retire_zlane_layered_sumproduct_fits` decide.
* ``retire_zlane_wide``, ``retire_zlane_layered_wide``,
  ``retire_zlane_sumproduct_wide``, ``retire_zlane_layered_sumproduct_wide``
  and the same four with ``_w128`` (same file, replace
  ``pallas_minsum._kernel_zlane`` at large Z on codes with rows of 28 to 58
  and of 59 to 121 members): the four large-Z kernels on the 64-bit and
  128-bit state words, whose slices grow with the word (retire_zlane: 8 or
  16 bytes a check; retire_zlane_layered: 16 or 24), the sum-product ones
  with wider sign masks.  The ``fits`` functions with ``word_bits`` decide.
* ``fused_zlane`` (``csrc/fused_minsum.cu``, replaces
  ``pallas_minsum._kernel_zlane`` for codes the retiring kernels do not
  take, rows of more than 121 members): the same semantics when a frame's
  state exceeds shared memory (the 5G maximum Z=384): c2v lives in a
  global scratch buffer, beliefs in shared memory, and each block walks
  over frames one at a time.

The builders take every flag the TPU kernels take: ``mode`` ("minsum" scaled by
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

The kernels compute the same function, so one plain version serves them all.
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
_RETIRE_MAX_THREADS = 1024  # kMaxThreads in csrc/fused_retire.cu
_RETIRE_MAX_GROUPS = 15  # kMaxGroups in csrc/fused_retire.cu: frames a block
# Members of a row the retiring kernels' state word holds signs of
# (kSignBits in csrc/retire.cuh): 27 with the 32-bit word, 58 with the
# 64-bit word of the wide routes (``*_wide``), which take rows of 28 to 58,
# and 121 with the 128-bit word of the ``*_w128`` routes, rows of 59 to 121.
_RETIRE_MAX_DEGREE = 27
_RETIRE_WIDE_MAX_DEGREE = 58
_RETIRE_WIDER_MAX_DEGREE = 121
# The state words' widths (the C entries' word_bits) and the suffix of the
# routes on each wider word.
WORD_BITS = (32, 64, 128)
_WORD_SUFFIX = {64: "_wide", 128: "_w128"}
_RETIRE_MAX_PARTS = 4  # parts a frame's rows and columns are split into
# retire_layered: frames a block when a frame is one warp (32 warps); more
# warps a frame take a named barrier each, so _RETIRE_MAX_GROUPS.
_LAYERED_MAX_FRAMES = 32
# retire_zlane_sumproduct: resident blocks an SM at most, each with a
# 4*K*Z-byte c2v slice (302,592 bytes at NR BG2 Z=384): one keeps 132
# slices (40 MB) within an H100's 50 MB L2, and a block of the most parts
# beat every two-block plan at NR BG2 Z=224-384 (tools/probe_zlane_blocks.py).
_ZLANE_SUMPRODUCT_BLOCKS_PER_SM = 1
# retire_layered_sumproduct and retire_zlane_layered_sumproduct are built for
# at most this many threads a block (kLayeredSumProductThreads), which leaves
# them 80 registers a thread.
_LAYERED_SUMPRODUCT_MAX_THREADS = 768

# The kernels of csrc/fused_retire.cu, each a route of its own; the layered
# ones read _layered_structure.  The four ``*_wide`` routes of each set are
# its kernels instantiated on the 64-bit state word, for rows of 28 to 58
# members, the four ``*_w128`` routes the same kernels on the 128-bit word,
# for rows of 59 to 121: B1's (``WIDE_ROUTES``, ``W128_ROUTES``) and the
# large-Z kernels' (``ZLANE_WIDE_ROUTES``, ``ZLANE_W128_ROUTES``).
_B1_ROUTES = ("fused_retire", "retire_layered", "retire_sumproduct", "retire_layered_sumproduct")
_ZLANE_ROUTES = ("retire_zlane", "retire_zlane_layered", "retire_zlane_sumproduct",
                 "retire_zlane_layered_sumproduct")
WIDE_ROUTES = tuple(route + "_wide" for route in _B1_ROUTES)
W128_ROUTES = tuple(route + "_w128" for route in _B1_ROUTES)
ZLANE_WIDE_ROUTES = tuple(route + "_wide" for route in _ZLANE_ROUTES)
ZLANE_W128_ROUTES = tuple(route + "_w128" for route in _ZLANE_ROUTES)
_WIDER_ROUTES = WIDE_ROUTES + W128_ROUTES + ZLANE_WIDE_ROUTES + ZLANE_W128_ROUTES
# A route on a wider word: (the kernel's own route, word_bits).
_ROUTE_WORD = {route + suffix: (route, bits) for route in _B1_ROUTES + _ZLANE_ROUTES
               for bits, suffix in _WORD_SUFFIX.items()}
RETIRING = ("fused_retire", "retire_zlane", "retire_layered", "retire_sumproduct",
            "retire_zlane_layered", "retire_zlane_sumproduct", "retire_layered_sumproduct",
            "retire_zlane_layered_sumproduct") + _WIDER_ROUTES
_LAYERED_ROUTES = tuple(route + suffix
                        for route in ("retire_layered", "retire_zlane_layered",
                                      "retire_layered_sumproduct",
                                      "retire_zlane_layered_sumproduct")
                        for suffix in ("", "_wide", "_w128"))
LAUNCHES: dict[str, int] = {"fused_retire": 0, "fused": 0, "retire_zlane": 0, "fused_zlane": 0,
                            "retire_layered": 0, "retire_sumproduct": 0,
                            "retire_zlane_layered": 0, "retire_zlane_sumproduct": 0,
                            "retire_layered_sumproduct": 0, "retire_zlane_layered_sumproduct": 0,
                            **{route: 0 for route in _WIDER_ROUTES}}


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


def _retire_structure_words(qc: QCLayout, parts: int) -> int:
    """int32 words of :func:`_retire_structure` in shared memory: 6K + R +
    C + 2 and two part tables, rounded up to 16 bytes."""
    R, C, K = qc.num_base_rows, qc.num_base_cols, qc.num_base_edges
    return -(-(6 * K + R + C + 2 + 2 * (parts + 1)) // 4) * 4


def _state_words(word_bits: int) -> int:
    """int32 words of a lifted check's compressed state: (alpha*m1,
    alpha*m2) and the state word of ``word_bits`` (32, 64 or 128) bits."""
    return 2 + word_bits // 32


def _max_degree(word_bits: int) -> int:
    """Members of a row whose signs a state word of ``word_bits`` holds."""
    return {32: _RETIRE_MAX_DEGREE, 64: _RETIRE_WIDE_MAX_DEGREE,
            128: _RETIRE_WIDER_MAX_DEGREE}[word_bits]


def retire_smem_bytes(qc: QCLayout, parts: int = 1, frames: int = 1, word_bits: int = 32) -> int:
    """Dynamic shared memory of one ``fused_retire`` block (``word_bits``
    64: ``fused_retire_wide``, 128: ``fused_retire_w128``): structure plus,
    per frame, the beliefs and the LLRs (C*Z float32 each) and the
    compressed check state (3 words per lifted check, 4 with the 64-bit
    state word, 6 with the 128-bit one)."""
    Z, C, R = qc.Z, qc.num_base_cols, qc.num_base_rows
    return 4 * (_retire_structure_words(qc, parts)
                + frames * (-(-(2 * C * Z + _state_words(word_bits) * R * Z) // 4) * 4))


def retire_threads(qc: QCLayout, parts: int, frames: int) -> int:
    """Threads of a ``fused_retire`` block: per frame, ``parts`` times the
    ceil(Z / 32) warps that span Z."""
    return 32 * -(-qc.Z // 32) * parts * frames


def retire_plans(qc: QCLayout, word_bits: int = 32) -> list[tuple[int, int]]:
    """The (parts, frames per block) a ``fused_retire`` launch on the state
    word of ``word_bits`` may take: at most 15 frames and 1024 threads a
    block, within shared memory."""
    return [(p, f) for p in range(1, _RETIRE_MAX_PARTS + 1)
            for f in range(1, _RETIRE_MAX_GROUPS + 1)
            if retire_threads(qc, p, f) <= _RETIRE_MAX_THREADS
            and retire_smem_bytes(qc, p, f, word_bits) <= _SMEM_BUDGET]


def retire_kernel_fits(qc: QCLayout, word_bits: int = 32) -> bool:
    """Whether ``fused_retire`` takes the code on the state word of
    ``word_bits``: rows of at most the members whose signs it holds (27 on
    the 32-bit word; 58 on the 64-bit one, ``fused_retire_wide``; 121 on
    the 128-bit one, ``fused_retire_w128``) and a frame within a block."""
    return qc.dr_max <= _max_degree(word_bits) and bool(retire_plans(qc, word_bits))


def retire_sumproduct_smem_bytes(qc: QCLayout, parts: int = 1, frames: int = 1,
                                 staged: bool = False) -> int:
    """Dynamic shared memory of one ``retire_sumproduct`` block: structure
    plus, per frame, the beliefs (C*Z float32), the LLRs too if ``staged``,
    and c2v (K*Z float32), rounded up to 16 bytes."""
    Z, C, K = qc.Z, qc.num_base_cols, qc.num_base_edges
    frame = -(-((2 if staged else 1) * C * Z + K * Z) // 4) * 4
    return 4 * (_retire_structure_words(qc, parts) + frames * frame)


def retire_sumproduct_plans(qc: QCLayout) -> list[tuple[int, int, bool]]:
    """The (parts, frames per block, staged) a ``retire_sumproduct`` launch
    may take: at most 15 frames and 1024 threads a block, within shared
    memory."""
    return [(p, f, staged) for p in range(1, _RETIRE_MAX_PARTS + 1)
            for f in range(1, _RETIRE_MAX_GROUPS + 1) for staged in (False, True)
            if retire_threads(qc, p, f) <= _RETIRE_MAX_THREADS
            and retire_sumproduct_smem_bytes(qc, p, f, staged) <= _SMEM_BUDGET]


def retire_sumproduct_fits(qc: QCLayout, word_bits: int = 32) -> bool:
    """Whether ``retire_sumproduct`` takes the code with sign masks of
    ``word_bits``: rows of at most 27 members (a word holds a check's
    signs, as in ``fused_retire``; 58 on ``retire_sumproduct_wide``'s 64-bit
    word, 121 on ``retire_sumproduct_w128``'s 128-bit one) and a frame, with
    one float of c2v an edge, within a block."""
    return qc.dr_max <= _max_degree(word_bits) and bool(retire_sumproduct_plans(qc))


def retire_zlane_smem_bytes(qc: QCLayout, parts: int = 1) -> int:
    """Dynamic shared memory of one ``retire_zlane`` block (one frame):
    structure plus the beliefs (C*Z float32) and (alpha*m1, alpha*m2) of
    each lifted check (R*Z float32 pairs)."""
    Z, C, R = qc.Z, qc.num_base_cols, qc.num_base_rows
    return 4 * (_retire_structure_words(qc, parts) + C * Z + 2 * R * Z)


def retire_zlane_scratch_bytes(qc: QCLayout, word_bits: int = 32) -> int:
    """Global scratch of one ``retire_zlane`` block: a state word (argmin
    and signs) of ``word_bits`` per lifted check (64: ``retire_zlane_wide``,
    128: ``retire_zlane_w128``)."""
    return word_bits // 8 * qc.num_base_rows * qc.Z


def retire_zlane_plans(qc: QCLayout) -> list[int]:
    """The parts a ``retire_zlane`` frame may be split into: at most 1024
    threads a block, within shared memory."""
    return [p for p in range(1, _RETIRE_MAX_PARTS + 1)
            if retire_threads(qc, p, 1) <= _RETIRE_MAX_THREADS
            and retire_zlane_smem_bytes(qc, p) <= _SMEM_BUDGET]


def retire_zlane_fits(qc: QCLayout, word_bits: int = 32) -> bool:
    """Whether ``retire_zlane`` takes the code on the state word of
    ``word_bits``: Z % 8 == 0 (as the TPU kernel), rows of at most 27
    members (58 on ``retire_zlane_wide``'s 64-bit word, 121 on
    ``retire_zlane_w128``'s 128-bit one) and a frame's beliefs and (alpha*m1,
    alpha*m2) within a block (the words live in the L2 slice)."""
    return (qc.Z % 8 == 0 and qc.dr_max <= _max_degree(word_bits)
            and bool(retire_zlane_plans(qc)))


def row_groups(st: _Structure) -> list[int]:
    """First row of each row group, then R: runs of consecutive base rows
    that pairwise share no column, taken greedily.  Rows of a group touch
    disjoint beliefs, so the layered schedule may update them in any order
    or side by side and compute the same bits."""
    starts, cols = [0], set()
    for r, members in enumerate(st.row_members):
        row_cols = {st.cols[k] for k in members}
        if cols & row_cols:
            starts.append(r)
            cols = set()
        cols |= row_cols
    return starts + [st.R]


def _layered_structure_words(qc: QCLayout) -> int:
    """int32 words of :func:`_layered_structure` in shared memory: 2K + R +
    1 + G + 1, rounded up to 16 bytes."""
    G = len(row_groups(_structure(qc))) - 1
    return -(-(2 * qc.num_base_edges + qc.num_base_rows + G + 2) // 4) * 4


def retire_layered_smem_bytes(qc: QCLayout, frames: int = 1, word_bits: int = 32) -> int:
    """Dynamic shared memory of one ``retire_layered`` block (``word_bits``
    64: ``retire_layered_wide``, 128: ``retire_layered_w128``): structure
    plus, per frame, the beliefs (C*Z float32) and the compressed check
    state (3 words per lifted check, 4 with the 64-bit state word, 6 with
    the 128-bit one), each rounded up to 16 bytes."""
    Z, C, R = qc.Z, qc.num_base_cols, qc.num_base_rows
    frame = -(-C * Z // 4) * 4 + -(-_state_words(word_bits) * R * Z // 4) * 4
    return 4 * (_layered_structure_words(qc) + frames * frame)


def _layered_plans(qc: QCLayout, smem_bytes,
                   max_threads: int = _RETIRE_MAX_THREADS) -> list[tuple[int, int]]:
    """The (parts, frames per block) of a layered kernel whose block takes
    ``smem_bytes(frames)`` of shared memory: parts up to the largest row
    group (a part runs one row of a group at a time), at most
    ``max_threads`` threads a block, 32 frames of one warp or 15 of more,
    within shared memory."""
    largest = max(np.diff(row_groups(_structure(qc))))
    plans = []
    for p in range(1, min(largest, _RETIRE_MAX_PARTS) + 1):
        one_warp = retire_threads(qc, p, 1) == 32
        for f in range(1, (_LAYERED_MAX_FRAMES if one_warp else _RETIRE_MAX_GROUPS) + 1):
            if retire_threads(qc, p, f) <= max_threads and smem_bytes(f) <= _SMEM_BUDGET:
                plans.append((p, f))
    return plans


def retire_layered_plans(qc: QCLayout, word_bits: int = 32) -> list[tuple[int, int]]:
    """The (parts, frames per block) a ``retire_layered`` launch on the state
    word of ``word_bits`` may take (:func:`_layered_plans`)."""
    return _layered_plans(qc, lambda f: retire_layered_smem_bytes(qc, f, word_bits))


def retire_layered_fits(qc: QCLayout, word_bits: int = 32) -> bool:
    """Whether ``retire_layered`` takes the code on the state word of
    ``word_bits``: rows of at most 27 members (58 on
    ``retire_layered_wide``'s 64-bit word, 121 on ``retire_layered_w128``'s
    128-bit one) and a frame within a block."""
    return qc.dr_max <= _max_degree(word_bits) and bool(retire_layered_plans(qc, word_bits))


def retire_zlane_layered_smem_bytes(qc: QCLayout, frames: int = 1) -> int:
    """Dynamic shared memory of one ``retire_zlane_layered`` block:
    ``retire_layered``'s structure plus, per frame, the beliefs (C*Z
    float32, rounded up to 16 bytes)."""
    frame = -(-qc.num_base_cols * qc.Z // 4) * 4
    return 4 * (_layered_structure_words(qc) + frames * frame)


def retire_zlane_layered_scratch_bytes(qc: QCLayout, word_bits: int = 32) -> int:
    """Global scratch of one ``retire_zlane_layered`` frame group:
    (alpha*m1, alpha*m2), then a state word (argmin and signs) of
    ``word_bits``, per lifted check: 12 bytes, 16 on
    ``retire_zlane_layered_wide``'s word, 24 on ``retire_zlane_layered_w128``'s."""
    return 4 * _state_words(word_bits) * qc.num_base_rows * qc.Z


def retire_zlane_layered_plans(qc: QCLayout) -> list[tuple[int, int]]:
    """The (parts, frames per block) a ``retire_zlane_layered`` launch
    may take (:func:`_layered_plans`), for Z % 8 == 0."""
    if qc.Z % 8:
        return []
    return _layered_plans(qc, lambda f: retire_zlane_layered_smem_bytes(qc, f))


def retire_zlane_layered_fits(qc: QCLayout, word_bits: int = 32) -> bool:
    """Whether ``retire_zlane_layered`` takes the code on the state word of
    ``word_bits``: Z % 8 == 0 (as the TPU kernel), rows of at most 27
    members (58 on the 64-bit word, 121 on the 128-bit one) and a frame's
    beliefs within a block."""
    return qc.dr_max <= _max_degree(word_bits) and bool(retire_zlane_layered_plans(qc))


def retire_layered_sumproduct_smem_bytes(qc: QCLayout, frames: int = 1) -> int:
    """Dynamic shared memory of one ``retire_layered_sumproduct`` block:
    ``retire_layered``'s structure plus, per frame, the beliefs (C*Z
    float32) and c2v (K*Z float32), each rounded up to 16 bytes."""
    Z, C, K = qc.Z, qc.num_base_cols, qc.num_base_edges
    frame = -(-C * Z // 4) * 4 + -(-K * Z // 4) * 4
    return 4 * (_layered_structure_words(qc) + frames * frame)


def retire_layered_sumproduct_plans(qc: QCLayout) -> list[tuple[int, int]]:
    """The (parts, frames per block) a ``retire_layered_sumproduct`` launch
    may take (:func:`_layered_plans`, at most 768 threads a block)."""
    return _layered_plans(qc, lambda f: retire_layered_sumproduct_smem_bytes(qc, f),
                          _LAYERED_SUMPRODUCT_MAX_THREADS)


def retire_layered_sumproduct_fits(qc: QCLayout, word_bits: int = 32) -> bool:
    """Whether ``retire_layered_sumproduct`` takes the code with sign masks
    of ``word_bits``: rows of at most 27 members (a word holds a check's
    signs; 58 on ``retire_layered_sumproduct_wide``'s 64-bit word, 121 on
    ``retire_layered_sumproduct_w128``'s 128-bit one) and a frame's beliefs
    and c2v within a block."""
    return qc.dr_max <= _max_degree(word_bits) and bool(retire_layered_sumproduct_plans(qc))


def retire_zlane_layered_sumproduct_smem_bytes(qc: QCLayout, frames: int = 1) -> int:
    """Dynamic shared memory of one ``retire_zlane_layered_sumproduct``
    block: ``retire_layered``'s structure plus, per frame, the beliefs (C*Z
    float32, rounded up to 16 bytes), as ``retire_zlane_layered``."""
    return retire_zlane_layered_smem_bytes(qc, frames)


def retire_zlane_layered_sumproduct_scratch_bytes(qc: QCLayout, word_bits: int = 32) -> int:
    """Global scratch of one ``retire_zlane_layered_sumproduct`` frame
    group: c2v, one float32 per lifted edge, whatever the sign masks' word
    (``word_bits``)."""
    return 4 * qc.num_base_edges * qc.Z


def retire_zlane_layered_sumproduct_plans(qc: QCLayout) -> list[tuple[int, int]]:
    """The (parts, frames per block) a ``retire_zlane_layered_sumproduct``
    launch may take (:func:`_layered_plans`, at most 768 threads a block),
    for Z % 8 == 0."""
    if qc.Z % 8:
        return []
    return _layered_plans(qc, lambda f: retire_zlane_layered_sumproduct_smem_bytes(qc, f),
                          _LAYERED_SUMPRODUCT_MAX_THREADS)


def retire_zlane_layered_sumproduct_fits(qc: QCLayout, word_bits: int = 32) -> bool:
    """Whether ``retire_zlane_layered_sumproduct`` takes the code with sign
    masks of ``word_bits``: Z % 8 == 0 (as the TPU kernel), rows of at most
    27 members (58 on the 64-bit word, 121 on the 128-bit one) and a
    frame's beliefs within a block."""
    return (qc.dr_max <= _max_degree(word_bits)
            and bool(retire_zlane_layered_sumproduct_plans(qc)))


def retire_zlane_sumproduct_smem_bytes(qc: QCLayout, parts: int = 1) -> int:
    """Dynamic shared memory of one ``retire_zlane_sumproduct`` block (one
    frame): structure plus the beliefs (C*Z float32)."""
    return 4 * (_retire_structure_words(qc, parts) + qc.num_base_cols * qc.Z)


def retire_zlane_sumproduct_scratch_bytes(qc: QCLayout, word_bits: int = 32) -> int:
    """Global scratch of one ``retire_zlane_sumproduct`` block: c2v, one
    float32 per lifted edge, whatever the sign masks' word
    (``word_bits``)."""
    return 4 * qc.num_base_edges * qc.Z


def retire_zlane_sumproduct_plans(qc: QCLayout) -> list[int]:
    """The parts a ``retire_zlane_sumproduct`` frame may be split into: at
    most 1024 threads a block, within shared memory."""
    return [p for p in range(1, _RETIRE_MAX_PARTS + 1)
            if retire_threads(qc, p, 1) <= _RETIRE_MAX_THREADS
            and retire_zlane_sumproduct_smem_bytes(qc, p) <= _SMEM_BUDGET]


def retire_zlane_sumproduct_fits(qc: QCLayout, word_bits: int = 32) -> bool:
    """Whether ``retire_zlane_sumproduct`` takes the code with sign masks of
    ``word_bits``: Z % 8 == 0, rows of at most 27 members (58 on the 64-bit
    word, 121 on the 128-bit one) and a frame's beliefs within a block."""
    return (qc.Z % 8 == 0 and qc.dr_max <= _max_degree(word_bits)
            and bool(retire_zlane_sumproduct_plans(qc)))


def _balanced_bounds(costs, parts: int) -> list[int]:
    """parts + 1 bounds that cut ``costs`` into contiguous runs of about
    equal sum."""
    cum = np.concatenate([[0], np.cumsum(costs)])
    inner = [int(np.abs(cum - cum[-1] * p / parts).argmin()) for p in range(1, parts)]
    return list(np.maximum.accumulate([0] + inner + [len(costs)]))


def _retire_structure(st: _Structure, parts: int = 1, per_edge: bool = False,
                      word_bits: int = 32) -> np.ndarray:
    """Structure for ``fused_retire`` (and ``retire_zlane``), int32: column
    members in col_members order as (r*Z, shift, j << 27, 31 - j) with j the
    member's position in its row (the state word's argmin field, and the
    shift that brings its sign, bit j, to bit 31) (4K), row members in row
    order as (col*Z, shift) (2K), row_ptr (R+1), col_ptr (C+1), then the
    first row and the first column of each of ``parts`` parts (parts+1
    each), cut so that the parts carry about equal work (a check costs its
    members plus 6, a variable its members plus 3).  ``per_edge`` (for
    ``retire_sumproduct``, whose c2v is one float an edge) puts the edge's
    offset i*Z in place of r*Z, with i = row_ptr[r] + j its position in row
    order.  ``word_bits`` 64 (the state word of the ``*_wide`` routes, the
    argmin in its top 6 bits) gives each column member (.., .., j, 63 - j),
    and 128 (the ``*_w128`` routes' two-limb word, the argmin in its top 7
    bits) (.., .., j, 127 - j): the argmin to compare, and the shift that
    brings bit j to the word's top bit."""
    Z = st.Z
    member, i = {}, 0
    for r, members in enumerate(st.row_members):
        for j, k in enumerate(members):
            fields = (j << 27, 31 - j) if word_bits == 32 else (j, word_bits - 1 - j)
            member[k] = ((i if per_edge else r) * Z, st.shifts[k], *fields)
            i += 1
    col_mem = [member[k] for m in st.col_members for k in m]
    row_mem = [(st.cols[k] * Z, st.shifts[k]) for m in st.row_members for k in m]
    row_deg = [len(m) for m in st.row_members]
    col_deg = [len(m) for m in st.col_members]
    words = [np.asarray(col_mem, np.int64).reshape(-1), np.asarray(row_mem).reshape(-1),
             np.cumsum([0] + row_deg), np.cumsum([0] + col_deg),
             _balanced_bounds(np.add(row_deg, 6), parts),
             _balanced_bounds(np.add(col_deg, 3), parts)]
    return np.concatenate([np.asarray(w, np.int64) for w in words]).astype(np.uint32).view(np.int32)


def _layered_structure(st: _Structure) -> np.ndarray:
    """Structure for ``retire_layered``, int32: row members in row order as
    (col*Z, shift) (2K), row_ptr (R+1) and the first row of each row group,
    then R (:func:`row_groups`, G+1)."""
    row_mem = [(st.cols[k] * st.Z, st.shifts[k]) for m in st.row_members for k in m]
    words = [np.asarray(row_mem).reshape(-1), np.cumsum([0] + [len(m) for m in st.row_members]),
             row_groups(st)]
    return np.concatenate([np.asarray(w, np.int64) for w in words]).astype(np.int32)


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
_RETIRE_SIGNATURES = {
    # llr, bits, conv, counter, structure, B, Z, R, C, K, T, alpha,
    # track, parts, frames_per_block, grid, word_bits, stream
    "ldpc_retire_minsum": ([_P] * 5 + [_I] * 6 + [_F] + [_I] * 5 + [_P], _I),
    # llr, bits, conv, counter, scratch, structure, B, Z, R, C, K, T, alpha,
    # track, parts, grid, word_bits, stream
    "ldpc_retire_zlane": ([_P] * 6 + [_I] * 6 + [_F] + [_I] * 4 + [_P], _I),
    # Z, R, C, K, parts, frames_per_block, word_bits
    "ldpc_retire_smem_bytes": ([_I] * 7, ctypes.c_longlong),
    "ldpc_retire_zlane_smem_bytes": ([_I] * 5, ctypes.c_longlong),
    # Z, R, C, K, parts, frames_per_block, track, word_bits -> blocks per SM
    "ldpc_retire_occupancy": ([_I] * 8, _I),
    # Z, R, C, K, parts, track, word_bits -> blocks per SM
    "ldpc_retire_zlane_occupancy": ([_I] * 7, _I),
    # llr, bits, conv, counter, structure, B, Z, R, C, K, G, T, alpha,
    # track, parts, frames_per_block, grid, word_bits, stream
    "ldpc_retire_layered": ([_P] * 5 + [_I] * 7 + [_F] + [_I] * 5 + [_P], _I),
    # Z, R, C, K, G, frames_per_block, word_bits
    "ldpc_retire_layered_smem_bytes": ([_I] * 7, ctypes.c_longlong),
    # Z, R, C, K, G, parts, frames_per_block, track, word_bits -> blocks per SM
    "ldpc_retire_layered_occupancy": ([_I] * 9, _I),
    # llr, bits, conv, counter, structure, B, Z, R, C, K, T,
    # track, parts, frames_per_block, staged, grid, word_bits, stream
    "ldpc_retire_sumproduct": ([_P] * 5 + [_I] * 12 + [_P], _I),
    # Z, R, C, K, parts, frames_per_block, staged
    "ldpc_retire_sumproduct_smem_bytes": ([_I] * 7, ctypes.c_longlong),
    # Z, R, C, K, parts, frames_per_block, staged, track, word_bits -> blocks per SM
    "ldpc_retire_sumproduct_occupancy": ([_I] * 9, _I),
    # llr, bits, conv, counter, scratch, structure, B, Z, R, C, K, G, T,
    # alpha, track, parts, frames_per_block, grid, word_bits, stream
    "ldpc_retire_zlane_layered": ([_P] * 6 + [_I] * 7 + [_F] + [_I] * 5 + [_P], _I),
    # Z, R, C, K, G, frames_per_block
    "ldpc_retire_zlane_layered_smem_bytes": ([_I] * 6, ctypes.c_longlong),
    # Z, R, C, K, G, parts, frames_per_block, track, word_bits -> blocks per SM
    "ldpc_retire_zlane_layered_occupancy": ([_I] * 9, _I),
    # llr, bits, conv, counter, scratch, structure, B, Z, R, C, K, T,
    # track, parts, grid, word_bits, stream
    "ldpc_retire_zlane_sumproduct": ([_P] * 6 + [_I] * 10 + [_P], _I),
    "ldpc_retire_zlane_sumproduct_smem_bytes": ([_I] * 5, ctypes.c_longlong),
    # Z, R, C, K, parts, track, word_bits -> blocks per SM
    "ldpc_retire_zlane_sumproduct_occupancy": ([_I] * 7, _I),
    # llr, bits, conv, counter, structure, B, Z, R, C, K, G, T,
    # track, parts, frames_per_block, grid, word_bits, stream
    "ldpc_retire_layered_sumproduct": ([_P] * 5 + [_I] * 12 + [_P], _I),
    # Z, R, C, K, G, frames_per_block
    "ldpc_retire_layered_sumproduct_smem_bytes": ([_I] * 6, ctypes.c_longlong),
    # Z, R, C, K, G, parts, frames_per_block, track, word_bits -> blocks per SM
    "ldpc_retire_layered_sumproduct_occupancy": ([_I] * 9, _I),
    # llr, bits, conv, counter, scratch, structure, B, Z, R, C, K, G, T,
    # track, parts, frames_per_block, grid, word_bits, stream
    "ldpc_retire_zlane_layered_sumproduct": ([_P] * 6 + [_I] * 12 + [_P], _I),
    # Z, R, C, K, G, frames_per_block
    "ldpc_retire_zlane_layered_sumproduct_smem_bytes": ([_I] * 6, ctypes.c_longlong),
    # Z, R, C, K, G, parts, frames_per_block, track, word_bits -> blocks per SM
    "ldpc_retire_zlane_layered_sumproduct_occupancy": ([_I] * 9, _I),
    "ldpc_retire_error_string": ([_I], ctypes.c_char_p),
}


def kernel_library():
    """The compiled ``csrc/fused_minsum.cu``, built on first use."""
    from ldpc_tpu_torch.ops import _build

    return _build.load("fused_minsum", _SIGNATURES)


def retire_kernel_library():
    """The compiled ``csrc/fused_retire.cu``, built on first use."""
    from ldpc_tpu_torch.ops import _build

    return _build.load("fused_retire", _RETIRE_SIGNATURES)


def retire_plan(qc: QCLayout, track_convergence: bool, parts: int | None = None,
                lib=None, word_bits: int = 32) -> tuple[int, int, int]:
    """(parts, frames per block, resident blocks per SM) of ``fused_retire``
    on the state word of ``word_bits``: of :func:`retire_plans` (those with
    ``parts`` if given), the most resident frames per SM by the runtime's
    occupancy query, then the most parts, then the fewest frames per
    block."""
    lib = lib or retire_kernel_library()
    dims = (qc.Z, qc.num_base_rows, qc.num_base_cols, qc.num_base_edges)
    best, key = (0, 0, 0), (0, 0, 0)
    for p, f in retire_plans(qc, word_bits):
        if parts is not None and p != parts:
            continue
        per_sm = lib.ldpc_retire_occupancy(*dims, p, f, int(track_convergence), word_bits)
        if (per_sm * f, p, -f) > key:
            best, key = (p, f, per_sm), (per_sm * f, p, -f)
    return best


def retire_sumproduct_plan(qc: QCLayout, track_convergence: bool, parts: int | None = None,
                           lib=None, word_bits: int = 32) -> tuple[int, int, bool, int]:
    """(parts, frames per block, staged, resident blocks per SM) of
    ``retire_sumproduct`` with sign masks of ``word_bits``: of
    :func:`retire_sumproduct_plans` (those with ``parts`` if given), the
    most resident frames per SM by the runtime's occupancy query, then the
    most parts, then staged LLRs, then the fewest frames per block."""
    lib = lib or retire_kernel_library()
    dims = (qc.Z, qc.num_base_rows, qc.num_base_cols, qc.num_base_edges)
    best, key = (0, 0, False, 0), (0, 0, False, 0)
    for p, f, staged in retire_sumproduct_plans(qc):
        if parts is not None and p != parts:
            continue
        per_sm = lib.ldpc_retire_sumproduct_occupancy(*dims, p, f, int(staged),
                                                      int(track_convergence), word_bits)
        if (per_sm * f, p, staged, -f) > key:
            best, key = (p, f, staged, per_sm), (per_sm * f, p, staged, -f)
    return best


def retire_zlane_plan(qc: QCLayout, track_convergence: bool, parts: int | None = None,
                      lib=None, word_bits: int = 32) -> tuple[int, int]:
    """(parts, resident blocks per SM) of ``retire_zlane`` on the state word
    of ``word_bits``: of :func:`retire_zlane_plans` (``parts`` if given),
    the most resident blocks per SM by the runtime's occupancy query, then
    the most parts."""
    lib = lib or retire_kernel_library()
    dims = (qc.Z, qc.num_base_rows, qc.num_base_cols, qc.num_base_edges)
    best = (0, 0)
    for p in retire_zlane_plans(qc):
        if parts is not None and p != parts:
            continue
        per_sm = lib.ldpc_retire_zlane_occupancy(*dims, p, int(track_convergence), word_bits)
        if (per_sm, p) > best[::-1]:
            best = (p, per_sm)
    return best


def retire_layered_plan(qc: QCLayout, track_convergence: bool, parts: int | None = None,
                        lib=None, word_bits: int = 32) -> tuple[int, int, int]:
    """(parts, frames per block, resident blocks per SM) of
    ``retire_layered`` on the state word of ``word_bits``: of
    :func:`retire_layered_plans` (those with ``parts`` if given), the most
    resident frames per SM by the runtime's occupancy query, then the most
    parts, then the fewest frames per block."""
    lib = lib or retire_kernel_library()
    dims = (qc.Z, qc.num_base_rows, qc.num_base_cols, qc.num_base_edges,
            len(row_groups(_structure(qc))) - 1)
    best, key = (0, 0, 0), (0, 0, 0)
    for p, f in retire_layered_plans(qc, word_bits):
        if parts is not None and p != parts:
            continue
        per_sm = lib.ldpc_retire_layered_occupancy(*dims, p, f, int(track_convergence),
                                                   word_bits)
        if (per_sm * f, p, -f) > key:
            best, key = (p, f, per_sm), (per_sm * f, p, -f)
    return best


def retire_zlane_layered_plan(qc: QCLayout, track_convergence: bool, parts: int | None = None,
                              lib=None, word_bits: int = 32) -> tuple[int, int, int]:
    """(parts, frames per block, resident blocks per SM) of
    ``retire_zlane_layered`` on the state word of ``word_bits``: of
    :func:`retire_zlane_layered_plans` with
    ``parts`` if given, the most resident frames per SM by the runtime's
    occupancy query, then the most parts, then the fewest frames per
    block."""
    lib = lib or retire_kernel_library()
    G = len(row_groups(_structure(qc))) - 1
    dims = (qc.Z, qc.num_base_rows, qc.num_base_cols, qc.num_base_edges, G)
    best, key = (0, 0, 0), (0, 0, 0)
    for p, f in retire_zlane_layered_plans(qc):
        if parts is not None and p != parts:
            continue
        per_sm = lib.ldpc_retire_zlane_layered_occupancy(*dims, p, f, int(track_convergence),
                                                         word_bits)
        if (per_sm * f, p, -f) > key:
            best, key = (p, f, per_sm), (per_sm * f, p, -f)
    return best


def retire_zlane_sumproduct_plan(qc: QCLayout, track_convergence: bool, parts: int | None = None,
                                 lib=None, word_bits: int = 32) -> tuple[int, int]:
    """(parts, resident blocks per SM) of ``retire_zlane_sumproduct`` with
    sign masks of ``word_bits``: of
    :func:`retire_zlane_sumproduct_plans` (``parts`` if given), with the
    blocks an SM capped at ``_ZLANE_SUMPRODUCT_BLOCKS_PER_SM`` (what the L2
    holds), the most resident warps per SM by the runtime's occupancy
    query, then the most parts."""
    lib = lib or retire_kernel_library()
    dims = (qc.Z, qc.num_base_rows, qc.num_base_cols, qc.num_base_edges)
    best, key = (0, 0), (0, 0)
    for p in retire_zlane_sumproduct_plans(qc):
        if parts is not None and p != parts:
            continue
        per_sm = min(_ZLANE_SUMPRODUCT_BLOCKS_PER_SM, lib.ldpc_retire_zlane_sumproduct_occupancy(
            *dims, p, int(track_convergence), word_bits))
        if (per_sm * p, p) > key:
            best, key = (p, per_sm), (per_sm * p, p)
    return best


def retire_layered_sumproduct_plan(qc: QCLayout, track_convergence: bool,
                                   parts: int | None = None, lib=None,
                                   word_bits: int = 32) -> tuple[int, int, int]:
    """(parts, frames per block, resident blocks per SM) of
    ``retire_layered_sumproduct`` with sign masks of ``word_bits``: of
    :func:`retire_layered_sumproduct_plans`
    (those with ``parts`` if given), the most resident frames per SM by the
    runtime's occupancy query, then the fewest parts, then the fewest frames
    per block.  Fewest parts, where ``retire_layered`` takes the most: at NR
    BG2 Z=32, 7 frames of one warp beat 7 of three warps by 1.0-1.6% in
    every call that timed both (chip_smoke.py sumproduct_layered)."""
    lib = lib or retire_kernel_library()
    dims = (qc.Z, qc.num_base_rows, qc.num_base_cols, qc.num_base_edges,
            len(row_groups(_structure(qc))) - 1)
    best, key = (0, 0, 0), (0, 0, 0)
    for p, f in retire_layered_sumproduct_plans(qc):
        if parts is not None and p != parts:
            continue
        per_sm = lib.ldpc_retire_layered_sumproduct_occupancy(*dims, p, f,
                                                             int(track_convergence),
                                                             word_bits)
        if (per_sm * f, -p, -f) > key:
            best, key = (p, f, per_sm), (per_sm * f, -p, -f)
    return best


def retire_zlane_layered_sumproduct_plan(qc: QCLayout, track_convergence: bool,
                                         parts: int | None = None, lib=None,
                                         word_bits: int = 32) -> tuple[int, int, int]:
    """(parts, frames per block, resident blocks per SM) of
    ``retire_zlane_layered_sumproduct`` with sign masks of ``word_bits``:
    of
    :func:`retire_zlane_layered_sumproduct_plans` (those with ``parts`` if
    given), the most resident frames per SM by the runtime's occupancy
    query, then the fewest parts, then the fewest frames per block.  At NR
    BG2 Z=384 that is two frame groups of one part an SM (shared memory
    holds no third frame's beliefs): they beat one group of two parts by
    9-11% (chip_smoke.py z384_sumproduct_layered), though their c2v slices
    (80 MB) exceed an H100's 50 MB L2."""
    lib = lib or retire_kernel_library()
    dims = (qc.Z, qc.num_base_rows, qc.num_base_cols, qc.num_base_edges,
            len(row_groups(_structure(qc))) - 1)
    best, key = (0, 0, 0), (0, 0, 0)
    for p, f in retire_zlane_layered_sumproduct_plans(qc):
        if parts is not None and p != parts:
            continue
        per_sm = lib.ldpc_retire_zlane_layered_sumproduct_occupancy(
            *dims, p, f, int(track_convergence), word_bits)
        if (per_sm * f, -p, -f) > key:
            best, key = (p, f, per_sm), (per_sm * f, -p, -f)
    return best


def _route(kind: str, qc: QCLayout, mode: str, schedule: str) -> str:
    """The kernel a decoder of ``kind`` launches (its ``LAUNCHES`` key): each
    mode and schedule on the retiring kernel of its size where that takes
    the code; rows of 28 to 58 members on the same kernel on the 64-bit
    state word (the route's ``*_wide`` form) and rows of 59 to 121 on the
    128-bit one (its ``*_w128`` form); the rest (rows over 121 members) on
    ``kind``'s own."""
    fits = {("fused", "minsum", "flooding"): ("fused_retire", retire_kernel_fits),
            ("fused", "minsum", "layered"): ("retire_layered", retire_layered_fits),
            ("fused", "sumproduct", "flooding"): ("retire_sumproduct", retire_sumproduct_fits),
            ("fused", "sumproduct", "layered"): ("retire_layered_sumproduct",
                                                 retire_layered_sumproduct_fits),
            ("fused_zlane", "minsum", "flooding"): ("retire_zlane", retire_zlane_fits),
            ("fused_zlane", "minsum", "layered"): ("retire_zlane_layered",
                                                   retire_zlane_layered_fits),
            ("fused_zlane", "sumproduct", "flooding"): ("retire_zlane_sumproduct",
                                                        retire_zlane_sumproduct_fits),
            ("fused_zlane", "sumproduct", "layered"): ("retire_zlane_layered_sumproduct",
                                                       retire_zlane_layered_sumproduct_fits)}
    route, takes = fits.get((kind, mode, schedule), (kind, None))
    if takes is None or takes(qc):
        return route
    for bits, suffix in _WORD_SUFFIX.items():
        if takes(qc, word_bits=bits):
            return route + suffix
    return kind


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

    Launches the ``route`` kernel for CUDA tensors and runs the plain
    version for CPU tensors; ``plain(llr)`` runs the plain version on any
    device.  ``kind`` "fused" routes min-sum with the flooding schedule to
    ``fused_retire`` (:func:`retire_kernel_fits`), min-sum with the layered
    schedule to ``retire_layered`` (:func:`retire_layered_fits`),
    sum-product with the flooding schedule to ``retire_sumproduct``
    (:func:`retire_sumproduct_fits`) and with the layered schedule to
    ``retire_layered_sumproduct`` (:func:`retire_layered_sumproduct_fits`)
    on the codes they take; ``kind`` "fused_zlane" routes them to
    ``retire_zlane``, ``retire_zlane_layered``, ``retire_zlane_sumproduct``
    and ``retire_zlane_layered_sumproduct`` (:func:`retire_zlane_fits`,
    :func:`retire_zlane_layered_fits`, :func:`retire_zlane_sumproduct_fits`,
    :func:`retire_zlane_layered_sumproduct_fits`).  Rows of 28 to 58
    members run on the same kernels' 64-bit state word (``WIDE_ROUTES``,
    ``ZLANE_WIDE_ROUTES``, each ``fits`` with ``word_bits=64``) and rows of
    59 to 121 on their 128-bit word (``W128_ROUTES``, ``ZLANE_W128_ROUTES``,
    ``word_bits=128``); the rest (rows over 121 members) runs on the
    ``kind`` kernel.
    ``retire`` says whether the route is one of the retiring kernels
    (``RETIRING``).
    """

    def __init__(self, kind: str, qc: QCLayout, max_iterations: int, alpha: float,
                 batch_tile: int, mode: str, track_convergence: bool, early_exit: bool,
                 schedule: str, device: torch.device):
        self.kind = kind
        self.qc = qc
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
        self.route = _route(kind, qc, mode, schedule)
        self.retire = self.route in RETIRING
        # Decoders on every retiring kernel but fused_retire keep the CSR
        # structure for _launch_zlane and _launch_fused.
        self.graph = None if self.route == "fused_retire" else torch.as_tensor(
            _graph_array(self.st), device=device)
        self._plain_index: dict[torch.device, _PlainIndex] = {}
        # Retiring kernels' launch plans (parts, frames per block, resident
        # blocks, structure on that card, staged LLRs) by (card, parts asked
        # for), made at the first launch on each.
        self._retire_plans: dict[tuple, tuple] = {}

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
        if self.retire:
            return self._launch_retire(llr)
        return self._launch_csr(llr, self.kind)

    def _launch_zlane(self, llr: torch.Tensor):
        """``fused_zlane`` on ``llr`` (contiguous, on a card) whatever the
        route: the kernel every mode and schedule ran on before the
        ``retire_zlane*`` kernels (and on rows of 28 to 121 members before
        their ``*_wide`` and ``*_w128`` forms), kept so each can be timed
        beside it."""
        if self.kind != "fused_zlane":
            raise ValueError(f"a {self.kind} decoder has no zlane launch")
        return self._launch_csr(llr, "fused_zlane")

    def _launch_fused(self, llr: torch.Tensor):
        """``fused`` on ``llr`` (contiguous, on a card) whatever the route:
        the kernel layered min-sum and both sum-product schedules ran on
        before ``retire_layered``, ``retire_sumproduct`` and
        ``retire_layered_sumproduct``, and every schedule on rows of 28 to
        121 members before the ``*_wide`` and ``*_w128`` routes, kept so each
        can be timed beside it."""
        if self.kind != "fused" or self.graph is None:
            raise ValueError(f"a {self.route} decoder has no fused launch")
        return self._launch_csr(llr, "fused")

    def _launch_csr(self, llr: torch.Tensor, kind: str):
        """The ``fused`` or ``fused_zlane`` kernel on ``llr``."""
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
            if kind == "fused":
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
        _check_rc(lib, rc, kind)
        LAUNCHES[kind] += 1
        return bits, conv

    def _launch_retire(self, llr: torch.Tensor, parts: int | None = None):
        """The route's retiring kernel (one of ``RETIRING``) on ``llr``
        (contiguous, on a card); ``parts`` fixes the parts a frame is split
        into (for the layered kernels, the rows of a row group it runs side
        by side) instead of the plan's choice.  The large-Z kernels run at
        most ``batch_tile`` frames in flight, if given (at least one
        block's)."""
        st = self.st
        B = llr.shape[0]
        bits = torch.empty_like(llr)
        conv = torch.empty((B,), dtype=torch.int32, device=llr.device)
        if B == 0:
            return bits, conv
        lib = retire_kernel_library()
        # A *_wide or *_w128 route launches its kernel's instantiation on the
        # 64-bit or 128-bit state word.
        route, word_bits = _ROUTE_WORD.get(self.route, (self.route, 32))
        with torch.cuda.device(llr.device):
            cache_key = (llr.device, parts)
            plan = self._retire_plans.get(cache_key)
            if plan is None:
                # flag: staged LLRs (retire_sumproduct).
                flag, frames = False, 1
                if route == "retire_zlane":
                    p, per_sm = retire_zlane_plan(self.qc, self.track_convergence, parts, lib,
                                                  word_bits)
                elif route == "retire_zlane_sumproduct":
                    p, per_sm = retire_zlane_sumproduct_plan(self.qc, self.track_convergence,
                                                             parts, lib, word_bits)
                elif route == "retire_zlane_layered":
                    p, frames, per_sm = retire_zlane_layered_plan(self.qc, self.track_convergence,
                                                                  parts, lib, word_bits)
                elif route == "retire_layered":
                    p, frames, per_sm = retire_layered_plan(self.qc, self.track_convergence,
                                                            parts, lib, word_bits)
                elif route == "retire_layered_sumproduct":
                    p, frames, per_sm = retire_layered_sumproduct_plan(
                        self.qc, self.track_convergence, parts, lib, word_bits)
                elif route == "retire_zlane_layered_sumproduct":
                    p, frames, per_sm = retire_zlane_layered_sumproduct_plan(
                        self.qc, self.track_convergence, parts, lib, word_bits)
                elif route == "retire_sumproduct":
                    p, frames, flag, per_sm = retire_sumproduct_plan(
                        self.qc, self.track_convergence, parts, lib, word_bits)
                else:
                    p, frames, per_sm = retire_plan(self.qc, self.track_convergence, parts, lib,
                                                    word_bits)
                resident = _resident_grid(per_sm, self.route, llr.device)
                table = (_layered_structure(st) if route in _LAYERED_ROUTES
                         else _retire_structure(st, p, per_edge=route in (
                             "retire_sumproduct", "retire_zlane_sumproduct"),
                                                 word_bits=word_bits))
                structure = torch.as_tensor(table, device=llr.device)
                plan = self._retire_plans[cache_key] = (p, frames, resident, structure, flag)
            p, frames, resident, structure, flag = plan
            grid = min(resident, -(-B // frames))
            if route.startswith("retire_zlane") and self.batch_tile:
                grid = min(grid, max(1, self.batch_tile // frames))
            counter = torch.zeros((1,), dtype=torch.int32, device=llr.device)
            stream = torch.cuda.current_stream(llr.device).cuda_stream
            pointers = (llr.data_ptr(), bits.data_ptr(), conv.data_ptr(), counter.data_ptr())
            track = int(self.track_convergence)
            args = (B, st.Z, st.R, st.C, st.K, self.max_iterations, self.alpha, track, p)
            G = structure.shape[0] - 2 * st.K - st.R - 2
            if route == "retire_zlane":
                scratch = torch.empty((grid * retire_zlane_scratch_bytes(self.qc, word_bits),),
                                      dtype=torch.uint8, device=llr.device)
                rc = lib.ldpc_retire_zlane(*pointers, scratch.data_ptr(), structure.data_ptr(),
                                           *args, grid, word_bits, stream)
            elif route == "retire_zlane_layered":
                scratch = torch.empty(
                    (grid * frames * retire_zlane_layered_scratch_bytes(self.qc, word_bits),),
                    dtype=torch.uint8, device=llr.device)
                rc = lib.ldpc_retire_zlane_layered(
                    *pointers, scratch.data_ptr(), structure.data_ptr(), B, st.Z, st.R, st.C,
                    st.K, G, self.max_iterations, self.alpha, track, p, frames, grid, word_bits,
                    stream)
            elif route == "retire_zlane_layered_sumproduct":
                scratch = torch.empty(
                    (grid * frames * retire_zlane_layered_sumproduct_scratch_bytes(self.qc),),
                    dtype=torch.uint8, device=llr.device)
                rc = lib.ldpc_retire_zlane_layered_sumproduct(
                    *pointers, scratch.data_ptr(), structure.data_ptr(), B, st.Z, st.R, st.C,
                    st.K, G, self.max_iterations, track, p, frames, grid, word_bits, stream)
            elif route == "retire_layered_sumproduct":
                rc = lib.ldpc_retire_layered_sumproduct(
                    *pointers, structure.data_ptr(), B, st.Z, st.R, st.C, st.K, G,
                    self.max_iterations, track, p, frames, grid, word_bits, stream)
            elif route == "retire_zlane_sumproduct":
                scratch = torch.empty((grid * retire_zlane_sumproduct_scratch_bytes(self.qc),),
                                      dtype=torch.uint8, device=llr.device)
                rc = lib.ldpc_retire_zlane_sumproduct(
                    *pointers, scratch.data_ptr(), structure.data_ptr(), B, st.Z, st.R, st.C,
                    st.K, self.max_iterations, track, p, grid, word_bits, stream)
            elif route == "retire_sumproduct":
                rc = lib.ldpc_retire_sumproduct(*pointers, structure.data_ptr(), B, st.Z, st.R,
                                                st.C, st.K, self.max_iterations, track, p,
                                                frames, int(flag), grid, word_bits, stream)
            elif route == "retire_layered":
                rc = lib.ldpc_retire_layered(*pointers, structure.data_ptr(), B, st.Z, st.R,
                                             st.C, st.K, G, self.max_iterations, self.alpha,
                                             track, p, frames, grid, word_bits, stream)
            else:
                rc = lib.ldpc_retire_minsum(*pointers, structure.data_ptr(), *args, frames, grid,
                                            word_bits, stream)
        if rc != 0:
            msg = lib.ldpc_retire_error_string(rc).decode()
            raise RuntimeError(f"{self.route} kernel launch failed: CUDA error {rc} ({msg})")
        LAUNCHES[self.route] += 1
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

    Min-sum runs on ``fused_retire`` with the flooding schedule and on
    ``retire_layered`` with the layered one, sum-product on
    ``retire_sumproduct`` and ``retire_layered_sumproduct``, each picking its
    own frames per block (:func:`retire_plan`, :func:`retire_layered_plan`,
    :func:`retire_sumproduct_plan`, :func:`retire_layered_sumproduct_plan`),
    on the codes they take (:func:`retire_kernel_fits`,
    :func:`retire_layered_fits`, :func:`retire_sumproduct_fits`,
    :func:`retire_layered_sumproduct_fits`), on their 64-bit-word forms
    (``fused_retire_wide``, ``retire_layered_wide``,
    ``retire_sumproduct_wide``, ``retire_layered_sumproduct_wide``) for rows
    of 28 to 58 members and on their 128-bit-word forms (``*_w128``) for
    rows of 59 to 121; codes with rows of more run on ``fused``,
    ``batch_tile`` frames per thread block with all state in shared memory
    (default: :func:`pick_fused_batch_tile`).  ``batch_tile`` is checked against the
    ``fused`` kernel's shared memory either way.  ``mode``: "minsum"
    (scaled, uses alpha) or "sumproduct" (BP).  ``track_convergence=False``
    skips the per-iteration syndrome/freeze pass (throughput mode: conv_iter
    returns max_iterations everywhere, bits are the final-iteration
    decisions).  ``early_exit=True`` (requires tracking) stops each block's
    iteration loop once all its frames have valid syndromes, with the same
    outputs (the retiring kernels let each frame go the iteration it
    converges either way).  ``schedule``: "flooding" or "layered" (each base row's new c2v
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
    exceeds a block's shared memory.  On the codes they take, min-sum runs
    on ``retire_zlane`` (flooding, :func:`retire_zlane_fits`) and on
    ``retire_zlane_layered`` (layered, :func:`retire_zlane_layered_fits`),
    sum-product on ``retire_zlane_sumproduct`` (flooding,
    :func:`retire_zlane_sumproduct_fits`) and on
    ``retire_zlane_layered_sumproduct`` (layered,
    :func:`retire_zlane_layered_sumproduct_fits`): persistent grids of the
    blocks that can be resident, frames that leave the kernel the iteration
    they converge, the beliefs in shared memory and the check state, or part
    of it, in each frame group's slice of a global scratch that the L2 holds
    (R*Z*4 bytes of state words; K*Z*4 bytes of c2v for sum-product, one
    block an SM for the flooding schedule).  Rows of 28 to 58 members run
    on the same kernels' 64-bit state word (``ZLANE_WIDE_ROUTES``), rows of
    59 to 121 on their 128-bit word (``ZLANE_W128_ROUTES``), whose slices
    grow with the word.  Codes with rows of more than 121 members
    run on ``fused_zlane``, one frame per thread block at a time,
    each block with K*Z*4 bytes of global c2v scratch (default: two blocks
    per streaming multiprocessor).  ``batch_tile``, for any of them, caps
    the frames in flight (at least one block's).  Requires Z % 8 == 0, as
    the JAX builder does.
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
    """Fused sum-product (belief propagation) decoder, flooding: on
    ``retire_sumproduct`` where it takes the code, ``retire_sumproduct_wide``
    for rows of 28 to 58 members, ``retire_sumproduct_w128`` for rows of 59
    to 121, else ``fused`` — see make_fused_minsum."""
    return make_fused_minsum(qc, max_iterations, alpha=1.0, batch_tile=batch_tile,
                             mode="sumproduct", device=device)
