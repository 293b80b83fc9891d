// Fused trained neural / offset min-sum decoder for Hopper (sm_90a): the
// whole decode of a trained NeuralMinSumDecoder in one kernel launch.
//
// Replaces the TPU kernel of ldpc_tpu/ops/pallas_neural.py:111 (`kernel`
// of make_fused_neural_minsum, :87) with three kernels:
//   * neural_group_kernel<POW2, L, STAGED, Word>, entry ldpc_neural_group
//     (slice 0): codes with rows of at most 121 members whose whole frame
//     fits a block: serve_trained_decoder --model neural_minsum, the OMS
//     flagship record (chip_smoke.py nms_main), depth 4 at Z=32, and
//     (nms_wide) the high-rate codes of rows of 32 and 64 and depth 6 at
//     Z=32.  Described below; its state word and depths past 4 at item 7.
//   * neural_group_slice_kernel<POW2, L, WSLICE, Word>, the same entry
//     (slice 1 or 2): the same codes where a frame exceeds a block (NR BG2
//     from Z of about 96 at depth 2 to Z=384; chip_smoke.py nms_large), with
//     its FIFO and, where A and the column sums leave no room, its state
//     words in an L2 slice.  Described at item 6 below.
//   * neural_minsum_kernel<SHARED>, entry ldpc_neural_minsum: the rest
//     (rows over 121 members), and through the wrapper's side door
//     (FusedNeuralDecoder._launch_minsum) any code, so the kernels can be
//     timed side by side.  Described at its section at the end.
// Python wrapper, weight packing (_pack_weights, check-aligned planes
// _Tables.wc) and the plain PyTorch version both are held against
// (neural_decode_plain): ldpc_tpu_torch/ops/fused_neural.py; a CPU model of
// neural_group's algorithm on the wrapper's tables:
// tests/test_torch_neural_group.py.  Built with -fmad=false: no a * b + c
// is contracted into an FMA, so w * llr and the residual taps round as the
// plain version rounds them, and the decisions are bit-identical.
//
// What it computes, per frame (the TPU kernel's order)
// ----------------------------------------------------
// Messages are var-aligned per base edge k: x[k*Z + v] belongs to variable
// (col[k], v) and to check (row[k], (v - shift[k]) mod Z); lifted check
// (r, z) reaches, through member k, the lane (z + shift[k]) mod Z.
//   seed:  q = the channel LLR of the edge's variable; c2v = 0; the FIFO
//          slots after the first are 0.  The FIFO holds max(L, 1) slots,
//          newest first; slot 0 is q itself (the TPU kernel's alias).
//   T times, iteration t:
//     check half: running m1, m2 (sentinel 1e9) and sign product
//       (sign(0) = +1) over the check's members of q; per member
//       loo = |x| > m1 ? m1 : m2;  loo = loo < 1e9 ? loo : 0;
//       loo = max(loo - offset[t], 0);  c2v = alpha[t] * sp * sign(x) * loo.
//     variable half, skipped at t = T - 1 (it feeds nothing):
//       colsum = sum of the variable's c2v in col_members order (from 0);
//       res    = sum over l < L of w_res[t, l] * slot_l (from 0);
//       q_new  = ((colsum - c2v) + w[t][k, z] * llr) + live * res;
//       slot_l = live * slot_{l-1} for l = max(L, 1) - 1 down to 1;  q = q_new.
//       live is 0 at t = 0, 1 after: at t = 0 slot 0 still holds the seed,
//       and the model's FIFO starts at zeros.
//   output: bits = llr + colsum(c2v) < 0.
// w is the channel weight per lifted edge, one plane per iteration
// (per_iteration) or one shared plane: edge, cell, type and scalar sharing
// are expanded to (K, Z) by the wrapper, as the TPU kernel's packing does.
//
// What bounds it on the card
// --------------------------
// Operations the decode needs per frame, whatever this source does (T
// iterations, no early stop; E = K*Z lifted edges, M = R*Z lifted checks,
// n = C*Z variables):
//   check half, T times:   per edge: abs, sign-product fold, min (m1), max
//     and min (m2), leave-one-out select, sign apply = 7 float32; per check:
//     m1 - offset, m2 - offset, two clamps at 0, two sentinel selects,
//     alpha * m1, alpha * m2 = 8 float32;
//   variable half, T - 1 times, per edge: column-sum add, subtract own,
//     w * llr, add = 4 float32; L taps: L multiplies and L adds = 2L;
//   output, per variable: its column sum (E adds in all), llr + sum,
//     decision = E + 2n float32.
// None is an FMA (the function rounds every product), so float32 runs at
// half the data sheet's 67 TFLOP/s: 33.5e12 per second.  LLRs are read and
// bits written once (8n bytes a frame) at 3.35e12 bytes per second; the
// weights (T * E * 4 bytes) once per launch.
// Main path (nr_2_0_32 Z=32: E=6304, M=1344, n=1664; T=10, L=2, batch
// 65536): T (7E + 8M) + (T - 1)(4 + 2L) E + E + 2n = 1.012e6 operations a
// frame, 6.63e10 in all: 1.98 ms; the bytes take 0.26 ms.  The bound is
// arithmetic.  chip_smoke.py nms_large: Z=128 (batch 16384) and Z=384
// (5461) at depth 2 have the same edges a batch, 1.98 ms; Z=32 at depth 4
// (65536) 2.42 ms.  The FIFO's traffic (a tap read for each message stored
// and one write a pass: 39.7 GB a batch at Z=128 depth 2) is the design's,
// not the function's, and no part of the bound.
//
// neural_group_kernel: what its design does about it
// --------------------------------------------------
// It takes fused_retire.cu's skeleton (retire.cuh: frame groups, named
// barriers, the structure tables and the 12-byte check state) without its
// retirement: a trained decoder returns the decisions after exactly T check
// halves (its weights change per iteration, so a frame whose checks hold at
// t < T may still change its bits), so no frame leaves early and no parity
// pass runs.
// 1. Balanced frame groups.  A frame is decoded by `parts` * ceil(Z / 32)
//    warps (up to 16), thread = lane z, so a roll by s is an index, (z + s)
//    & (Z - 1) under POW2, else a conditional subtract; nothing divides in
//    the passes.  Parts are contiguous ranges of rows and of columns cut to
//    equal work (fused_minsum.py _balanced_bounds), and a group meets only
//    at its own named barrier, twice an iteration.  At Z <= 16 a group
//    decodes 32 / Z frames side by side (lane = frame * Z + z): frames that
//    never leave early can share a warp's passes, where one frame would
//    leave 32 - Z lanes idle (chip_smoke.py's serve phase, nr_2_0_4 Z=4,
//    batch 4096 with codewords and channel: 1.200 ms with one frame a
//    group, 0.564 ms with 8; nms_serve_shape times the kernel alone).
// 2. Compressed check state: A = (alpha * max(m1' - offset, 0), alpha *
//    max(m2' - offset, 0)), m' being m with the 1e9 sentinel replaced by 0,
//    in the plain version's order (sentinel, subtract, clamp, multiply), and
//    the word W: output signs and argmin.  Exact: ((alpha * sp) * sign) *
//    loo is +-(alpha * loo), since products of +-1 do not round, and at a
//    tie every tied member's loo is the same; a negative alpha or offset
//    changes none of that, and a zero c2v keeps the plain version's sign.
// 3. v2c rebuilt in the check pass; no q or c2v array.  The column pass
//    writes one float a variable, cs, its c2v summed from +0.0 in
//    col_members order (the last column pass writes the bits, llr + cs <
//    0).  Check pass t + 1 rebuilds each member's message from cs, its old
//    c2v (from the check's own state, in registers until the new state is
//    written), w_t * llr and the taps (check_row below), and folds it.  T
//    check passes and T column passes, where neural_minsum_kernel runs T
//    check halves, T - 1 variable halves and an output pass.
// 4. A check-aligned FIFO of L floats a lifted edge: the edge at row-order
//    position i and check lane z is at i*Z + z, so a warp's accesses are 32
//    consecutive words and only the thread of check (r, z) touches them; a
//    ring indexed by t mod L replaces the slot-by-slot shift.  At L = 0 a
//    frame keeps no per-edge state at all.
// 5. Channel weights, check-aligned too (the wrapper repacks them, planes
//    padded to 16 bytes).  STAGED: each iteration's plane (K*Z floats,
//    25,216 B at Z=32) is copied into shared memory with cp.async, double-
//    buffered, during the iteration before the one that reads it; since no
//    frame retires, the groups of a block meet at a block barrier once an
//    iteration.  Else each weight is read from L2 (14.9 GB of reads for the
//    main batch).  The wrapper stages wherever a plan with the planes fits
//    (at depth 2 up to Z = 32).
// 6. The slice forms (neural_group_slice_kernel), for frames that exceed a
//    block: a whole frame, 4 (2 C*Z + 3 R*Z + L K*Z) bytes, is 319,488 B at
//    NR BG2 Z=128 depth 2.  A and the column sums stay in shared memory (the
//    check pass reads each member's cs, the column pass each edge's A), and
//    so do the state words W where they fit beside them (slice 1: 4 (3 R*Z
//    + C*Z) bytes a frame, 91,136 at Z=128); the FIFO, L planes of K*Z
//    floats (201,728 B at Z=128 depth 2), lives in the frame's slice of a
//    global scratch, and at Z=384 (slice 2: A and cs alone are 208,896 B)
//    W too (669,696 B a slice).  The LLRs are read from the frame's input
//    row, the weights from L2.  A slice entry is touched in the check pass
//    only by its check's thread (the FIFO is check-aligned, item 4), so the
//    slice needs no barrier; ordinary coherent loads read it.  L2: one
//    frame group an SM puts 132 slices in flight, 26.6 MB at Z=128 depth 2
//    in slice 1, 88 MB at Z=384 (over the 50 MB L2 whatever the plan); two
//    put 53 MB at Z=128.  The wrapper keeps a layout per shape by
//    measurement (nms_large's sweep): the whole frame in shared memory
//    wherever it fits (the slice forms ran 19-30% slower at Z=32 depth 4),
//    else slice 1 (6-9% faster than slice 2 at Z=128), else slice 2; and
//    the most groups an SM whose slices fit the L2, then the most parts
//    (one group of 32 warps at Z=128: two groups of 16 ran 27-31% slower).
// Shared memory: the structure (6K + R + C + 2 ints and two part tables,
// 5,232 B at NR BG2 and 14 parts) and, staged, two weight planes once a
// block; per frame 4 (2 C*Z + 3 R*Z + L K*Z) bytes: LLRs, cs, check state,
// FIFO: 79,872 at NR BG2 Z=32, L=2 (29,440 at L=0; 130,304 at L=4, one
// frame a block).  The wrapper takes, of the plans of at most 14 warps a
// group where an SM holds two groups or more (the parts sweep: 14 parts ran
// 2-5% faster than 16 at nms_main), the one with the most resident frames
// by the runtime's occupancy query, then the most parts: main path, 2
// frames of 14 parts (28 warps) in one block per SM with the staged
// planes; 54-64 registers a thread, no spills.  A group alone on its SM
// takes the most parts (32 warps at Z=32 depth 4).  The slice forms hold 4
// (3 R*Z + C*Z) or 4 (2 R*Z + C*Z) bytes a frame.
// 7. Rows of 28 to 121 members and FIFOs deeper than 4 (routes
//    neural_group_wide, neural_group_w128; chip_smoke.py nms_wide).  Both
//    kernels take the state word W as a template parameter (Word,
//    retire.cuh), as fused_retire.cu's B1 kernels do: unsigned (27 output
//    signs and a 5-bit argmin, 12 bytes a check with A), unsigned long long
//    (58 signs, 6-bit argmin, 16 bytes) for rows of 28 to 58 members, and
//    Word128 (two 64-bit limbs, 121 signs, 7-bit argmin, 24 bytes) for rows
//    of 59 to 121.  The wrapper encodes the structure's column members for
//    the word (j, bits - 1 - j), and every operation on W is an overload of
//    retire.cuh (push_sign's carry between the limbs, product_flips' mask
//    across them, argmin_of, is_argmin, member_sign); the check pass folds
//    members d - 1 .. 27 (64-bit) from a switch of their own and d - 1 ..
//    58 (128-bit) in a loop before it.  A frame's state grows to 4 or 6
//    words a check: 4 (2 C*Z + 4 R*Z + L K*Z) bytes a frame on the 64-bit
//    word (120,832 at wide_rows' code, depth 2); the slice forms' column
//    sums are padded to an even count so that W after them stays 8-byte
//    aligned.  A W entry has one owner thread, its check's, in every
//    layout: the 128-bit word's two limbs are written by it alone and read
//    by others only after the group's barrier, so no store is torn.
//    Depth: the forms of their own, L = 0..4, keep the taps and the FIFO
//    offsets of slot (t - l) mod L in registers, each tap unrolled; a
//    deeper FIFO runs the form of run-time depth (L = kRunDepth), whose
//    depth rides in `flags` above per_iteration, whose taps are read from
//    the parameters through the read-only cache (one address a warp, where
//    the forms of their own read them once a pass) in a loop of min(L, t)
//    taps, and whose FIFO offset steps down one plane a tap from slot t mod
//    L, wrapping from slot 0 to L - 1, so no tap divides.  The FIFO is L
//    planes of K*Z floats in whatever layout holds the frame (deep FIFOs
//    take the slice forms, whose shared memory does not grow with L; NR
//    BG2 Z=32 keeps a whole frame up to depth 7, 205,952 B); the only limit
//    is the FIFO's 32-bit offsets, (L + 1) K*Z < 2^30 words.  The kernels
//    live in neural_group.cuh: this source instantiates them on the 32-bit
//    word, fused_neural_wide.cu and fused_neural_w128.cu on the other two,
//    48 kernels each, one nvcc run a source side by side (one source of
//    all 146 took 327 s).  The 32-bit forms of depth 0..4 compile as they
//    did before Word and the run-time form existed
//    (tools/probe_sass_diff.py against the parent tree).  Measured
//    (chip_smoke.py nms_wide, NVIDIA H100 80GB HBM3, 700.00 W): 31.5 ms at
//    rows of 32 (Z=64, batch 65536), 65.9 ms at rows of 64 (p = 67, 49152),
//    30.9 ms at NR BG2 Z=32 depth 6 (65536), where neural_minsum_kernel
//    took 77.0, 95.4 and 94.5 ms in the same call (PERF.md).
// Measured (chip_smoke.py nms_main, NVIDIA H100 80GB HBM3, 700.00 W):
// 13.29 ms per batch of 65536, where neural_minsum_kernel took 38.58 ms in
// the same call (2.90x), 15% of the bound; the weights read from L2 14.28
// ms; depth 0 10.95 ms (depth 2 is 1.21x it).  nms_large: 20.57 ms at
// Z=128 depth 2 (slice 1, 8 parts), 35.55 ms at Z=384 (slice 2, 2 parts),
// 18.51 ms at Z=32 depth 4 (32 parts), where neural_minsum_kernel took
// 75.68, 73.24 and 83.54 ms in the same call (PERF.md).

#include <cuda_runtime.h>

#include "retire.cuh"

namespace {
using NeuralWord = unsigned;  // this library's neural_group: rows of up to 27 members
}  // namespace

#include "neural_group.cuh"

namespace {

constexpr int kMaxFramesPerBlock = 32;  // neural_minsum_kernel
// At one frame a block (Z=32) two blocks fit an SM; 512 threads a block
// hide more shared-memory latency than 256 (PERF.md section 6, B3's times).
constexpr int kThreads = 512;

struct Graph {
  const int* row_ptr;   // (R+1) offsets into row_edge
  const int* row_edge;  // (K) base edges of each row, in row order
  const int* col_ptr;   // (C+1) offsets into col_edge
  const int* col_edge;  // (K) base edges of each column, in col_members order
  const int* shift;     // (K) circulant shift mod Z
  const int* col;       // (K) base column
  int Z, R, C, K;
};

struct Args {
  const float* llr;     // (B, n)
  float* bits;          // (B, n)
  const int* graph;     // row_ptr, row_edge, col_ptr, col_edge, shift, col
  const float* w;       // (per_iteration ? T : 1, K, Z) channel weights
  const float* params;  // alpha (T), offset (T), w_res (T, max(L, 1))
  float* scratch;       // SHARED = false: (grid, (1 + max(L, 1)) * K * Z)
  int B, Z, R, C, K, T, L, per_iteration, fpb;
};

__host__ __device__ inline int round4(int x) { return (x + 3) / 4 * 4; }
__host__ __device__ inline int graph_words(int R, int C, int K) {
  return round4(4 * K + R + C + 2);
}
__host__ __device__ inline int slots_of(int L) { return L > 1 ? L : 1; }
__host__ __device__ inline int param_words(int T, int L) { return round4(T * (2 + slots_of(L))); }

// Floats of state a frame needs besides its LLRs: c2v, q, FIFO slots 1.. .
__host__ __device__ inline long long state_floats(int Z, int K, int L) {
  return static_cast<long long>(1 + slots_of(L)) * K * Z;
}

long long smem_bytes(int Z, int R, int C, int K, int T, int L, int fpb, bool shared) {
  const long long per_frame = C * Z + (shared ? state_floats(Z, K, L) : 0);
  return 4LL * (graph_words(R, C, K) + param_words(T, L) + (shared ? fpb : 1) * per_frame);
}

__device__ __forceinline__ float sign_of(float x) { return x < 0.0f ? -1.0f : 1.0f; }

__device__ __forceinline__ int lane_of(const Graph& g, int k, int z) {
  const int v = z + g.shift[k];
  return v >= g.Z ? v - g.Z : v;
}

// Check update of lifted check (r, z) of one frame: q and c2v (K*Z each).
__device__ __forceinline__ void check_update(const Graph& g, const float* q, float* c2v, int r,
                                             int z, float alpha, float offset) {
  const int j0 = g.row_ptr[r], j1 = g.row_ptr[r + 1];
  float m1 = kBig, m2 = kBig, sp = 1.0f;
  for (int j = j0; j < j1; ++j) {
    const int k = g.row_edge[j];
    const float x = q[k * g.Z + lane_of(g, k, z)];
    const float mag = fabsf(x);
    sp = sp * sign_of(x);
    const float new_min = fminf(mag, m1);
    m2 = fminf(fmaxf(mag, m1), m2);
    m1 = new_min;
  }
  for (int j = j0; j < j1; ++j) {
    const int k = g.row_edge[j];
    const int e = k * g.Z + lane_of(g, k, z);
    const float x = q[e];
    float loo = fabsf(x) > m1 ? m1 : m2;
    loo = loo < kBig ? loo : 0.0f;
    loo = fmaxf(__fsub_rn(loo, offset), 0.0f);
    c2v[e] = __fmul_rn(__fmul_rn(__fmul_rn(alpha, sp), sign_of(x)), loo);
  }
}

__device__ __forceinline__ float column_sum(const Graph& g, const float* c2v, int c, int z) {
  float cs = 0.0f;
  for (int j = g.col_ptr[c]; j < g.col_ptr[c + 1]; ++j)
    cs = __fadd_rn(cs, c2v[g.col_edge[j] * g.Z + z]);
  return cs;
}

// Decodes nf frames with the whole block.  llr holds the frames' LLRs one
// after another (n floats a frame), c2v and q E floats a frame, fifo
// (slots - 1) * E floats a frame; bits are the frames' rows of the output.
// s_par holds alpha, offset and w_res.  Ends with a barrier.
__device__ __forceinline__ void decode_tile(const Graph& g, const Args& a, const float* s_par,
                                            const float* llr,
                                            float* c2v, float* q, float* fifo,
                                            float* __restrict__ bits, int nf) {
  const int Z = g.Z, n = g.C * Z, E = g.K * Z, M = g.R * Z;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int L = a.L, S = slots_of(L), T = a.T;
  const float* alpha = s_par;
  const float* offset = s_par + T;
  const float* w_res = s_par + 2 * T;  // (T, S)

  for (int i = tid; i < nf * E; i += nt) {
    const int f = i / E, e = i - f * E, k = e / Z;
    c2v[i] = 0.0f;
    q[i] = llr[f * n + g.col[k] * Z + (e - k * Z)];
  }
  for (int i = tid; i < nf * (S - 1) * E; i += nt) fifo[i] = 0.0f;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    for (int i = tid; i < nf * M; i += nt) {
      const int f = i / M, rz = i - f * M, r = rz / Z;
      check_update(g, q + f * E, c2v + f * E, r, rz - r * Z, alpha[t], offset[t]);
    }
    __syncthreads();
    if (t + 1 == T) break;  // the last variable half feeds nothing

    const float live = t > 0 ? 1.0f : 0.0f;
    const float* w = a.w + (a.per_iteration ? static_cast<size_t>(t) * E : 0);
    const float* taps = w_res + t * S;
    for (int i = tid; i < nf * n; i += nt) {
      const int f = i / n, v = i - f * n, c = v / Z, z = v - c * Z;
      const float* c2v_f = c2v + f * E;
      float* q_f = q + f * E;
      float* fifo_f = fifo + static_cast<size_t>(f) * (S - 1) * E;
      const float cs = column_sum(g, c2v_f, c, z);
      const float x = llr[i];
      for (int j = g.col_ptr[c]; j < g.col_ptr[c + 1]; ++j) {
        const int e = g.col_edge[j] * Z + z;
        float res = 0.0f;  // slot 0 is q, slot l >= 1 is fifo slot l - 1
        for (int l = 0; l < L; ++l)
          res = __fadd_rn(res, __fmul_rn(taps[l], l == 0 ? q_f[e] : fifo_f[(l - 1) * E + e]));
        const float q_new = __fadd_rn(
            __fadd_rn(__fsub_rn(cs, c2v_f[e]), __fmul_rn(__ldg(w + e), x)), __fmul_rn(live, res));
        for (int l = S - 1; l >= 1; --l)
          fifo_f[(l - 1) * E + e] = __fmul_rn(live, l == 1 ? q_f[e] : fifo_f[(l - 2) * E + e]);
        q_f[e] = q_new;
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < nf * n; i += nt) {
    const int f = i / n, v = i - f * n, c = v / Z;
    const float cs = column_sum(g, c2v + f * E, c, v - c * Z);
    bits[i] = __fadd_rn(llr[i], cs) < 0.0f ? 1.0f : 0.0f;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// neural_minsum_kernel (the first port of B3)
// ---------------------------------------------------------------------------
//
// One thread owns one lifted check (check half) or one variable (variable
// half: its column sum, then each of its messages), and walks CSR structure
// arrays in shared memory; a roll by s is the index (z + s) mod Z.  LLRs are
// read as they come, (B, n) row-major.  The per-iteration channel weights
// stay in global memory, where L2 holds them for every block; alpha, offset
// and the taps go to shared memory.  The state of a frame (c2v, q and
// max(L, 1) - 1 more FIFO slots: (1 + max(L, 1)) * E floats, 75 KB at Z=32
// L=2, plus its LLRs) stays in shared memory, `fpb` frames a block (SHARED
// = true).  Where one frame's state does not fit (above Z of about 100 at
// L=2) it lives in a global scratch slice per block, reused frame after
// frame, and only the LLRs stay in shared memory (SHARED = false).  Its
// warps are uneven (a warp owns whole rows or columns, whose degrees run
// from 1 to 23 on NR BG2), every half ends at a block barrier, and it keeps
// c2v, q and the FIFO as full floats: at nms_main depth 2 takes 1.33x the
// time of depth 0 (chip_smoke.py variants_ms, no_taps_replaced).
//
// B3, pallas_neural.kernel.  SHARED: `fpb` frames a block, all state in
// shared memory.  Otherwise: frames f = blockIdx.x, + gridDim.x, ..., one at
// a time, state in the block's global scratch slice.
template <bool SHARED>
__global__ void __launch_bounds__(kThreads) neural_minsum_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int Z = a.Z, R = a.R, C = a.C, K = a.K;
  const int n = C * Z, E = K * Z, S = slots_of(a.L);
  const int tid = threadIdx.x, nt = blockDim.x;

  int* s_graph = reinterpret_cast<int*>(smem);
  for (int i = tid; i < 4 * K + R + C + 2; i += nt) s_graph[i] = a.graph[i];
  float* s_par = smem + graph_words(R, C, K);
  for (int i = tid; i < a.T * (2 + S); i += nt) s_par[i] = a.params[i];
  float* s_llr = s_par + param_words(a.T, a.L);
  Graph g;
  g.row_ptr = s_graph;
  g.row_edge = g.row_ptr + R + 1;
  g.col_ptr = g.row_edge + K;
  g.col_edge = g.col_ptr + C + 1;
  g.shift = g.col_edge + K;
  g.col = g.shift + K;
  g.Z = Z;
  g.R = R;
  g.C = C;
  g.K = K;

  if (SHARED) {
    const int f0 = blockIdx.x * a.fpb;
    const int nf = min(a.fpb, a.B - f0);
    float* c2v = s_llr + a.fpb * n;
    float* q = c2v + a.fpb * E;
    float* fifo = q + a.fpb * E;
    const float* llr_tile = a.llr + static_cast<size_t>(f0) * n;
    for (int i = tid; i < nf * n; i += nt) s_llr[i] = llr_tile[i];
    __syncthreads();
    decode_tile(g, a, s_par, s_llr, c2v, q, fifo, a.bits + static_cast<size_t>(f0) * n, nf);
  } else {
    float* c2v = a.scratch + static_cast<size_t>(blockIdx.x) * state_floats(Z, K, a.L);
    float* q = c2v + E;
    float* fifo = q + E;
    for (int f = blockIdx.x; f < a.B; f += gridDim.x) {
      const size_t off = static_cast<size_t>(f) * n;
      for (int i = tid; i < n; i += nt) s_llr[i] = a.llr[off + i];
      __syncthreads();
      decode_tile(g, a, s_par, s_llr, c2v, q, fifo, a.bits + off, 1);
    }
  }
}

template <bool SHARED>
cudaError_t prepare(long long smem) {
  return cudaFuncSetAttribute(neural_minsum_kernel<SHARED>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs.
long long ldpc_neural_smem_bytes(int Z, int R, int C, int K, int T, int L, int fpb, int shared) {
  return smem_bytes(Z, R, C, K, T, L, fpb, shared != 0);
}

// Floats of global scratch one block needs when the state is not shared.
long long ldpc_neural_scratch_floats(int Z, int K, int L) { return state_floats(Z, K, L); }

// Resident blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or
// -cudaError_t.
int ldpc_neural_occupancy(int Z, int R, int C, int K, int T, int L, int fpb, int shared) {
  const long long smem = smem_bytes(Z, R, C, K, T, L, fpb, shared != 0);
  int blocks = 0;
  cudaError_t err = shared ? prepare<true>(smem) : prepare<false>(smem);
  if (err == cudaSuccess)
    err = shared ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &blocks, neural_minsum_kernel<true>, kThreads, smem)
                 : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &blocks, neural_minsum_kernel<false>, kThreads, smem);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// The entry point of neural_minsum_kernel (pallas_neural.kernel).  shared:
// `fpb` frames a block in shared memory, grid ceil(B / fpb); otherwise
// `grid` blocks, each with its slice of `scratch`.  Launches on `stream`, no
// sync; returns a cudaError_t (0 on success).
int ldpc_neural_minsum(const void* llr, void* bits, const void* graph, const void* w,
                       const void* params, void* scratch, int B, int Z, int R, int C, int K, int T,
                       int L, int per_iteration, int fpb, int shared, int grid, void* stream) {
  if (B < 1 || T < 1 || L < 0) return cudaErrorInvalidValue;
  if (shared ? (fpb < 1 || fpb > kMaxFramesPerBlock) : grid < 1) return cudaErrorInvalidValue;
  Args a;
  a.llr = static_cast<const float*>(llr);
  a.bits = static_cast<float*>(bits);
  a.graph = static_cast<const int*>(graph);
  a.w = static_cast<const float*>(w);
  a.params = static_cast<const float*>(params);
  a.scratch = static_cast<float*>(scratch);
  a.B = B;
  a.Z = Z;
  a.R = R;
  a.C = C;
  a.K = K;
  a.T = T;
  a.L = L;
  a.per_iteration = per_iteration;
  a.fpb = shared ? fpb : 1;
  const long long smem = smem_bytes(Z, R, C, K, T, L, fpb, shared != 0);
  cudaError_t err = shared ? prepare<true>(smem) : prepare<false>(smem);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (shared)
    neural_minsum_kernel<true><<<(B + fpb - 1) / fpb, kThreads, smem, s>>>(a);
  else
    neural_minsum_kernel<false><<<grid, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

}  // extern "C"
