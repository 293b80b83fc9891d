// Scaled min-sum and sum-product for Hopper (sm_90a): a frame's whole
// decode in one group of warps, and frames that leave the kernel the
// iteration they converge.
//
// Replaces, for mode "minsum" and for sum-product flooding, the TPU kernels
// of ldpc_tpu/ops/pallas_minsum.py:
//   * retire_minsum_kernel<TRACK, POW2>  <- _kernel (make_fused_minsum),
//                                           flooding: the bench.py headline
//                                           and the port's main path; entry
//                                           ldpc_retire_minsum
//   * retire_zlane_kernel<TRACK, POW2>   <- _kernel_zlane
//                                           (make_fused_minsum_zlane),
//                                           flooding at large Z (bench.py's
//                                           z384 section); entry
//                                           ldpc_retire_zlane
//   * retire_layered_kernel<TRACK, POW2> <- _kernel, schedule "layered"
//                                           (make_fused_minsum(schedule=
//                                           "layered"), MinSumScaledDecoder(
//                                           schedule="layered")); entry
//                                           ldpc_retire_layered
//   * retire_sumproduct_kernel<TRACK, POW2> <- _kernel, mode "sumproduct",
//                                           flooding (make_fused_bp,
//                                           BeliefPropagationDecoder); entry
//                                           ldpc_retire_sumproduct
//   * retire_zlane_layered_kernel<TRACK, POW2>
//                                        <- _kernel_zlane, schedule "layered"
//                                           (make_fused_minsum_zlane(schedule=
//                                           "layered"), MinSumScaledDecoder(
//                                           schedule="layered") at large Z);
//                                           entry ldpc_retire_zlane_layered
//   * retire_zlane_sumproduct_kernel<TRACK, POW2>
//                                        <- _kernel_zlane, mode "sumproduct",
//                                           flooding (BeliefPropagationDecoder
//                                           at large Z); entry
//                                           ldpc_retire_zlane_sumproduct
//   * retire_layered_sumproduct_kernel<TRACK, POW2>
//                                        <- _kernel, mode "sumproduct",
//                                           schedule "layered"; entry
//                                           ldpc_retire_layered_sumproduct
//   * retire_zlane_layered_sumproduct_kernel<TRACK, POW2>
//                                        <- _kernel_zlane, mode "sumproduct",
//                                           schedule "layered"; entry
//                                           ldpc_retire_zlane_layered_sumproduct
// They took the place of fused_minsum_kernel and zlane_minsum_kernel
// (fused_minsum.cu) on every path.  All eight, templated on the state word
// (retire.cuh), also run on a 64-bit word for rows of 28 to 58 members (the
// wrapper's *_wide routes; see "Rows of 28 to 58 members" below) and on a
// 128-bit word of two limbs for rows of 59 to 121 (the *_w128 routes; see
// "Rows of 59 to 121 members" and, for the four large-Z kernels, "Large Z
// on the wider words"); codes with wider rows stay on the fused_minsum.cu
// kernels (the wrapper's retire_*_fits).
// The flooding kernels run one frame loop (decode_frames) over a check pass
// and a column pass: the two min-sum kernels share compressed state and
// passes and differ only in where a frame's state lives; the two sum-product
// kernels keep one float a lifted edge and have their own passes, described
// at their section below.  The four layered kernels run one frame loop
// (layered_frames) over a row update of their own check state (min-sum's
// state words, sum-product's c2v), and are described at their own
// sections.  Python wrapper and
// the plain PyTorch version all are held against (fused_decode_plain):
// ldpc_tpu_torch/ops/fused_minsum.py.  CPU models of this source's
// algorithms on the wrapper's structure tables:
// tests/test_torch_minsum_retire.py (min-sum flooding),
// tests/test_torch_minsum_layered.py (layered),
// tests/test_torch_minsum_sumproduct_retire.py (sum-product),
// tests/test_torch_zlane_retire_sched.py (both at large Z, the state as
// the slices lay it out), tests/test_torch_layered_sumproduct_retire.py
// (layered sum-product, in shared memory and in the slices).
//
// The min-sum flooding kernels
// ============================
//
// What it computes (the TPU kernel's order)
// -----------------------------------------
// Lifted check (r, z) reaches, through member j of base row r (base edge k),
// the variable (col[k], (z + shift[k]) mod Z).  Per iteration every check
// takes v2c = belief - c2v for its members, folds |v2c| into a running
// (m1, m2) with the 1e9 sentinel and v2c < 0 into a sign product (sign(0) =
// +1), and sends member j  c2v = alpha * sp * sign(v2c_j) * loo_j  with
// loo_j = |v2c_j| > m1 ? m1 : m2, 0 where it is the sentinel; then every
// belief is  llr + (the variable's c2v summed from 0 in col_members order).
// With tracking, the first iteration whose hard decisions satisfy every
// check freezes the frame's bits and sets conv_iter; without, all
// max_iterations run and conv_iter = max_iterations.  Bits and conv_iter
// are identical to the plain version and to the JAX package.
//
// What bounds it on the card
// --------------------------
// The operations the decode needs per iteration of one frame, whatever this
// source does (counted in fused_minsum.cu): per lifted edge 9 float32 and 1
// int32, per lifted check 4 + 1, per variable 2 + 0; float32 at 33.5e12 per
// second (no FMA), int32 at 16.75e12.  A frame needs conv_iter iterations:
// later ones change neither its bits nor conv_iter.  Main path (nr_2_0_32
// Z=32, B=65536, 3 dB, mean conv_iter 3.014): 0.476 ms of operations against
// 0.26 ms of bytes (LLRs read, bits written once).  z384 (nr_2_0_32 Z=384,
// B=512, 3 dB, mean conv_iter 3.32): 0.049 ms of operations.
//
// What the design does about it
// -----------------------------
// 1. Frames retire.  A frame's bits and conv_iter do not depend on the
//    iterations after it converges, so its group stops there, writes the
//    bits and takes the next frame from an atomic counter (a persistent grid
//    of the blocks that can be resident).  In throughput mode no frame
//    retires; early_exit changes nothing here, the outputs being the same.
// 2. Compressed check state.  A check's c2v is kept as A = (alpha * m1,
//    alpha * m2), sentinel already 0, and a word W: the output sign of
//    member j at bit j (27 bits) and the argmin in the top 5 bits; 12 bytes
//    a check, 16 KB a frame at Z=32 where 25 KB of c2v floats were.  Member
//    j's c2v is (j == argmin ? A.y : A.x) with sign bit j of W.  Exact:
//    alpha * sp * sign * loo is +-(alpha * loo), since products of +-1 do not
//    round, and at a tie (m1 == m2) every tied member's loo is the same.  So
//    the check pass reads each member's belief once and writes 12 bytes a
//    check, where the replaced kernels read belief and c2v twice per edge
//    and wrote c2v per edge.
// 3. Syndrome folded into the check pass.  Iteration t's check pass reads
//    the beliefs of iteration t - 1 before the column pass overwrites them,
//    so it XORs their hard decisions per check on the way; a vote of the
//    group (bar.red.or, __any_sync for one warp) is the barrier between the
//    passes.  If no check is violated the frame converged at iteration t - 1
//    and its frozen bits are those same beliefs, still in shared memory.
//    The last iteration needs no parity pass: whether or not its beliefs
//    satisfy the checks, the outputs are conv_iter = max_iterations and
//    their decisions.
// 4. No run-time division: a thread's lane z and its rows and columns are
//    fixed, frame offsets are computed once per frame, and a roll by s is
//    (z + s) & (Z - 1) for Z a power of two (POW2; the block's offset, a
//    multiple of Z, is OR-ed in), else  v = z + s; v -= v >= Z ? Z : 0.  The
//    structure holds each member's belief offset col*Z and shift (row
//    members) and its row's state offset r*Z, shift, position and sign shift
//    (column members).  The members of a row are folded from a switch on
//    the row's degree that falls through, last member first, so each
//    member's position is a constant.
// 5. Barriers and occupancy.  A frame group is ceil(Z / 32) warps per part
//    (thread = z, so a warp's shared-memory accesses are a rotation of 32
//    consecutive words: conflict-free) and `parts` parts, each a contiguous
//    range of rows and of columns cut to about equal work.  The group's two
//    barriers an iteration are a named barrier of its own (bar.sync id, n;
//    __syncwarp for a group of one warp); groups of a block share only the
//    structure.  The wrapper picks parts (up to 4) and frames per block by
//    the runtime's occupancy query.
// 6. Large Z (retire_zlane_kernel).  A whole frame, 4 (2 C*Z + 3 R*Z)
//    bytes, is 353 KB at Z=384, over the 227 KB a block can use.  So one
//    frame group a block keeps in shared memory the beliefs (C*Z floats) and
//    A (R*Z float2), which the column pass reads per edge (8 bytes) and the
//    check pass per member; the state words W (R*Z, 4 bytes per edge in the
//    column pass) live in the block's slice of a global scratch, 64.5 KB at
//    Z=384, which stays in L2 (132 slices, 8.5 MB); the column pass reads
//    the LLRs from the frame's input row.  L2 sees about 0.5 MB a frame and
//    iteration, where the replaced kernel moved about 1.2 MB of c2v floats
//    through a 303 KB slice a frame (80 MB in flight, over the 50 MB L2).
//
// Shared memory: the structure (6K + R + C + 2 ints and two part tables,
// 5.0 KB for NR BG2) once a block, and per frame of retire_minsum_kernel the
// beliefs and the LLRs (C*Z floats each) and the check state (3 R*Z words):
// 4 (2 C*Z + 3 R*Z) bytes, 29,440 at NR BG2 Z=32.  Main path: 7 frames of 4
// parts (28 warps, 896 threads) in one block per SM, 57-62 registers a
// thread (ptxas), no spills.  retire_zlane_kernel: 4 (C*Z + 2 R*Z) bytes of
// frame state, 208,896 at Z=384 (2 parts: 24 warps, one block per SM).  A
// row may have at most 27 members on the 32-bit state word (NR rows have at
// most 19), 58 on the 64-bit one and 121 on the 128-bit one.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W): main path
// about 3.2 ms per batch of 65536, throughput mode 16.2 ms; the kernel it
// replaced took 48.6 and 34.2 ms on the same card and batch.  Most
// instructions of both passes are compares, selects, min/max and logic
// (cuobjdump -sass of the built library).  z384: about 0.60 ms per batch
// of 512 (58 registers, 24 warps a block, one block per SM), throughput
// mode 2.7 ms, where zlane_minsum_kernel took 6.95 ms.  What sets its pace
// is the warps a frame: with one part (12 warps) it takes 1.55x as long;
// the L2 slice costs 7-13% against shared memory at Z=240, where both
// layouts fit one frame of 32 warps per SM (chip_smoke.py split_probe).

// Rows of 28 to 58 members (the 64-bit state word)
// ================================================
// What it computes: the same four functions, bit for bit, on codes with
// rows too wide for the 32-bit word's 27 signs, such as the high-rate QC
// codes of IEEE 802.3an (a 6 x 32 array of 64 x 64 circulants, rows of 32).
// They ran on fused_minsum_kernel before: all state in shared memory, pass
// 1's sub, abs and sign recomputed in pass 2, no frame retiring.
//
// What bounds it: the same operation counts per lifted edge, check and
// variable as the 32-bit kernels (chip_smoke.py bound_ms, bp_bound_ms) over
// each frame's conv_iter iterations.
//
// What the design does about it.  The four kernels take the state word as
// a template parameter (Word, retire.cuh) and are instantiated on unsigned
// long long: 58 output signs at bits 0..57 and the argmin in the top 6 bits
// (kNoMember 63), so a check's compressed min-sum state is 16 bytes (A and
// W) where it was 12; the structure's column members carry (j, 63 - j) for
// the argmin compare and the sign shift; the sum-product kernels keep one
// float of c2v an edge and widen only their sign masks (and the layered
// one's local phi array, 58 slots).  A 64-bit fold shifts with shift-or,
// where the 32-bit one uses a funnel shift; counts use __popcll.  min-sum
// flooding's check pass folds members d - 1 .. 27 from a switch of their
// own before the 27-member body; the layered kernels' rows of more than 12
// members run their run-time loops.  The 32-bit instantiations are the
// same code as before the word was a parameter (every 64-bit form sits
// behind an overload or an if constexpr), so their SASS does not change
// (tools/probe_sass_diff.py).
//
// Measured: chip_smoke.py phase wide_rows (PERF.md).

// Rows of 59 to 121 members (the 128-bit state word)
// ==================================================
// What it computes: the same four functions, bit for bit, on codes whose
// rows are too wide for the 64-bit word's 58 signs: array LDPC codes (J. L.
// Fan's, a p x p circulant in every cell of a J x L array, shift r*c mod p)
// and other QC codes of rate 0.93 and above, such as chip_smoke.py's
// widest_rows (p = 67, 4 x 64 cells, rows of 64 members).  They ran on
// fused_minsum_kernel before.
//
// What bounds it: the same operation counts per lifted edge, check and
// variable (chip_smoke.py bound_ms, bp_bound_ms) over each frame's conv_iter
// iterations.
//
// What the design does about it.  The four kernels are instantiated on
// Word128 (retire.cuh): two 64-bit limbs, 121 output signs at bits 0..120
// and the argmin in the top 7 bits (kNoMember 127), so a check's compressed
// min-sum state is 24 bytes (A and W); the structure's column members carry
// (j, 127 - j).  Every Word128 operation is an overload of its own that
// works limb by limb (no limb is shifted by 64 or more): push_sign carries
// bit 63 of lo into hi, odd adds two __popcll, product_flips builds a mask
// of d bits across the limbs, bit_at_31 and member_sign pick the limb, and
// sign_at has its own specialization below.  What grows per thread: a
// check's old word and its fold's sign word (neg) are two limbs each (four
// registers where the 64-bit word takes two).  Rows this wide take the
// kernels' run-time member loops: min-sum flooding's check pass folds
// members d - 1 .. 58 in a loop before the 58-member switch; layered
// min-sum (layered_row_wide), sum-product flooding (phi parked in the c2v
// slots) and layered sum-product (layered_sp_row_wide, whose local phi
// array grows to 121 slots) run loops over the whole row, as on the 64-bit
// word past 12 members.  The 32-bit and 64-bit instantiations compile as
// they did (tools/probe_sass_diff.py: all 48 kernels of this file, and
// fused_neural.cu's, same registers, spills and SASS).
//
// Registers a thread and spills on the 128-bit word (ptxas, sm_90a):
// retire_minsum_kernel 63-64, none spilled; retire_layered_kernel 64, 0-4
// bytes; retire_sumproduct_kernel 60-64, 0-4 bytes;
// retire_layered_sumproduct_kernel 80, none spilled, and a 488-byte stack
// frame (the 121-slot phi array).
//
// Measured: chip_smoke.py phase widest_rows (PERF.md).

// Large Z on the wider words
// ==========================
// What it computes: the four large-Z kernels' functions (retire_zlane,
// retire_zlane_layered, retire_zlane_sumproduct,
// retire_zlane_layered_sumproduct), bit for bit, on codes whose frames
// exceed a block's shared memory and whose rows have 28 to 121 members,
// such as chip_smoke.py's zlane_wide codes (IEEE 802.3an's shape at Z=384,
// rows of 32; Fan's array shape at Z=256, rows of 64).  They ran on
// zlane_minsum_kernel (fused_minsum.cu) before: one frame a block, c2v
// through an HBM scratch of K*Z floats a block, no frame retiring.
//
// What bounds it: the same operation counts per lifted edge, check and
// variable (chip_smoke.py bound_ms, bp_bound_ms) over each frame's conv_iter
// iterations.
//
// What the design does about it.  The four kernels take the state word as
// the B1 kernels do (Word: unsigned, unsigned long long, Word128), with
// every wider operation one of retire.cuh's overloads, so the 32-bit
// instantiations compile as before.  Only where the word lives changes:
// retire_zlane's slice in L2 is R*Z Words (8 or 16 bytes a check where it
// was 4), retire_zlane_layered's slice holds A then R*Z Words (16 or 24
// bytes a check where it was 12); the sum-product kernels keep one float of
// c2v an edge and widen only their sign masks (and the layered one's local
// phi array, 58 or 121 slots).  Shared memory does not depend on the word,
// so the plans are the 32-bit ones', taken by the occupancy query of each
// instantiation.
//
// Measured: chip_smoke.py phase zlane_wide (PERF.md).

#include <cuda_runtime.h>

#include "phi.cuh"
#include "retire.cuh"

namespace {

constexpr float kBig = 1e9f;  // stand-in for +inf, as _BIG in the JAX package

template <typename Word>
__host__ __device__ inline int frame_words(int Z, int R, int C) {
  return (2 * C * Z + kStateWords<Word> * R * Z + 3) / 4 * 4;
}

// A frame's check state and what the two passes do with it (decode_frames
// runs either): min-sum keeps a check's c2v compressed, A = (alpha*m1,
// alpha*m2) and the state word W; sum-product keeps one float a lifted edge
// (see the sum-product section below).  Word: the state word's type (W
// here, sum-product's sign masks), 32 bits or, for rows of 28 to 58
// members, 64 (retire.cuh).
template <typename Word>
struct MinSumState {
  float2* A;
  Word* W;
  float alpha;
  int checks;  // R*Z entries of A and W
};

template <typename Word>
__device__ __forceinline__ void clear_state(const MinSumState<Word>& st, int i, int step) {
  for (; i < st.checks; i += step) {
    st.A[i] = make_float2(0.0f, 0.0f);
    st.W[i] = Word{0};
  }
}

// Check pass of lifted check (r, z): reads the member beliefs once and the
// check's state (A: alpha*m1, alpha*m2; W: the output sign of member j at
// bit j, the argmin in the top bits), writes its new state; returns the hard
// decisions of the beliefs it read XOR-ed together in bit 31.  Beliefs are
// never -0.0 (a load adds +0.0, a column sum starts from +0.0), so v2c is
// never -0.0 and the sign bit of a belief or of v2c is its "< 0".
//
// The members are folded from the last to the first, entering the switch at
// member d - 1 and falling through, so every member index is a constant and
// no per-member bound check is made.  m1, m2, the sign product and the
// parity do not depend on the order; with "<=" the argmin is still the first
// member that reaches m1 (if no |v2c| is below the sentinel both outputs
// are 0 and the argmin is not read).  With the 64-bit word a row of more
// than 27 members folds members d - 1 .. 27 first, from a switch of its
// own, and falls into the 27-member body; the 32-bit word has no such
// switch, so its kernels are the ones they were.  With the 128-bit word a
// row of more than 58 members folds members d - 1 .. 58 in a run-time loop
// before that switch.
template <bool TRACK, bool POW2, typename Word>
__device__ __forceinline__ unsigned check_pass(const Structure& s, const float* bel,
                                               const MinSumState<Word>& st, int r, int z,
                                               int Z) {
  float2* A = st.A;
  Word* W = st.W;
  const float alpha = st.alpha;
  const int q = r * Z + z;
  const float2 a = A[q];
  const Word w_old = W[q];
  const unsigned arg_old = argmin_of(w_old);
  const int j0 = s.row_ptr[r], d = s.row_ptr[r + 1] - j0;
  const int2* mem = s.row_mem + j0;
  float m1 = kBig, m2 = kBig;
  unsigned arg = kNoMember<Word>, parity = 0u;
  Word neg = 0u;
  auto member = [&](int j) {
    const int2 m = mem[j];
    const float b = bel[rolled<POW2>(z, m.y, m.x, Z)];
    const float x = b - flip_if(static_cast<unsigned>(j) == arg_old ? a.y : a.x,
                                bit_at_31(w_old, j));
    const float mag = fabsf(x);
    neg = push_sign(x, neg);  // (neg << 1) | (x < 0)
    if (TRACK) parity ^= __float_as_uint(b);
    arg = mag <= m1 ? static_cast<unsigned>(j) : arg;
    m2 = fminf(fmaxf(mag, m1), m2);
    m1 = fminf(mag, m1);
  };
#define RETIRE_MEMBER(J) \
  case (J) + 1:          \
    member(J);           \
    [[fallthrough]];
  // The 128-bit word's rows of more than 58 members fold members d - 1 .. 58
  // in a run-time loop, then fall into the 58-member switch.
  if constexpr (kSignBits<Word> > 58)
    for (int j = d - 1; j >= 58; --j) member(j);
  if constexpr (kSignBits<Word> > 27) {
    switch (kSignBits<Word> > 58 && d > 58 ? 58 : d) {
      RETIRE_MEMBER(57) RETIRE_MEMBER(56) RETIRE_MEMBER(55) RETIRE_MEMBER(54) RETIRE_MEMBER(53)
      RETIRE_MEMBER(52) RETIRE_MEMBER(51) RETIRE_MEMBER(50) RETIRE_MEMBER(49) RETIRE_MEMBER(48)
      RETIRE_MEMBER(47) RETIRE_MEMBER(46) RETIRE_MEMBER(45) RETIRE_MEMBER(44) RETIRE_MEMBER(43)
      RETIRE_MEMBER(42) RETIRE_MEMBER(41) RETIRE_MEMBER(40) RETIRE_MEMBER(39) RETIRE_MEMBER(38)
      RETIRE_MEMBER(37) RETIRE_MEMBER(36) RETIRE_MEMBER(35) RETIRE_MEMBER(34) RETIRE_MEMBER(33)
      RETIRE_MEMBER(32) RETIRE_MEMBER(31) RETIRE_MEMBER(30) RETIRE_MEMBER(29) RETIRE_MEMBER(28)
      RETIRE_MEMBER(27)
      default:
        break;
    }
  }
  switch (kSignBits<Word> > 27 && d > 27 ? 27 : d) {
    RETIRE_MEMBER(26) RETIRE_MEMBER(25) RETIRE_MEMBER(24) RETIRE_MEMBER(23) RETIRE_MEMBER(22)
    RETIRE_MEMBER(21) RETIRE_MEMBER(20) RETIRE_MEMBER(19) RETIRE_MEMBER(18) RETIRE_MEMBER(17)
    RETIRE_MEMBER(16) RETIRE_MEMBER(15) RETIRE_MEMBER(14) RETIRE_MEMBER(13) RETIRE_MEMBER(12)
    RETIRE_MEMBER(11) RETIRE_MEMBER(10) RETIRE_MEMBER(9) RETIRE_MEMBER(8) RETIRE_MEMBER(7)
    RETIRE_MEMBER(6) RETIRE_MEMBER(5) RETIRE_MEMBER(4) RETIRE_MEMBER(3) RETIRE_MEMBER(2)
    RETIRE_MEMBER(1) RETIRE_MEMBER(0)
    default:
      break;
  }
#undef RETIRE_MEMBER
  const Word sp = product_flips(neg, d);
  A[q] = make_float2(alpha * (m1 < kBig ? m1 : 0.0f), alpha * (m2 < kBig ? m2 : 0.0f));
  W[q] = state_word(neg ^ sp, arg);
  return parity;
}

// Column pass of variable (c, z): its c2v expanded from the check states and
// summed from 0 in col_members order, plus its LLR.
template <bool POW2, typename Word>
__device__ __forceinline__ float column_pass(const Structure& s, const float* llr,
                                             const MinSumState<Word>& st, int c, int z, int Z) {
  const float2* A = st.A;
  const Word* W = st.W;
  float cs = 0.0f;
  const int i1 = s.col_ptr[c + 1];
#pragma unroll 4
  for (int i = s.col_ptr[c]; i < i1; ++i) {
    const int4 m = s.col_mem[i];
    const int q = rolled<POW2>(z, Z - m.y, m.x, Z);  // (z - shift) mod Z in row r
    const float2 a = A[q];
    const Word w = W[q];
    const float v = is_argmin(w, m.z) ? a.y : a.x;
    cs = cs + flip_if(v, member_sign(w, m.w));
  }
  return llr[c * Z + z] + cs;
}

// ---------------------------------------------------------------------------
// Sum-product flooding (retire_sumproduct_kernel): its state and passes
// ---------------------------------------------------------------------------
//
// What it computes (the TPU kernel's order, pallas_minsum.py:202-223, as
// fused_minsum_kernel<true, false> computes it).  Check (r, z) takes, for
// its members j = 0..d-1 in row order, v2c x_j = belief - c2v_j, phi_j =
// phi(clamp(|x_j|, 1e-7, 20)) with phi(x) = -logf(tanhf(x / 2) + 1e-30),
// S = S + phi_j from S = 0, and the sign product (sign(0) = +1); member j
// gets  c2v_j = sp * sign(x_j) * phi(max(S - phi_j, 1e-7)).  Every belief
// is llr + (the variable's c2v summed from 0 in col_members order).
// Tracking, conv_iter and the bits are the flooding min-sum kernel's.
//
// What bounds it.  Operations (fused_minsum.cu's header): per lifted edge
// 16 float32, 1 int32 and 4 special-function operations (tanh and log of
// two phi), per check 1 int32, per variable 2 float32, over each frame's
// conv_iter iterations (chip_smoke.py bp_bound_ms).  Main batch (nr_2_0_32
// Z=32, 65536 frames, 3 dB): 1.861 ms of operations, the special functions
// the largest part.  An accurate tanhf or logf is tens of instructions, so a
// phi is far from the bound's two special-function operations.
//
// What the design does about it.
// 1. Frames retire, on decode_frames as min-sum flooding does: the syndrome
//    of iteration t - 1 is read off iteration t's check pass, and a frame
//    whose checks all hold writes its bits and leaves.  A frame runs about
//    conv_iter + 1 check passes where fused_minsum_kernel ran 20 iterations.
// 2. Each phi once.  A check keeps phi_j of its members in registers (rows
//    of up to kPhiSlots members; wider rows park phi_j in the member's own
//    c2v slot) between the fold and the outputs: two phi a member, where
//    fused_minsum_kernel computes three (it recomputes v2c and phi_j).  The
//    phi_j are added to S in member order 0..d-1 (the min-sum fold runs last
//    member first; a float sum in that order would round differently).
// 3. One float a lifted edge: each member's output is a value of its own, so
//    the state does not compress.  c2v is check-aligned: the edge at row-
//    order position i, check lane z, is at i*Z + z, so the check pass reads
//    and writes its own lane; the column pass reads i*Z + (z - shift) mod Z,
//    a rotation of 32 consecutive words.  Neither pass has bank conflicts.
// 4. Signs: a sign is applied by flipping the sign bit (flip_if), which is
//    multiplication by +-1 on +-0.0 too (phi returns -0.0 where tanhf rounds
//    to 1); v2c is never -0.0 (beliefs are not, see check_pass above), so
//    its sign bit is its "< 0".  The first iteration reads c2v = +0.0.
// 5. The same float operations in the same order with the same libdevice
//    functions as fused_minsum_kernel, so the two give identical bits and
//    conv_iter; retirement changes no output.
//
// Shared memory and plan.  A frame's beliefs and c2v, 4 (C*Z + K*Z) bytes:
// 31,872 at NR BG2 Z=32 (38,528 with its LLRs staged), and the structure
// (5,152 bytes at 4 parts) once a block.  The wrapper takes the plan with
// the most resident frames by the runtime's occupancy query: at NR BG2
// Z=32, 7 frames of 4 parts (28 warps) a block with the LLRs read from the
// input rows (5 frames staged), one block per SM, 59-64 registers a thread
// (ptxas), no spills.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W): 10.10 ms per
// batch of 65536 at 3 dB (mean conv_iter 2.96; the bound is 18% of it),
// throughput mode 51.2 ms, where fused_minsum_kernel took 82.3 ms on the
// same batch and card.  A phi is 47 SASS instructions, 2 of them MUFU
// (ldpc_tpu_torch/tools/probe_phi.py: cuobjdump -sass), where the bound
// counts 2 special-function operations, and the card runs 6.4e11 of them a
// second; the batch's 3.3e9 phi take about half the kernel's time at that
// rate.  A phi on the approximations (tanh.approx.f32, __logf) is 8
// instructions at 2.8x the rate, but it rounds otherwise, and the kernel
// must equal fused_minsum_kernel.

constexpr int kPhiSlots = 12;  // members whose phi a check keeps in registers

// phi_j of a member whose v2c is x: phi(clamp(|x|, 1e-7, 20)).
__device__ __forceinline__ float v2c_phi(float x) {
  return phi(fminf(fmaxf(fabsf(x), 1e-7f), 20.0f));
}

// Member j's new c2v from the row's phi sum S and its own phi p: sign bit
// sp ^ (bit j of neg), the sign product times the sign of its v2c.
template <typename Word>
__device__ __forceinline__ float c2v_out(float S, float p, unsigned sp, Word neg, int j) {
  return flip_if(phi(fmaxf(S - p, 1e-7f)), sp ^ bit_at_31(neg, j));
}

// The sign bit of x (member j's v2c) at bit j of a Word.
template <typename Word>
__device__ __forceinline__ Word sign_at(float x, int j) {
  return static_cast<Word>(__float_as_uint(x) >> 31) << j;
}
template <>
__device__ __forceinline__ Word128 sign_at<Word128>(float x, int j) {
  const unsigned long long b = static_cast<unsigned long long>(__float_as_uint(x) >> 31)
                               << (j & 63);
  return j < 64 ? Word128(b) : Word128(0ull, b);
}

// c2v of a frame's lifted edges, check-aligned: the edge at row-order
// position i (member j of row r: i = row_ptr[r] + j) and check lane z is
// c2v[i*Z + z].  Word: the type of a check's sign mask, 64 bits for rows of
// more than 27 members.
template <typename Word>
struct SumProductState {
  float* c2v;
  int edges;  // K*Z
};

template <typename Word>
__device__ __forceinline__ void clear_state(const SumProductState<Word>& st, int i, int step) {
  for (; i < st.edges; i += step) st.c2v[i] = 0.0f;
}

// Check pass of lifted check (r, z): new c2v for its members from the
// beliefs and the old c2v; returns the hard decisions of the beliefs it read
// XOR-ed together in bit 31.  The members run in row order, so S is summed
// in the kernels' order; phi_j of each is computed once.
template <bool TRACK, bool POW2, typename Word>
__device__ __forceinline__ unsigned check_pass(const Structure& s, const float* bel,
                                               const SumProductState<Word>& st, int r, int z,
                                               int Z) {
  const int j0 = s.row_ptr[r], d = s.row_ptr[r + 1] - j0;
  const int2* mem = s.row_mem + j0;
  float* c2v = st.c2v + j0 * Z + z;  // member j's c2v at c2v[j * Z]
  float S = 0.0f;
  unsigned parity = 0u;
  Word neg = 0u;
  // Member j's v2c folded in: its sign at bit j of neg; returns phi_j.
  auto fold = [&](int j) {
    const int2 m = mem[j];
    const float b = bel[rolled<POW2>(z, m.y, m.x, Z)];
    const float x = b - c2v[j * Z];
    neg |= sign_at<Word>(x, j);
    if (TRACK) parity ^= __float_as_uint(b);
    const float p = v2c_phi(x);
    S = S + p;
    return p;
  };
  auto out = [&](int j, float p, unsigned sp) { return c2v_out(S, p, sp, neg, j); };
  if (d <= kPhiSlots) {
    float ph[kPhiSlots];
#pragma unroll
    for (int j = 0; j < kPhiSlots; ++j)
      if (j < d) ph[j] = fold(j);
    const unsigned sp = odd(neg) << 31;
#pragma unroll
    for (int j = 0; j < kPhiSlots; ++j)
      if (j < d) c2v[j * Z] = out(j, ph[j], sp);
  } else {
    // Wider rows: phi_j waits in member j's own c2v slot, which no other
    // thread reads before the pass's closing barrier.
    for (int j = 0; j < d; ++j) c2v[j * Z] = fold(j);
    const unsigned sp = odd(neg) << 31;
    for (int j = 0; j < d; ++j) c2v[j * Z] = out(j, c2v[j * Z], sp);
  }
  return parity;
}

// Column pass of variable (c, z): its c2v summed from 0 in col_members
// order, plus its LLR.  The structure's column members carry the edge's
// offset i*Z (not min-sum's r*Z).
template <bool POW2, typename Word>
__device__ __forceinline__ float column_pass(const Structure& s, const float* llr,
                                             const SumProductState<Word>& st, int c, int z,
                                             int Z) {
  float cs = 0.0f;
  const int i1 = s.col_ptr[c + 1];
#pragma unroll 4
  for (int i = s.col_ptr[c]; i < i1; ++i) {
    const int4 m = s.col_mem[i];
    cs = cs + st.c2v[rolled<POW2>(z, Z - m.y, m.x, Z)];  // (z - shift) mod Z
  }
  return llr[c * Z + z] + cs;
}

// A frame group decodes frames from the counter until the batch is done.
// bel is the group's, in shared memory; st is its check state (State:
// MinSumState or SumProductState), in shared memory or, for min-sum's state
// words at large Z, in its block's slice of global scratch.  With STAGED a
// frame's LLRs are copied into L (shared memory) and the column passes read
// them there; without, they read them from the frame's input row.
template <bool TRACK, bool POW2, bool STAGED, typename State>
__device__ __forceinline__ void decode_frames(const Structure& s, const Lanes& t, int* s_frame,
                                              const float* __restrict__ llr, float* bits, int* conv,
                                              int* next_frame, float* bel, float* L,
                                              const State& st, int B, int Z, int C,
                                              int max_iterations) {
  const int n = C * Z;
  const Group& grp = t.grp;
  for (;;) {
    int f;
    if (grp.threads == 32) {
      f = t.gi == 0 ? atomicAdd(next_frame, 1) : 0;
      f = __shfl_sync(0xffffffffu, f, 0);
    } else {
      if (t.gi == 0) *s_frame = atomicAdd(next_frame, 1);
      grp.sync();
      f = *s_frame;
    }
    if (f >= B) break;
    const float* src = llr + static_cast<size_t>(f) * n;
    for (int i = t.gi; i < n; i += grp.threads) {
      const float x = src[i];
      bel[i] = x + 0.0f;  // -0.0 -> +0.0; the same decisions and v2c
      if (STAGED) L[i] = x;
    }
    clear_state(st, t.gi, grp.threads);
    grp.sync();
    const float* lf = STAGED ? L : src;

    int it = 0;
    bool converged = false;
    for (; it < max_iterations; ++it) {
      unsigned parity = 0u;
      if (t.active)
        for (int r = t.r0; r < t.r1; ++r)
          parity |= check_pass<TRACK, POW2>(s, bel, st, r, t.z, Z);
      if (TRACK && it > 0) {
        // The beliefs of iteration it - 1 satisfy every check: conv_iter = it.
        if (!grp.sync_or(parity >> 31)) {
          converged = true;
          break;
        }
      } else {
        grp.sync();
      }
      if (t.active)
        for (int c = t.c0; c < t.c1; ++c)
          bel[c * Z + t.z] = column_pass<POW2>(s, lf, st, c, t.z, Z);
      grp.sync();
    }
    if (t.gi == 0) conv[f] = converged ? it : max_iterations;
    float* out = bits + static_cast<size_t>(f) * n;
    for (int i = t.gi; i < n; i += grp.threads) out[i] = bel[i] < 0.0f ? 1.0f : 0.0f;
    grp.sync();  // the next frame's LLRs overwrite bel
  }
}

// Up to 15 frame groups a block; a group's beliefs, LLRs and state words in
// shared memory.
template <bool TRACK, bool POW2, typename Word>
__global__ void __launch_bounds__(kMaxThreads)
retire_minsum_kernel(const float* __restrict__ llr, float* __restrict__ bits,
                     int* __restrict__ conv, int* __restrict__ next_frame,
                     const int* __restrict__ structure, int B, int Z, int R, int C, int K,
                     int max_iterations, float alpha, int parts) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_frame[kMaxGroups];
  int* s_struct = reinterpret_cast<int*>(smem);
  const Structure s = load_structure(s_struct, structure, R, C, K, parts);
  const Lanes t = lanes_of(s, Z, parts);
  const int n = C * Z;
  float* bel = reinterpret_cast<float*>(s_struct + structure_words(R, C, K, parts)) +
               t.g * frame_words<Word>(Z, R, C);
  float* L = bel + n;
  float2* A = reinterpret_cast<float2*>(L + n);  // 8-byte aligned: 2n is even
  Word* W = reinterpret_cast<Word*>(A + R * Z);
  decode_frames<TRACK, POW2, true>(s, t, s_frame + t.g, llr, bits, conv, next_frame, bel, L,
                                   MinSumState<Word>{A, W, alpha, R * Z}, B, Z, C,
                                   max_iterations);
}

// One frame group a block, for Z where a whole frame exceeds shared memory:
// beliefs and A in shared memory, the state words W in the block's slice
// (R*Z words) of `scratch`, LLRs read from the input rows.  W is written by
// the check pass and read by other threads of the group after a barrier,
// so it is read with ordinary (coherent) loads: scratch is neither const
// nor __restrict__, which keeps the compiler off the read-only path.
// Word: the state word, as retire_minsum_kernel's; the slice is R*Z Words
// (scratch is addressed in 32-bit words whatever the Word, so every
// instantiation has one signature).
template <bool TRACK, bool POW2, typename Word>
__global__ void __launch_bounds__(kMaxThreads)
retire_zlane_kernel(const float* __restrict__ llr, float* __restrict__ bits,
                    int* __restrict__ conv, int* __restrict__ next_frame, unsigned* scratch,
                    const int* __restrict__ structure, int B, int Z, int R, int C, int K,
                    int max_iterations, float alpha, int parts) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_frame;
  int* s_struct = reinterpret_cast<int*>(smem);
  const Structure s = load_structure(s_struct, structure, R, C, K, parts);
  const Lanes t = lanes_of(s, Z, parts);
  float* bel = reinterpret_cast<float*>(s_struct + structure_words(R, C, K, parts));
  float2* A = reinterpret_cast<float2*>(bel + C * Z);  // 8-byte aligned: Z is even
  Word* W = reinterpret_cast<Word*>(scratch) + static_cast<size_t>(blockIdx.x) * R * Z;
  decode_frames<TRACK, POW2, false>(s, t, &s_frame, llr, bits, conv, next_frame, bel, nullptr,
                                    MinSumState<Word>{A, W, alpha, R * Z}, B, Z, C,
                                    max_iterations);
}

// A frame's beliefs, its LLRs if STAGED, then its c2v (K*Z floats), rounded
// up to 16 bytes.
__host__ __device__ inline int sumproduct_frame_words(int Z, int C, int K, int staged) {
  return ((staged ? 2 : 1) * C * Z + K * Z + 3) / 4 * 4;
}

// Sum-product flooding: up to 15 frame groups a block, as
// retire_minsum_kernel; a group's beliefs and c2v in shared memory, and its
// LLRs too where `staged` (else the column passes read the input row).
template <bool TRACK, bool POW2, typename Word>
__global__ void __launch_bounds__(kMaxThreads)
retire_sumproduct_kernel(const float* __restrict__ llr, float* __restrict__ bits,
                         int* __restrict__ conv, int* __restrict__ next_frame,
                         const int* __restrict__ structure, int B, int Z, int R, int C, int K,
                         int max_iterations, int parts, int staged) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_frame[kMaxGroups];
  int* s_struct = reinterpret_cast<int*>(smem);
  const Structure s = load_structure(s_struct, structure, R, C, K, parts);
  const Lanes t = lanes_of(s, Z, parts);
  const int n = C * Z;
  float* bel = reinterpret_cast<float*>(s_struct + structure_words(R, C, K, parts)) +
               t.g * sumproduct_frame_words(Z, C, K, staged);
  if (staged)
    decode_frames<TRACK, POW2, true>(s, t, s_frame + t.g, llr, bits, conv, next_frame, bel,
                                     bel + n, SumProductState<Word>{bel + 2 * n, K * Z}, B, Z,
                                     C,
                                     max_iterations);
  else
    decode_frames<TRACK, POW2, false>(s, t, s_frame + t.g, llr, bits, conv, next_frame, bel,
                                      nullptr, SumProductState<Word>{bel + n, K * Z}, B, Z, C,
                                      max_iterations);
}

// ---------------------------------------------------------------------------
// The layered schedule (retire_layered_kernel)
// ---------------------------------------------------------------------------
//
// What it computes (the TPU kernel's order).  A sweep runs the base rows in
// order; row r's Z lifted checks touch disjoint variables and run in
// parallel.  Check (r, z) takes v2c = belief - old for its members (old: the
// member's c2v from the previous sweep, 0 in the first), folds them as the
// flooding kernels do, and each member's belief becomes (belief + new) - old
// in float32, in that order.  With tracking, the first sweep after which the
// hard decisions satisfy every check freezes the bits and sets conv_iter.
//
// What bounds it.  Operations (chip_smoke.py OPS_PER_EDGE_LAYERED, from the
// flooding count in fused_minsum.cu): per lifted edge 10 float32 and 1
// int32 (two adds fold the new c2v in, and there is no column sum), per
// check 4 + 1, per variable 1 + 0, over each frame's conv_iter sweeps.  At the layered
// phase's batch (nr_2_0_32 Z=32, 65536 frames, 3 dB, mean conv_iter 2.0):
// 0.334 ms of operations against 0.26 ms of bytes.
//
// What the design does about it.
// 1. Frames retire, as in the flooding kernels.  The syndrome cannot ride on
//    the next sweep: row r of sweep t + 1 reads beliefs that rows 0..r - 1
//    of the same sweep changed.  So after each sweep but the last a parity
//    pass reads every check's members (all of a frame's warps share it, a
//    warp stops at its first violated row); a frame that passes writes its
//    bits from those beliefs, still in shared memory, and leaves.
// 2. The flooding kernels' 12-byte check state, exact for the same reason;
//    a lifted check's state is read and written by one thread only, so the
//    whole row's old state stays in registers until every member has
//    subtracted its old c2v, and the first sweep reads none (old c2v 0).
// 3. A warp per frame (ceil(Z / 32) warps where Z > 32): lane z runs check
//    (r, z) of every row, so rows follow each other with only a warp
//    barrier between row groups.  A row's members are loaded before the fold
//    (an unrolled body per degree up to 12, the loads of a constant count).
// 4. Row groups: runs of consecutive rows that pairwise share no column
//    commute exactly (28 groups of NR BG2's 42 rows: 10 of two rows, 2 of
//    three), so a frame of `parts` warps runs a group's rows side by side
//    with a named barrier between groups.
// 5. Shared memory holds a frame's beliefs and check state, 4 (C*Z + 3 R*Z)
//    bytes: 22,784 at NR BG2 Z=32, and the structure (2K + R + G + 2 ints,
//    1,872 bytes) once a block; no LLR copy (the beliefs start from them and
//    there is no column sum).  The wrapper takes the plan with the most
//    resident frames by the runtime's occupancy query, then the most parts:
//    at NR BG2 Z=32 10 frames of 3 warps in one block per SM.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W): 2.18 ms per
// batch of 65536 at 3 dB (mean conv_iter 2.0), throughput mode 16.9 ms,
// where fused_minsum_kernel took 96.4 ms on the same batch and card; one
// warp a frame 2.68 ms, two 2.49 ms; 63-64 registers, 0-4 bytes spilled.

__host__ __device__ inline int layered_structure_words(int R, int K, int G) {
  return (2 * K + R + 1 + G + 1 + 3) / 4 * 4;
}

// A frame's beliefs (C*Z floats, rounded up to 16 bytes), then its check
// state: A (R*Z float2), W (R*Z Words).
__host__ __device__ inline int layered_bel_words(int Z, int C) { return (C * Z + 3) / 4 * 4; }

template <typename Word>
__host__ __device__ inline int layered_frame_words(int Z, int R, int C) {
  return layered_bel_words(Z, C) + (kStateWords<Word> * R * Z + 3) / 4 * 4;
}

// Structure in shared memory, as ldpc_tpu_torch/ops/fused_minsum.py
// _layered_structure lays it out: row members in row order (K int2: col*Z,
// shift), row_ptr (R+1), and the first row of each row group (G+1): runs of
// consecutive rows that pairwise share no column.
struct LayeredStructure {
  const int2* row_mem;
  const int* row_ptr;
  const int* grp_ptr;
};

// A layered frame's check state and what a row update does with it
// (layered_frames runs either): min-sum keeps a check's c2v compressed, A =
// (alpha*m1, alpha*m2) and the state word W (R*Z entries each); sum-product
// keeps one float a lifted edge, check-aligned (see its section below).
// Word: as MinSumState's.
template <typename Word>
struct LayeredMinSumState {
  float2* A;
  Word* W;
  float alpha;
};

// The check's new state from the fold of its d members.
template <typename Word>
__device__ __forceinline__ void new_state(float m1, float m2, unsigned arg, Word neg, int d,
                                          float alpha, float2& an, Word& wn) {
  const Word sp = product_flips(neg, d);
  an = make_float2(alpha * (m1 < kBig ? m1 : 0.0f), alpha * (m2 < kBig ? m2 : 0.0f));
  wn = state_word(neg ^ sp, arg);
}

// Base row r's update at lane z (state at q; FIRST: the first sweep, whose
// old c2v are 0), for a row of D members (mem: its members).  Each member's
// v2c is belief - old, and its belief becomes (belief + new) - old, in that
// order, as the TPU kernel computes it.  All D beliefs are loaded before
// the fold and kept in registers with the old c2v, so the new state
// replaces the old one only after every member has used it.  Beliefs are
// never -0.0 (a load adds +0.0, and (b + new) - old is -0.0 only if b is),
// so neither is v2c.
template <int D, bool POW2, typename Word>
__device__ __forceinline__ void layered_row(const int2* mem, float* bel, float2* A, Word* W,
                                            int q, int z, int Z, float alpha, bool first) {
  const float2 a = first ? make_float2(0.0f, 0.0f) : A[q];
  const Word w = first ? Word{0} : W[q];
  int pos[D];
  float b[D], old[D];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const int2 m = mem[j];
    pos[j] = rolled<POW2>(z, m.y, m.x, Z);
    b[j] = bel[pos[j]];
  }
  float m1 = kBig, m2 = kBig;
  unsigned arg = kNoMember<Word>;
  Word neg = 0u;
#pragma unroll
  for (int j = D - 1; j >= 0; --j) {
    old[j] = c2v_of(a, w, j);
    fold(b[j] - old[j], j, m1, m2, arg, neg);
  }
  float2 an;
  Word wn;
  new_state(m1, m2, arg, neg, D, alpha, an, wn);
#pragma unroll
  for (int j = 0; j < D; ++j) bel[pos[j]] = (b[j] + c2v_of(an, wn, j)) - old[j];
  A[q] = an;
  W[q] = wn;
}

// The same for rows of more than 12 members, with a run-time loop: the fold
// reads the beliefs, the update reads them again (no other thread writes
// them in between).
template <bool POW2, typename Word>
__device__ __forceinline__ void layered_row_wide(const int2* mem, int d, float* bel, float2* A,
                                                 Word* W, int q, int z, int Z, float alpha,
                                                 bool first) {
  const float2 a = first ? make_float2(0.0f, 0.0f) : A[q];
  const Word w = first ? Word{0} : W[q];
  float m1 = kBig, m2 = kBig;
  unsigned arg = kNoMember<Word>;
  Word neg = 0u;
  for (int j = d - 1; j >= 0; --j) {
    const int2 m = mem[j];
    fold(bel[rolled<POW2>(z, m.y, m.x, Z)] - c2v_of(a, w, j), j, m1, m2, arg, neg);
  }
  float2 an;
  Word wn;
  new_state(m1, m2, arg, neg, d, alpha, an, wn);
  for (int j = 0; j < d; ++j) {
    const int2 m = mem[j];
    const int p = rolled<POW2>(z, m.y, m.x, Z);
    bel[p] = (bel[p] + c2v_of(an, wn, j)) - c2v_of(a, w, j);
  }
  A[q] = an;
  W[q] = wn;
}

// Base row r's update at lane z: rows of up to 12 members (NR base graph 2
// has rows of 3 to 10) run an unrolled body with their beliefs and old c2v
// in registers, wider ones the loop, which keeps the kernel within the 64
// registers a thread that 1024 threads a block leave.
template <bool POW2, typename Word>
__device__ __forceinline__ void layered_update(const LayeredStructure& s, float* bel,
                                               const LayeredMinSumState<Word>& st, int r, int z,
                                               int Z, bool first) {
  const int j0 = s.row_ptr[r];
  const int d = s.row_ptr[r + 1] - j0;
  const int2* mem = s.row_mem + j0;
  const int q = r * Z + z;
  switch (d) {
#define LAYERED_ROW(D)                                                    \
  case D:                                                                 \
    layered_row<D, POW2>(mem, bel, st.A, st.W, q, z, Z, st.alpha, first); \
    break;
    LAYERED_ROW(1) LAYERED_ROW(2) LAYERED_ROW(3) LAYERED_ROW(4) LAYERED_ROW(5) LAYERED_ROW(6)
    LAYERED_ROW(7) LAYERED_ROW(8) LAYERED_ROW(9) LAYERED_ROW(10) LAYERED_ROW(11)
    LAYERED_ROW(12)
#undef LAYERED_ROW
    default:
      layered_row_wide<POW2>(mem, d, bel, st.A, st.W, q, z, Z, st.alpha, first);
  }
}

// c2v of a layered sum-product frame, check-aligned as retire_sumproduct's:
// member j of row r at lane z is c2v[(row_ptr[r] + j) * Z + z], in shared
// memory or the frame group's slice of global scratch (the layered
// sum-product section below).  Word: the type of a check's sign mask, as
// SumProductState's.
template <typename Word>
struct LayeredSumProductState {
  float* c2v;
};

// Base row r's sum-product update at lane z, for a row of D members (mem:
// its members; c2v: member j's slot at c2v[j * Z]; FIRST: the first sweep,
// whose old c2v are +0.0 and whose slots are not read).  Member j's v2c is
// x_j = belief - old, phi_j = phi(clamp(|x_j|, 1e-7, 20)) computed once and
// kept in a register, S = S + phi_j in member order 0..D-1; its new c2v is
// sp * sign(x_j) * phi(max(S - phi_j, 1e-7)) and its belief becomes (belief
// + new) - old.  Beliefs are never -0.0 (see layered_row), so neither is
// x_j, and its sign bit is its "< 0".
template <int D, bool POW2, typename Word>
__device__ __forceinline__ void layered_sp_row(const int2* mem, float* bel, float* c2v, int z,
                                               int Z, bool first) {
  int pos[D];
  float b[D], old[D], ph[D];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const int2 m = mem[j];
    pos[j] = rolled<POW2>(z, m.y, m.x, Z);
    b[j] = bel[pos[j]];
    old[j] = first ? 0.0f : c2v[j * Z];
  }
  float S = 0.0f;
  Word neg = 0u;
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const float x = b[j] - old[j];
    neg |= sign_at<Word>(x, j);
    ph[j] = v2c_phi(x);
    S = S + ph[j];
  }
  const unsigned sp = odd(neg) << 31;
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const float v = c2v_out(S, ph[j], sp, neg, j);
    bel[pos[j]] = (b[j] + v) - old[j];
    c2v[j * Z] = v;
  }
}

// The same for rows of more than kPhiSlots members, with run-time loops:
// the update reads each belief and old c2v again (no other thread writes
// them in between), and phi_j waits in a per-thread array in local memory
// (27 slots with the 32-bit word, 58 with the 64-bit, 121 with the
// 128-bit).  Its c2v slot cannot hold it, as check_pass's does: the slot
// keeps the old c2v, which the belief update subtracts.
template <bool POW2, typename Word>
__device__ __forceinline__ void layered_sp_row_wide(const int2* mem, int d, float* bel,
                                                    float* c2v, int z, int Z, bool first) {
  float ph[kSignBits<Word>];
  float S = 0.0f;
  Word neg = 0u;
  for (int j = 0; j < d; ++j) {
    const int2 m = mem[j];
    const float x = bel[rolled<POW2>(z, m.y, m.x, Z)] - (first ? 0.0f : c2v[j * Z]);
    neg |= sign_at<Word>(x, j);
    ph[j] = v2c_phi(x);
    S = S + ph[j];
  }
  const unsigned sp = odd(neg) << 31;
  for (int j = 0; j < d; ++j) {
    const int2 m = mem[j];
    const int p = rolled<POW2>(z, m.y, m.x, Z);
    const float v = c2v_out(S, ph[j], sp, neg, j);
    bel[p] = (bel[p] + v) - (first ? 0.0f : c2v[j * Z]);
    c2v[j * Z] = v;
  }
}

// Base row r's sum-product update at lane z: rows of up to kPhiSlots
// members (NR base graph 2 has rows of 3 to 10) run an unrolled body with
// their beliefs, old c2v and phi in registers, wider ones the loop.
template <bool POW2, typename Word>
__device__ __forceinline__ void layered_update(const LayeredStructure& s, float* bel,
                                               const LayeredSumProductState<Word>& st, int r,
                                               int z, int Z, bool first) {
  const int j0 = s.row_ptr[r];
  const int d = s.row_ptr[r + 1] - j0;
  const int2* mem = s.row_mem + j0;
  float* c2v = st.c2v + j0 * Z + z;
  switch (d) {
#define LAYERED_SP_ROW(D)                                    \
  case D:                                                    \
    layered_sp_row<D, POW2, Word>(mem, bel, c2v, z, Z, first); \
    break;
    LAYERED_SP_ROW(1) LAYERED_SP_ROW(2) LAYERED_SP_ROW(3) LAYERED_SP_ROW(4) LAYERED_SP_ROW(5)
    LAYERED_SP_ROW(6) LAYERED_SP_ROW(7) LAYERED_SP_ROW(8) LAYERED_SP_ROW(9) LAYERED_SP_ROW(10)
    LAYERED_SP_ROW(11) LAYERED_SP_ROW(12)
#undef LAYERED_SP_ROW
    default:
      layered_sp_row_wide<POW2, Word>(mem, d, bel, c2v, z, Z, first);
  }
}

// Whether lifted check (r, z) is violated: the XOR of its members' hard
// decisions (the sign bits of their beliefs), in bit 31.
template <bool POW2>
__device__ __forceinline__ unsigned row_parity(const LayeredStructure& s, const float* bel, int r,
                                               int z, int Z) {
  unsigned p = 0u;
  const int i1 = s.row_ptr[r + 1];
#pragma unroll 4
  for (int i = s.row_ptr[r]; i < i1; ++i) {
    const int2 m = s.row_mem[i];
    p ^= __float_as_uint(bel[rolled<POW2>(z, m.y, m.x, Z)]);
  }
  return p >> 31;
}

// Layered structure in shared memory at s_struct (2K + R + 1 + G + 1 ints);
// ends with a barrier.
__device__ __forceinline__ LayeredStructure load_layered_structure(
    int* s_struct, const int* __restrict__ structure, int R, int K, int G) {
  for (int i = threadIdx.x; i < 2 * K + R + 1 + G + 1; i += blockDim.x) s_struct[i] = structure[i];
  LayeredStructure s;
  s.row_mem = reinterpret_cast<const int2*>(s_struct);
  s.row_ptr = s_struct + 2 * K;
  s.grp_ptr = s.row_ptr + R + 1;
  __syncthreads();
  return s;
}

// What a thread of a layered frame group works on.  A group is `parts`
// times ceil(Z / 32) warps: warp w of group g covers lanes z = 32 * (w % zw)
// + lane and part w / zw, which runs rows grp_ptr[i] + part, + 2 parts, ...
// of each row group i and the parity of rows part, part + parts, ...  A
// lifted check's state is read and written by one thread only.
struct LayeredLanes {
  Group grp;
  int g, gi, part, z;
  bool active;
};

__device__ __forceinline__ LayeredLanes layered_lanes(int Z, int parts) {
  const int zw = (Z + 31) / 32, gwarps = zw * parts;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = warp / gwarps, wg = warp - g * gwarps;
  LayeredLanes t;
  t.grp = Group{g + 1, 32 * gwarps};
  t.g = g;
  t.part = wg / zw;
  t.z = 32 * (wg - t.part * zw) + lane;
  t.gi = 32 * wg + lane;
  t.active = t.z < Z;
  return t;
}

// A layered frame group decodes frames from the counter until the batch is
// done: its beliefs (bel) in shared memory, its check state (State:
// LayeredMinSumState or LayeredSumProductState) in shared memory or its
// slice of global scratch.  Where the LLR and bit rows are 16-byte aligned
// (n % 4 == 0) they move as float4.
template <bool TRACK, bool POW2, typename State>
__device__ __forceinline__ void layered_frames(const LayeredStructure& s, const LayeredLanes& t,
                                               int* s_frame, const float* __restrict__ llr,
                                               float* __restrict__ bits, int* __restrict__ conv,
                                               int* __restrict__ next_frame, float* bel,
                                               const State& st, int B, int Z, int R, int C,
                                               int G, int max_iterations, int parts) {
  const Group& grp = t.grp;
  const int gi = t.gi;
  const int n = C * Z;
  const bool vec = n % 4 == 0 && (reinterpret_cast<size_t>(llr) & 15) == 0 &&
                   (reinterpret_cast<size_t>(bits) & 15) == 0;

  for (;;) {
    int f;
    if (grp.threads == 32) {
      f = gi == 0 ? atomicAdd(next_frame, 1) : 0;
      f = __shfl_sync(0xffffffffu, f, 0);
    } else {
      if (gi == 0) *s_frame = atomicAdd(next_frame, 1);
      grp.sync();
      f = *s_frame;
    }
    if (f >= B) break;
    const float* src = llr + static_cast<size_t>(f) * n;
    if (vec) {
#pragma unroll 8
      for (int i = 4 * gi; i < n; i += 4 * grp.threads) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(src + i));
        *reinterpret_cast<float4*>(bel + i) =  // -0.0 -> +0.0
            make_float4(x.x + 0.0f, x.y + 0.0f, x.z + 0.0f, x.w + 0.0f);
      }
    } else {
      for (int i = gi; i < n; i += grp.threads) bel[i] = src[i] + 0.0f;
    }
    grp.sync();

    int done = max_iterations;
    for (int it = 0; it < max_iterations; ++it) {
      for (int i = 0; i < G; ++i) {
        if (t.active)
          for (int r = s.grp_ptr[i] + t.part; r < s.grp_ptr[i + 1]; r += parts)
            layered_update<POW2>(s, bel, st, r, t.z, Z, it == 0);
        grp.sync();
      }
      // The last sweep needs no parity pass: converged or not, the outputs
      // are conv_iter = max_iterations and its decisions.  A warp stops at
      // its first violated row.
      if (TRACK && it + 1 < max_iterations) {
        bool violated = false;
        for (int r = t.part; r < R && !violated; r += parts)
          violated = __any_sync(0xffffffffu, t.active && row_parity<POW2>(s, bel, r, t.z, Z));
        if (!grp.sync_or(violated)) {
          done = it + 1;
          break;
        }
      }
    }
    if (gi == 0) conv[f] = done;
    float* out = bits + static_cast<size_t>(f) * n;
    if (vec) {
#pragma unroll 8
      for (int i = 4 * gi; i < n; i += 4 * grp.threads) {
        const float4 x = *reinterpret_cast<const float4*>(bel + i);
        *reinterpret_cast<float4*>(out + i) =
            make_float4(x.x < 0.0f ? 1.0f : 0.0f, x.y < 0.0f ? 1.0f : 0.0f,
                        x.z < 0.0f ? 1.0f : 0.0f, x.w < 0.0f ? 1.0f : 0.0f);
      }
    } else {
      for (int i = gi; i < n; i += grp.threads) out[i] = bel[i] < 0.0f ? 1.0f : 0.0f;
    }
    grp.sync();  // the next frame's LLRs overwrite bel
  }
}

// Up to 32 frame groups a block (15 where a group is more than one warp: a
// named barrier each), each with its beliefs and check state in shared
// memory.
template <bool TRACK, bool POW2, typename Word>
__global__ void __launch_bounds__(kMaxThreads)
retire_layered_kernel(const float* __restrict__ llr, float* __restrict__ bits,
                      int* __restrict__ conv, int* __restrict__ next_frame,
                      const int* __restrict__ structure, int B, int Z, int R, int C, int K, int G,
                      int max_iterations, float alpha, int parts) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_frame[kMaxGroups];
  int* s_struct = reinterpret_cast<int*>(smem);
  const LayeredStructure s = load_layered_structure(s_struct, structure, R, K, G);
  const LayeredLanes t = layered_lanes(Z, parts);
  float* bel = reinterpret_cast<float*>(s_struct + layered_structure_words(R, K, G)) +
               t.g * layered_frame_words<Word>(Z, R, C);
  float2* A = reinterpret_cast<float2*>(bel + layered_bel_words(Z, C));
  Word* W = reinterpret_cast<Word*>(A + R * Z);  // 8-byte aligned: 2 R*Z words past A
  layered_frames<TRACK, POW2>(s, t, s_frame + t.g, llr, bits, conv, next_frame, bel,
                              LayeredMinSumState<Word>{A, W, alpha}, B, Z, R, C, G,
                              max_iterations, parts);
}

// ---------------------------------------------------------------------------
// Layered min-sum at large Z (retire_zlane_layered_kernel)
// ---------------------------------------------------------------------------
//
// What it computes: retire_layered_kernel's function (above), bit for bit,
// for Z where a frame's beliefs and check state exceed a block's shared
// memory: 4 (C*Z + 3 R*Z) bytes, 273 KB at NR BG2 Z=384.
//
// What bounds it.  The layered operation count (chip_smoke.py
// OPS_PER_EDGE_LAYERED) over each frame's conv_iter sweeps: 0.0313 ms at the
// z384_layered phase's batch (nr_2_0_32 Z=384, 512 frames, 3 dB).  A sweep is
// 28 row groups in a chain, each a barrier of the frame's warps, so what
// sets the pace is latency: a row's state loads, its member loads and fold,
// its belief and state stores, the barrier.
//
// What the design does about it.  retire_layered_kernel's frame loop (a
// lane per check of a row, the row's old state in registers until every
// member has used it, the first sweep reading no state, row groups side by
// side on `parts`, a parity pass after each sweep but the last, frames that
// retire from the counter), with the state split as retire_zlane_kernel
// splits it: the beliefs (C*Z floats) stay in shared memory, and the check
// state, A (R*Z float2) then W (R*Z words), lives in the frame group's slice
// of a global scratch, which the L2 holds.  A lifted check's state is read
// and written by its own thread only, so the slice needs no barrier of its
// own; it is not cleared between frames (the first sweep reads none).
// layered_row issues a row's state loads before its member loads, so their
// L2 latency overlaps the shared-memory loads of the beliefs.
//
// Shared memory: the layered structure once a block and the beliefs of each
// frame group: 79,872 bytes a frame at NR BG2 Z=384, so two frames of 12
// warps an SM.  Scratch a frame group: 12 R*Z bytes (193,536 at Z=384).
// The wrapper's plan takes the most resident frames by the runtime's
// occupancy query: at Z=384 one frame of one part a block, two blocks an
// SM; 64 registers, 20-28 bytes spilled.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W): 0.272-0.279 ms
// per batch of 512 at 3 dB (mean conv_iter 2.0), where zlane_minsum_kernel
// took 6.05-6.10 ms on the same batch and card.  A layout with A in shared memory
// beside the beliefs (one frame of two parts an SM) took 0.25-0.6% longer
// and was dropped.  At Z=256, where retire_layered's whole frame fits a
// block, the slices cost nothing measurable (split_probe).

// Scratch words (32-bit) of a frame group: A (8-byte aligned since Z % 8 ==
// 0), then W (R*Z Words: 3, 4 or 6 words a check in all).
template <typename Word>
__host__ __device__ inline long long zlane_layered_slice_words(int Z, int R) {
  return static_cast<long long>(kStateWords<Word>) * R * Z;
}

template <bool TRACK, bool POW2, typename Word>
__global__ void __launch_bounds__(kMaxThreads)
retire_zlane_layered_kernel(const float* __restrict__ llr, float* __restrict__ bits,
                            int* __restrict__ conv, int* __restrict__ next_frame,
                            unsigned* scratch, const int* __restrict__ structure, int B, int Z,
                            int R, int C, int K, int G, int max_iterations, float alpha,
                            int parts, int frames) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_frame[kMaxGroups];
  int* s_struct = reinterpret_cast<int*>(smem);
  const LayeredStructure s = load_layered_structure(s_struct, structure, R, K, G);
  const LayeredLanes t = layered_lanes(Z, parts);
  float* bel = reinterpret_cast<float*>(s_struct + layered_structure_words(R, K, G)) +
               t.g * layered_bel_words(Z, C);
  unsigned* slice = scratch + (static_cast<long long>(blockIdx.x) * frames + t.g) *
                                  zlane_layered_slice_words<Word>(Z, R);
  float2* A = reinterpret_cast<float2*>(slice);
  Word* W = reinterpret_cast<Word*>(slice + 2 * R * Z);  // 8-byte aligned: Z % 8 == 0
  layered_frames<TRACK, POW2>(s, t, s_frame + t.g, llr, bits, conv, next_frame, bel,
                              LayeredMinSumState<Word>{A, W, alpha}, B, Z, R, C, G,
                              max_iterations, parts);
}

// ---------------------------------------------------------------------------
// Sum-product flooding at large Z (retire_zlane_sumproduct_kernel)
// ---------------------------------------------------------------------------
//
// What it computes: retire_sumproduct_kernel's function for Z where a
// frame's beliefs and c2v exceed a block's shared memory (4 (C*Z + K*Z)
// bytes, 382 KB at NR BG2 Z=384); bits and conv_iter identical to
// zlane_minsum_kernel<true, false> (fused_minsum.cu), whose check_update
// computes the same float operations in the same order.
//
// What bounds it: the sum-product operation count (chip_smoke.py
// bp_bound_ms) over each frame's conv_iter iterations, the phi the largest
// part; about 0.17 ms at the z384_sumproduct phase's batch.
//
// What the design does about it.  decode_frames with retire_sumproduct's
// passes (c2v check-aligned, each phi once and in registers, S summed in
// member order, the syndrome read off the next check pass, frames that
// retire) and one frame group a block: the beliefs (C*Z floats, 79,872
// bytes at Z=384) in shared memory, c2v (K*Z floats, 302,592 bytes) in the
// block's slice of a global scratch, the LLRs read from the frame's input
// row.  The column pass reads other threads' c2v after the group's barrier,
// so the slice is read with ordinary (coherent) loads, as retire_zlane's W.
// The wrapper keeps one block an SM: 132 slices are 40 MB, which the 50 MB
// L2 holds (zlane_minsum_kernel's two blocks an SM put 80 MB in flight).
//
// Shared memory: the structure and the beliefs, 85,008 bytes at NR BG2
// Z=384 and 2 parts (24 warps); 64 registers, 0-16 bytes spilled.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W): 1.90 ms per
// batch of 512 at 3 dB (mean conv_iter 3.1), where zlane_minsum_kernel took
// 10.7 ms on the same batch and card with identical outputs; one part at two
// blocks an SM took 12% longer; at Z=224, where retire_sumproduct's whole
// frame fits a block, the c2v slice costs 13% (split_probe).

template <bool TRACK, bool POW2, typename Word>
__global__ void __launch_bounds__(kMaxThreads)
retire_zlane_sumproduct_kernel(const float* __restrict__ llr, float* __restrict__ bits,
                               int* __restrict__ conv, int* __restrict__ next_frame,
                               float* scratch, const int* __restrict__ structure, int B, int Z,
                               int R, int C, int K, int max_iterations, int parts) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_frame;
  int* s_struct = reinterpret_cast<int*>(smem);
  const Structure s = load_structure(s_struct, structure, R, C, K, parts);
  const Lanes t = lanes_of(s, Z, parts);
  float* bel = reinterpret_cast<float*>(s_struct + structure_words(R, C, K, parts));
  float* c2v = scratch + static_cast<size_t>(blockIdx.x) * K * Z;
  decode_frames<TRACK, POW2, false>(s, t, &s_frame, llr, bits, conv, next_frame, bel, nullptr,
                                    SumProductState<Word>{c2v, K * Z}, B, Z, C,
                                    max_iterations);
}

// ---------------------------------------------------------------------------
// Layered sum-product (retire_layered_sumproduct_kernel,
// retire_zlane_layered_sumproduct_kernel)
// ---------------------------------------------------------------------------
//
// What they compute: exactly what fused_minsum_kernel<true, true> and
// zlane_minsum_kernel<true, true> (fused_minsum.cu) compute, in the same
// order, for the TPU kernels' layered sum-product (pallas_minsum.py:202-223,
// the layered fold at :219-222, and :447-468).  A sweep runs the base rows
// in order; for lifted check (r, z), members j = 0..d-1 in row order: x_j =
// belief - old_j (old_j: the member's c2v of the previous sweep, +0.0 in the
// first), phi_j = phi(clamp(|x_j|, 1e-7, 20)), S = S + phi_j from S = 0, and
// the sign product (sign(0) = +1); member j's new c2v is sp * sign(x_j) *
// phi(max(S - phi_j, 1e-7)), and each belief becomes (belief + new) - old,
// in that order.  With tracking, the first sweep after which every check
// holds freezes the bits and sets conv_iter.  The same libdevice logf and
// tanhf (phi.cuh) in the same float operations, built with this file's
// flags, so bits and conv_iter are identical to the replaced kernels'.  No
// FMA can change a rounding here: the only product before a fold is +-1 *
// phi, which is exact, and the sign is applied by flipping a bit; so,
// unlike layered min-sum's alpha * loo, these kernels need no -fmad=false
// and their JAX reference no FMA-free XLA.
//
// What bounds it.  Operations (fused_minsum.cu's header, chip_smoke.py
// OPS_PER_EDGE_SUMPRODUCT_LAYERED): per lifted edge 17 float32, 1 int32 and
// 4 special-function operations, per check 1 int32, per variable 1 float32,
// over each frame's conv_iter sweeps (bp_bound_ms(..., layered=True)); at
// NR BG2 Z=32, batch 65536, 3 dB (mean conv_iter 2.0) 1.275 ms, the special
// functions the largest part.  A phi is 47 SASS instructions
// (tools/probe_phi.py), far from the bound's two.
//
// What the design does about it.
// 1. layered_frames' frame loop, as the layered min-sum kernels run it (the
//    atomic frame counter, row groups side by side on `parts` warps with a
//    named barrier a group, a parity pass after each sweep but the last,
//    frames that retire the sweep they converge, float4 LLR and bit moves),
//    with a check-aligned c2v as its check state.  A frame runs about
//    conv_iter sweeps and conv_iter parity passes, where the replaced
//    kernels ran 20 sweeps with a syndrome after each.
// 2. Each phi once: a row's beliefs, old c2v and phi stay in registers
//    (rows of up to kPhiSlots members) between the fold and the update, two
//    phi a member where the replaced kernels compute three.  Wider rows run
//    loops with phi_j in a per-thread local array (layered_sp_row_wide).
// 3. c2v check-aligned: member j of row r, lane z at (row_ptr[r] + j) * Z +
//    z, so a warp's lanes touch consecutive words (no bank conflicts; L2
//    reads coalesce).  A lifted check's slots are read and written by its
//    own thread only, so they need no barrier and are never cleared: the
//    first sweep reads none.
// 4. Where c2v lives.  retire_layered_sumproduct_kernel keeps a frame's
//    beliefs (C*Z floats) and c2v (K*Z floats) in shared memory, 31,872
//    bytes a frame at NR BG2 Z=32 beside the 1,872-byte layered structure:
//    7 frames a block.  retire_zlane_layered_sumproduct_kernel, for Z where
//    that exceeds a block, keeps the beliefs in shared memory (79,872 bytes
//    at Z=384) and c2v (4 K*Z bytes, 302,592 at Z=384) in the frame group's
//    slice of a global scratch.  The wrapper's plan takes as many frame
//    groups an SM as the occupancy query allows, two at Z=384 (shared
//    memory holds no third): two put 80 MB of slices in flight against the
//    H100's 50 MB L2, and still beat one of twice the warps.
// 5. Both kernels are built for at most kLayeredSumProductThreads (768)
//    threads a block, which leaves them 80 registers a thread where
//    kMaxThreads leaves 64: a block of 7 frames of 3 warps at Z=32 takes
//    672 threads, and the plans at NR BG2 take at most 768 at Z=384.
//
// Shared memory and plan: see 4 and 5; the wrapper takes the plan with the
// most resident frames by the runtime's occupancy query, then the fewest
// parts (one warp a frame beat three by 1.0-1.6% at Z=32, and one part of
// two frame groups beat two parts of one at Z=384): at NR BG2 Z=32 7
// frames of one warp a block, one block an SM; at Z=384 one frame of one
// part (12 warps) a block, two blocks an SM.  80 registers; 4-24 bytes
// spilled at Z=32, 48-96 at Z=384 (ptxas).
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W): 6.674-6.689
// ms per batch of 65536 at Z=32, 3 dB (mean conv_iter 2.0) with 7 frames of
// one warp an SM (three warps a frame: 6.76-6.83 ms in earlier calls),
// where fused_minsum_kernel<true, true> took 188.6-190.1 ms in the same
// calls; 0.515-0.523 ms per batch of 512 at Z=384 with two frame groups
// an SM (one of two parts: 0.566-0.575 ms), where zlane_minsum_kernel<true,
// true> took 8.92-9.08 ms; outputs identical.  At Z=32 a sweep costs 2.67
// ms of the batch (throughput mode; 3.44 ms at three warps a frame).
// Neither more warps a frame nor more frames an SM (c2v in L2 slices,
// retire_zlane_layered_sumproduct at Z=32 with 24 frames of one warp an
// SM: 7.28-7.47 ms) make it faster.  The sweep's 8.3e8 phi take 1.29 ms of
// it at tools/probe_phi.py's rate; the rest is not split.

constexpr int kLayeredSumProductThreads = 768;

// A frame's beliefs (C*Z floats, rounded up to 16 bytes), then its c2v (K*Z
// floats, rounded up to 16 bytes).
__host__ __device__ inline int layered_sumproduct_frame_words(int Z, int C, int K) {
  return layered_bel_words(Z, C) + (K * Z + 3) / 4 * 4;
}

// Up to 24 frame groups a block (15 where a group is more than one warp), each
// with its beliefs and c2v in shared memory.
template <bool TRACK, bool POW2, typename Word>
__global__ void __launch_bounds__(kLayeredSumProductThreads)
retire_layered_sumproduct_kernel(const float* __restrict__ llr, float* __restrict__ bits,
                                 int* __restrict__ conv, int* __restrict__ next_frame,
                                 const int* __restrict__ structure, int B, int Z, int R, int C,
                                 int K, int G, int max_iterations, int parts) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_frame[kMaxGroups];
  int* s_struct = reinterpret_cast<int*>(smem);
  const LayeredStructure s = load_layered_structure(s_struct, structure, R, K, G);
  const LayeredLanes t = layered_lanes(Z, parts);
  float* bel = reinterpret_cast<float*>(s_struct + layered_structure_words(R, K, G)) +
               t.g * layered_sumproduct_frame_words(Z, C, K);
  layered_frames<TRACK, POW2>(s, t, s_frame + t.g, llr, bits, conv, next_frame, bel,
                              LayeredSumProductState<Word>{bel + layered_bel_words(Z, C)}, B, Z,
                              R, C, G, max_iterations, parts);
}

// Beliefs in shared memory, c2v in the frame group's slice (K*Z floats) of
// `scratch`; a slice is read and written only by the thread that owns each
// of its checks, so it needs no barrier and ordinary loads.
template <bool TRACK, bool POW2, typename Word>
__global__ void __launch_bounds__(kLayeredSumProductThreads)
retire_zlane_layered_sumproduct_kernel(const float* __restrict__ llr, float* __restrict__ bits,
                                       int* __restrict__ conv, int* __restrict__ next_frame,
                                       float* scratch, const int* __restrict__ structure, int B,
                                       int Z, int R, int C, int K, int G, int max_iterations,
                                       int parts, int frames) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_frame[kMaxGroups];
  int* s_struct = reinterpret_cast<int*>(smem);
  const LayeredStructure s = load_layered_structure(s_struct, structure, R, K, G);
  const LayeredLanes t = layered_lanes(Z, parts);
  float* bel = reinterpret_cast<float*>(s_struct + layered_structure_words(R, K, G)) +
               t.g * layered_bel_words(Z, C);
  float* c2v = scratch + (static_cast<long long>(blockIdx.x) * frames + t.g) * K * Z;
  layered_frames<TRACK, POW2>(s, t, s_frame + t.g, llr, bits, conv, next_frame, bel,
                              LayeredSumProductState<Word>{c2v}, B, Z, R, C, G,
                              max_iterations, parts);
}

using Narrow = unsigned;          // the 32-bit state word: rows of up to 27 members
using Wide = unsigned long long;  // the 64-bit state word: rows of up to 58 members
using Wider = Word128;            // the 128-bit state word: rows of up to 121 members

// A word_bits argument of the C entries: 32 (Narrow), 64 (Wide) or 128
// (Wider).
bool valid_word(int word_bits) { return word_bits == 32 || word_bits == 64 || word_bits == 128; }

// The instantiation of kernel template KERNEL<TRACK, POW2, Word> for the
// run-time track, pow2 and word_bits of the function it is used in.
#define PICK_WORD(KERNEL, WORD)                                                        \
  (track ? (pow2 ? &KERNEL<true, true, WORD> : &KERNEL<true, false, WORD>)             \
         : (pow2 ? &KERNEL<false, true, WORD> : &KERNEL<false, false, WORD>))
#define PICK(KERNEL)                                  \
  (word_bits == 128  ? PICK_WORD(KERNEL, Wider)       \
   : word_bits == 64 ? PICK_WORD(KERNEL, Wide)        \
                     : PICK_WORD(KERNEL, Narrow))

using Kernel = decltype(&retire_minsum_kernel<true, true, Narrow>);
using ZlaneKernel = decltype(&retire_zlane_kernel<true, true, Narrow>);

Kernel pick_kernel(int track, int Z, int word_bits) {
  const bool pow2 = (Z & (Z - 1)) == 0;
  return PICK(retire_minsum_kernel);
}

ZlaneKernel pick_zlane_kernel(int track, int Z, int word_bits) {
  const bool pow2 = (Z & (Z - 1)) == 0;
  return PICK(retire_zlane_kernel);
}

long long retire_smem(int Z, int R, int C, int K, int parts, int frames, int word_bits) {
  const int frame = word_bits == 128  ? frame_words<Wider>(Z, R, C)
                    : word_bits == 64 ? frame_words<Wide>(Z, R, C)
                                      : frame_words<Narrow>(Z, R, C);
  return 4LL * (structure_words(R, C, K, parts) + static_cast<long long>(frames) * frame);
}

// Structure, beliefs (C*Z floats) and A (R*Z float2).
long long zlane_smem(int Z, int R, int C, int K, int parts) {
  return 4LL * (structure_words(R, C, K, parts) + static_cast<long long>(C + 2 * R) * Z);
}

int retire_threads(int Z, int parts, int frames) { return 32 * ((Z + 31) / 32) * parts * frames; }

// Sets the kernel's dynamic shared memory; with `blocks`, also asks the
// runtime how many blocks of `threads` can be resident on one SM.
template <typename Fn>
cudaError_t prepare(Fn kernel, long long smem, int threads, int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err == cudaSuccess && blocks != nullptr)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, threads, smem);
  return err;
}

bool valid_plan(int Z, int parts, int frames) {
  return parts >= 1 && frames >= 1 && frames <= kMaxGroups &&
         retire_threads(Z, parts, frames) <= kMaxThreads;
}

// Z even keeps A 8-byte aligned; the wrapper asks Z % 8 == 0, as the TPU
// kernel does.
bool valid_zlane_plan(int Z, int parts) { return Z % 8 == 0 && valid_plan(Z, parts, 1); }

using SumProductKernel = decltype(&retire_sumproduct_kernel<true, true, Narrow>);

SumProductKernel pick_sumproduct_kernel(int track, int Z, int word_bits) {
  const bool pow2 = (Z & (Z - 1)) == 0;
  return PICK(retire_sumproduct_kernel);
}

long long sumproduct_smem(int Z, int R, int C, int K, int parts, int frames, int staged) {
  return 4LL * (structure_words(R, C, K, parts) +
                static_cast<long long>(frames) * sumproduct_frame_words(Z, C, K, staged));
}

using LayeredKernel = decltype(&retire_layered_kernel<true, true, Narrow>);

LayeredKernel pick_layered_kernel(int track, int Z, int word_bits) {
  const bool pow2 = (Z & (Z - 1)) == 0;
  return PICK(retire_layered_kernel);
}

long long layered_smem(int Z, int R, int C, int K, int G, int frames, int word_bits) {
  const int frame = word_bits == 128  ? layered_frame_words<Wider>(Z, R, C)
                    : word_bits == 64 ? layered_frame_words<Wide>(Z, R, C)
                                      : layered_frame_words<Narrow>(Z, R, C);
  return 4LL * (layered_structure_words(R, K, G) + static_cast<long long>(frames) * frame);
}

// Up to 32 frame groups of one warp a block, 15 of more (a named barrier
// each).
bool valid_layered_plan(int Z, int parts, int frames) {
  const int threads = retire_threads(Z, parts, frames);
  return parts >= 1 && frames >= 1 && threads <= kMaxThreads &&
         (frames <= kMaxGroups || threads == 32 * frames);
}

using ZlaneLayeredKernel = decltype(&retire_zlane_layered_kernel<true, true, Narrow>);

ZlaneLayeredKernel pick_zlane_layered_kernel(int track, int Z, int word_bits) {
  const bool pow2 = (Z & (Z - 1)) == 0;
  return PICK(retire_zlane_layered_kernel);
}

// Structure and each frame's beliefs.
long long zlane_layered_smem(int Z, int R, int C, int K, int G, int frames) {
  return 4LL * (layered_structure_words(R, K, G) +
                static_cast<long long>(frames) * layered_bel_words(Z, C));
}

// Z % 8 == 0, as the TPU kernel asks, keeps A 8-byte aligned in the slices.
bool valid_zlane_layered_plan(int Z, int parts, int frames) {
  return Z % 8 == 0 && valid_layered_plan(Z, parts, frames);
}

using ZlaneSumProductKernel = decltype(&retire_zlane_sumproduct_kernel<true, true, Narrow>);

ZlaneSumProductKernel pick_zlane_sumproduct_kernel(int track, int Z, int word_bits) {
  const bool pow2 = (Z & (Z - 1)) == 0;
  return PICK(retire_zlane_sumproduct_kernel);
}

// Structure and one frame's beliefs (C*Z floats).
long long zlane_sumproduct_smem(int Z, int R, int C, int K, int parts) {
  return 4LL * (structure_words(R, C, K, parts) + static_cast<long long>(C) * Z);
}

using LayeredSumProductKernel =
    decltype(&retire_layered_sumproduct_kernel<true, true, Narrow>);

LayeredSumProductKernel pick_layered_sumproduct_kernel(int track, int Z, int word_bits) {
  const bool pow2 = (Z & (Z - 1)) == 0;
  return PICK(retire_layered_sumproduct_kernel);
}

long long layered_sumproduct_smem(int Z, int R, int C, int K, int G, int frames) {
  return 4LL * (layered_structure_words(R, K, G) +
                static_cast<long long>(frames) * layered_sumproduct_frame_words(Z, C, K));
}

bool valid_layered_sumproduct_plan(int Z, int parts, int frames) {
  return valid_layered_plan(Z, parts, frames) &&
         retire_threads(Z, parts, frames) <= kLayeredSumProductThreads;
}

using ZlaneLayeredSumProductKernel =
    decltype(&retire_zlane_layered_sumproduct_kernel<true, true, Narrow>);

ZlaneLayeredSumProductKernel pick_zlane_layered_sumproduct_kernel(int track, int Z,
                                                                  int word_bits) {
  const bool pow2 = (Z & (Z - 1)) == 0;
  return PICK(retire_zlane_layered_sumproduct_kernel);
}

#undef PICK
#undef PICK_WORD

// Z % 8 == 0, as the TPU kernel asks.
bool valid_zlane_layered_sumproduct_plan(int Z, int parts, int frames) {
  return Z % 8 == 0 && valid_layered_sumproduct_plan(Z, parts, frames);
}

}  // namespace

extern "C" {

// Decodes B frames: `grid` blocks of `frames` frame groups, each of `parts`
// parts (the row and column ranges the structure's part tables give);
// `counter` is one int32 set to 0; `word_bits` 32, 64 or 128, the state
// word (64 for rows of 28 to 58 members, 128 for rows of 59 to 121, each
// with the structure's encoding for its word).
// Returns a cudaError_t (0 on success).  Launches on `stream`, no sync.
int ldpc_retire_minsum(const void* llr, void* bits, void* conv, void* counter,
                       const void* structure, int B, int Z, int R, int C, int K, int T,
                       float alpha, int track, int parts, int frames, int grid, int word_bits,
                       void* stream) {
  if (B < 1 || grid < 1 || !valid_plan(Z, parts, frames) || !valid_word(word_bits))
    return cudaErrorInvalidValue;
  const long long smem = retire_smem(Z, R, C, K, parts, frames, word_bits);
  const Kernel kernel = pick_kernel(track, Z, word_bits);
  const int threads = retire_threads(Z, parts, frames);
  cudaError_t err = prepare(kernel, smem, threads, nullptr);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(llr), static_cast<float*>(bits), static_cast<int*>(conv),
      static_cast<int*>(counter), static_cast<const int*>(structure), B, Z, R, C, K, T, alpha,
      parts);
  return cudaGetLastError();
}

// As ldpc_retire_minsum, one frame group a block: `scratch` holds grid * R*Z
// state words of `word_bits` (32, 64 or 128), one slice a block.
int ldpc_retire_zlane(const void* llr, void* bits, void* conv, void* counter, void* scratch,
                      const void* structure, int B, int Z, int R, int C, int K, int T,
                      float alpha, int track, int parts, int grid, int word_bits,
                      void* stream) {
  if (B < 1 || grid < 1 || !valid_zlane_plan(Z, parts) || !valid_word(word_bits))
    return cudaErrorInvalidValue;
  const long long smem = zlane_smem(Z, R, C, K, parts);
  const ZlaneKernel kernel = pick_zlane_kernel(track, Z, word_bits);
  const int threads = retire_threads(Z, parts, 1);
  cudaError_t err = prepare(kernel, smem, threads, nullptr);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(llr), static_cast<float*>(bits), static_cast<int*>(conv),
      static_cast<int*>(counter), static_cast<unsigned*>(scratch),
      static_cast<const int*>(structure), B, Z, R, C, K, T, alpha, parts);
  return cudaGetLastError();
}

// Decodes B frames with the layered schedule: `grid` blocks of `frames`
// frame groups, each of `parts` warps (times ceil(Z / 32)) that run the rows
// of a row group side by side; the structure holds G row groups; `counter`
// is one int32 set to 0; `word_bits` as ldpc_retire_minsum's.  Returns a
// cudaError_t (0 on success).  Launches on `stream`, no sync.
int ldpc_retire_layered(const void* llr, void* bits, void* conv, void* counter,
                        const void* structure, int B, int Z, int R, int C, int K, int G, int T,
                        float alpha, int track, int parts, int frames, int grid, int word_bits,
                        void* stream) {
  if (B < 1 || grid < 1 || G < 1 || !valid_layered_plan(Z, parts, frames) ||
      !valid_word(word_bits))
    return cudaErrorInvalidValue;
  const long long smem = layered_smem(Z, R, C, K, G, frames, word_bits);
  const LayeredKernel kernel = pick_layered_kernel(track, Z, word_bits);
  const int threads = retire_threads(Z, parts, frames);
  cudaError_t err = prepare(kernel, smem, threads, nullptr);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(llr), static_cast<float*>(bits), static_cast<int*>(conv),
      static_cast<int*>(counter), static_cast<const int*>(structure), B, Z, R, C, K, G, T, alpha,
      parts);
  return cudaGetLastError();
}

// Sum-product flooding, as ldpc_retire_minsum; `staged` copies each frame's
// LLRs into shared memory; `word_bits` sets the sign masks' word (the
// shared memory does not depend on it).
int ldpc_retire_sumproduct(const void* llr, void* bits, void* conv, void* counter,
                           const void* structure, int B, int Z, int R, int C, int K, int T,
                           int track, int parts, int frames, int staged, int grid, int word_bits,
                           void* stream) {
  if (B < 1 || grid < 1 || !valid_plan(Z, parts, frames) || !valid_word(word_bits))
    return cudaErrorInvalidValue;
  const long long smem = sumproduct_smem(Z, R, C, K, parts, frames, staged);
  const SumProductKernel kernel = pick_sumproduct_kernel(track, Z, word_bits);
  const int threads = retire_threads(Z, parts, frames);
  cudaError_t err = prepare(kernel, smem, threads, nullptr);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(llr), static_cast<float*>(bits), static_cast<int*>(conv),
      static_cast<int*>(counter), static_cast<const int*>(structure), B, Z, R, C, K, T, parts,
      staged);
  return cudaGetLastError();
}

long long ldpc_retire_sumproduct_smem_bytes(int Z, int R, int C, int K, int parts, int frames,
                                            int staged) {
  return sumproduct_smem(Z, R, C, K, parts, frames, staged);
}

int ldpc_retire_sumproduct_occupancy(int Z, int R, int C, int K, int parts, int frames,
                                     int staged, int track, int word_bits) {
  if (!valid_plan(Z, parts, frames) || !valid_word(word_bits))
    return -static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  const cudaError_t err = prepare(pick_sumproduct_kernel(track, Z, word_bits),
                                  sumproduct_smem(Z, R, C, K, parts, frames, staged),
                                  retire_threads(Z, parts, frames), &blocks);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

long long ldpc_retire_smem_bytes(int Z, int R, int C, int K, int parts, int frames,
                                 int word_bits) {
  return retire_smem(Z, R, C, K, parts, frames, word_bits);
}

long long ldpc_retire_zlane_smem_bytes(int Z, int R, int C, int K, int parts) {
  return zlane_smem(Z, R, C, K, parts);
}

// Resident blocks per SM of a launch with these arguments
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or -cudaError_t.
int ldpc_retire_occupancy(int Z, int R, int C, int K, int parts, int frames, int track,
                          int word_bits) {
  if (!valid_plan(Z, parts, frames) || !valid_word(word_bits))
    return -static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  const cudaError_t err =
      prepare(pick_kernel(track, Z, word_bits), retire_smem(Z, R, C, K, parts, frames, word_bits),
              retire_threads(Z, parts, frames), &blocks);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

int ldpc_retire_zlane_occupancy(int Z, int R, int C, int K, int parts, int track,
                                int word_bits) {
  if (!valid_zlane_plan(Z, parts) || !valid_word(word_bits))
    return -static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  const cudaError_t err =
      prepare(pick_zlane_kernel(track, Z, word_bits), zlane_smem(Z, R, C, K, parts),
              retire_threads(Z, parts, 1), &blocks);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

long long ldpc_retire_layered_smem_bytes(int Z, int R, int C, int K, int G, int frames,
                                         int word_bits) {
  return layered_smem(Z, R, C, K, G, frames, word_bits);
}

int ldpc_retire_layered_occupancy(int Z, int R, int C, int K, int G, int parts, int frames,
                                  int track, int word_bits) {
  if (!valid_layered_plan(Z, parts, frames) || !valid_word(word_bits))
    return -static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  const cudaError_t err = prepare(pick_layered_kernel(track, Z, word_bits),
                                  layered_smem(Z, R, C, K, G, frames, word_bits),
                                  retire_threads(Z, parts, frames), &blocks);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// Layered min-sum at large Z, as ldpc_retire_layered: `scratch` holds grid
// * frames slices of (2 + word_bits / 32) R*Z words (A, then the state
// words W of `word_bits`), one a frame group.
int ldpc_retire_zlane_layered(const void* llr, void* bits, void* conv, void* counter,
                              void* scratch, const void* structure, int B, int Z, int R, int C,
                              int K, int G, int T, float alpha, int track, int parts, int frames,
                              int grid, int word_bits, void* stream) {
  if (B < 1 || grid < 1 || G < 1 || !valid_zlane_layered_plan(Z, parts, frames) ||
      !valid_word(word_bits))
    return cudaErrorInvalidValue;
  const long long smem = zlane_layered_smem(Z, R, C, K, G, frames);
  const ZlaneLayeredKernel kernel = pick_zlane_layered_kernel(track, Z, word_bits);
  const int threads = retire_threads(Z, parts, frames);
  cudaError_t err = prepare(kernel, smem, threads, nullptr);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(llr), static_cast<float*>(bits), static_cast<int*>(conv),
      static_cast<int*>(counter), static_cast<unsigned*>(scratch),
      static_cast<const int*>(structure), B, Z, R, C, K, G, T, alpha, parts, frames);
  return cudaGetLastError();
}

long long ldpc_retire_zlane_layered_smem_bytes(int Z, int R, int C, int K, int G, int frames) {
  return zlane_layered_smem(Z, R, C, K, G, frames);
}

int ldpc_retire_zlane_layered_occupancy(int Z, int R, int C, int K, int G, int parts, int frames,
                                        int track, int word_bits) {
  if (!valid_zlane_layered_plan(Z, parts, frames) || !valid_word(word_bits))
    return -static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  const cudaError_t err = prepare(pick_zlane_layered_kernel(track, Z, word_bits),
                                  zlane_layered_smem(Z, R, C, K, G, frames),
                                  retire_threads(Z, parts, frames), &blocks);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// Sum-product flooding at large Z, as ldpc_retire_zlane: one frame group a
// block; `scratch` holds grid slices of K*Z floats of c2v, one a block;
// `word_bits` sets the sign masks' word (neither the shared memory nor the
// scratch depends on it).
int ldpc_retire_zlane_sumproduct(const void* llr, void* bits, void* conv, void* counter,
                                 void* scratch, const void* structure, int B, int Z, int R, int C,
                                 int K, int T, int track, int parts, int grid, int word_bits,
                                 void* stream) {
  if (B < 1 || grid < 1 || !valid_zlane_plan(Z, parts) || !valid_word(word_bits))
    return cudaErrorInvalidValue;
  const long long smem = zlane_sumproduct_smem(Z, R, C, K, parts);
  const ZlaneSumProductKernel kernel = pick_zlane_sumproduct_kernel(track, Z, word_bits);
  const int threads = retire_threads(Z, parts, 1);
  cudaError_t err = prepare(kernel, smem, threads, nullptr);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(llr), static_cast<float*>(bits), static_cast<int*>(conv),
      static_cast<int*>(counter), static_cast<float*>(scratch),
      static_cast<const int*>(structure), B, Z, R, C, K, T, parts);
  return cudaGetLastError();
}

long long ldpc_retire_zlane_sumproduct_smem_bytes(int Z, int R, int C, int K, int parts) {
  return zlane_sumproduct_smem(Z, R, C, K, parts);
}

int ldpc_retire_zlane_sumproduct_occupancy(int Z, int R, int C, int K, int parts, int track,
                                           int word_bits) {
  if (!valid_zlane_plan(Z, parts) || !valid_word(word_bits))
    return -static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  const cudaError_t err = prepare(pick_zlane_sumproduct_kernel(track, Z, word_bits),
                                  zlane_sumproduct_smem(Z, R, C, K, parts),
                                  retire_threads(Z, parts, 1), &blocks);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// Layered sum-product, as ldpc_retire_layered: `grid` blocks of `frames`
// frame groups of `parts` warps (times ceil(Z / 32)), each frame's beliefs
// and c2v in shared memory; at most 768 threads a block; `word_bits` sets
// the sign masks' word (the shared memory does not depend on it).
int ldpc_retire_layered_sumproduct(const void* llr, void* bits, void* conv, void* counter,
                                   const void* structure, int B, int Z, int R, int C, int K,
                                   int G, int T, int track, int parts, int frames, int grid,
                                   int word_bits, void* stream) {
  if (B < 1 || grid < 1 || G < 1 || !valid_layered_sumproduct_plan(Z, parts, frames) ||
      !valid_word(word_bits))
    return cudaErrorInvalidValue;
  const long long smem = layered_sumproduct_smem(Z, R, C, K, G, frames);
  const LayeredSumProductKernel kernel = pick_layered_sumproduct_kernel(track, Z, word_bits);
  const int threads = retire_threads(Z, parts, frames);
  cudaError_t err = prepare(kernel, smem, threads, nullptr);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(llr), static_cast<float*>(bits), static_cast<int*>(conv),
      static_cast<int*>(counter), static_cast<const int*>(structure), B, Z, R, C, K, G, T, parts);
  return cudaGetLastError();
}

long long ldpc_retire_layered_sumproduct_smem_bytes(int Z, int R, int C, int K, int G,
                                                    int frames) {
  return layered_sumproduct_smem(Z, R, C, K, G, frames);
}

int ldpc_retire_layered_sumproduct_occupancy(int Z, int R, int C, int K, int G, int parts,
                                             int frames, int track, int word_bits) {
  if (!valid_layered_sumproduct_plan(Z, parts, frames) || !valid_word(word_bits))
    return -static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  const cudaError_t err =
      prepare(pick_layered_sumproduct_kernel(track, Z, word_bits),
              layered_sumproduct_smem(Z, R, C, K, G, frames), retire_threads(Z, parts, frames),
              &blocks);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// Layered sum-product at large Z, as ldpc_retire_zlane_layered: `scratch`
// holds grid * frames slices of K*Z floats of c2v, one a frame group;
// `word_bits` sets the sign masks' word.
int ldpc_retire_zlane_layered_sumproduct(const void* llr, void* bits, void* conv, void* counter,
                                         void* scratch, const void* structure, int B, int Z,
                                         int R, int C, int K, int G, int T, int track, int parts,
                                         int frames, int grid, int word_bits, void* stream) {
  if (B < 1 || grid < 1 || G < 1 || !valid_zlane_layered_sumproduct_plan(Z, parts, frames) ||
      !valid_word(word_bits))
    return cudaErrorInvalidValue;
  const long long smem = zlane_layered_smem(Z, R, C, K, G, frames);
  const ZlaneLayeredSumProductKernel kernel =
      pick_zlane_layered_sumproduct_kernel(track, Z, word_bits);
  const int threads = retire_threads(Z, parts, frames);
  cudaError_t err = prepare(kernel, smem, threads, nullptr);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(llr), static_cast<float*>(bits), static_cast<int*>(conv),
      static_cast<int*>(counter), static_cast<float*>(scratch),
      static_cast<const int*>(structure), B, Z, R, C, K, G, T, parts, frames);
  return cudaGetLastError();
}

long long ldpc_retire_zlane_layered_sumproduct_smem_bytes(int Z, int R, int C, int K, int G,
                                                          int frames) {
  return zlane_layered_smem(Z, R, C, K, G, frames);
}

int ldpc_retire_zlane_layered_sumproduct_occupancy(int Z, int R, int C, int K, int G, int parts,
                                                   int frames, int track, int word_bits) {
  if (!valid_zlane_layered_sumproduct_plan(Z, parts, frames) || !valid_word(word_bits))
    return -static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  const cudaError_t err = prepare(pick_zlane_layered_sumproduct_kernel(track, Z, word_bits),
                                  zlane_layered_smem(Z, R, C, K, G, frames),
                                  retire_threads(Z, parts, frames), &blocks);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

const char* ldpc_retire_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
