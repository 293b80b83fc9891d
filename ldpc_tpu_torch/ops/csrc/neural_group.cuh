// neural_group, B3's redesign (replaces ldpc_tpu/ops/pallas_neural.py:111
// `kernel` on codes with rows of at most 121 members), on one check-state
// word: its kernels neural_group_kernel and neural_group_slice_kernel, the
// host side of their launch and its C entries (ldpc_neural_group and the
// plan queries).  What it computes, what bounds it and its design: the
// header of fused_neural.cu.
//
// The source that includes this header names the word first, as
// `NeuralWord` in the anonymous namespace (retire.cuh's unsigned, unsigned
// long long or Word128), and builds one library for it: fused_neural.cu the
// 32-bit word (rows of up to 27 members, route neural_group, beside
// fused_neural's kernel), fused_neural_wide.cu the 64-bit word (28 to 58,
// neural_group_wide) and fused_neural_w128.cu the 128-bit word (59 to 121,
// neural_group_w128).  Each word's 48 kernels (POW2, depth 0..4 and the
// run-time depth, staged or not, two slice forms) so compile side by side
// in three nvcc runs.
#pragma once

#include <cuda_runtime.h>

#include "retire.cuh"

namespace {

constexpr float kBig = 1e9f;  // stand-in for +inf, as _BIG in the JAX package

// ---------------------------------------------------------------------------
// neural_group_kernel: a frame on a group of warps, compressed check state,
// v2c rebuilt in the check pass, a check-aligned FIFO ring
// ---------------------------------------------------------------------------

// The deepest FIFO with forms of its own (template argument L = 0..4): depth
// 4 takes one more tap and read a rebuild, in every layout.  Deeper FIFOs
// take the run-time-depth form, L = kRunDepth.
constexpr int kMaxDepth = 4;
constexpr int kRunDepth = -1;

// Words of one iteration's channel weights (K*Z floats), rounded up to 16
// bytes: the wrapper pads each plane so that it can be copied in 16-byte
// pieces.
__host__ __device__ inline int plane_words(int Z, int K) { return (K * Z + 3) / 4 * 4; }

// A frame: its LLRs and column sums (C*Z floats each), its check state (A:
// R*Z float2, W: R*Z Words) and its FIFO (L planes of K*Z floats), rounded
// up to 16 bytes.  W starts 2 C*Z + 2 R*Z words in, so it is 8-byte aligned.
template <typename Word>
__host__ __device__ inline int group_frame_words(int Z, int R, int C, int K, int L) {
  return (2 * C * Z + kStateWords<Word> * R * Z + L * K * Z + 3) / 4 * 4;
}

// Frames a frame group decodes side by side: 32 / Z where Z <= 16 (lane =
// frame * Z + z), else one.
__host__ __device__ inline int frames_per_group(int Z) { return Z <= 16 ? 32 / Z : 1; }

template <typename Word>
long long group_smem(int Z, int R, int C, int K, int L, int parts, int groups, int staged) {
  return 4LL * (structure_words(R, C, K, parts) + (staged ? 2LL * plane_words(Z, K) : 0LL) +
                static_cast<long long>(groups) * frames_per_group(Z) *
                    group_frame_words<Word>(Z, R, C, K, L));
}

// Copies `words` floats (a multiple of 4, 16-byte aligned) from global to
// shared memory with cp.async, all threads of the block, as one group.
__device__ __forceinline__ void stage_plane(float* dst, const float* src, int words) {
  for (int i = 4 * threadIdx.x; i < words; i += 4 * blockDim.x) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst + i));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src + i) : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void staged_wait() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// What check pass p > 0 needs to rebuild its members' v2c: the variable half
// of iteration t = p - 1 as neural_decode_plain runs it.
struct Rebuild {
  const float* w;        // iteration t's channel weights, check-aligned (i*Z + z)
  float tap[kMaxDepth];  // w_res[t, l]
  int read[kMaxDepth];   // FIFO offset (slot * K*Z) of q_{t-l}, slot (t - l) mod L
  int write;             // FIFO offset of q_{t+1}, slot (t + 1) mod L
  int taps;              // taps whose message is stored: min(L, t)
  float live;            // 0 at t = 0, else 1
};

// The same for the run-time-depth form: the taps stay in the parameters
// (read through the read-only cache, one address a warp), and the FIFO
// offset of q_{t-l} steps down one plane a tap from slot t mod L, wrapping
// from slot 0 to slot L - 1, so no tap divides.
struct DeepRebuild {
  const float* w;    // as Rebuild's
  const float* tap;  // w_res[t, 0..L-1] in the parameters
  int first;         // FIFO offset of q_t: (t mod L) * K*Z
  int last;          // FIFO offset of slot L - 1: (L - 1) * K*Z
  int plane;         // K*Z
  int write;         // as Rebuild's
  int taps;          // as Rebuild's
  float live;        // as Rebuild's
};

// Check pass of lifted check (r, z).  FIRST (pass 0): member j's v2c is its
// LLR + 0.0 (-0.0 folds as +0.0, whose sign the plain version takes as +1).
// Otherwise it is rebuilt from its variable's column sum, its old c2v (the
// check's state, read once into registers), its weight times its LLR and
// the taps on its FIFO,
//   q = ((cs - c2v) + w * llr) + live * (sum over l < taps of tap_l * q_{t-l}),
// and stored in the FIFO before it is folded (its own slot, which only this
// thread reads: the member's edge is check-aligned).  q is never -0.0 (cs
// starts from +0.0, so neither cs - c2v nor the sums after it are), so its
// sign bit is its "< 0".  Taps whose slot the plain version holds at zero
// (t - l < 1) are left out: they add +-0.0 to a sum that is never -0.0.  The
// members are folded last first from a switch that falls through, as in
// fused_retire.cu's check_pass: with the 64-bit word a row of more than 27
// members folds members d - 1 .. 27 from a switch of its own first, with
// the 128-bit word a row of more than 58 folds members d - 1 .. 58 in a
// loop before that (the 32-bit word has neither, so its forms compile as
// they did).  Then the check's new state: A = alpha * max(m' - offset, 0)
// for m1 and m2 (m' the sentinel replaced by 0), W = output signs and
// argmin (Word, retire.cuh).  Exact: ((alpha * sp) * sign) * loo is +-(alpha
// * loo), since products of +-1 do not round, and at a tie every tied
// member's loo is the same; a negative alpha or offset changes none of
// that.  L = kRunDepth: the taps of a DeepRebuild, in a loop over min(L, t).
template <bool FIRST, bool POW2, int L, typename Word, typename Taps>
__device__ __forceinline__ void check_row(const Structure& s, const float* llr, const float* cs,
                                          float2* A, Word* W, float* fifo, const Taps& rb,
                                          float alpha, float offset, int r, int z, int Z) {
  const int q = r * Z + z;
  const int j0 = s.row_ptr[r], d = s.row_ptr[r + 1] - j0;
  const int2* mem = s.row_mem + j0;
  const int e0 = j0 * Z + z;  // member j's edge, check-aligned: e0 + j * Z
  const float2 a = FIRST ? make_float2(0.0f, 0.0f) : A[q];
  const Word w_old = FIRST ? Word{0} : W[q];
  float m1 = kBig, m2 = kBig;
  unsigned arg = kNoMember<Word>;
  Word neg = Word{0};
  auto member = [&](int j) {
    const int2 m = mem[j];
    const int v = rolled<POW2>(z, m.y, m.x, Z);
    float x;
    if constexpr (FIRST) {
      x = llr[v] + 0.0f;
    } else {
      const int e = e0 + j * Z;
      x = (cs[v] - c2v_of(a, w_old, j)) + rb.w[e] * llr[v];
      if constexpr (L == kRunDepth) {
        float res = 0.0f;
        int slot = rb.first;
        for (int l = 0; l < rb.taps; ++l) {
          res = res + __ldg(rb.tap + l) * fifo[slot + e];
          slot = slot == 0 ? rb.last : slot - rb.plane;
        }
        x = x + rb.live * res;
        fifo[rb.write + e] = x;
      } else if (L > 0) {
        float res = 0.0f;
#pragma unroll
        for (int l = 0; l < L; ++l)
          if (l < rb.taps) res = res + rb.tap[l] * fifo[rb.read[l] + e];
        x = x + rb.live * res;
        fifo[rb.write + e] = x;
      }
    }
    fold(x, j, m1, m2, arg, neg);
  };
#define NEURAL_MEMBER(J) \
  case (J) + 1:          \
    member(J);           \
    [[fallthrough]];
  if constexpr (kSignBits<Word> > 58)
    for (int j = d - 1; j >= 58; --j) member(j);
  if constexpr (kSignBits<Word> > 27) {
    switch (kSignBits<Word> > 58 && d > 58 ? 58 : d) {
      NEURAL_MEMBER(57) NEURAL_MEMBER(56) NEURAL_MEMBER(55) NEURAL_MEMBER(54) NEURAL_MEMBER(53)
      NEURAL_MEMBER(52) NEURAL_MEMBER(51) NEURAL_MEMBER(50) NEURAL_MEMBER(49) NEURAL_MEMBER(48)
      NEURAL_MEMBER(47) NEURAL_MEMBER(46) NEURAL_MEMBER(45) NEURAL_MEMBER(44) NEURAL_MEMBER(43)
      NEURAL_MEMBER(42) NEURAL_MEMBER(41) NEURAL_MEMBER(40) NEURAL_MEMBER(39) NEURAL_MEMBER(38)
      NEURAL_MEMBER(37) NEURAL_MEMBER(36) NEURAL_MEMBER(35) NEURAL_MEMBER(34) NEURAL_MEMBER(33)
      NEURAL_MEMBER(32) NEURAL_MEMBER(31) NEURAL_MEMBER(30) NEURAL_MEMBER(29) NEURAL_MEMBER(28)
      NEURAL_MEMBER(27)
      default:
        break;
    }
  }
  switch (kSignBits<Word> > 27 && d > 27 ? 27 : d) {
    NEURAL_MEMBER(26) NEURAL_MEMBER(25) NEURAL_MEMBER(24) NEURAL_MEMBER(23) NEURAL_MEMBER(22)
    NEURAL_MEMBER(21) NEURAL_MEMBER(20) NEURAL_MEMBER(19) NEURAL_MEMBER(18) NEURAL_MEMBER(17)
    NEURAL_MEMBER(16) NEURAL_MEMBER(15) NEURAL_MEMBER(14) NEURAL_MEMBER(13) NEURAL_MEMBER(12)
    NEURAL_MEMBER(11) NEURAL_MEMBER(10) NEURAL_MEMBER(9) NEURAL_MEMBER(8) NEURAL_MEMBER(7)
    NEURAL_MEMBER(6) NEURAL_MEMBER(5) NEURAL_MEMBER(4) NEURAL_MEMBER(3) NEURAL_MEMBER(2)
    NEURAL_MEMBER(1) NEURAL_MEMBER(0)
    default:
      break;
  }
#undef NEURAL_MEMBER
  const Word sp = product_flips(neg, d);
  const float m1z = m1 < kBig ? m1 : 0.0f, m2z = m2 < kBig ? m2 : 0.0f;
  A[q] = make_float2(alpha * fmaxf(m1z - offset, 0.0f), alpha * fmaxf(m2z - offset, 0.0f));
  W[q] = state_word(neg ^ sp, arg);
}

// Variable (c, z)'s c2v, expanded from the check states and summed from +0.0
// in col_members order.
template <bool POW2, typename Word>
__device__ __forceinline__ float state_column_sum(const Structure& s, const float2* A,
                                                  const Word* W, int c, int z, int Z) {
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
  return cs;
}

// What a form of depth L rebuilds with: Rebuild (L = 0..4) or DeepRebuild.
template <int L>
struct TapsOf {
  using type = Rebuild;
};
template <>
struct TapsOf<kRunDepth> {
  using type = DeepRebuild;
};

// B3 on frame groups.  A block holds `groups` groups of `parts` * ceil(Z /
// 32) warps, and a group decodes F = frames_per_group(Z) frames side by
// side (at Z <= 16 lane = f * Z + z: no frame leaves early, so frames can
// share a warp's passes).  Block b's groups take frames (b * groups + g) * F
// + f, then + gridDim.x * groups * F, ... (a group past the batch leaves,
// or, where a block barrier waits for it, decodes the batch's last frame
// again and writes nothing; so does a lane past the batch).  A frame runs T
// check passes, each followed by a column pass,
// with its group's named barrier between them; the last column pass writes
// the bits (llr + cs < 0).  STAGED: the channel weights are read from shared
// memory, copied there with cp.async: a shared plane once a block, per-
// iteration planes double-buffered, iteration t's plane (read by check pass
// t + 1) copied during iteration t, with one block barrier an iteration in
// place of the group's second.  Else each weight is read from global memory
// (L2), 32 consecutive floats a warp.  Word: the state word (retire.cuh).
// `flags`: per_iteration; in the run-time-depth form (L = kRunDepth) bit 0
// is per_iteration and the bits above it the depth.
template <bool POW2, int L, bool STAGED, typename Word>
__global__ void __launch_bounds__(kMaxThreads)
neural_group_kernel(const float* __restrict__ llr, float* __restrict__ bits,
                    const int* __restrict__ structure, const float* __restrict__ w,
                    const float* __restrict__ params, int B, int Z, int R, int C, int K, int T,
                    int flags, int parts, int groups) {
  using Taps = typename TapsOf<L>::type;
  const int per_iteration = L == kRunDepth ? flags & 1 : flags;
  const int depth = L == kRunDepth ? flags >> 1 : L;
  extern __shared__ __align__(16) float smem[];  // as neural_minsum_kernel declares it
  int* s_struct = reinterpret_cast<int*>(smem);
  const int pw = plane_words(Z, K);
  float* s_w = reinterpret_cast<float*>(s_struct + structure_words(R, C, K, parts));
  const bool restage = STAGED && per_iteration;
  if (STAGED && !per_iteration) {
    stage_plane(s_w, w, pw);
    staged_wait();  // load_structure's barrier makes the plane visible
  }
  const Structure s = load_structure(s_struct, structure, R, C, K, parts);
  const Lanes ln = lanes_of(s, Z, parts);
  const Group& grp = ln.grp;
  const int n = C * Z, KZ = K * Z, S = depth > 1 ? depth : 1;
  // The thread's frame within its group (fl) and lane (z); once, at start.
  const int F = frames_per_group(Z), fw = group_frame_words<Word>(Z, R, C, K, depth);
  const int lane = threadIdx.x & 31;
  const int fl = F > 1 ? min(lane / Z, F - 1) : 0;
  const int z = F > 1 ? lane - fl * Z : ln.z;
  const bool active = F > 1 ? lane < F * Z : ln.active;
  float* group_frames = s_w + (STAGED ? 2 * pw : 0) + ln.g * F * fw;
  float* frame = group_frames + fl * fw;
  float* s_llr = frame;
  float* s_cs = frame + n;
  float2* A = reinterpret_cast<float2*>(frame + 2 * n);  // 8-byte aligned: 2n is even
  Word* W = reinterpret_cast<Word*>(A + R * Z);
  float* fifo = reinterpret_cast<float*>(W + R * Z);
  const float* alpha = params;
  const float* offset = params + T;
  const float* w_res = params + 2 * T;  // (T, max(L, 1))

  for (int base = blockIdx.x * groups * F; base < B; base += gridDim.x * groups * F) {
    const int first = base + ln.g * F;
    if (first >= B && !restage) break;  // no block barrier waits for this group
    for (int k = 0; k < F; ++k) {
      const float* src = llr + static_cast<size_t>(min(first + k, B - 1)) * n;
      for (int i = ln.gi; i < n; i += grp.threads) group_frames[k * fw + i] = src[i];
    }
    const bool owner = first + fl < B;
    const int f = owner ? first + fl : B - 1;
    if (restage && T > 1) stage_plane(s_w, w, pw);  // iteration 0's, for check pass 1
    grp.sync();

    for (int p = 0; p < T; ++p) {
      if (active) {
        if (p == 0) {
          const Taps none{};
          for (int r = ln.r0; r < ln.r1; ++r)
            check_row<true, POW2, L>(s, s_llr, s_cs, A, W, fifo, none, __ldg(alpha),
                                     __ldg(offset), r, z, Z);
        } else {
          const int t = p - 1;
          Taps rb;
          rb.w = STAGED ? s_w + (restage ? (t & 1) * pw : 0)
                        : w + (per_iteration ? static_cast<size_t>(t) * pw : 0);
          rb.live = t > 0 ? 1.0f : 0.0f;
          rb.taps = min(depth, t);
          rb.write = depth > 0 ? (p % S) * KZ : 0;
          if constexpr (L == kRunDepth) {  // the taps from the parameters, a step a tap
            rb.tap = w_res + t * S;
            rb.first = (t % S) * KZ;
            rb.last = (S - 1) * KZ;
            rb.plane = KZ;
          } else {
#pragma unroll
            for (int l = 0; l < kMaxDepth; ++l) {
              rb.tap[l] = l < L ? __ldg(w_res + t * S + l) : 0.0f;
              rb.read[l] = l < L ? ((t - l + S) % S) * KZ : 0;
            }
          }
          for (int r = ln.r0; r < ln.r1; ++r)
            check_row<false, POW2, L>(s, s_llr, s_cs, A, W, fifo, rb, __ldg(alpha + p),
                                      __ldg(offset + p), r, z, Z);
        }
      }
      grp.sync();
      const bool last = p + 1 == T;
      if (active) {
        float* out = bits + static_cast<size_t>(f) * n;
        for (int c = ln.c0; c < ln.c1; ++c) {
          const int v = c * Z + z;
          const float cs = state_column_sum<POW2>(s, A, W, c, z, Z);
          if (!last)
            s_cs[v] = cs;
          else if (owner)
            out[v] = s_llr[v] + cs < 0.0f ? 1.0f : 0.0f;
        }
      }
      if (restage) {
        // Every group is past check pass p, which read the other buffer.
        staged_wait();
        __syncthreads();
        if (p + 1 < T - 1)
          stage_plane(s_w + ((p + 1) & 1) * pw, w + static_cast<size_t>(p + 1) * pw, pw);
      } else {
        grp.sync();  // the next pass (or frame) overwrites what this one read
      }
    }
  }
}

// The slice forms, for frames that do not fit a block.  In shared memory a
// frame's A (R*Z float2), its column sums (C*Z floats, padded to an even
// count where a Word is 8 bytes or more, so that W after them is 8-byte
// aligned) and, unless WSLICE, its state words W (R*Z Words), rounded up to
// 16 bytes (A first, so it is 8-byte aligned at any Z).
template <typename Word>
__host__ __device__ inline int slice_cs_words(int Z, int C) {
  return sizeof(Word) > 4 ? (C * Z + 1) / 2 * 2 : C * Z;
}
template <typename Word>
__host__ __device__ inline int slice_frame_words(int Z, int R, int C, bool wslice) {
  return (2 * R * Z + slice_cs_words<Word>(Z, C) +
          (wslice ? 0 : (kStateWords<Word> - 2) * R * Z) + 3) / 4 * 4;
}

// A frame's slice of the global scratch: W if WSLICE, then its FIFO (L
// planes of K*Z floats), rounded up to 16 bytes.
template <typename Word>
__host__ __device__ inline long long slice_words(int Z, int R, int K, int L, bool wslice) {
  return ((wslice ? static_cast<long long>(kStateWords<Word> - 2) * R * Z : 0LL) +
          static_cast<long long>(L) * K * Z + 3) / 4 * 4;
}

// B3 on frame groups, the slice forms: neural_group_kernel's frame loop and
// passes with the weights read from L2, where a frame's FIFO and, if
// WSLICE, its state words W live in its slice of `scratch` (slice (b *
// groups + g) * F + f for frame f of group g of block b) and its LLRs are
// read from its input row; A, the column sums and otherwise W stay in
// shared memory.  Entry r*Z + z of W and i*Z + z of each FIFO plane are
// read and written in the check pass only by the thread of check (r, z),
// and W is read by other threads of the group only after the group's
// barrier (column pass), so the slice needs no barrier of its own (a
// 128-bit W entry too: one thread writes both limbs, and no other reads
// them before the barrier); scratch is neither const nor __restrict__, so
// its loads are ordinary (coherent) ones, as retire_zlane_kernel's
// (fused_retire.cu).  `flags` as neural_group_kernel's.
template <bool POW2, int L, bool WSLICE, typename Word>
__global__ void __launch_bounds__(kMaxThreads)
neural_group_slice_kernel(const float* __restrict__ llr, float* __restrict__ bits,
                          const int* __restrict__ structure, const float* __restrict__ w,
                          const float* __restrict__ params, unsigned* scratch, int B, int Z,
                          int R, int C, int K, int T, int flags, int parts, int groups) {
  using Taps = typename TapsOf<L>::type;
  const int per_iteration = L == kRunDepth ? flags & 1 : flags;
  const int depth = L == kRunDepth ? flags >> 1 : L;
  extern __shared__ __align__(16) float smem[];  // as neural_minsum_kernel declares it
  int* s_struct = reinterpret_cast<int*>(smem);
  const Structure s = load_structure(s_struct, structure, R, C, K, parts);
  const Lanes ln = lanes_of(s, Z, parts);
  const Group& grp = ln.grp;
  const int n = C * Z, KZ = K * Z, S = depth > 1 ? depth : 1, pw = plane_words(Z, K);
  const int F = frames_per_group(Z);
  const int lane = threadIdx.x & 31;
  const int fl = F > 1 ? min(lane / Z, F - 1) : 0;
  const int z = F > 1 ? lane - fl * Z : ln.z;
  const bool active = F > 1 ? lane < F * Z : ln.active;
  const int slot = ln.g * F + fl;  // the thread's frame among the block's
  float2* A = reinterpret_cast<float2*>(smem + structure_words(R, C, K, parts) +
                                        slot * slice_frame_words<Word>(Z, R, C, WSLICE));
  float* s_cs = reinterpret_cast<float*>(A + R * Z);
  unsigned* own = scratch + (static_cast<size_t>(blockIdx.x) * groups * F + slot) *
                                slice_words<Word>(Z, R, K, depth, WSLICE);
  Word* W = reinterpret_cast<Word*>(WSLICE ? own : reinterpret_cast<unsigned*>(
                                                       s_cs + slice_cs_words<Word>(Z, C)));
  float* fifo = reinterpret_cast<float*>(WSLICE ? reinterpret_cast<unsigned*>(W + R * Z) : own);
  const float* alpha = params;
  const float* offset = params + T;
  const float* w_res = params + 2 * T;  // (T, max(L, 1))

  for (int base = blockIdx.x * groups * F; base < B; base += gridDim.x * groups * F) {
    const int first = base + ln.g * F;
    if (first >= B) break;
    const bool owner = first + fl < B;
    const int f = owner ? first + fl : B - 1;
    const float* lf = llr + static_cast<size_t>(f) * n;

    for (int p = 0; p < T; ++p) {
      if (active) {
        if (p == 0) {
          const Taps none{};
          for (int r = ln.r0; r < ln.r1; ++r)
            check_row<true, POW2, L>(s, lf, s_cs, A, W, fifo, none, __ldg(alpha), __ldg(offset),
                                     r, z, Z);
        } else {
          const int t = p - 1;
          Taps rb;
          rb.w = w + (per_iteration ? static_cast<size_t>(t) * pw : 0);
          rb.live = t > 0 ? 1.0f : 0.0f;
          rb.taps = min(depth, t);
          rb.write = depth > 0 ? (p % S) * KZ : 0;
          if constexpr (L == kRunDepth) {  // the taps from the parameters, a step a tap
            rb.tap = w_res + t * S;
            rb.first = (t % S) * KZ;
            rb.last = (S - 1) * KZ;
            rb.plane = KZ;
          } else {
#pragma unroll
            for (int l = 0; l < kMaxDepth; ++l) {
              rb.tap[l] = l < L ? __ldg(w_res + t * S + l) : 0.0f;
              rb.read[l] = l < L ? ((t - l + S) % S) * KZ : 0;
            }
          }
          for (int r = ln.r0; r < ln.r1; ++r)
            check_row<false, POW2, L>(s, lf, s_cs, A, W, fifo, rb, __ldg(alpha + p),
                                      __ldg(offset + p), r, z, Z);
        }
      }
      grp.sync();
      const bool last = p + 1 == T;
      if (active) {
        float* out = bits + static_cast<size_t>(f) * n;
        for (int c = ln.c0; c < ln.c1; ++c) {
          const int v = c * Z + z;
          const float cs = state_column_sum<POW2>(s, A, W, c, z, Z);
          if (!last)
            s_cs[v] = cs;
          else if (owner)
            out[v] = lf[v] + cs < 0.0f ? 1.0f : 0.0f;
        }
      }
      grp.sync();  // the next pass (or frame) overwrites what this one read
    }
  }
}

using GroupKernel = decltype(&neural_group_kernel<true, 0, false, NeuralWord>);

// The form of depth L: its own for L = 0..kMaxDepth, else the run-time one.
template <bool POW2, bool STAGED>
GroupKernel group_kernel_of_depth(int L) {
  switch (L) {
    case 0:
      return &neural_group_kernel<POW2, 0, STAGED, NeuralWord>;
    case 1:
      return &neural_group_kernel<POW2, 1, STAGED, NeuralWord>;
    case 2:
      return &neural_group_kernel<POW2, 2, STAGED, NeuralWord>;
    case 3:
      return &neural_group_kernel<POW2, 3, STAGED, NeuralWord>;
    case 4:
      return &neural_group_kernel<POW2, 4, STAGED, NeuralWord>;
    default:
      return &neural_group_kernel<POW2, kRunDepth, STAGED, NeuralWord>;
  }
}

GroupKernel pick_group_kernel(int Z, int L, int staged) {
  const bool pow2 = (Z & (Z - 1)) == 0;
  if (pow2)
    return staged ? group_kernel_of_depth<true, true>(L) : group_kernel_of_depth<true, false>(L);
  return staged ? group_kernel_of_depth<false, true>(L) : group_kernel_of_depth<false, false>(L);
}

using SliceKernel = decltype(&neural_group_slice_kernel<true, 0, true, NeuralWord>);

template <bool POW2, bool WSLICE>
SliceKernel slice_kernel_of_depth(int L) {
  switch (L) {
    case 0:
      return &neural_group_slice_kernel<POW2, 0, WSLICE, NeuralWord>;
    case 1:
      return &neural_group_slice_kernel<POW2, 1, WSLICE, NeuralWord>;
    case 2:
      return &neural_group_slice_kernel<POW2, 2, WSLICE, NeuralWord>;
    case 3:
      return &neural_group_slice_kernel<POW2, 3, WSLICE, NeuralWord>;
    case 4:
      return &neural_group_slice_kernel<POW2, 4, WSLICE, NeuralWord>;
    default:
      return &neural_group_slice_kernel<POW2, kRunDepth, WSLICE, NeuralWord>;
  }
}

// slice 1: the FIFO in the slices; 2: the FIFO and W.
SliceKernel pick_slice_kernel(int Z, int L, int slice) {
  const bool pow2 = (Z & (Z - 1)) == 0, wslice = slice == 2;
  if (pow2)
    return wslice ? slice_kernel_of_depth<true, true>(L) : slice_kernel_of_depth<true, false>(L);
  return wslice ? slice_kernel_of_depth<false, true>(L) : slice_kernel_of_depth<false, false>(L);
}

int group_threads(int Z, int parts, int groups) { return 32 * ((Z + 31) / 32) * parts * groups; }

// A block holds at most 1024 threads and 15 groups (one named barrier each);
// `slice` is 0 (a whole frame in shared memory), 1 (its FIFO in its slice)
// or 2 (its FIFO and W), and the slice forms read their weights from L2.
// Any depth whose FIFO offsets stay below 2^30 words ((L + 1) K*Z), which
// also keeps the run-time-depth form's flags (depth << 1) an int.
// `word_bits` must be this library's word's.
bool valid_group_plan(int Z, int K, int L, int parts, int groups, int staged, int slice,
                      int word_bits) {
  return L >= 0 && static_cast<long long>(L + 1) * K * Z < (1LL << 30) && parts >= 1 &&
         groups >= 1 && groups <= kMaxGroups && group_threads(Z, parts, groups) <= kMaxThreads &&
         slice >= 0 && slice <= 2 && !(staged && slice) &&
         word_bits == 8 * static_cast<int>(sizeof(NeuralWord));
}

long long group_block_smem(int Z, int R, int C, int K, int L, int parts, int groups, int staged,
                           int slice) {
  if (!slice) return group_smem<NeuralWord>(Z, R, C, K, L, parts, groups, staged);
  return 4LL * (structure_words(R, C, K, parts) +
                static_cast<long long>(groups) * frames_per_group(Z) *
                    slice_frame_words<NeuralWord>(Z, R, C, slice == 2));
}

// Sets the kernel's dynamic shared memory; with `blocks`, also asks the
// runtime how many blocks of `threads` can be resident on one SM.
template <typename Kernel>
cudaError_t prepare_group(Kernel kernel, long long smem, int threads, int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err == cudaSuccess && blocks != nullptr)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, threads, smem);
  return err;
}

// prepare_group for the layout's kernel.
cudaError_t prepare_layout(int Z, int R, int C, int K, int L, int parts, int groups, int staged,
                           int slice, int* blocks) {
  const long long smem = group_block_smem(Z, R, C, K, L, parts, groups, staged, slice);
  const int threads = group_threads(Z, parts, groups);
  return slice ? prepare_group(pick_slice_kernel(Z, L, slice), smem, threads, blocks)
               : prepare_group(pick_group_kernel(Z, L, staged), smem, threads, blocks);
}

}  // namespace

extern "C" {

// The entry point of neural_group_kernel and, where `slice` (1: the FIFO in
// the slices, 2: the FIFO and W), neural_group_slice_kernel: `grid` blocks
// of `groups` frame groups (each of frames_per_group(Z) frames) of `parts`
// parts (the structure's part tables, fused_minsum.py _retire_structure, its
// column members encoded for the word), weights check-aligned per plane
// (plane_words apart), STAGED where `staged`, on this library's state word
// (`word_bits` must name it: 32, 64 or 128); depth L > kMaxDepth on the
// run-time-depth form; `scratch` (slice forms) holds grid * groups *
// frames_per_group(Z) slices of ldpc_neural_group_slice_words.  Launches on
// `stream`, no sync; returns a cudaError_t (0 on success).
int ldpc_neural_group(const void* llr, void* bits, const void* structure, const void* w,
                      const void* params, void* scratch, int B, int Z, int R, int C, int K, int T,
                      int L, int per_iteration, int parts, int groups, int staged, int slice,
                      int grid, int word_bits, void* stream) {
  if (B < 1 || T < 1 || grid < 1 ||
      !valid_group_plan(Z, K, L, parts, groups, staged, slice, word_bits) ||
      (slice && scratch == nullptr))
    return cudaErrorInvalidValue;
  const long long smem = group_block_smem(Z, R, C, K, L, parts, groups, staged, slice);
  const int threads = group_threads(Z, parts, groups);
  cudaError_t err = prepare_layout(Z, R, C, K, L, parts, groups, staged, slice, nullptr);
  if (err != cudaSuccess) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* in = static_cast<const float*>(llr);
  auto* out = static_cast<float*>(bits);
  const auto* st = static_cast<const int*>(structure);
  const auto* wt = static_cast<const float*>(w);
  const auto* par = static_cast<const float*>(params);
  // the run-time-depth form reads its depth above per_iteration's bit
  const int flags = L > kMaxDepth ? (per_iteration != 0) | (L << 1) : per_iteration;
  if (slice) {
    const SliceKernel kernel = pick_slice_kernel(Z, L, slice);
    kernel<<<grid, threads, smem, s>>>(in, out, st, wt, par, static_cast<unsigned*>(scratch), B, Z,
                                       R, C, K, T, flags, parts, groups);
  } else {
    const GroupKernel kernel = pick_group_kernel(Z, L, staged);
    kernel<<<grid, threads, smem, s>>>(in, out, st, wt, par, B, Z, R, C, K, T, flags, parts,
                                       groups);
  }
  return cudaGetLastError();
}

// Bytes of dynamic shared memory of a neural_group launch (-1 where
// `word_bits` is not this library's).
long long ldpc_neural_group_smem_bytes(int Z, int R, int C, int K, int L, int parts, int groups,
                                       int staged, int slice, int word_bits) {
  if (word_bits != 8 * static_cast<int>(sizeof(NeuralWord))) return -1;
  return group_block_smem(Z, R, C, K, L, parts, groups, staged, slice);
}

// Words of one frame's slice of a slice form's scratch (-1 as above).
long long ldpc_neural_group_slice_words(int Z, int R, int K, int L, int slice, int word_bits) {
  if (word_bits != 8 * static_cast<int>(sizeof(NeuralWord))) return -1;
  return slice_words<NeuralWord>(Z, R, K, L, slice == 2);
}

// Resident blocks per SM of a neural_group launch with these arguments, or
// -cudaError_t.
int ldpc_neural_group_occupancy(int Z, int R, int C, int K, int L, int parts, int groups,
                                int staged, int slice, int word_bits) {
  if (!valid_group_plan(Z, K, L, parts, groups, staged, slice, word_bits))
    return -static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  const cudaError_t err = prepare_layout(Z, R, C, K, L, parts, groups, staged, slice, &blocks);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

const char* ldpc_neural_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
