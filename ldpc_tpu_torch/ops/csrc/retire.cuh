// The frame-group skeleton of the retiring min-sum kernels
// (fused_retire.cu) and of neural_group_kernel (fused_neural.cu): a frame
// decoded by a group of warps with a named barrier of its own, the structure
// tables of ldpc_tpu_torch/ops/fused_minsum.py _retire_structure, rolls
// without division, and the 12-byte compressed check state (A = the two
// leave-one-out outputs, W = output signs and argmin).
#pragma once

namespace {

constexpr int kSignBits = 27;  // members a state word holds signs of
constexpr unsigned kNoMember = 31;  // argmin of a check whose every |v2c| >= kBig
constexpr int kMaxThreads = 1024;
constexpr int kMaxGroups = 15;  // named barriers 1..15, one a frame group

__host__ __device__ inline int structure_words(int R, int C, int K, int parts) {
  return (6 * K + R + C + 2 + 2 * (parts + 1) + 3) / 4 * 4;
}

// a with its sign bit flipped where bit 31 of `bits` is set.
__device__ __forceinline__ float flip_if(float a, unsigned bits) {
  return __uint_as_float(__float_as_uint(a) ^ (bits & 0x80000000u));
}

// The threads of one frame group: a warp, or `threads` threads that share
// named barrier `id` (1..15; 0 is __syncthreads').
struct Group {
  int id, threads;
  __device__ __forceinline__ void sync() const {
    if (threads == 32)
      __syncwarp();
    else
      asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
  }
  // A barrier that also returns whether any thread of the group passed true.
  __device__ __forceinline__ bool sync_or(bool pred) const {
    if (threads == 32) {
      const bool any = __any_sync(0xffffffffu, pred);
      __syncwarp();
      return any;
    }
    unsigned out;
    asm volatile(
        "{\n\t.reg .pred p, q;\n\t"
        "setp.ne.u32 p, %1, 0;\n\t"
        "bar.red.or.pred q, %2, %3, p;\n\t"
        "selp.u32 %0, 1, 0, q;\n\t}"
        : "=r"(out)
        : "r"(static_cast<unsigned>(pred)), "r"(id), "r"(threads)
        : "memory");
    return out != 0u;
  }
};

// Structure in shared memory, as ldpc_tpu_torch/ops/fused_minsum.py
// _retire_structure lays it out: column members in col_members order (K
// int4: r*Z, shift, j << 27, 31 - j for member j of its row), row members in
// row order (K int2: col*Z, shift), row_ptr (R+1),
// col_ptr (C+1), and the first row and column of each part (parts+1 each).
struct Structure {
  const int4* col_mem;
  const int2* row_mem;
  const int* row_ptr;
  const int* col_ptr;
  const int* row_part;
  const int* col_part;
};

// Lane v of a roll by s of a circulant block: (z + s) mod Z, where s < Z.
// With Z a power of two it is (z + s) & (Z - 1), and OR-ing in the block's
// offset (a multiple of Z) adds it.
template <bool POW2>
__device__ __forceinline__ int rolled(int z, int s, int offset, int Z) {
  if (POW2) return ((z + s) & (Z - 1)) | offset;
  int v = z + s;
  v -= v >= Z ? Z : 0;
  return v + offset;
}

// The structure, copied into shared memory at s_struct; ends with a barrier.
__device__ __forceinline__ Structure load_structure(int* s_struct, const int* __restrict__ structure,
                                                    int R, int C, int K, int parts) {
  for (int i = threadIdx.x; i < 6 * K + R + C + 2 + 2 * (parts + 1); i += blockDim.x)
    s_struct[i] = structure[i];
  Structure s;
  s.col_mem = reinterpret_cast<const int4*>(s_struct);
  s.row_mem = reinterpret_cast<const int2*>(s_struct + 4 * K);
  s.row_ptr = s_struct + 6 * K;
  s.col_ptr = s.row_ptr + R + 1;
  s.row_part = s.col_ptr + C + 1;
  s.col_part = s.row_part + parts + 1;
  __syncthreads();
  return s;
}

// What a thread works on.  A frame group is `parts` * ceil(Z / 32) warps;
// warp w of group g covers lanes z = 32 * (w % zw) + lane (zw = ceil(Z / 32)
// warps span Z) and part w / zw: the rows and columns between
// row_part / col_part [part] and [part + 1].  Thread (z, part) owns lifted
// checks (r, z) and variables (c, z) of its part's rows and columns.
struct Lanes {
  Group grp;
  int g, gi;  // the group, and the thread's index within it
  int z, r0, r1, c0, c1;
  bool active;
};

__device__ __forceinline__ Lanes lanes_of(const Structure& s, int Z, int parts) {
  const int zw = (Z + 31) / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gwarps = zw * parts;
  const int g = warp / gwarps, wg = warp - g * gwarps;
  const int part = wg / zw;
  Lanes t;
  t.grp = Group{g + 1, 32 * gwarps};
  t.g = g;
  t.gi = 32 * wg + lane;
  t.z = 32 * (wg - part * zw) + lane;
  t.active = t.z < Z;
  t.r0 = s.row_part[part];
  t.r1 = s.row_part[part + 1];
  t.c0 = s.col_part[part];
  t.c1 = s.col_part[part + 1];
  return t;
}

// Member j's c2v, expanded from its check's state (a: alpha*m1, alpha*m2;
// w: output sign of member j at bit j, argmin in the top bits).
__device__ __forceinline__ float c2v_of(float2 a, unsigned w, int j) {
  return flip_if(static_cast<unsigned>(j) == (w >> kSignBits) ? a.y : a.x, w << (31 - j));
}

// One member's v2c folded into the check's running state: m1, m2, the
// argmin and the sign bits.  Callers fold members last first, so with "<="
// the argmin is the first member that reaches m1, and (neg << 1) | sign puts
// member j's sign at bit j.  Callers never pass -0.0 (see layered_row in
// fused_retire.cu, check_row in fused_neural.cu), so the sign bit of x is
// its "< 0".
__device__ __forceinline__ void fold(float x, int j, float& m1, float& m2, unsigned& arg,
                                     unsigned& neg) {
  const float mag = fabsf(x);
  neg = __funnelshift_l(__float_as_uint(x), neg, 1);
  arg = mag <= m1 ? static_cast<unsigned>(j) : arg;
  m2 = fminf(fmaxf(mag, m1), m2);
  m1 = fminf(mag, m1);
}

}  // namespace
