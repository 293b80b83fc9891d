// The frame-group skeleton of the retiring min-sum kernels
// (fused_retire.cu) and of neural_group_kernel (fused_neural.cu): a frame
// decoded by a group of warps with a named barrier of its own, the structure
// tables of ldpc_tpu_torch/ops/fused_minsum.py _retire_structure, rolls
// without division, and the compressed check state (A = the two
// leave-one-out outputs, W = output signs and argmin).
//
// The state word W is a Word: unsigned (12 bytes a check with A) keeps the
// output signs of members 0..26 at bits 0..26 and the argmin in the top 5
// bits; unsigned long long (16 bytes a check) keeps members 0..57 at bits
// 0..57 and the argmin in the top 6, for rows of 28 to 58 members (58, not
// 64: the argmin needs its 6 bits, and a row of 64 would make 1 << 64
// undefined); Word128 (24 bytes a check), two 64-bit limbs, keeps members
// 0..120 at bits 0..120 and the argmin in the top 7, for rows of 59 to 121
// members.  The 32-bit forms below are the ones the kernels had before the
// word was a parameter, so those kernels compile as they did; the 64-bit
// ones are as they were, and every Word128 form is an overload of its own.
#pragma once

namespace {

// The 128-bit state word: bits 0..63 in lo, 64..127 in hi.  Its overloads
// below work limb by limb and never shift a limb by 64 or more.
struct Word128 {
  unsigned long long lo, hi;
  __host__ __device__ constexpr Word128(unsigned long long l = 0ull, unsigned long long h = 0ull)
      : lo(l), hi(h) {}
};
__device__ __forceinline__ Word128 operator|(Word128 a, Word128 b) {
  return Word128(a.lo | b.lo, a.hi | b.hi);
}
__device__ __forceinline__ Word128 operator^(Word128 a, Word128 b) {
  return Word128(a.lo ^ b.lo, a.hi ^ b.hi);
}
__device__ __forceinline__ Word128& operator|=(Word128& a, Word128 b) { return a = a | b; }

template <typename Word>  // members a state word holds signs of
constexpr int kSignBits = sizeof(Word) == 16 ? 121 : sizeof(Word) == 8 ? 58 : 27;
template <typename Word>  // argmin of a check whose every |v2c| >= kBig
constexpr unsigned kNoMember = 8 * sizeof(Word) - 1;
template <typename Word>  // words of a check's state: A (2) and W
constexpr int kStateWords = 2 + sizeof(Word) / 4;
constexpr int kMaxThreads = 1024;
constexpr int kMaxGroups = 15;  // named barriers 1..15, one a frame group

__host__ __device__ inline int structure_words(int R, int C, int K, int parts) {
  return (6 * K + R + C + 2 + 2 * (parts + 1) + 3) / 4 * 4;
}

// a with its sign bit flipped where bit 31 of `bits` is set.
__device__ __forceinline__ float flip_if(float a, unsigned bits) {
  return __uint_as_float(__float_as_uint(a) ^ (bits & 0x80000000u));
}

// Bit j of a state or sign word at bit 31 (flip_if reads no other bit).
__device__ __forceinline__ unsigned bit_at_31(unsigned w, int j) { return w << (31 - j); }
__device__ __forceinline__ unsigned bit_at_31(unsigned long long w, int j) {
  return static_cast<unsigned>(w >> j) << 31;
}
__device__ __forceinline__ unsigned bit_at_31(Word128 w, int j) {
  return static_cast<unsigned>((j < 64 ? w.lo : w.hi) >> (j & 63)) << 31;
}

// Whether the word has an odd number of bits set: 1 or 0.
__device__ __forceinline__ unsigned odd(unsigned w) { return __popc(w) & 1u; }
__device__ __forceinline__ unsigned odd(unsigned long long w) { return __popcll(w) & 1u; }
__device__ __forceinline__ unsigned odd(Word128 w) {
  return (__popcll(w.lo) + __popcll(w.hi)) & 1u;
}

// What turns the d members' v2c signs (neg: member j's at bit j) into
// their output signs, neg ^ product_flips: all d bits where the sign
// product is negative.
template <typename Word>
__device__ __forceinline__ Word product_flips(Word neg, int d) {
  return odd(neg) ? (Word{1} << d) - Word{1} : Word{0};
}
// The 128-bit form: a mask of d bits across the limbs (d <= 121).
__device__ __forceinline__ Word128 product_flips(Word128 neg, int d) {
  if (!odd(neg)) return Word128();
  return d < 64 ? Word128((1ull << d) - 1ull) : Word128(~0ull, (1ull << (d - 64)) - 1ull);
}

// A check's state word: output signs and argmin.
template <typename Word>
__device__ __forceinline__ Word state_word(Word signs, unsigned arg) {
  return signs | (static_cast<Word>(arg) << kSignBits<Word>);
}
__device__ __forceinline__ Word128 state_word(Word128 signs, unsigned arg) {
  return Word128(signs.lo,
                 signs.hi | (static_cast<unsigned long long>(arg) << (kSignBits<Word128> - 64)));
}

// The argmin a state word holds.
template <typename Word>
__device__ __forceinline__ unsigned argmin_of(Word w) {
  return static_cast<unsigned>(w >> kSignBits<Word>);
}
__device__ __forceinline__ unsigned argmin_of(Word128 w) {
  return static_cast<unsigned>(w.hi >> (kSignBits<Word128> - 64));
}

// The column-member fields of _retire_structure (m.z, m.w) read against a
// state word: whether the member is its check's argmin, and its output
// sign at bit 31.  32-bit word: (j << 27, 31 - j); 64-bit: (j, 63 - j);
// 128-bit: (j, 127 - j), where a shift by 127 - j >= 64 is one of lo by
// 63 - j.
__device__ __forceinline__ bool is_argmin(unsigned w, int mz) {
  return ((w ^ static_cast<unsigned>(mz)) & 0xf8000000u) == 0u;
}
__device__ __forceinline__ bool is_argmin(unsigned long long w, int mz) {
  return argmin_of(w) == static_cast<unsigned>(mz);
}
__device__ __forceinline__ unsigned member_sign(unsigned w, int mw) { return w << mw; }
__device__ __forceinline__ bool is_argmin(Word128 w, int mz) {
  return argmin_of(w) == static_cast<unsigned>(mz);
}
__device__ __forceinline__ unsigned member_sign(unsigned long long w, int mw) {
  return static_cast<unsigned>((w << mw) >> 32);
}
__device__ __forceinline__ unsigned member_sign(Word128 w, int mw) {
  return static_cast<unsigned>(((mw >= 64 ? w.lo : w.hi) << (mw & 63)) >> 32);
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
// int4: r*Z, shift, j << 27, 31 - j for member j of its row; j, 63 - j for
// the 64-bit state word; j, 127 - j for the 128-bit one), row members in
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
template <typename Word>
__device__ __forceinline__ float c2v_of(float2 a, Word w, int j) {
  return flip_if(static_cast<unsigned>(j) == argmin_of(w) ? a.y : a.x, bit_at_31(w, j));
}

// neg shifted up one with the sign bit of x below: (neg << 1) | (x < 0).
__device__ __forceinline__ unsigned push_sign(float x, unsigned neg) {
  return __funnelshift_l(__float_as_uint(x), neg, 1);
}
__device__ __forceinline__ unsigned long long push_sign(float x, unsigned long long neg) {
  return (neg << 1) | (__float_as_uint(x) >> 31);
}
// The 128-bit form carries bit 63 of lo into bit 0 of hi.
__device__ __forceinline__ Word128 push_sign(float x, Word128 neg) {
  return Word128((neg.lo << 1) | (__float_as_uint(x) >> 31), (neg.hi << 1) | (neg.lo >> 63));
}

// One member's v2c folded into the check's running state: m1, m2, the
// argmin and the sign bits.  Callers fold members last first, so with "<="
// the argmin is the first member that reaches m1, and (neg << 1) | sign puts
// member j's sign at bit j.  Callers never pass -0.0 (see layered_row in
// fused_retire.cu, check_row in fused_neural.cu), so the sign bit of x is
// its "< 0".
template <typename Word>
__device__ __forceinline__ void fold(float x, int j, float& m1, float& m2, unsigned& arg,
                                     Word& neg) {
  const float mag = fabsf(x);
  neg = push_sign(x, neg);
  arg = mag <= m1 ? static_cast<unsigned>(j) : arg;
  m2 = fminf(fmaxf(mag, m1), m2);
  m1 = fminf(mag, m1);
}

}  // namespace
