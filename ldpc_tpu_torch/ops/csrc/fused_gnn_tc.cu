// B4 and B5 on the tensor cores for Hopper (sm_90a): the whole decode of
// the flagship corrected min-sum GNN (T iterations of scaled min-sum, each
// half-update followed by a GNN correction) in one kernel launch, the
// correction's products as bf16 mma.sync tiles with float32 accumulators.
// Two kernels share the min-sum skeleton (decode_frames), the staging and
// the tile helpers:
//
//   corrected_v2_tc_kernel<H, INJ>  <- ldpc_tpu/ops/pallas_gnn.py:1791
//     _corrected_kernel_v2 (make_fused_corrected_gnn_decoder_v2, pallas_call
//     at :2105), B4: the second layer folded; entry ldpc_corrected_gnn, v1 = 0.
//   corrected_tc_kernel<H, INJ>     <- ldpc_tpu/ops/pallas_gnn.py:1341
//     _corrected_kernel (make_fused_corrected_gnn_decoder, pallas_call at
//     :1672), B5: the second layer not folded; entry ldpc_corrected_gnn,
//     v1 = 1 (see "B5" below).
//
// H is the hidden width, built for 16 and 64; INJ is input injection.  The
// Python wrapper, the packed weight layout (pack_corrected_tc_weights) and
// the plain PyTorch version (_Plain): ldpc_tpu_torch/ops/fused_gnn.py.
//
// What it computes, per frame
// ---------------------------
// Messages are var-aligned per base edge k: message e = k*Z + z belongs to
// variable (col[k], z) and to check (row[k], (z - shift[k]) mod Z).  v2c
// starts as the channel LLR of the edge's variable, c2v as 0.  T times:
//   1. check half: c2v = alpha * sign product * leave-one-out min of |v2c|
//      over the check's members (running m1/m2, sign(0) = +1, sentinel 1e9);
//   2. c2v += correction(layer 2t, v2c);
//   3. colsum = per-variable sum of c2v (col_members order);
//   4. early_exit only: hard decisions llr + colsum < 0, syndrome as an XOR
//      of decision bits; a frame whose syndrome is valid writes its 0/1
//      decisions, records conv_iter = t + 1 and stops;
//   5. v2c = (colsum - c2v) + w_ch * llr;  v2c += correction(layer 2t+1, c2v).
// A frame that never stopped writes 1 / (1 + exp(llr + colsum)) with the
// last colsum, and conv_iter = T.  Step 5 of the last iteration feeds nothing
// and is skipped, so a frame that runs conv_iter iterations runs
// 2 conv_iter - 1 corrections.
//
// B4's correction of layer idx, for every message with scalar value m and
// type tau (weights rounded to bf16 by the wrapper):
//   f      = bf16(m * emb_w + ebias[tau])          ebias = emb_b + type embedding
//   vmean  = bf16(sum of f over the variable's messages * (1 / degree))
//   lf     = bf16(llr * emb_w + emb_b)             (INJ only)
//   pre_col = ((W1va vmean) + b1v) + W1vl lf       per variable
//   pre_row = (sum over the check's members of W1ca f) * (1 / degree) + b1c
//   pv     = (W1vf f) + pre_col
//   pc     = ((W1cf f) + pre_row) + W1cl lf        (lf of the message's variable)
//   corr   = (w2pv . bf16(relu(pv)) + w2pc . bf16(relu(pc))) + cconst
// with w2p = bf16(pw^T [W2v W2c]) and cconst = bf16(pw.(b2v + b2c) + pb)
// folded by the wrapper.  Against the plain version only the float32
// summation order inside a product changes (the tensor cores sum a k-tile in
// their own order; the check's members are summed as products, which is the
// TPU kernel's own formula, pallas_gnn.py:1854-1862, where the plain version
// sums the features first).  Every bf16 rounding point and every other
// operation is the plain version's, in its order.
//
// The bound of both kernels (chip_smoke.py gnn_bound_ms)
// -------------------------------------------------------
// The least work of the function, whatever the design.  Per correction of
// one frame, with E = K*Z messages, n = C*Z variables, M = R*Z checks, inj =
// 1 with input injection:
//   products: (2E + (1 + 2 inj) n + M) products of (h, h) by a vector, 2h^2
//     operations each (W1vf f and W1cf f a message; W1va vmean, W1vl lf and
//     W1cl lf a variable; W1ca a check); plus the second layer: B4's thin
//     product 2 * 2h * E, B5's two (h, h) products and the projection,
//     (4h^2 + 2h) E.  They are bf16 x bf16 -> float32 products, counted at
//     the tensor cores' dense bf16 rate, 989e12 per second.
//   elementwise float32 (none an FMA, so 33.5e12 per second):
//     B4: (8 + inj) h E + (2 + 3 inj) h n + 3 h M + E
//         (embed 2, variable sum 1, check sum 1, add the shared term and
//          ReLU 2 for pv and 2 + inj for pc a message and feature; mean and
//          bias a variable, embed and add of lf; mean and bias a check)
//     B5: (15 + inj) h E + (1 + 3 inj) h n + h M + E
//         (embed 2, variable sum 1, check sum 1, add the shared term, the
//          per-edge bias and ReLU for pv (3) and pc (3 + inj), b2 for out_v
//          and out_c 2, their sum 1, the projection's multiply and sum 2 a
//          message and feature; mean a variable, embed and add of lf; mean
//          a check; pb a message).
// Per iteration the min-sum skeleton adds 12 E + 4 M + 2 n float32 and, with
// early_exit, E + M int32 operations (16.75e12 per second).  A frame needs
// conv_iter iterations and 2 conv_iter - 1 corrections.  LLRs are read and
// soft bits written once (8 n + 4 bytes a frame at 3.35e12 bytes per
// second).  The bound is the larger of the tensor-core time and the float32
// and int32 time, or the bytes' time if that is larger.  At gnn_main
// (nr_2_0_32 Z=32 h=64, inj): B4 157e6 product operations a correction
// against 4.4e6 elementwise, B5 259e6 against 7.0e6 (0.262 us against
// 0.208 us a correction of a frame): both are bound by the products, 2.567
// ms (B4) and 4.243 ms (B5) for the batch of 2048 at 0 dB.
//
// B4's design
// ------------
// A frame's whole state lives in shared memory: v2c, c2v, the variable-side
// partial correction of each message (one float), the LLRs, the column sums,
// the graph, the embedding, the layer's small vectors, its ebias table and
// its weights as bf16 [out][in] rows padded by 8 bf16 (so the eight 16-byte
// rows one ldmatrix phase reads fall in eight different bank quads): W1vf,
// W1cf, W1ca, W1va, then W1vl, W1cl with injection.  No global scratch.
// The weights, small vectors and ebias table of the next correction stage
// with cp.async while the min-sum half-update runs.  A correction is two
// passes, each warp taking 16-row tiles, rows in the mma's M:
//   A. variable-major: 16 flat variables c*Z + z a tile (any Z: at Z < 16 a
//      tile spans columns of different degree; a row past its degree, or past
//      the last variable, is a zero A row and writes nothing).  Each thread
//      sums its rows' member features for its 16 (H = 64) columns in
//      registers, in member order, for vmean; pre_col is two products; then
//      per member slot the A fragment of f is built in registers from the
//      message scalar (no ldmatrix for A), W1vf f + pre_col, relu, bf16, and
//      the thin w2pv product (one more mma a k-tile, w2pv in column 0 of B)
//      gives the message's variable-side partial, stored in shared memory.
//   B. check-major: 16 flat checks r*Z + zc a tile.  pre_row accumulates
//      W1ca f over the members in one accumulator; then per member slot W1cf
//      f (+ W1cl lf) + pre_row, relu, bf16, the thin w2pc product, plus the
//      partial and cconst into `out`.
// `out` is never the array the correction reads (c2v for the check half's,
// v2c for the var half's), and each message belongs to one variable and one
// check, so both passes update in place.  Each weight fragment a thread
// reads (ldmatrix.x4, two n-tiles of one k-tile) feeds two mma; the member
// loops walk the n-tiles in pairs, so a pair's first-layer outputs are the
// thin product's k-tile and never leave registers.
//
// Block shape (both kernels): the plan asks the runtime's occupancy query for
// every warp count from 1 to kMaxWarps and takes the one with the most
// resident warps per SM (ties: the smaller block, so more frames are in
// flight).  Frames are handed to blocks through an atomic counter, because
// frames stop after different numbers of iterations.
//
// Flags: built without -fmad=false.  The only products are the mma's; every
// elementwise multiply that is followed by an add (the embedding, the means'
// scales, the var-half update) is written with __fmul_rn / __fadd_rn, which
// the compiler never contracts into an FMA, and the min-sum scale is a
// product of three multiplies with no add.  So the flag would change no
// result here.
//
// What bounds B4 on the card
// ---------------------------
// The least work is B4's bound in chip_smoke.py (gnn_bound_ms): 2E + (1 +
// 2 inj) n + M (h, h) products a correction of a frame at the dense bf16
// rate, plus the thin second layer (E = K*Z messages, n = C*Z variables, M =
// R*Z checks); 2.567 ms at gnn_main (nr_2_0_32 Z=32 h=64, T=10, batch 2048).
// This design does (3 + inj) E + (1 + inj) n (h, h) products (each message's
// W1ca product, and W1cl lf per message instead of per variable): 1.5x at
// the main path.  What bounds it is not the tensor cores but the work around
// them: each message's features are built from its scalar five times a
// correction (the variable sum, pass A's member loop, pass B's W1ca sum and
// member loop, and the LLR features), and each first-layer output passes an
// add, a ReLU and a bf16 pack; those and the weight fragments' ldmatrix
// traffic share the issue slots of 12 warps, which 168 registers a thread
// leave an SM.  Holding the fragments of one matrix in registers, or more
// warps with fewer registers, bought little; computing both rows of a
// fragment unconditionally (so they share the emb_w loads) and dealing tiles
// from a queue did.  Shared memory at the main path (H = 64, injection):
// 104,208 B of state and 55,296 B of weights (36,864 B without injection),
// one block per SM; at nr_2_0_4 Z = 4 74,496 B, three blocks of 4 warps.
//
// H = 128 under this design: 6 padded matrices are 6 * 128 * 136 * 2 =
// 208,896 B; with a frame's state that is past the 232,448 B a block can
// use (not built).
//
// B5
// --
// The same skeleton; the correction of layer idx, for every message e = (k, z)
// with scalar value m (weights rounded to bf16 by the wrapper, bias1v and
// bias1c the per-edge float32 first-layer biases that carry the type
// embeddings), in the plain version's rounding points and order:
//   f      = bf16(m * emb_w + emb_b)
//   vmean  = bf16(sum of f over the variable's messages, in member order,
//                 * (1 / degree))
//   lf     = bf16(llr * emb_w + emb_b)                       (INJ only)
//   rmean  = bf16(sum of f over the check's members, in row order,
//                 * (1 / degree))
//   pre_col = (W1va vmean) + W1vl lf,  pre_llr = W1cl lf     per variable
//   pv     = ((W1vf f) + pre_col) + bias1v[k]
//   pc     = ((W1cf f + W1ca rmean) + bias1c[k]) + pre_llr
//   out_v  = bf16(W2v bf16(relu(pv)) + b2v),  out_c = bf16(W2c bf16(relu(pc)) + b2c)
//   lo     = bf16(out_v + out_c)
//   corr   = sum_j lo_j pw_j + pb                            (float32)
// Against the plain version only float32 summation orders change: inside
// each product (the tensor cores' order, W1cf f and W1ca rmean in one
// accumulator) and in the projection (a thread's 16 columns, then the quad).
//
// Why one pass, where B4 takes two: lo = bf16(out_v + out_c) couples the
// variable side and the check side of a message through a rounding, so no
// scalar partial can carry one side to the other (B4's pass A hands pass B
// one float a message).  The whole h-vector out_v of every message would
// have to wait, E * h * 2 bytes = 807 KB a frame at nr_2_0_32 Z=32, which
// fits neither shared memory nor, for 132 frames, L2.  So one
// variable-major pass computes both sides of each message: per 16-row tile
// of flat variables (at Z < 16 a tile spans columns, as in B4's pass A),
// vmean in registers in member order, pre_col in registers and pre_llr in
// the warp's slice of shared memory (4 KB a warp at H = 64, which leaves
// the registers to the accumulators); then per member slot the message's
// check mean is rebuilt from
// its check's message scalars in row order (rmean is one per check, but
// there is no room to keep it: M * h * 2 = 172 KB a frame), f is built, the
// check side runs (its out_c packed to bf16 in registers), then the
// variable side, each first layer's n-tile pair p feeding its second
// layer's k-tile p straight from the accumulators (no shared memory), then
// lo, the projection as float32 products summed over a quad's lanes with
// two shuffles, and out[e] += corr in place.  bias1v[k], bias1c[k] (2 K H
// floats a layer, 100 KB at the main path) are not staged: a tile's 16
// rows read one 256 B row of each from L2 per member slot.  A check mean
// rebuilt per message costs sum over rows of degree^2 / K feature builds a
// message (1035 / 197 = 5.3 at NR BG2); check-major tiles rebuilding each
// variable's mean instead would cost sum of degree^2 over columns / K =
// 11.6 and two more products a message.
//
// B5's work: 5E + (1 + 2 INJ) n (h, h) products a correction (W1vf f, W1cf
// f, W1ca rmean, W2v, W2c a message; W1va vmean, W1vl lf, W1cl lf a
// variable), against the bound's 4E + (1 + 2 INJ) n + M ("The bound of
// both kernels" above): 1.16x at the main path.  What bounds it is not the tensor
// cores but the work around them on 12 warps of 168 registers: the check
// means' feature builds (each value a multiply, an add, half a bf16 pack,
// an unpack and an add, 5.3 times a message), the two second-layer
// epilogues (bias, bf16, sum, bf16, projection), and the bias rows from L2.
// ldpc_tpu_torch/tools/probe_corrected_split.py times builds without each
// part: on an H100 (700 W) at gnn_main with T fixed at 10, the check-mean
// rebuilds take 30% of the time, the second layer's products 13%, the bias
// rows 7%, everything outside the member loop 6%.  The 36 B a thread spills
// at 168 registers: at 8 warps a build that keeps 238 registers and spills
// nothing is 6% faster than the spilling one, and 12 spilling warps are
// faster than both.
// Shared memory (make_layout): graph, inverse degrees, v2c, c2v, LLRs,
// column sums, embedding, the layer's b2v, b2c, pw, pb and its 8 (6
// without injection) padded bf16 matrices W1vf, W1cf, W1ca, W1va, (W1vl,
// W1cl,) W2v, W2c, plus a warp's pre_llr tile: at nr_2_0_32 Z=32, H = 64
// with injection 70,544 B of state, 73,728 B of weights and 12 x 4,096 B,
// 193,424 B for one block of 12 warps an SM; at nr_2_0_4 Z=4 14,768 B of
// state, 113,072 B a block of 6 warps, two blocks an SM.  No global
// scratch.  H = 128: 8 * 128 * 136 * 2 = 278,528 B of weights alone, past a
// block (not built).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxWarps = 12;
constexpr int kTile = 16;  // rows a tile: the mma's M
constexpr float kBig = 1e9f;  // stand-in for +inf, as _BIG in the JAX package

// First-layer weight matrices of a layer, in packing order; kWvl and kWcl
// with injection only.  B5 stages W2v, W2c after them.
enum { kWvf = 0, kWcf, kWca, kWva, kWvl, kWcl };

__host__ __device__ inline int round4(int x) { return (x + 3) / 4 * 4; }
// (H, H) matrices staged a layer: the first layer's, plus B5's W2v, W2c.
__host__ __device__ constexpr int num_mats(int inject, bool v1 = false) {
  return (inject ? 6 : 4) + (v1 ? 2 : 0);
}

template <int H>
struct Shape {
  static constexpr int WS = H + 8;     // padded row of a weight matrix (bf16)
  static constexpr int MAT = H * WS;   // one padded matrix
  static constexpr int NT = H / 8;     // n-tiles of an h-wide output
  static constexpr int KT = H / 16;    // k-tiles of an h-wide input
};

struct Args {
  const float* llr;          // (B, n)
  float* soft;               // (B, n)
  float* conv;               // (B,) or nullptr
  int* counter;              // next frame to hand out, starts at 0
  const int* graph;          // row_ptr, row_edge, col_ptr, col_edge, shift, col, row, type
  const float* inv;          // 1/degree per column (C), then per row (R)
  const __nv_bfloat16* w;    // (2T, NM, H, H + 8) packed, NM = num_mats(inject, v1)
  const float* tab;          // B4: (2T, ntypes, H) ebias per message type;
                             // B5: (2T, 2, K, H) bias1v, bias1c per base edge
  const float* small;        // B4: (2T, 4H + 4) b1v, b1c, w2pv, w2pc, cconst, 3 zeros;
                             // B5: (2T, 3H + 4) b2v, b2c, pw, pb, 3 zeros
  const float* emb;          // emb_w (H), emb_b (H)
  int B, Z, R, C, K, ntypes, T, early_exit;  // ntypes: B4 only
  float w_ch, alpha;
};

__host__ __device__ inline int small_floats(int H, bool v1) { return (v1 ? 3 : 4) * H + 4; }

// Byte offsets of a block's dynamic shared memory (all 16-byte aligned).
// B4 (v1 false) keeps a partial a message and an ebias table; B5 (v1 true)
// keeps neither, stages W2v and W2c and, with injection, gives each of its
// `warps` warps a tile's pre_llr (kTile x H floats).
struct Layout {
  int graph, inv, v2c, c2v, part, llr, colsum, emb, small, tab, w, pl, total;
};

__host__ __device__ inline Layout make_layout(bool v1, int H, int inject, int Z, int R, int C,
                                              int K, int ntypes, int warps) {
  Layout L;
  int o = 0;
  L.graph = o; o += 4 * round4(6 * K + R + C + 2);
  L.inv = o; o += 4 * round4(C + R);
  L.v2c = o; o += 4 * round4(K * Z);
  L.c2v = o; o += 4 * round4(K * Z);
  L.part = o; o += v1 ? 0 : 4 * round4(K * Z);
  L.llr = o; o += 4 * round4(C * Z);
  L.colsum = o; o += 4 * round4(C * Z);
  L.emb = o; o += 4 * 2 * H;
  L.small = o; o += 4 * small_floats(H, v1);
  L.tab = o; o += v1 ? 0 : 4 * ntypes * H;
  L.w = o; o += 2 * num_mats(inject, v1) * H * (H + 8);
  L.pl = o; o += v1 && inject ? 4 * warps * kTile * H : 0;
  L.total = o;
  return L;
}

__device__ __forceinline__ float sign_of(float x) { return x < 0.0f ? -1.0f : 1.0f; }

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// d += a (16x16, row) * b (16x8, col), bf16 in, float32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 in one register, lo in the low half (the lower
// column of a fragment).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The two bf16 halves of a register that pack_bf16 filled, as floats.
__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// The bf16 features m * w + b at columns q, q + 1 (w already loaded).
__device__ __forceinline__ uint32_t embed2(float m, float2 w, const float* b, int q) {
  const float2 bv = *reinterpret_cast<const float2*>(b + q);
  return pack_bf16(__fadd_rn(__fmul_rn(m, w.x), bv.x), __fadd_rn(__fmul_rn(m, w.y), bv.y));
}

// The A fragments (every k-tile) of the features m * emb_w + bias of a
// tile's rows g (m0, bias row b0) and g + 8 (m1, b1); a row that is not ok
// holds no message: zeros.  Both rows are computed unconditionally (any
// valid bias row will do for a row that is not ok), so they share the
// emb_w loads.
template <int H>
__device__ __forceinline__ void feature_frags(uint32_t (&a)[H / 16][4], const float* emb_w,
                                              float m0, const float* b0, bool ok0, float m1,
                                              const float* b1, bool ok1, int tig) {
#pragma unroll
  for (int kt = 0; kt < H / 16; ++kt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int q = kt * 16 + 2 * tig + 8 * half;
      const float2 w = *reinterpret_cast<const float2*>(emb_w + q);
      const uint32_t v0 = embed2(m0, w, b0, q), v1 = embed2(m1, w, b1, q);
      a[kt][2 * half] = ok0 ? v0 : 0u;
      a[kt][2 * half + 1] = ok1 ? v1 : 0u;
    }
  }
}

// x0, x1 (rows g, g + 8) += the bf16 features of one message each at the
// thread's columns q, q + 1, q + 8, q + 9 of each k-tile (q = 16 kt + 2 tig),
// where ok0, ok1.
template <int H>
__device__ __forceinline__ void add_features(float (&x0)[H / 16][4], float (&x1)[H / 16][4],
                                             const float* emb_w, float m0, const float* b0,
                                             bool ok0, float m1, const float* b1, bool ok1,
                                             int tig) {
#pragma unroll
  for (int kt = 0; kt < H / 16; ++kt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int q = kt * 16 + 2 * tig + 8 * half;
      const float2 w = *reinterpret_cast<const float2*>(emb_w + q);
      const uint32_t v0 = embed2(m0, w, b0, q), v1 = embed2(m1, w, b1, q);
      const float2 f0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v0));
      const float2 f1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v1));
      if (ok0) {
        x0[kt][2 * half] = __fadd_rn(x0[kt][2 * half], f0.x);
        x0[kt][2 * half + 1] = __fadd_rn(x0[kt][2 * half + 1], f0.y);
      }
      if (ok1) {
        x1[kt][2 * half] = __fadd_rn(x1[kt][2 * half], f1.x);
        x1[kt][2 * half + 1] = __fadd_rn(x1[kt][2 * half + 1], f1.y);
      }
    }
  }
}

// acc += A * W^T over all H outputs for one k-tile kt: A's 16 rows by
// inputs 16 kt .. 16 kt + 15 (fragment a), W a padded (H x H) [out][in]
// matrix in shared memory.
template <int H>
__device__ __forceinline__ void product_ktile(float (&acc)[H / 8][4], const uint32_t (&a)[4],
                                              const __nv_bfloat16* W, int kt, int lane) {
  const int brow = (lane >> 4) * 8 + (lane & 7), bcol = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int p = 0; p < H / 16; ++p) {
    uint32_t w[4];
    ldmatrix_x4(w, W + (p * 16 + brow) * Shape<H>::WS + kt * 16 + bcol);
    mma_bf16(acc[2 * p], a, w[0], w[1]);
    mma_bf16(acc[2 * p + 1], a, w[2], w[3]);
  }
}

// acc += A * W^T over all H outputs: A the k-tiles a[kt] (16 rows).
template <int H>
__device__ __forceinline__ void product(float (&acc)[H / 8][4], const uint32_t (&a)[H / 16][4],
                                        const __nv_bfloat16* W, int lane) {
#pragma unroll
  for (int kt = 0; kt < H / 16; ++kt) product_ktile<H>(acc, a[kt], W, kt, lane);
}

// acc[0..1] += A * W^T for outputs 16p .. 16p + 15 (n-tiles 2p, 2p + 1).
template <int H>
__device__ __forceinline__ void product16_add(float (&acc)[2][4], const uint32_t (&a)[H / 16][4],
                                              const __nv_bfloat16* W, int p, int lane) {
  const int brow = (lane >> 4) * 8 + (lane & 7), bcol = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kt = 0; kt < H / 16; ++kt) {
    uint32_t w[4];
    ldmatrix_x4(w, W + (p * 16 + brow) * Shape<H>::WS + kt * 16 + bcol);
    mma_bf16(acc[0], a[kt], w[0], w[1]);
    mma_bf16(acc[1], a[kt], w[2], w[3]);
  }
}

// acc[0..1] = A * W^T for outputs 16p .. 16p + 15.
template <int H>
__device__ __forceinline__ void product16(float (&acc)[2][4], const uint32_t (&a)[H / 16][4],
                                          const __nv_bfloat16* W, int p, int lane) {
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[0][i] = acc[1][i] = 0.0f;
  product16_add<H>(acc, a, W, p, lane);
}

// The A fragment of the thin product's k-tile p: bf16(relu(x)) of the
// first-layer outputs 16p .. 16p + 15 (C fragments of n-tiles 2p, 2p + 1).
__device__ __forceinline__ void relu_pack(uint32_t (&h)[4], const float (&x)[2][4]) {
  h[0] = pack_bf16(fmaxf(x[0][0], 0.0f), fmaxf(x[0][1], 0.0f));
  h[1] = pack_bf16(fmaxf(x[0][2], 0.0f), fmaxf(x[0][3], 0.0f));
  h[2] = pack_bf16(fmaxf(x[1][0], 0.0f), fmaxf(x[1][1], 0.0f));
  h[3] = pack_bf16(fmaxf(x[1][2], 0.0f), fmaxf(x[1][3], 0.0f));
}

// B fragments of a thin (H-long) row as column 0 of a 16x8 B tile per k-tile:
// lanes 0..3 (g = 0) hold it, every other lane zeros.
template <int H>
__device__ __forceinline__ void thin_frags(uint32_t (&w)[H / 16][2], const float* row, int lane) {
  const int tig = lane & 3;
#pragma unroll
  for (int p = 0; p < H / 16; ++p) {
    const int q = p * 16 + 2 * tig;
    w[p][0] = lane < 4 ? pack_bf16(row[q], row[q + 1]) : 0u;
    w[p][1] = lane < 4 ? pack_bf16(row[q + 8], row[q + 9]) : 0u;
  }
}

struct Graph {
  const int* row_ptr;   // (R+1) offsets into row_edge
  const int* row_edge;  // (K) base edges of each row, in row order
  const int* col_ptr;   // (C+1) offsets into col_edge
  const int* col_edge;  // (K) base edges of each column, in col_members order
  const int* shift;     // (K) circulant shift mod Z
  const int* col;       // (K) base column
  const int* row;       // (K) base row
  const int* type;      // (K) message type (index of the shift value)
};

// Pointers into a block's shared memory.
struct Block {
  Graph g;
  const float *inv_dc, *inv_dr;
  float *v2c, *c2v, *part, *llr, *colsum;
  const float *emb_w, *emb_b;
  float* small;        // the staged layer's small vectors (Args::small)
  float* tab;          // B4: the staged layer's ebias per type
  __nv_bfloat16* w;    // the staged layer's padded matrices
  float* pl;           // B5 with injection: each warp's tile of pre_llr
  int Z, R, C, K, n, M;
};

// The next tile of a pass for this warp, from the block's queue `next`
// (lane 0 takes it, every lane gets it).
__device__ __forceinline__ int next_tile(int* next, int lane) {
  int tile = 0;
  if (lane == 0) tile = atomicAdd(next, 1);
  return __shfl_sync(0xffffffffu, tile, 0);
}

// A tile row: its group (column or row of the base graph), its lane z, its
// first member slot and its degree (0: no row).
struct TileRow {
  int grp, z, j0, d;
};

__device__ __forceinline__ TileRow tile_row(int i, int count, int Z, const int* ptr) {
  TileRow t{0, 0, 0, 0};
  if (i < count) {
    t.grp = i / Z;
    t.z = i - t.grp * Z;
    t.j0 = ptr[t.grp];
    t.d = ptr[t.grp + 1] - t.j0;
  }
  return t;
}

// Starts the copy of layer idx's weights, small vectors and (B4) ebias
// table into shared memory (one commit group; correction() waits for it).
template <int H, bool INJ, bool V1>
__device__ __forceinline__ void stage_layer(const Args& a, const Block& b, int idx) {
  constexpr int WL = num_mats(INJ, V1) * Shape<H>::MAT;  // bf16 of one layer
  constexpr int NS = (V1 ? 3 : 4) * H + 4;                // small floats of one layer
  const int tid = threadIdx.x, nt = blockDim.x;
  const __nv_bfloat16* w = a.w + static_cast<size_t>(idx) * WL;
  for (int c = tid; c < WL / 8; c += nt) cp_async16(b.w + c * 8, w + c * 8);
  const float* s = a.small + static_cast<size_t>(idx) * NS;
  for (int c = tid; c < NS / 4; c += nt) cp_async16(b.small + c * 4, s + c * 4);
  if constexpr (!V1) {
    const int tab_chunks = a.ntypes * H / 4;
    const float* t = a.tab + static_cast<size_t>(idx) * a.ntypes * H;
    for (int c = tid; c < tab_chunks; c += nt) cp_async16(b.tab + c * 4, t + c * 4);
  }
  cp_async_commit();
}

// Pass A: per message, the variable-side partial correction into b.part.
template <int H, bool INJ>
__device__ __forceinline__ void pass_variables(const Block& b, const float* msgs, int* queue,
                                               int lane) {
  using S = Shape<H>;
  const int g = lane >> 2, tig = lane & 3;
  const int Z = b.Z;
  const Graph& gr = b.g;
  const __nv_bfloat16* Wvf = b.w + kWvf * S::MAT;
  const __nv_bfloat16* Wva = b.w + kWva * S::MAT;
  const __nv_bfloat16* Wvl = b.w + kWvl * S::MAT;
  const float* b1v = b.small;
  uint32_t w2[S::KT][2];
  thin_frags<H>(w2, b.small + 2 * H, lane);
  const int ntiles = (b.n + kTile - 1) / kTile;
  for (int tile = next_tile(queue, lane); tile < ntiles; tile = next_tile(queue, lane)) {
    const TileRow r0 = tile_row(tile * kTile + g, b.n, Z, gr.col_ptr);
    const TileRow r1 = tile_row(tile * kTile + g + 8, b.n, Z, gr.col_ptr);
    const int dmax = __reduce_max_sync(0xffffffffu, max(r0.d, r1.d));

    // pre_col = ((W1va vmean) + b1v) + W1vl lf, rows g and g + 8.
    float pre[S::NT][4];
#pragma unroll
    for (int nt = 0; nt < S::NT; ++nt) pre[nt][0] = pre[nt][1] = pre[nt][2] = pre[nt][3] = 0.0f;
    if constexpr (INJ) {
      uint32_t lf[S::KT][4];
      feature_frags<H>(lf, b.emb_w, b.llr[r0.grp * Z + r0.z], b.emb_b, r0.d > 0,
                       b.llr[r1.grp * Z + r1.z], b.emb_b, r1.d > 0, tig);
      product<H>(pre, lf, Wvl, lane);
    }
    {
      float x0[S::KT][4], x1[S::KT][4];
#pragma unroll
      for (int kt = 0; kt < S::KT; ++kt)
        x0[kt][0] = x0[kt][1] = x0[kt][2] = x0[kt][3] = x1[kt][0] = x1[kt][1] = x1[kt][2] =
            x1[kt][3] = 0.0f;
      for (int s = 0; s < dmax; ++s) {
        const bool ok0 = s < r0.d, ok1 = s < r1.d;
        const int k0 = ok0 ? gr.col_edge[r0.j0 + s] : 0;
        const int k1 = ok1 ? gr.col_edge[r1.j0 + s] : 0;
        add_features<H>(x0, x1, b.emb_w, msgs[k0 * Z + r0.z], b.tab + gr.type[k0] * H, ok0,
                        msgs[k1 * Z + r1.z], b.tab + gr.type[k1] * H, ok1, tig);
      }
      const float inv0 = r0.d > 0 ? b.inv_dc[r0.grp] : 0.0f;
      const float inv1 = r1.d > 0 ? b.inv_dc[r1.grp] : 0.0f;
      uint32_t vm[S::KT][4];
#pragma unroll
      for (int kt = 0; kt < S::KT; ++kt) {
        vm[kt][0] = pack_bf16(__fmul_rn(x0[kt][0], inv0), __fmul_rn(x0[kt][1], inv0));
        vm[kt][1] = pack_bf16(__fmul_rn(x1[kt][0], inv1), __fmul_rn(x1[kt][1], inv1));
        vm[kt][2] = pack_bf16(__fmul_rn(x0[kt][2], inv0), __fmul_rn(x0[kt][3], inv0));
        vm[kt][3] = pack_bf16(__fmul_rn(x1[kt][2], inv1), __fmul_rn(x1[kt][3], inv1));
      }
      float acc[S::NT][4];
#pragma unroll
      for (int nt = 0; nt < S::NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
      product<H>(acc, vm, Wva, lane);
#pragma unroll
      for (int nt = 0; nt < S::NT; ++nt) {
        const float2 bv = *reinterpret_cast<const float2*>(b1v + nt * 8 + 2 * tig);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float s = __fadd_rn(acc[nt][i], (i & 1) ? bv.y : bv.x);
          pre[nt][i] = INJ ? __fadd_rn(s, pre[nt][i]) : s;
        }
      }
    }

    // Per member slot: W1vf f + pre_col, relu, bf16, the thin w2pv product.
    for (int s = 0; s < dmax; ++s) {
      const bool ok0 = s < r0.d, ok1 = s < r1.d;
      const int k0 = ok0 ? gr.col_edge[r0.j0 + s] : 0;
      const int k1 = ok1 ? gr.col_edge[r1.j0 + s] : 0;
      const int e0 = k0 * Z + r0.z, e1 = k1 * Z + r1.z;
      uint32_t f[S::KT][4];
      feature_frags<H>(f, b.emb_w, msgs[e0], b.tab + gr.type[k0] * H, ok0, msgs[e1],
                       b.tab + gr.type[k1] * H, ok1, tig);
      float th[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int p = 0; p < S::KT; ++p) {
        float x[2][4];
        product16<H>(x, f, Wvf, p, lane);
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int i = 0; i < 4; ++i) x[half][i] = __fadd_rn(x[half][i], pre[2 * p + half][i]);
        uint32_t h[4];
        relu_pack(h, x);
        mma_bf16(th, h, w2[p][0], w2[p][1]);
      }
      if (tig == 0) {
        if (ok0) b.part[e0] = th[0];
        if (ok1) b.part[e1] = th[2];
      }
    }
  }
}

// Pass B: per message, the check-side correction plus the partial and
// cconst, added into out.
template <int H, bool INJ>
__device__ __forceinline__ void pass_checks(const Block& b, const float* msgs, float* out,
                                            int* queue, int lane) {
  using S = Shape<H>;
  const int g = lane >> 2, tig = lane & 3;
  const int Z = b.Z;
  const Graph& gr = b.g;
  const __nv_bfloat16* Wcf = b.w + kWcf * S::MAT;
  const __nv_bfloat16* Wca = b.w + kWca * S::MAT;
  const __nv_bfloat16* Wcl = b.w + kWcl * S::MAT;
  const float* b1c = b.small + H;
  const float cconst = b.small[4 * H];
  uint32_t w2[S::KT][2];
  thin_frags<H>(w2, b.small + 3 * H, lane);
  const int ntiles = (b.M + kTile - 1) / kTile;
  for (int tile = next_tile(queue, lane); tile < ntiles; tile = next_tile(queue, lane)) {
    const TileRow r0 = tile_row(tile * kTile + g, b.M, Z, gr.row_ptr);
    const TileRow r1 = tile_row(tile * kTile + g + 8, b.M, Z, gr.row_ptr);
    const int dmax = __reduce_max_sync(0xffffffffu, max(r0.d, r1.d));
    // Member s of a row: base edge k, its message e = k*Z + v with
    // v = (zc + shift[k]) mod Z, and its variable col[k]*Z + v.
    auto member = [&](const TileRow& r, int s, int& k, int& v) {
      k = gr.row_edge[r.j0 + s];
      v = r.z + gr.shift[k];
      v = v >= Z ? v - Z : v;
    };

    // pre_row = (sum over members of W1ca f) * (1 / degree) + b1c.
    float pre[S::NT][4];
#pragma unroll
    for (int nt = 0; nt < S::NT; ++nt) pre[nt][0] = pre[nt][1] = pre[nt][2] = pre[nt][3] = 0.0f;
    for (int s = 0; s < dmax; ++s) {
      const bool ok0 = s < r0.d, ok1 = s < r1.d;
      int k0 = 0, v0 = 0, k1 = 0, v1 = 0;
      if (ok0) member(r0, s, k0, v0);
      if (ok1) member(r1, s, k1, v1);
      uint32_t f[S::KT][4];
      feature_frags<H>(f, b.emb_w, msgs[k0 * Z + v0], b.tab + gr.type[k0] * H, ok0,
                       msgs[k1 * Z + v1], b.tab + gr.type[k1] * H, ok1, tig);
      product<H>(pre, f, Wca, lane);
    }
    {
      const float inv0 = r0.d > 0 ? b.inv_dr[r0.grp] : 0.0f;
      const float inv1 = r1.d > 0 ? b.inv_dr[r1.grp] : 0.0f;
#pragma unroll
      for (int nt = 0; nt < S::NT; ++nt) {
        const float2 bv = *reinterpret_cast<const float2*>(b1c + nt * 8 + 2 * tig);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pre[nt][i] = __fadd_rn(__fmul_rn(pre[nt][i], i < 2 ? inv0 : inv1), (i & 1) ? bv.y : bv.x);
      }
    }

    // Per member slot: (W1cf f + pre_row) + W1cl lf, relu, bf16, the thin
    // w2pc product; out += (partial + that) + cconst.
    for (int s = 0; s < dmax; ++s) {
      const bool ok0 = s < r0.d, ok1 = s < r1.d;
      int k0 = 0, v0 = 0, k1 = 0, v1 = 0;
      if (ok0) member(r0, s, k0, v0);
      if (ok1) member(r1, s, k1, v1);
      const int e0 = k0 * Z + v0, e1 = k1 * Z + v1;
      uint32_t f[S::KT][4];
      feature_frags<H>(f, b.emb_w, msgs[e0], b.tab + gr.type[k0] * H, ok0, msgs[e1],
                       b.tab + gr.type[k1] * H, ok1, tig);
      uint32_t lf[INJ ? S::KT : 1][4];
      if constexpr (INJ)
        feature_frags<H>(lf, b.emb_w, b.llr[gr.col[k0] * Z + v0], b.emb_b, ok0,
                         b.llr[gr.col[k1] * Z + v1], b.emb_b, ok1, tig);
      float th[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int p = 0; p < S::KT; ++p) {
        float x[2][4];
        product16<H>(x, f, Wcf, p, lane);
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int i = 0; i < 4; ++i) x[half][i] = __fadd_rn(x[half][i], pre[2 * p + half][i]);
        if constexpr (INJ) {
          float l[2][4];
          product16<H>(l, lf, Wcl, p, lane);
#pragma unroll
          for (int half = 0; half < 2; ++half)
#pragma unroll
            for (int i = 0; i < 4; ++i) x[half][i] = __fadd_rn(x[half][i], l[half][i]);
        }
        uint32_t h[4];
        relu_pack(h, x);
        mma_bf16(th, h, w2[p][0], w2[p][1]);
      }
      if (tig == 0) {
        if (ok0) out[e0] = __fadd_rn(out[e0], __fadd_rn(__fadd_rn(b.part[e0], th[0]), cconst));
        if (ok1) out[e1] = __fadd_rn(out[e1], __fadd_rn(__fadd_rn(b.part[e1], th[2]), cconst));
      }
    }
  }
}

// B5's correction, one variable-major pass: out[e] += the whole correction
// of every message e.  Per 16-row tile of flat variables: vmean, pre_col =
// (W1va vmean) + W1vl lf in registers and, with injection, pre_llr = W1cl lf
// in the warp's slice of shared memory; then per member slot (base edge k of
// each row's column) the message's first layer, second layer, sum and
// projection, with its check's mean rebuilt from the check's messages.
template <int H, bool INJ>
__device__ __forceinline__ void pass_unfolded(const Args& a, const Block& b, int idx,
                                              const float* msgs, float* out, int* queue,
                                              int lane) {
  using S = Shape<H>;
  const int g = lane >> 2, tig = lane & 3;
  const int Z = b.Z;
  const Graph& gr = b.g;
  const __nv_bfloat16* Wvf = b.w + kWvf * S::MAT;
  const __nv_bfloat16* Wcf = b.w + kWcf * S::MAT;
  const __nv_bfloat16* Wca = b.w + kWca * S::MAT;
  const __nv_bfloat16* Wva = b.w + kWva * S::MAT;
  const __nv_bfloat16* Wvl = b.w + kWvl * S::MAT;
  const __nv_bfloat16* Wcl = b.w + kWcl * S::MAT;
  const __nv_bfloat16* W2v = b.w + num_mats(INJ) * S::MAT;
  const __nv_bfloat16* W2c = W2v + S::MAT;
  const float* b2v = b.small;
  const float* b2c = b.small + H;
  const float* pw = b.small + 2 * H;
  const float pb = b.small[3 * H];
  // The layer's per-edge first-layer biases, (K, H) each, read from L2.
  const float* bias1v = a.tab + static_cast<size_t>(idx) * 2 * b.K * H;
  const float* bias1c = bias1v + static_cast<size_t>(b.K) * H;
  // This warp's pre_llr tile, as each lane holds its accumulators: float2
  // (nt, half) of lane l at [(2 nt + half) * 32 + l] (rows g, g + 8).
  float2* pl = reinterpret_cast<float2*>(b.pl) + (threadIdx.x >> 5) * (kTile * H / 2);
  const int ntiles = (b.n + kTile - 1) / kTile;
  for (int tile = next_tile(queue, lane); tile < ntiles; tile = next_tile(queue, lane)) {
    const TileRow r0 = tile_row(tile * kTile + g, b.n, Z, gr.col_ptr);
    const TileRow r1 = tile_row(tile * kTile + g + 8, b.n, Z, gr.col_ptr);
    const int dmax = __reduce_max_sync(0xffffffffu, max(r0.d, r1.d));

    // pre_col = (W1va vmean) + W1vl lf and pre_llr = W1cl lf, rows g and g + 8.
    float pre[S::NT][4];
#pragma unroll
    for (int nt = 0; nt < S::NT; ++nt) pre[nt][0] = pre[nt][1] = pre[nt][2] = pre[nt][3] = 0.0f;
    if constexpr (INJ) {
      uint32_t lf[S::KT][4];
      feature_frags<H>(lf, b.emb_w, b.llr[r0.grp * Z + r0.z], b.emb_b, r0.d > 0,
                       b.llr[r1.grp * Z + r1.z], b.emb_b, r1.d > 0, tig);
      float acc[S::NT][4];
#pragma unroll
      for (int nt = 0; nt < S::NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
      product<H>(acc, lf, Wcl, lane);
#pragma unroll
      for (int nt = 0; nt < S::NT; ++nt) {
        pl[(2 * nt) * 32 + lane] = make_float2(acc[nt][0], acc[nt][1]);
        pl[(2 * nt + 1) * 32 + lane] = make_float2(acc[nt][2], acc[nt][3]);
      }
      product<H>(pre, lf, Wvl, lane);
    }
    {
      float x0[S::KT][4], x1[S::KT][4];
#pragma unroll
      for (int kt = 0; kt < S::KT; ++kt)
        x0[kt][0] = x0[kt][1] = x0[kt][2] = x0[kt][3] = x1[kt][0] = x1[kt][1] = x1[kt][2] =
            x1[kt][3] = 0.0f;
      for (int s = 0; s < dmax; ++s) {
        const bool ok0 = s < r0.d, ok1 = s < r1.d;
        const int k0 = ok0 ? gr.col_edge[r0.j0 + s] : 0;
        const int k1 = ok1 ? gr.col_edge[r1.j0 + s] : 0;
        add_features<H>(x0, x1, b.emb_w, msgs[k0 * Z + r0.z], b.emb_b, ok0,
                        msgs[k1 * Z + r1.z], b.emb_b, ok1, tig);
      }
      const float inv0 = r0.d > 0 ? b.inv_dc[r0.grp] : 0.0f;
      const float inv1 = r1.d > 0 ? b.inv_dc[r1.grp] : 0.0f;
      uint32_t vm[S::KT][4];
#pragma unroll
      for (int kt = 0; kt < S::KT; ++kt) {
        vm[kt][0] = pack_bf16(__fmul_rn(x0[kt][0], inv0), __fmul_rn(x0[kt][1], inv0));
        vm[kt][1] = pack_bf16(__fmul_rn(x1[kt][0], inv1), __fmul_rn(x1[kt][1], inv1));
        vm[kt][2] = pack_bf16(__fmul_rn(x0[kt][2], inv0), __fmul_rn(x0[kt][3], inv0));
        vm[kt][3] = pack_bf16(__fmul_rn(x1[kt][2], inv1), __fmul_rn(x1[kt][3], inv1));
      }
      float acc[S::NT][4];
#pragma unroll
      for (int nt = 0; nt < S::NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
      product<H>(acc, vm, Wva, lane);
#pragma unroll
      for (int nt = 0; nt < S::NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pre[nt][i] = INJ ? __fadd_rn(acc[nt][i], pre[nt][i]) : acc[nt][i];
    }

    // Per member slot: the message of each row whose variable has one.  The
    // check side first, so that its second-layer output waits packed in bf16
    // while the variable side runs.
    for (int s = 0; s < dmax; ++s) {
      const bool ok0 = s < r0.d, ok1 = s < r1.d;
      const int k0 = ok0 ? gr.col_edge[r0.j0 + s] : 0;
      const int k1 = ok1 ? gr.col_edge[r1.j0 + s] : 0;
      const int e0 = k0 * Z + r0.z, e1 = k1 * Z + r1.z;

      // rmean of each row's check (row[k], (z - shift[k]) mod Z): its members'
      // features summed in row order, times 1 / degree, rounded to bf16.
      uint32_t rm[S::KT][4];
      {
        int c0 = r0.z - gr.shift[k0], c1 = r1.z - gr.shift[k1];
        c0 = c0 < 0 ? c0 + Z : c0;
        c1 = c1 < 0 ? c1 + Z : c1;
        const int row0 = gr.row[k0], row1 = gr.row[k1];
        const int j0 = gr.row_ptr[row0], j1 = gr.row_ptr[row1];
        const int d0 = ok0 ? gr.row_ptr[row0 + 1] - j0 : 0;
        const int d1 = ok1 ? gr.row_ptr[row1 + 1] - j1 : 0;
        const int jmax = __reduce_max_sync(0xffffffffu, max(d0, d1));
        float x0[S::KT][4], x1[S::KT][4];
#pragma unroll
        for (int kt = 0; kt < S::KT; ++kt)
          x0[kt][0] = x0[kt][1] = x0[kt][2] = x0[kt][3] = x1[kt][0] = x1[kt][1] = x1[kt][2] =
              x1[kt][3] = 0.0f;
        for (int j = 0; j < jmax; ++j) {
          const bool in0 = j < d0, in1 = j < d1;
          const int m0 = in0 ? gr.row_edge[j0 + j] : 0, m1 = in1 ? gr.row_edge[j1 + j] : 0;
          int v0 = c0 + gr.shift[m0], v1 = c1 + gr.shift[m1];
          v0 = v0 >= Z ? v0 - Z : v0;
          v1 = v1 >= Z ? v1 - Z : v1;
          add_features<H>(x0, x1, b.emb_w, msgs[m0 * Z + v0], b.emb_b, in0, msgs[m1 * Z + v1],
                          b.emb_b, in1, tig);
        }
        const float inv0 = d0 > 0 ? b.inv_dr[row0] : 0.0f;
        const float inv1 = d1 > 0 ? b.inv_dr[row1] : 0.0f;
#pragma unroll
        for (int kt = 0; kt < S::KT; ++kt) {
          rm[kt][0] = pack_bf16(__fmul_rn(x0[kt][0], inv0), __fmul_rn(x0[kt][1], inv0));
          rm[kt][1] = pack_bf16(__fmul_rn(x1[kt][0], inv1), __fmul_rn(x1[kt][1], inv1));
          rm[kt][2] = pack_bf16(__fmul_rn(x0[kt][2], inv0), __fmul_rn(x0[kt][3], inv0));
          rm[kt][3] = pack_bf16(__fmul_rn(x1[kt][2], inv1), __fmul_rn(x1[kt][3], inv1));
        }
      }
      uint32_t f[S::KT][4];
      feature_frags<H>(f, b.emb_w, msgs[e0], b.emb_b, ok0, msgs[e1], b.emb_b, ok1, tig);

      // Check side: out_c = bf16(W2c bf16(relu(((W1cf f + W1ca rmean) + bias1c)
      // + pre_llr)) + b2c), W1cf f + W1ca rmean in one accumulator, the first
      // layer's n-tile pair p feeding the second layer's k-tile p.
      uint32_t oc[S::NT][2];
      {
        const float* bc0 = bias1c + k0 * H;
        const float* bc1 = bias1c + k1 * H;
        float acc[S::NT][4];
#pragma unroll
        for (int nt = 0; nt < S::NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
#pragma unroll
        for (int p = 0; p < S::KT; ++p) {
          float x[2][4];
          product16<H>(x, f, Wcf, p, lane);
          product16_add<H>(x, rm, Wca, p, lane);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int nt = 2 * p + half, q = nt * 8 + 2 * tig;
            const float2 u0 = __ldg(reinterpret_cast<const float2*>(bc0 + q));
            const float2 u1 = __ldg(reinterpret_cast<const float2*>(bc1 + q));
            x[half][0] = __fadd_rn(x[half][0], u0.x);
            x[half][1] = __fadd_rn(x[half][1], u0.y);
            x[half][2] = __fadd_rn(x[half][2], u1.x);
            x[half][3] = __fadd_rn(x[half][3], u1.y);
            if constexpr (INJ) {
              const float2 l0 = pl[(2 * nt) * 32 + lane], l1 = pl[(2 * nt + 1) * 32 + lane];
              x[half][0] = __fadd_rn(x[half][0], l0.x);
              x[half][1] = __fadd_rn(x[half][1], l0.y);
              x[half][2] = __fadd_rn(x[half][2], l1.x);
              x[half][3] = __fadd_rn(x[half][3], l1.y);
            }
          }
          uint32_t h[4];
          relu_pack(h, x);
          product_ktile<H>(acc, h, W2c, p, lane);
        }
#pragma unroll
        for (int nt = 0; nt < S::NT; ++nt) {
          const float2 bb = *reinterpret_cast<const float2*>(b2c + nt * 8 + 2 * tig);
          oc[nt][0] = pack_bf16(__fadd_rn(acc[nt][0], bb.x), __fadd_rn(acc[nt][1], bb.y));
          oc[nt][1] = pack_bf16(__fadd_rn(acc[nt][2], bb.x), __fadd_rn(acc[nt][3], bb.y));
        }
      }

      // Variable side: out_v = bf16(W2v bf16(relu((W1vf f + pre_col) + bias1v)) + b2v);
      // then lo = bf16(out_v + out_c) and each row's sum_j lo_j pw_j.
      float s0 = 0.0f, s1 = 0.0f;
      {
        const float* bv0 = bias1v + k0 * H;
        const float* bv1 = bias1v + k1 * H;
        float acc[S::NT][4];
#pragma unroll
        for (int nt = 0; nt < S::NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
#pragma unroll
        for (int p = 0; p < S::KT; ++p) {
          float x[2][4];
          product16<H>(x, f, Wvf, p, lane);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int nt = 2 * p + half, q = nt * 8 + 2 * tig;
            const float2 u0 = __ldg(reinterpret_cast<const float2*>(bv0 + q));
            const float2 u1 = __ldg(reinterpret_cast<const float2*>(bv1 + q));
            x[half][0] = __fadd_rn(__fadd_rn(x[half][0], pre[nt][0]), u0.x);
            x[half][1] = __fadd_rn(__fadd_rn(x[half][1], pre[nt][1]), u0.y);
            x[half][2] = __fadd_rn(__fadd_rn(x[half][2], pre[nt][2]), u1.x);
            x[half][3] = __fadd_rn(__fadd_rn(x[half][3], pre[nt][3]), u1.y);
          }
          uint32_t h[4];
          relu_pack(h, x);
          product_ktile<H>(acc, h, W2v, p, lane);
        }
#pragma unroll
        for (int nt = 0; nt < S::NT; ++nt) {
          const int q = nt * 8 + 2 * tig;
          const float2 bb = *reinterpret_cast<const float2*>(b2v + q);
          const float2 w = *reinterpret_cast<const float2*>(pw + q);
          const float2 c0 = unpack_bf16(oc[nt][0]), c1 = unpack_bf16(oc[nt][1]);
          const float lo00 = bf16r(__fadd_rn(bf16r(__fadd_rn(acc[nt][0], bb.x)), c0.x));
          const float lo01 = bf16r(__fadd_rn(bf16r(__fadd_rn(acc[nt][1], bb.y)), c0.y));
          const float lo10 = bf16r(__fadd_rn(bf16r(__fadd_rn(acc[nt][2], bb.x)), c1.x));
          const float lo11 = bf16r(__fadd_rn(bf16r(__fadd_rn(acc[nt][3], bb.y)), c1.y));
          s0 = __fadd_rn(__fadd_rn(s0, __fmul_rn(lo00, w.x)), __fmul_rn(lo01, w.y));
          s1 = __fadd_rn(__fadd_rn(s1, __fmul_rn(lo10, w.x)), __fmul_rn(lo11, w.y));
        }
      }
      // The quad's four column groups.
      s0 = __fadd_rn(s0, __shfl_xor_sync(0xffffffffu, s0, 1));
      s1 = __fadd_rn(s1, __shfl_xor_sync(0xffffffffu, s1, 1));
      s0 = __fadd_rn(s0, __shfl_xor_sync(0xffffffffu, s0, 2));
      s1 = __fadd_rn(s1, __shfl_xor_sync(0xffffffffu, s1, 2));
      if (tig == 0) {
        if (ok0) out[e0] = __fadd_rn(out[e0], __fadd_rn(s0, pb));
        if (ok1) out[e1] = __fadd_rn(out[e1], __fadd_rn(s1, pb));
      }
    }
  }
}

// out[e] += correction of layer idx (staged) computed from msgs.  Waits for
// the staging; starts and ends with a barrier.  Tiles are dealt to warps
// from a queue per pass (`queues`, two ints), in the code's order: tiles
// cost in proportion to their rows' degrees (1 to 23 members a column at
// nr_2_0_32), and the base graphs list their heavy columns and rows first.
template <int H, bool INJ, bool V1>
__device__ __forceinline__ void correction(const Args& a, const Block& b, int idx,
                                           const float* msgs, float* out, int* queues) {
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) queues[0] = queues[1] = 0;
  cp_async_wait_all();
  __syncthreads();  // the staged layer, the messages and the queues visible to every warp
  if constexpr (V1) {
    pass_unfolded<H, INJ>(a, b, idx, msgs, out, queues, lane);
  } else {
    pass_variables<H, INJ>(b, msgs, queues, lane);
    __syncthreads();  // every partial written
    pass_checks<H, INJ>(b, msgs, out, queues + 1, lane);
  }
  __syncthreads();
}

// The decode of B4 (V1 false) or B5 (V1 true): frames from the atomic
// counter, T iterations of the min-sum skeleton each, a correction after
// every half-update.
template <int H, bool INJ, bool V1>
__device__ __forceinline__ void decode_frames(const Args& a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_frame, s_viol, s_queues[2];
  const int Z = a.Z, R = a.R, C = a.C, K = a.K;
  const int n = C * Z, E = K * Z, M = R * Z;
  const int tid = threadIdx.x, nt = blockDim.x;
  const Layout L = make_layout(V1, H, INJ, Z, R, C, K, a.ntypes, nt / 32);

  int* s_graph = reinterpret_cast<int*>(smem + L.graph);
  float* s_inv = reinterpret_cast<float*>(smem + L.inv);
  float* s_emb = reinterpret_cast<float*>(smem + L.emb);
  for (int i = tid; i < 6 * K + R + C + 2; i += nt) s_graph[i] = a.graph[i];
  for (int i = tid; i < C + R; i += nt) s_inv[i] = a.inv[i];
  for (int i = tid; i < 2 * H; i += nt) s_emb[i] = a.emb[i];

  Block b;
  b.g.row_ptr = s_graph;
  b.g.row_edge = b.g.row_ptr + R + 1;
  b.g.col_ptr = b.g.row_edge + K;
  b.g.col_edge = b.g.col_ptr + C + 1;
  b.g.shift = b.g.col_edge + K;
  b.g.col = b.g.shift + K;
  b.g.row = b.g.col + K;
  b.g.type = b.g.row + K;
  b.inv_dc = s_inv;
  b.inv_dr = s_inv + C;
  b.v2c = reinterpret_cast<float*>(smem + L.v2c);
  b.c2v = reinterpret_cast<float*>(smem + L.c2v);
  b.part = reinterpret_cast<float*>(smem + L.part);
  b.llr = reinterpret_cast<float*>(smem + L.llr);
  b.colsum = reinterpret_cast<float*>(smem + L.colsum);
  b.emb_w = s_emb;
  b.emb_b = s_emb + H;
  b.small = reinterpret_cast<float*>(smem + L.small);
  b.tab = reinterpret_cast<float*>(smem + L.tab);
  b.w = reinterpret_cast<__nv_bfloat16*>(smem + L.w);
  b.pl = reinterpret_cast<float*>(smem + L.pl);
  b.Z = Z;
  b.R = R;
  b.C = C;
  b.K = K;
  b.n = n;
  b.M = M;
  const Graph& g = b.g;
  __syncthreads();

  for (;;) {
    if (tid == 0) {
      s_frame = atomicAdd(a.counter, 1);
      s_viol = 0;
    }
    __syncthreads();
    const int f = s_frame;
    if (f >= a.B) break;
    const float* llr_f = a.llr + static_cast<size_t>(f) * n;
    float* soft_f = a.soft + static_cast<size_t>(f) * n;
    for (int i = tid; i < n; i += nt) b.llr[i] = llr_f[i];
    __syncthreads();
    for (int i = tid; i < E; i += nt) {
      const int k = i / Z;
      b.v2c[i] = b.llr[g.col[k] * Z + (i - k * Z)];
      b.c2v[i] = 0.0f;
    }
    __syncthreads();

    int conv = 0;
    for (int t = 0; t < a.T; ++t) {
      stage_layer<H, INJ, V1>(a, b, 2 * t);
      // Check half: scaled min-sum, one thread per lifted check.
      for (int i = tid; i < M; i += nt) {
        const int r = i / Z, zc = i - r * Z;
        const int j0 = g.row_ptr[r], j1 = g.row_ptr[r + 1];
        float m1 = kBig, m2 = kBig, sp = 1.0f;
        for (int j = j0; j < j1; ++j) {
          const int k = g.row_edge[j];
          int v = zc + g.shift[k];
          v = v >= Z ? v - Z : v;
          const float x = b.v2c[k * Z + v];
          const float mag = fabsf(x);
          sp = sp * sign_of(x);
          const float new_min = fminf(mag, m1);
          m2 = fminf(fmaxf(mag, m1), m2);
          m1 = new_min;
        }
        for (int j = j0; j < j1; ++j) {
          const int k = g.row_edge[j];
          int v = zc + g.shift[k];
          v = v >= Z ? v - Z : v;
          const float x = b.v2c[k * Z + v];
          float loo = fabsf(x) > m1 ? m1 : m2;
          loo = loo < kBig ? loo : 0.0f;
          b.c2v[k * Z + v] = a.alpha * sp * sign_of(x) * loo;
        }
      }
      correction<H, INJ, V1>(a, b, 2 * t, b.v2c, b.c2v, s_queues);

      // Column sums in col_members order; with early_exit the syndrome.
      for (int i = tid; i < n; i += nt) {
        const int c = i / Z, z = i - c * Z;
        float cs = 0.0f;
        for (int j = g.col_ptr[c]; j < g.col_ptr[c + 1]; ++j)
          cs = __fadd_rn(cs, b.c2v[g.col_edge[j] * Z + z]);
        b.colsum[i] = cs;
      }
      __syncthreads();
      if (a.early_exit) {
        for (int i = tid; i < M; i += nt) {
          const int r = i / Z, zc = i - r * Z;
          int p = 0;
          for (int j = g.row_ptr[r]; j < g.row_ptr[r + 1]; ++j) {
            const int k = g.row_edge[j];
            int v = zc + g.shift[k];
            v = v >= Z ? v - Z : v;
            const int u = g.col[k] * Z + v;
            p ^= __fadd_rn(b.llr[u], b.colsum[u]) < 0.0f;
          }
          if (p) s_viol = 1;
        }
        __syncthreads();
        const int viol = s_viol;
        __syncthreads();
        if (!viol) {
          conv = t + 1;
          for (int i = tid; i < n; i += nt)
            soft_f[i] = __fadd_rn(b.llr[i], b.colsum[i]) < 0.0f ? 1.0f : 0.0f;
          break;
        }
        if (tid == 0) s_viol = 0;
      }
      if (t + 1 == a.T) break;  // the last var half feeds nothing

      // Var half: leave-one-out sum plus the weighted channel LLR.
      stage_layer<H, INJ, V1>(a, b, 2 * t + 1);
      for (int i = tid; i < E; i += nt) {
        const int k = i / Z;
        const int u = g.col[k] * Z + (i - k * Z);
        b.v2c[i] = __fadd_rn(__fsub_rn(b.colsum[u], b.c2v[i]), __fmul_rn(a.w_ch, b.llr[u]));
      }
      correction<H, INJ, V1>(a, b, 2 * t + 1, b.c2v, b.v2c, s_queues);
    }

    if (conv == 0) {
      for (int i = tid; i < n; i += nt)
        soft_f[i] = 1.0f / (1.0f + expf(__fadd_rn(b.llr[i], b.colsum[i])));
    }
    if (a.conv != nullptr && tid == 0)
      a.conv[f] = static_cast<float>(conv > 0 ? conv : a.T);
    __syncthreads();
  }
}

// B4, _corrected_kernel_v2: the second layer and projection folded.
template <int H, bool INJ>
__global__ void __launch_bounds__(kMaxWarps * 32, 1) corrected_v2_tc_kernel(const Args a) {
  decode_frames<H, INJ, false>(a);
}

// B5, _corrected_kernel: the second layer not folded.
template <int H, bool INJ>
__global__ void __launch_bounds__(kMaxWarps * 32, 1) corrected_tc_kernel(const Args a) {
  decode_frames<H, INJ, true>(a);
}

using KernelFn = void (*)(const Args);

KernelFn pick_kernel(bool v1, int H, int inject) {
  switch (H) {
    case 16:
      if (v1) return inject ? corrected_tc_kernel<16, true> : corrected_tc_kernel<16, false>;
      return inject ? corrected_v2_tc_kernel<16, true> : corrected_v2_tc_kernel<16, false>;
    case 64:
      if (v1) return inject ? corrected_tc_kernel<64, true> : corrected_tc_kernel<64, false>;
      return inject ? corrected_v2_tc_kernel<64, true> : corrected_v2_tc_kernel<64, false>;
  }
  return nullptr;
}

// The block shape: for each warp count 1..kMaxWarps the runtime's occupancy
// query; *warps, *blocks of the count with the most resident warps per SM
// (ties: the fewer warps a block).  Returns a cudaError_t; 0 blocks where
// the state does not fit a block.
int plan(bool v1, int H, int inject, int Z, int R, int C, int K, int ntypes, int* warps,
         int* blocks) {
  KernelFn kernel = pick_kernel(v1, H, inject);
  *warps = 0;
  *blocks = 0;
  if (kernel == nullptr) return cudaErrorInvalidValue;
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  for (int w = 1; w <= kMaxWarps; ++w) {
    const long long smem = make_layout(v1, H, inject, Z, R, C, K, ntypes, w).total;
    if (smem > optin) break;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * w, smem);
    if (err != cudaSuccess) return err;
    if (per_sm * w > *blocks * *warps) {
      *warps = w;
      *blocks = per_sm;
    }
  }
  return cudaSuccess;
}

// Launches the kernel on `stream` with `grid` blocks of `warps` warps, no
// sync.  `counter` must hold 0; `conv` may be null.  Returns a cudaError_t
// (0 on success).
int launch(bool v1, int H, const void* llr, void* soft, void* conv, void* counter,
           const void* graph, const void* inv, const void* w, const void* tab, const void* small,
           const void* emb, int B, int Z, int R, int C, int K, int ntypes, int T, int inject,
           int early_exit, float w_ch, float alpha, int grid, int warps, void* stream) {
  KernelFn kernel = pick_kernel(v1, H, inject);
  if (kernel == nullptr || grid < 1 || B < 1 || T < 1 || warps < 1 || warps > kMaxWarps)
    return cudaErrorInvalidValue;
  const long long smem = make_layout(v1, H, inject, Z, R, C, K, ntypes, warps).total;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  Args a;
  a.llr = static_cast<const float*>(llr);
  a.soft = static_cast<float*>(soft);
  a.conv = static_cast<float*>(conv);
  a.counter = static_cast<int*>(counter);
  a.graph = static_cast<const int*>(graph);
  a.inv = static_cast<const float*>(inv);
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.tab = static_cast<const float*>(tab);
  a.small = static_cast<const float*>(small);
  a.emb = static_cast<const float*>(emb);
  a.B = B;
  a.Z = Z;
  a.R = R;
  a.C = C;
  a.K = K;
  a.ntypes = ntypes;
  a.T = T;
  a.early_exit = early_exit;
  a.w_ch = w_ch;
  a.alpha = alpha;
  kernel<<<grid, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// `v1` picks the kernel: 0 corrected_v2_tc_kernel (B4), 1 corrected_tc_kernel
// (B5).  B4 reads `ntypes` and ignores `warps` in the size (its layout has no
// per-warp part); B5 ignores `ntypes`.

// Bytes of dynamic shared memory one block of `warps` warps needs.
long long ldpc_corrected_tc_smem_bytes(int v1, int H, int inject, int Z, int R, int C, int K,
                                       int ntypes, int warps) {
  return make_layout(v1 != 0, H, inject, Z, R, C, K, ntypes, warps).total;
}

// The block shape (see plan).
int ldpc_corrected_tc_plan(int v1, int H, int inject, int Z, int R, int C, int K, int ntypes,
                           int* warps, int* blocks) {
  return plan(v1 != 0, H, inject, Z, R, C, K, ntypes, warps, blocks);
}

// The entry point of both kernels (see launch).
int ldpc_corrected_gnn(int v1, int H, const void* llr, void* soft, void* conv, void* counter,
                       const void* graph, const void* inv, const void* w, const void* tab,
                       const void* small, const void* emb, int B, int Z, int R, int C, int K,
                       int ntypes, int T, int inject, int early_exit, float w_ch, float alpha,
                       int grid, int warps, void* stream) {
  return launch(v1 != 0, H, llr, soft, conv, counter, graph, inv, w, tab, small, emb, B, Z, R, C,
                K, ntypes, T, inject, early_exit, w_ch, alpha, grid, warps, stream);
}

const char* ldpc_corrected_tc_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
