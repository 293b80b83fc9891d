// Fused corrected min-sum GNN decoders for Hopper (sm_90a): the whole decode
// of a frame (T iterations of scaled min-sum, each half-update followed by a
// GNN correction) in one kernel launch.
//
// Replaces the TPU kernels of ldpc_tpu/ops/pallas_gnn.py:
//   * corrected_v2_kernel<H>  <- _corrected_kernel_v2
//                                (make_fused_corrected_gnn_decoder_v2),
//                                entry point ldpc_corrected_gnn_v2
//   * corrected_kernel<H>     <- _corrected_kernel
//                                (make_fused_corrected_gnn_decoder),
//                                entry point ldpc_corrected_gnn
// The two kernels share the min-sum skeleton (decode_frames) and differ in
// the correction: correction<H, 2> and correction<H, 1> below.  H is the
// hidden width, built for 16 and 64.
// Python wrappers, weight packing and the plain PyTorch version of each
// kernel: ldpc_tpu_torch/ops/fused_gnn.py.  Built with -fmad=false: nvcc
// contracts no a * b + c on its own, every fused multiply-add below is an
// explicit fmaf in a matrix product, and the min-sum skeleton rounds after
// every operation (the untrained decoder is bit-exact scaled min-sum).
//
// What both compute, per frame
// ----------------------------
// Messages are var-aligned per base edge k: msg[k*Z + z] belongs to variable
// (col[k], z) and to check (row[k], (z - shift[k]) mod Z).  v2c starts as the
// channel LLR of the edge's variable, c2v as 0.  T times:
//   1. check half: c2v = alpha * sign product * leave-one-out min of |v2c|
//      over the check's members (running m1/m2, sign(0) = +1, sentinel 1e9);
//   2. c2v += correction(layer 2t, v2c): the correction reads the
//      half-update's inputs;
//   3. colsum = per-variable sum of c2v (col_members order);
//   4. early_exit only: hard decisions llr + colsum < 0, syndrome as an XOR
//      of decision bits; a frame whose syndrome is valid writes its 0/1
//      decisions, records conv_iter = t + 1 and stops;
//   5. v2c = (colsum - c2v) + w_ch * llr;  v2c += correction(layer 2t+1, c2v).
// A frame that never stopped writes 1 / (1 + exp(llr + colsum)) with the
// last colsum, and conv_iter = T.  The TPU kernel checks the syndrome after
// step 5 with the colsum of step 3; checking before step 5 gives the same
// outputs and saves the converged iteration's second correction.  Step 5 of
// the last iteration feeds nothing and is skipped, so a frame that runs
// conv_iter iterations runs 2 conv_iter - 1 corrections.  The TPU kernel
// stops a tile of 128/Z frames together; here each frame stops alone (the
// outputs do not depend on the tiling).
//
// The correction of layer idx, for every message with scalar value m:
//   f      = bf16(m * emb_w + ebias)                      (h features)
//   vmean  = bf16(sum of f over the variable's messages / degree)
//   lf     = bf16(llr * emb_w + emb_b)                    (input injection)
//   v2 (B4): ebias = emb_b + type embedding;
//     rsum   = sum of f over the check's members (float32, never rounded)
//     pre_v  = W1vf f + ((W1va vmean + b1v) + W1vl lf)
//     pre_c  = (W1cf f + ((W1ca rsum) / degree + b1c)) + W1cl lf
//     corr   = w2p . [bf16(relu(pre_v)); bf16(relu(pre_c))] + cconst
//     with w2p = bf16(pw^T [W2v W2c]) and cconst = bf16(pw.(b2v + b2c) + pb)
//     folded by the wrapper.  The TPU kernel multiplies every message's
//     features by W1ca and averages the products; W1ca times the float32 sum
//     is the same up to float32 rounding and costs one product per check.
//     That one operand is float32: a tensor-core version of this kernel must
//     either multiply every message's bf16 features by W1ca and average, as
//     the TPU kernel does (K*Z products instead of R*Z), or split the sum
//     into bf16 parts; rounding the sum to bf16 would be another function.
//   v1 (B5): ebias = emb_b; type embeddings sit in per-edge first-layer
//     biases bias1v, bias1c (float32);
//     rmean  = bf16(sum of f over the check's members / degree)
//     pre_v  = (W1vf f + (W1va vmean + W1vl lf)) + bias1v[k]
//     pre_c  = ((W1cf f + W1ca rmean) + bias1c[k]) + W1cl lf
//     out_v  = bf16(W2v bf16(relu(pre_v)) + b2v), out_c likewise
//     corr   = sum_j float(bf16(out_v + out_c))[j] * pw[j] + pb.
// bf16 rounding points (all __float2bfloat16_rn, repeated in this order by
// the plain version): f, vmean, lf, v1's rmean, the ReLU outputs, v1's
// out_v, out_c and their sum; the weights W1*, W2* and v2's w2p, cconst are
// rounded by the wrapper.  Every product accumulates in float32.
//
// What changed against the TPU kernels
// ------------------------------------
// No lane layout, no rolls, no padding of C or of weights, no ones-row: one
// thread owns one variable, check or message, and a roll by s is the index
// (z + s) mod Z.  The embedded features are never stored: they are a
// function of one float, so each thread rebuilds the h features of a message
// where it needs them (in the variable's mean, the check's sum and the
// message's own products).  What outlives a phase is per variable and per
// check (pre_v's and pre_c's shared terms, (2C + R) * Z * h floats a frame,
// 1.2 MB at nr_2_0_32 Z=32 h=64): it lives in a global scratch slice per
// resident block, laid out [group][j][z] so a warp reads consecutive floats.
// Messages, LLRs, column sums, the base graph and one layer's weights
// (expanded from bf16 to float32) live in shared memory; weights are staged
// from global memory (L2) once per correction.  The products are plain FMA
// loops: each thread holds its h inputs in registers and walks the weight
// rows, which every thread of the warp reads at the same address (a
// broadcast), four rows at a time for four independent accumulators.
// Frames are handed to blocks through an atomic counter, because frames
// stop after different numbers of iterations.
//
// What bounds it on the card
// --------------------------
// Per correction of one frame, with E = K*Z messages, n = C*Z variables,
// M = R*Z checks, inj = 1 with input injection:
//   products: (2E + (1 + 2 inj) n + M) products of (h, h) by a vector, 2h^2
//     operations each; plus the second layer: v2's thin product 2 * 2h * E,
//     v1's two (h, h) products and the projection, (4h^2 + 2h) E.  They are
//     bf16 x bf16 -> float32 products, so they are counted at the tensor
//     cores' dense bf16 rate, 989e12 per second.  v2's M check-relation
//     products (7% of the count on the main path) are counted so too, once
//     per check: the least work of the function, although the float32 sum
//     above does not run on the tensor cores as written.
//   elementwise float32 (none an FMA, so 33.5e12 per second):
//     v2: (8 + inj) h E + (2 + 3 inj) h n + 3 h M + E
//         (embed 2, variable sum 1, check sum 1, add shared term and ReLU 2
//          for pre_v and 2 + inj for pre_c per message and feature; mean and
//          bias per variable, embed and add of lf; mean, bias per check)
//     v1: (15 + inj) h E + (1 + 3 inj) h n + h M + E
//         (as above with the per-edge bias, plus bias, bf16 sum, projection
//          multiply and sum of the second layer).
// Per iteration the min-sum skeleton adds 12 E + 4 M + 2 n float32 and, with
// early_exit, E + M int32 operations (16.75e12 per second).  A frame needs
// conv_iter iterations and 2 conv_iter - 1 corrections.  LLRs are read and
// soft bits written once (8 n bytes a frame at 3.35e12 bytes per second).
// Main path (nr_2_0_32 Z=32 h=64, inj): 157e6 product operations (v2) per
// correction against 4.4e6 elementwise: the bound is the products.  This
// source runs them on the float32 FMA pipe (at most 67e12 per second, 1/15
// of the tensor cores), so the kernel is far from its bound; using wgmma
// needs the messages of a warp group gathered into 64-row tiles and is left
// to later work.
//
// Shared memory of a block (4-byte words; see make_layout): graph,
// inverse degrees, v2c, c2v, LLRs, colsum, embedding, the layer's small
// vectors (v2: also the per-type ebias table) and 6 (v2) or 8 (v1) weight
// matrices of h*h floats: 177 KB (v2) and 202 KB (v1) at the main path's
// shapes, one block per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gnn_common.cuh"

namespace {

constexpr float kBig = 1e9f;  // stand-in for +inf, as _BIG in the JAX package
// Threads of a block: corrected_v2 fits 128 registers a thread, corrected needs more.
__host__ __device__ constexpr int threads_of(int variant) { return variant == 2 ? 512 : 256; }

// Weight matrices of a layer, in packing order.
enum { kWvf = 0, kWcf, kWca, kWva, kWvl, kWcl, kW2v, kW2c };

struct Args {
  const float* llr;          // (B, n)
  float* soft;               // (B, n)
  float* conv;               // (B,) or nullptr
  int* counter;              // next frame to hand out, starts at 0
  float* scratch;            // (grid, (2C + R) * H * Z)
  const int* graph;          // row_ptr, row_edge, col_ptr, col_edge, shift, col, row, type
  const float* inv;          // 1/degree per column (C), then per row (R)
  const __nv_bfloat16* w;    // (2T, NW, H, H)
  const float* tab;          // v2: ebias (2T, ntypes, H); v1: bias1 (2T, 2, K, H)
  const float* small;        // v2: (2T, 4H+4) b1v b1c w2pv w2pc cconst; v1: (2T, 3H+4) b2v b2c pw pb
  const float* emb;          // emb_w (H), emb_b (H)
  int B, Z, R, C, K, ntypes, T, inject, early_exit;
  float w_ch, alpha;
};

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

__host__ __device__ inline int num_weights(int variant) { return variant == 2 ? 6 : 8; }
__host__ __device__ inline int small_floats(int variant, int H) {
  return variant == 2 ? 4 * H + 4 : 3 * H + 4;
}

// Offsets (in 4-byte words) of a block's shared memory.
struct Layout {
  int graph, inv, v2c, c2v, llr, colsum, emb, small, tab, w, total;
};

__host__ __device__ inline Layout make_layout(int variant, int H, int Z, int R, int C, int K,
                                              int ntypes) {
  Layout L;
  int o = 0;
  L.graph = o; o += round4(6 * K + R + C + 2);
  L.inv = o; o += round4(C + R);
  L.v2c = o; o += round4(K * Z);
  L.c2v = o; o += round4(K * Z);
  L.llr = o; o += round4(C * Z);
  L.colsum = o; o += round4(C * Z);
  L.emb = o; o += 2 * H;
  L.small = o; o += small_floats(variant, H);
  L.tab = o; o += variant == 2 ? round4(ntypes * H) : 0;
  L.w = o; o += num_weights(variant) * H * H;
  L.total = o;
  return L;
}

__device__ __forceinline__ float sign_of(float x) { return x < 0.0f ? -1.0f : 1.0f; }

// Pointers into a block's shared memory and scratch.
template <int H>
struct Block {
  Graph g;
  const float *inv_dc, *inv_dr;
  float *v2c, *c2v, *llr, *colsum;
  const float *emb_w, *emb_b;
  float* small;  // the staged layer's small vectors
  float* tab;    // v2: the staged layer's ebias table
  float* w;      // the staged layer's weight matrices
  float *pre_col, *pre_llr, *pre_row;  // global scratch, [group][j][z]
  int Z, R, C, K;
};

// x[q] += bf16(m * emb_w[q] + bias[q]): one message's features into a sum.
template <int H>
__device__ __forceinline__ void add_features(float (&x)[H], float m, const float* emb_w,
                                             const float* bias) {
#pragma unroll
  for (int q = 0; q < H; ++q)
    x[q] = __fadd_rn(x[q], bf16r(__fadd_rn(__fmul_rn(m, emb_w[q]), bias[q])));
}

template <int H>
__device__ __forceinline__ void set_features(float (&x)[H], float m, const float* emb_w,
                                             const float* bias) {
#pragma unroll
  for (int q = 0; q < H; ++q) x[q] = bf16r(__fadd_rn(__fmul_rn(m, emb_w[q]), bias[q]));
}

// out[e] += correction of layer idx computed from msgs; ends with a barrier.
template <int H, int V>
__device__ void correction(const Args& a, const Block<H>& b, int idx, const float* msgs,
                           float* out) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int Z = b.Z, K = b.K;
  const Graph& g = b.g;
  constexpr int NW = V == 2 ? 6 : 8;

  // Stage the layer: weights (bf16 -> float32), small vectors, ebias table.
  {
    const __nv_bfloat16* wl = a.w + static_cast<size_t>(idx) * NW * H * H;
    for (int i = tid; i < NW * H * H; i += nt) {
      const int m = i / (H * H);
      if (!a.inject && (m == kWvl || m == kWcl)) continue;
      b.w[i] = __bfloat162float(wl[i]);
    }
    const int ns = V == 2 ? 4 * H + 4 : 3 * H + 4;
    for (int i = tid; i < ns; i += nt) b.small[i] = a.small[static_cast<size_t>(idx) * ns + i];
    if (V == 2) {
      const int ne = a.ntypes * H;
      for (int i = tid; i < ne; i += nt) b.tab[i] = a.tab[static_cast<size_t>(idx) * ne + i];
    }
  }
  __syncthreads();
  const float* W = b.w;

  // Per variable: mean of its messages' features, and the products every
  // message of the variable shares.
  for (int i = tid; i < b.C * Z; i += nt) {
    const int c = i / Z, z = i - c * Z;
    float x[H];
#pragma unroll
    for (int q = 0; q < H; ++q) x[q] = 0.0f;
    for (int j = g.col_ptr[c]; j < g.col_ptr[c + 1]; ++j) {
      const int k = g.col_edge[j];
      add_features<H>(x, msgs[k * Z + z], b.emb_w, V == 2 ? b.tab + g.type[k] * H : b.emb_b);
    }
    const float inv = b.inv_dc[c];
#pragma unroll
    for (int q = 0; q < H; ++q) x[q] = bf16r(__fmul_rn(x[q], inv));
    float* pc = b.pre_col + c * H * Z + z;
    const float* b1v = b.small;  // v2 only
    matvec<H>(W + kWva * H * H, x,
              [&](int j, float s) { pc[j * Z] = V == 2 ? __fadd_rn(s, b1v[j]) : s; });
    if (a.inject) {
      set_features<H>(x, b.llr[i], b.emb_w, b.emb_b);
      matvec<H>(W + kWvl * H * H, x, [&](int j, float s) { pc[j * Z] = __fadd_rn(pc[j * Z], s); });
      float* pl = b.pre_llr + c * H * Z + z;
      matvec<H>(W + kWcl * H * H, x, [&](int j, float s) { pl[j * Z] = s; });
    }
  }

  // Per check: sum of its members' features and the check-relation product.
  for (int i = tid; i < b.R * Z; i += nt) {
    const int r = i / Z, zc = i - r * Z;
    float x[H];
#pragma unroll
    for (int q = 0; q < H; ++q) x[q] = 0.0f;
    for (int j = g.row_ptr[r]; j < g.row_ptr[r + 1]; ++j) {
      const int k = g.row_edge[j];
      int v = zc + g.shift[k];
      v = v >= Z ? v - Z : v;
      add_features<H>(x, msgs[k * Z + v], b.emb_w, V == 2 ? b.tab + g.type[k] * H : b.emb_b);
    }
    const float inv = b.inv_dr[r];
    float* pr = b.pre_row + r * H * Z + zc;
    if constexpr (V == 2) {
      const float* b1c = b.small + H;
      matvec<H>(W + kWca * H * H, x,
                [&](int j, float s) { pr[j * Z] = __fadd_rn(__fmul_rn(s, inv), b1c[j]); });
    } else {
#pragma unroll
      for (int q = 0; q < H; ++q) x[q] = bf16r(__fmul_rn(x[q], inv));
      matvec<H>(W + kWca * H * H, x, [&](int j, float s) { pr[j * Z] = s; });
    }
  }
  __syncthreads();  // the scratch writes above are visible to the whole block

  // Per message: its own products, the second layer and the projection.
  for (int i = tid; i < K * Z; i += nt) {
    const int k = i / Z, z = i - k * Z;
    const int c = g.col[k];
    int zc = z - g.shift[k];
    zc = zc < 0 ? zc + Z : zc;
    const float* pc = b.pre_col + c * H * Z + z;
    const float* pl = b.pre_llr + c * H * Z + z;
    const float* pr = b.pre_row + g.row[k] * H * Z + zc;
    const bool inject = a.inject;
    float x[H];
    set_features<H>(x, msgs[i], b.emb_w, V == 2 ? b.tab + g.type[k] * H : b.emb_b);
    float corr = 0.0f;
    if constexpr (V == 2) {
      const float* w2pv = b.small + 2 * H;
      const float* w2pc = b.small + 3 * H;
      matvec<H>(W + kWvf * H * H, x, [&](int j, float s) {
        const float h1 = bf16r(fmaxf(__fadd_rn(s, pc[j * Z]), 0.0f));
        corr = fmaf(w2pv[j], h1, corr);
      });
      matvec<H>(W + kWcf * H * H, x, [&](int j, float s) {
        float p = __fadd_rn(s, pr[j * Z]);
        if (inject) p = __fadd_rn(p, pl[j * Z]);
        corr = fmaf(w2pc[j], bf16r(fmaxf(p, 0.0f)), corr);
      });
      corr = __fadd_rn(corr, b.small[4 * H]);
    } else {
      const float* b2v = b.small;
      const float* b2c = b.small + H;
      const float* pw = b.small + 2 * H;
      const float* bias1v = a.tab + (static_cast<size_t>(idx) * 2 * K + k) * H;
      const float* bias1c = bias1v + static_cast<size_t>(K) * H;
      float hl[H];  // indexed by the row loop: thread-local memory
      float ov[H];
      float h1[H];
      matvec<H>(W + kWvf * H * H, x, [&](int j, float s) {
        hl[j] = bf16r(fmaxf(__fadd_rn(__fadd_rn(s, pc[j * Z]), bias1v[j]), 0.0f));
      });
#pragma unroll
      for (int q = 0; q < H; ++q) h1[q] = hl[q];
      matvec<H>(W + kW2v * H * H, h1,
                [&](int j, float s) { ov[j] = bf16r(__fadd_rn(s, b2v[j])); });
      matvec<H>(W + kWcf * H * H, x, [&](int j, float s) {
        float p = __fadd_rn(__fadd_rn(s, pr[j * Z]), bias1c[j]);
        if (inject) p = __fadd_rn(p, pl[j * Z]);
        hl[j] = bf16r(fmaxf(p, 0.0f));
      });
#pragma unroll
      for (int q = 0; q < H; ++q) h1[q] = hl[q];
      matvec<H>(W + kW2c * H * H, h1, [&](int j, float s) {
        const float oc = bf16r(__fadd_rn(s, b2c[j]));
        const float lo = bf16r(__fadd_rn(ov[j], oc));
        corr = __fadd_rn(corr, __fmul_rn(lo, pw[j]));
      });
      corr = __fadd_rn(corr, b.small[3 * H]);
    }
    out[i] = __fadd_rn(out[i], corr);
  }
  __syncthreads();
}

// The decode both kernels share: frames from the atomic counter, T
// iterations of the min-sum skeleton each, correction<H, V> after every
// half-update.
template <int H, int V>
__device__ __forceinline__ void decode_frames(const Args& a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_frame, s_viol;
  float* smem = reinterpret_cast<float*>(smem_raw);
  const int Z = a.Z, R = a.R, C = a.C, K = a.K;
  const int n = C * Z, E = K * Z, M = R * Z;
  const int tid = threadIdx.x, nt = blockDim.x;
  const Layout L = make_layout(V, H, Z, R, C, K, a.ntypes);

  int* s_graph = reinterpret_cast<int*>(smem + L.graph);
  for (int i = tid; i < 6 * K + R + C + 2; i += nt) s_graph[i] = a.graph[i];
  for (int i = tid; i < C + R; i += nt) smem[L.inv + i] = a.inv[i];
  for (int i = tid; i < 2 * H; i += nt) smem[L.emb + i] = a.emb[i];

  Block<H> b;
  b.g.row_ptr = s_graph;
  b.g.row_edge = b.g.row_ptr + R + 1;
  b.g.col_ptr = b.g.row_edge + K;
  b.g.col_edge = b.g.col_ptr + C + 1;
  b.g.shift = b.g.col_edge + K;
  b.g.col = b.g.shift + K;
  b.g.row = b.g.col + K;
  b.g.type = b.g.row + K;
  b.inv_dc = smem + L.inv;
  b.inv_dr = b.inv_dc + C;
  b.v2c = smem + L.v2c;
  b.c2v = smem + L.c2v;
  b.llr = smem + L.llr;
  b.colsum = smem + L.colsum;
  b.emb_w = smem + L.emb;
  b.emb_b = b.emb_w + H;
  b.small = smem + L.small;
  b.tab = smem + L.tab;
  b.w = smem + L.w;
  b.pre_col = a.scratch + static_cast<size_t>(blockIdx.x) * (2 * C + R) * H * Z;
  b.pre_llr = b.pre_col + static_cast<size_t>(C) * H * Z;
  b.pre_row = b.pre_llr + static_cast<size_t>(C) * H * Z;
  b.Z = Z;
  b.R = R;
  b.C = C;
  b.K = K;
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
      __syncthreads();
      correction<H, V>(a, b, 2 * t, b.v2c, b.c2v);

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
      for (int i = tid; i < E; i += nt) {
        const int k = i / Z;
        const int u = g.col[k] * Z + (i - k * Z);
        b.v2c[i] = __fadd_rn(__fsub_rn(b.colsum[u], b.c2v[i]), __fmul_rn(a.w_ch, b.llr[u]));
      }
      __syncthreads();
      correction<H, V>(a, b, 2 * t + 1, b.c2v, b.v2c);
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

// B4, _corrected_kernel_v2: the second layer and the projection folded into
// one thin product.
template <int H>
__global__ void __launch_bounds__(threads_of(2)) corrected_v2_kernel(const Args a) {
  decode_frames<H, 2>(a);
}

// B5, _corrected_kernel: full (h, h) second layers, bf16 layer outputs,
// float32 projection.
template <int H>
__global__ void __launch_bounds__(threads_of(1)) corrected_kernel(const Args a) {
  decode_frames<H, 1>(a);
}

using KernelFn = void (*)(const Args);

KernelFn pick_kernel(int variant, int H) {
  if (variant == 2) {
    switch (H) {
      case 16: return corrected_v2_kernel<16>;
      case 64: return corrected_v2_kernel<64>;
    }
  } else if (variant == 1) {
    switch (H) {
      case 16: return corrected_kernel<16>;
      case 64: return corrected_kernel<64>;
    }
  }
  return nullptr;
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs.
long long ldpc_corrected_gnn_smem_bytes(int variant, int H, int Z, int R, int C, int K,
                                        int ntypes) {
  return 4LL * make_layout(variant, H, Z, R, C, K, ntypes).total;
}

// Floats of global scratch one block needs.
long long ldpc_corrected_gnn_scratch_floats(int H, int Z, int R, int C) {
  return static_cast<long long>(2 * C + R) * H * Z;
}

// Resident blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// or -cudaError_t; -cudaErrorInvalidValue for an unsupported (variant, H).
int ldpc_corrected_gnn_occupancy(int variant, int H, int Z, int R, int C, int K, int ntypes) {
  KernelFn kernel = pick_kernel(variant, H);
  if (kernel == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  const long long smem = ldpc_corrected_gnn_smem_bytes(variant, H, Z, R, C, K, ntypes);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads_of(variant), smem);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// Launches one of the two kernels on `stream` with `grid` blocks, no sync.
static int launch(int variant, int H, const void* llr, void* soft, void* conv, void* counter,
                  void* scratch, const void* graph, const void* inv, const void* w,
                  const void* tab, const void* small, const void* emb, int B, int Z, int R, int C,
                  int K, int ntypes, int T, int inject, int early_exit, float w_ch, float alpha,
                  int grid, void* stream) {
  KernelFn kernel = pick_kernel(variant, H);
  if (kernel == nullptr || grid < 1 || B < 1 || T < 1) return cudaErrorInvalidValue;
  const long long smem = ldpc_corrected_gnn_smem_bytes(variant, H, Z, R, C, K, ntypes);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  Args a;
  a.llr = static_cast<const float*>(llr);
  a.soft = static_cast<float*>(soft);
  a.conv = static_cast<float*>(conv);
  a.counter = static_cast<int*>(counter);
  a.scratch = static_cast<float*>(scratch);
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
  a.inject = inject;
  a.early_exit = early_exit;
  a.w_ch = w_ch;
  a.alpha = alpha;
  kernel<<<grid, threads_of(variant), smem, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

// The entry point of corrected_v2_kernel (_corrected_kernel_v2).  `counter`
// must hold 0.  `conv` may be null.  Returns a cudaError_t (0 on success).
int ldpc_corrected_gnn_v2(int H, const void* llr, void* soft, void* conv, void* counter,
                          void* scratch, const void* graph, const void* inv, const void* w,
                          const void* tab, const void* small, const void* emb, int B, int Z, int R,
                          int C, int K, int ntypes, int T, int inject, int early_exit, float w_ch,
                          float alpha, int grid, void* stream) {
  return launch(2, H, llr, soft, conv, counter, scratch, graph, inv, w, tab, small, emb, B, Z, R,
                C, K, ntypes, T, inject, early_exit, w_ch, alpha, grid, stream);
}

// The entry point of corrected_kernel (_corrected_kernel), same arguments.
int ldpc_corrected_gnn(int H, const void* llr, void* soft, void* conv, void* counter,
                       void* scratch, const void* graph, const void* inv, const void* w,
                       const void* tab, const void* small, const void* emb, int B, int Z, int R,
                       int C, int K, int ntypes, int T, int inject, int early_exit, float w_ch,
                       float alpha, int grid, void* stream) {
  return launch(1, H, llr, soft, conv, counter, scratch, graph, inv, w, tab, small, emb, B, Z, R,
                C, K, ntypes, T, inject, early_exit, w_ch, alpha, grid, stream);
}

const char* ldpc_gnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
