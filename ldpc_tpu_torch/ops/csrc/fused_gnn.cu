// B5, the fused corrected min-sum GNN decoder for Hopper (sm_90a): the whole
// decode of a frame (T iterations of scaled min-sum, each half-update
// followed by a GNN correction) in one kernel launch, the second MLP layer
// not folded.
//
// Replaces the TPU kernel of ldpc_tpu/ops/pallas_gnn.py:
//   * corrected_kernel<H>     <- _corrected_kernel
//                                (make_fused_corrected_gnn_decoder),
//                                entry point ldpc_corrected_gnn
// H is the hidden width, built for 16 and 64.  Its sibling B4
// (_corrected_kernel_v2, the folded second layer) runs on the tensor cores
// in fused_gnn_tc.cu and shares the min-sum skeleton below step for step.
// Python wrappers, weight packing and the plain PyTorch version:
// ldpc_tpu_torch/ops/fused_gnn.py.  Built with -fmad=false: nvcc contracts
// no a * b + c on its own, every fused multiply-add below is an explicit
// fmaf in a matrix product, and the min-sum skeleton rounds after every
// operation (the untrained decoder is bit-exact scaled min-sum).
//
// What it computes, per frame
// ---------------------------
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
//   f      = bf16(m * emb_w + emb_b)                      (h features)
//   vmean  = bf16(sum of f over the variable's messages / degree)
//   rmean  = bf16(sum of f over the check's members / degree)
//   lf     = bf16(llr * emb_w + emb_b)                    (input injection)
//   type embeddings sit in per-edge first-layer biases bias1v, bias1c (float32);
//   pre_v  = (W1vf f + (W1va vmean + W1vl lf)) + bias1v[k]
//   pre_c  = ((W1cf f + W1ca rmean) + bias1c[k]) + W1cl lf
//   out_v  = bf16(W2v bf16(relu(pre_v)) + b2v), out_c likewise
//   corr   = sum_j float(bf16(out_v + out_c))[j] * pw[j] + pb.
// bf16 rounding points (all __float2bfloat16_rn, repeated in this order by
// the plain version): f, vmean, lf, rmean, the ReLU outputs, out_v, out_c
// and their sum; the weights W1*, W2* are rounded by the wrapper.  Every
// product accumulates in float32.
//
// What changed against the TPU kernel
// -----------------------------------
// No lane layout, no rolls, no padding of C or of weights, no ones-row: one
// thread owns one variable, check or message, and a roll by s is the index
// (z + s) mod Z.  The embedded features are never stored: they are a
// function of one float, so each thread rebuilds the h features of a message
// where it needs them (in the variable's mean, the check's mean and the
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
//     operations each, plus the second layer's two (h, h) products and the
//     projection, (4h^2 + 2h) E.  They are bf16 x bf16 -> float32 products,
//     so they are counted at the tensor cores' dense bf16 rate, 989e12 per
//     second.
//   elementwise float32 (none an FMA, so 33.5e12 per second):
//     (15 + inj) h E + (1 + 3 inj) h n + h M + E
//     (embed 2, variable sum 1, check sum 1, add shared term, bias and ReLU
//      for pre_v and pre_c, bias, bf16 sum, projection multiply and sum of
//      the second layer per message and feature; mean per variable, embed
//      and add of lf; mean per check).
// Per iteration the min-sum skeleton adds 12 E + 4 M + 2 n float32 and, with
// early_exit, E + M int32 operations (16.75e12 per second).  A frame needs
// conv_iter iterations and 2 conv_iter - 1 corrections.  LLRs are read and
// soft bits written once (8 n bytes a frame at 3.35e12 bytes per second).
// The bound is the products; this source runs them on the float32 FMA pipe
// (at most 67e12 per second, 1/15 of the tensor cores), so the kernel is far
// from its bound.
//
// Shared memory of a block (4-byte words; see make_layout): graph, inverse
// degrees, v2c, c2v, LLRs, colsum, embedding, the layer's small vectors and
// 8 weight matrices of h*h floats: 202 KB at the main path's shapes, one
// block per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gnn_common.cuh"

namespace {

constexpr float kBig = 1e9f;  // stand-in for +inf, as _BIG in the JAX package
constexpr int kThreads = 256;  // threads of a block
constexpr int kNumWeights = 8;  // (h, h) weight matrices of a layer

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
  const __nv_bfloat16* w;    // (2T, 8, H, H)
  const float* tab;          // bias1 (2T, 2, K, H)
  const float* small;        // (2T, 3H+4) b2v b2c pw pb
  const float* emb;          // emb_w (H), emb_b (H)
  int B, Z, R, C, K, T, inject, early_exit;
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

__host__ __device__ inline int small_floats(int H) { return 3 * H + 4; }

// Offsets (in 4-byte words) of a block's shared memory.
struct Layout {
  int graph, inv, v2c, c2v, llr, colsum, emb, small, w, total;
};

__host__ __device__ inline Layout make_layout(int H, int Z, int R, int C, int K) {
  Layout L;
  int o = 0;
  L.graph = o; o += round4(6 * K + R + C + 2);
  L.inv = o; o += round4(C + R);
  L.v2c = o; o += round4(K * Z);
  L.c2v = o; o += round4(K * Z);
  L.llr = o; o += round4(C * Z);
  L.colsum = o; o += round4(C * Z);
  L.emb = o; o += 2 * H;
  L.small = o; o += small_floats(H);
  L.w = o; o += kNumWeights * H * H;
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
template <int H>
__device__ void correction(const Args& a, const Block<H>& b, int idx, const float* msgs,
                           float* out) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int Z = b.Z, K = b.K;
  const Graph& g = b.g;

  // Stage the layer: weights (bf16 -> float32) and small vectors.
  {
    const __nv_bfloat16* wl = a.w + static_cast<size_t>(idx) * kNumWeights * H * H;
    for (int i = tid; i < kNumWeights * H * H; i += nt) {
      const int m = i / (H * H);
      if (!a.inject && (m == kWvl || m == kWcl)) continue;
      b.w[i] = __bfloat162float(wl[i]);
    }
    const int ns = small_floats(H);
    for (int i = tid; i < ns; i += nt) b.small[i] = a.small[static_cast<size_t>(idx) * ns + i];
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
      add_features<H>(x, msgs[k * Z + z], b.emb_w, b.emb_b);
    }
    const float inv = b.inv_dc[c];
#pragma unroll
    for (int q = 0; q < H; ++q) x[q] = bf16r(__fmul_rn(x[q], inv));
    float* pc = b.pre_col + c * H * Z + z;
    matvec<H>(W + kWva * H * H, x, [&](int j, float s) { pc[j * Z] = s; });
    if (a.inject) {
      set_features<H>(x, b.llr[i], b.emb_w, b.emb_b);
      matvec<H>(W + kWvl * H * H, x, [&](int j, float s) { pc[j * Z] = __fadd_rn(pc[j * Z], s); });
      float* pl = b.pre_llr + c * H * Z + z;
      matvec<H>(W + kWcl * H * H, x, [&](int j, float s) { pl[j * Z] = s; });
    }
  }

  // Per check: mean of its members' features and the check-relation product.
  for (int i = tid; i < b.R * Z; i += nt) {
    const int r = i / Z, zc = i - r * Z;
    float x[H];
#pragma unroll
    for (int q = 0; q < H; ++q) x[q] = 0.0f;
    for (int j = g.row_ptr[r]; j < g.row_ptr[r + 1]; ++j) {
      const int k = g.row_edge[j];
      int v = zc + g.shift[k];
      v = v >= Z ? v - Z : v;
      add_features<H>(x, msgs[k * Z + v], b.emb_w, b.emb_b);
    }
    const float inv = b.inv_dr[r];
    float* pr = b.pre_row + r * H * Z + zc;
#pragma unroll
    for (int q = 0; q < H; ++q) x[q] = bf16r(__fmul_rn(x[q], inv));
    matvec<H>(W + kWca * H * H, x, [&](int j, float s) { pr[j * Z] = s; });
  }
  __syncthreads();  // the scratch writes above are visible to the whole block

  // Per message: its own products, the second layer and the projection.
  const float* b2v = b.small;
  const float* b2c = b.small + H;
  const float* pw = b.small + 2 * H;
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
    set_features<H>(x, msgs[i], b.emb_w, b.emb_b);
    float corr = 0.0f;
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
    matvec<H>(W + kW2v * H * H, h1, [&](int j, float s) { ov[j] = bf16r(__fadd_rn(s, b2v[j])); });
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
    out[i] = __fadd_rn(out[i], corr);
  }
  __syncthreads();
}

// The decode: frames from the atomic counter, T iterations of the min-sum
// skeleton each, correction<H> after every half-update.
template <int H>
__device__ __forceinline__ void decode_frames(const Args& a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_frame, s_viol;
  float* smem = reinterpret_cast<float*>(smem_raw);
  const int Z = a.Z, R = a.R, C = a.C, K = a.K;
  const int n = C * Z, E = K * Z, M = R * Z;
  const int tid = threadIdx.x, nt = blockDim.x;
  const Layout L = make_layout(H, Z, R, C, K);

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
      correction<H>(a, b, 2 * t, b.v2c, b.c2v);

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
      correction<H>(a, b, 2 * t + 1, b.c2v, b.v2c);
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

// B5, _corrected_kernel: full (h, h) second layers, bf16 layer outputs,
// float32 projection.
template <int H>
__global__ void __launch_bounds__(kThreads) corrected_kernel(const Args a) {
  decode_frames<H>(a);
}

using KernelFn = void (*)(const Args);

KernelFn pick_kernel(int H) {
  switch (H) {
    case 16: return corrected_kernel<16>;
    case 64: return corrected_kernel<64>;
  }
  return nullptr;
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs.
long long ldpc_corrected_gnn_smem_bytes(int H, int Z, int R, int C, int K) {
  return 4LL * make_layout(H, Z, R, C, K).total;
}

// Floats of global scratch one block needs.
long long ldpc_corrected_gnn_scratch_floats(int H, int Z, int R, int C) {
  return static_cast<long long>(2 * C + R) * H * Z;
}

// Resident blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// or -cudaError_t; -cudaErrorInvalidValue for an unsupported H.
int ldpc_corrected_gnn_occupancy(int H, int Z, int R, int C, int K) {
  KernelFn kernel = pick_kernel(H);
  if (kernel == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  const long long smem = ldpc_corrected_gnn_smem_bytes(H, Z, R, C, K);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// The entry point of corrected_kernel (_corrected_kernel): launches it on
// `stream` with `grid` blocks, no sync.  `counter` must hold 0.  `conv` may
// be null.  Returns a cudaError_t (0 on success).
int ldpc_corrected_gnn(int H, const void* llr, void* soft, void* conv, void* counter,
                       void* scratch, const void* graph, const void* inv, const void* w,
                       const void* tab, const void* small, const void* emb, int B, int Z, int R,
                       int C, int K, int T, int inject, int early_exit, float w_ch, float alpha,
                       int grid, void* stream) {
  KernelFn kernel = pick_kernel(H);
  if (kernel == nullptr || grid < 1 || B < 1 || T < 1) return cudaErrorInvalidValue;
  const long long smem = ldpc_corrected_gnn_smem_bytes(H, Z, R, C, K);
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
  a.T = T;
  a.inject = inject;
  a.early_exit = early_exit;
  a.w_ch = w_ch;
  a.alpha = alpha;
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

const char* ldpc_gnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
