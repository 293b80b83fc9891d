// Fused fully-neural message-GNN decoders for Hopper (sm_90a): the whole
// forward of a trained fully-neural MessageGNNDecoder (LLR embedding, T GNN
// layers, output projection, per-variable sum, sigmoid) in one kernel launch.
//
// Replaces the TPU kernels of ldpc_tpu/ops/pallas_gnn.py:
//   * msg_gnn_kernel<H>     <- _kernel     (make_fused_gnn_decoder),
//                              entry point ldpc_msg_gnn
//   * msg_gnn_v2_kernel<H>  <- _kernel_v2  (make_fused_gnn_decoder_v2),
//                              entry point ldpc_msg_gnn_v2
// The two compute the same function and differ in one bf16 rounding (and, with
// input injection, in the order of one float32 sum): layer<H, 6> and
// layer<H, 7> below.  H is the hidden width, built for 16 and 64.  Python
// wrappers, weight packing (_extract) and the plain PyTorch version of each
// kernel: ldpc_tpu_torch/ops/fused_gnn.py.  Built with -fmad=false: every
// fused multiply-add below is an explicit fmaf in a matrix product, and the
// elementwise steps round after every operation as the plain version does.
//
// What both compute, per frame
// ----------------------------
// Messages are var-aligned per base edge k: message (k, z) belongs to
// variable (col[k], z) and to check (row[k], (z - shift[k]) mod Z).  Each
// message carries h features, f (bf16):
//   seed:   f = bf16(llr[col[k], z] * emb_w + emb_b); lf, the same of the
//           variable's LLR, with input injection (rebuilt where needed).
//   layer t = 0 .. T-1 (weights of layer t, bf16; the type embeddings are
//   folded into per-edge first-layer biases b1v[t, k], b1c[t, k], float32):
//     vmean  = bf16(sum of f over the variable's messages * (1 / degree))
//     rmean  = bf16(sum of f over the check's messages * (1 / degree))
//     B6: pre_col = W1va vmean + W1vl lf;   B7: pre_col = W1va vmean
//     pre_row = W1ca rmean
//     per message:
//       B6: pv = (W1vf f + pre_col) + b1v
//       B7: pv = ((W1vf f + pre_col) + b1v) + W1vl lf
//       both: pc = ((W1cf f + pre_row[check]) + b1c) + W1cl lf
//       (the lf terms only with injection)
//       h1v = bf16(relu(pv)), h1c = bf16(relu(pc))
//       B6: new = bf16(bf16(W2v h1v + b2v) + bf16(W2c h1c + b2c))
//       B7: new = bf16([W2v W2c] [h1v; h1c] + b2), b2 = b2v + b2c
//       f = new at t = 0, bf16(new + f) after (residual from layer 2)
//   output: acc = sum over the variable's messages of
//           ((acc + sum_q f[q] * proj_w[q]) + proj_b);
//           soft = 1 / (1 + exp(llr + acc)).
// Every product accumulates in float32 (bf16 x bf16 products are exact in
// float32, so only the summation order differs from the plain version's).
//
// What changed against the TPU kernels
// ------------------------------------
// No lane layout, no rolls, no padding: one thread owns one variable, check
// or message, and a roll by s is the index (z + s) mod Z.  A frame's state
// does not fit in a block (the features alone are K*Z*h bf16, 807 KB at
// nr_2_0_32 Z=32 h=64), so it lives in a global scratch slice per resident
// block, sized by the grid and not by the batch, laid out [group][feature][z]
// so a warp reads consecutive z: the features (bf16) and the per-variable and
// per-check first-layer terms pre_col, pre_row and, with injection, the LLR
// terms (float32), (C + R + 2C inj) * Z * h floats.  The means and the LLR
// features are never stored: the thread of a variable or check sums its
// messages' features in registers and multiplies at once.  Frames are handed
// to blocks through an atomic counter.  Each layer runs in two phases
// separated by barriers: (1) variables and checks, (2) messages, each
// message reading only its own features and the shared terms, so it is
// updated in place.  One phase's four (h, h) weight matrices are staged in
// shared memory as float32 (64 KB at h=64); a message's first-layer outputs
// go through a per-thread column of shared memory (2h bf16) into registers
// for the second layer.  The products are plain FMA loops: each thread holds
// its h (or 2h) inputs in registers and walks the weight rows, which every
// thread of the warp reads at the same address (a broadcast), four rows at a
// time for four (or eight) independent accumulators.
//
// What bounds it on the card
// --------------------------
// Per layer of one frame, with E = K*Z messages, n = C*Z variables, M = R*Z
// checks, inj = 1 with input injection:
//   products: (4E + n + M + 2 inj n) products of (h, h) by a vector, 2h^2
//     operations each (first layer per message twice, second layer twice;
//     one per variable and check mean; the LLR terms per variable).  They
//     are bf16 x bf16 -> float32 products, so they are counted at the
//     tensor cores' dense bf16 rate, 989e12 per second.
//   elementwise float32 (none an FMA: 33.5e12 per second), per feature:
//     means 2E + n + M adds and multiplies; per message pv and pc 6 (+2 inj),
//     second layer 3 (B6) or 1 (B7), residual 1 after layer 1; B6 with inj
//     n more for pre_col.  Once per frame: seed 2E h (+2 n h inj), output
//     2E h + 2E + 4n.
// LLRs are read and soft bits written once (8n bytes a frame, 3.35e12 bytes
// per second).  Main path (bench.py section_msg_gnn: nr_2_0_32 Z=32 h=64,
// T=20, no injection, batch 2048): 115.6e6 multiply-adds per layer of a
// frame, 9.47e12 operations for the batch, 9.6 ms; the elementwise work
// takes 6 ms at the float32 rate and runs beside it: the bound is the
// products.  This source runs them on the float32 FMA pipe (at most 67e12 per
// second, 1/15 of the tensor cores): 141 ms at a full pipe, so the kernel is
// far from its bound.  It also moves the scratch through L2 and device
// memory: per layer of a frame, the features are read three times and
// written once (3.2 MB) and the shared terms written once and read once per
// message (1 MB and 3.2 MB), about 370 GB for the batch; whether that or the
// FMA issue limits it is not measured.  Using wgmma needs the messages of a
// warp group gathered into 64-row tiles and is left to later work.
//
// Shared memory of a block (4-byte words; see make_layout): graph, inverse
// degrees, the frame's LLRs, embedding and projection, the layer's second-
// layer biases, four h*h weight matrices (float32) and the first-layer
// staging (2h bf16 per thread): 144 KB at the main path's shapes, one block
// of 256 threads per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gnn_common.cuh"

namespace {

constexpr int kThreads = 256;

// Weight matrices of a layer, in packing order: phase 1 (means and LLR
// terms) then phase 2 (messages).
enum { kWva = 0, kWca, kWvl, kWcl, kWvf, kWcf, kW2v, kW2c, kNumWeights };

struct Args {
  const float* llr;          // (B, n)
  float* soft;               // (B, n)
  int* counter;              // next frame to hand out, starts at 0
  float* scratch;            // (grid, scratch_floats)
  const int* graph;          // row_ptr, row_edge, col_ptr, col_edge, shift, col, row, type
  const float* inv;          // 1/degree per column (C), then per row (R)
  const __nv_bfloat16* w;    // (T, 8, H, H)
  const float* tab;          // (T, 2, K, H): b1v, b1c per edge (type embeddings folded in)
  const float* small;        // (T, 2H): B6 b2v, b2c; B7 b2v + b2c, 0
  const float* emb;          // emb_w (H), emb_b (H), proj_w (H), proj_b
  int B, Z, R, C, K, T, inject;
};

struct Graph {
  const int* row_ptr;   // (R+1) offsets into row_edge
  const int* row_edge;  // (K) base edges of each row, in row order
  const int* col_ptr;   // (C+1) offsets into col_edge
  const int* col_edge;  // (K) base edges of each column, in col_members order
  const int* shift;     // (K) circulant shift mod Z
  const int* col;       // (K) base column
  const int* row;       // (K) base row
};

// Offsets (in 4-byte words) of a block's shared memory.
struct Layout {
  int graph, inv, llr, emb, small, w, stage, total;
};

__host__ __device__ inline Layout make_layout(int H, int Z, int R, int C, int K) {
  Layout L;
  int o = 0;
  L.graph = o; o += round4(6 * K + R + C + 2);
  L.inv = o; o += round4(C + R);
  L.llr = o; o += round4(C * Z);
  L.emb = o; o += round4(3 * H + 1);
  L.small = o; o += 2 * H;
  L.w = o; o += 4 * H * H;
  L.stage = o; o += H * kThreads;  // 2H bf16 per thread
  L.total = o;
  return L;
}

// Floats of one block's global scratch: pre_col (C), pre_row (R), with
// injection the LLR terms (2C), each Z*H float32; then the features, K*Z*H
// bf16.
__host__ __device__ inline long long scratch_floats(int H, int Z, int R, int C, int K,
                                                    int inject) {
  return static_cast<long long>(C + R + (inject ? 2 * C : 0)) * Z * H +
         static_cast<long long>(K) * Z * H / 2;
}

// The second layer of one message, rows four at a time: B6 sums W2v x and
// W2c y apart (sink(j, sv, sc)); B7 continues one sum over both
// (sink(j, s, 0)).
template <int H, int V, typename Sink>
__device__ __forceinline__ void second_layer(const float* __restrict__ W2v,
                                             const float* __restrict__ W2c, const float (&x)[H],
                                             const float (&y)[H], Sink&& sink) {
#pragma unroll 1
  for (int j = 0; j < H; j += 4) {
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
    rows4<H>(W2v, j, x, a0, a1, a2, a3);
    if constexpr (V == 6) {
      float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, c3 = 0.0f;
      rows4<H>(W2c, j, y, c0, c1, c2, c3);
      sink(j, a0, c0);
      sink(j + 1, a1, c1);
      sink(j + 2, a2, c2);
      sink(j + 3, a3, c3);
    } else {
      rows4<H>(W2c, j, y, a0, a1, a2, a3);
      sink(j, a0, 0.0f);
      sink(j + 1, a1, 0.0f);
      sink(j + 2, a2, 0.0f);
      sink(j + 3, a3, 0.0f);
    }
  }
}

// x[q] = bf16(m * emb_w[q] + emb_b[q]): one LLR's features.
template <int H>
__device__ __forceinline__ void embed(float (&x)[H], float m, const float* emb_w,
                                      const float* emb_b) {
#pragma unroll
  for (int q = 0; q < H; ++q) x[q] = bf16r(__fadd_rn(__fmul_rn(m, emb_w[q]), emb_b[q]));
}

// Pointers into a block's shared memory and scratch.
template <int H>
struct Block {
  Graph g;
  const float *inv_dc, *inv_dr;
  float* llr;
  const float *emb_w, *emb_b, *proj_w;
  float proj_b;
  float* small;            // the staged layer's second-layer biases
  float* w;                // the staged phase's four weight matrices
  __nv_bfloat16* stage;    // [2H][kThreads] first-layer outputs
  float *pre_col, *pre_row, *pre_llr_v, *pre_llr_c;  // global scratch, [group][j][z]
  __nv_bfloat16* feats;    // global scratch, [k][q][z]
  int Z, R, C, K;
};

// Stages weights first .. first+3 of layer t (bf16 -> float32); the caller
// synchronises.
template <int H>
__device__ void stage_weights(const Args& a, const Block<H>& b, int t, int first) {
  const __nv_bfloat16* wl = a.w + (static_cast<size_t>(t) * kNumWeights + first) * H * H;
  for (int i = threadIdx.x; i < 4 * H * H; i += blockDim.x) b.w[i] = __bfloat162float(wl[i]);
}

// Layer t of one frame: phase 1 (variables and checks), phase 2 (messages).
// Starts and ends with a barrier.
template <int H, int V>
__device__ void layer(const Args& a, const Block<H>& b, int t) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int Z = b.Z, C = b.C, K = b.K, n = C * Z, M = b.R * Z;
  const Graph& g = b.g;
  const __nv_bfloat16* F = b.feats;

  stage_weights<H>(a, b, t, kWva);
  for (int i = tid; i < 2 * H; i += nt) b.small[i] = a.small[static_cast<size_t>(t) * 2 * H + i];
  __syncthreads();

  // Phase 1: per variable, the mean of its messages' features times W1va
  // (and the LLR terms); per check, the mean times W1ca.
  for (int i = tid; i < n + M; i += nt) {
    float x[H];
#pragma unroll
    for (int q = 0; q < H; ++q) x[q] = 0.0f;
    if (i < n) {
      const int c = i / Z, z = i - c * Z;
      for (int j = g.col_ptr[c]; j < g.col_ptr[c + 1]; ++j) {
        const __nv_bfloat16* fk = F + static_cast<size_t>(g.col_edge[j]) * H * Z + z;
#pragma unroll
        for (int q = 0; q < H; ++q) x[q] = __fadd_rn(x[q], __bfloat162float(fk[q * Z]));
      }
      const float inv = b.inv_dc[c];
#pragma unroll
      for (int q = 0; q < H; ++q) x[q] = bf16r(__fmul_rn(x[q], inv));
      float* pc = b.pre_col + static_cast<size_t>(c) * H * Z + z;
      matvec<H>(b.w + kWva * H * H, x, [&](int j, float s) { pc[j * Z] = s; });
      if (a.inject) {
        embed<H>(x, b.llr[i], b.emb_w, b.emb_b);
        if constexpr (V == 6) {
          matvec<H>(b.w + kWvl * H * H, x,
                    [&](int j, float s) { pc[j * Z] = __fadd_rn(pc[j * Z], s); });
        } else {
          float* lv = b.pre_llr_v + static_cast<size_t>(c) * H * Z + z;
          matvec<H>(b.w + kWvl * H * H, x, [&](int j, float s) { lv[j * Z] = s; });
        }
        float* lc = b.pre_llr_c + static_cast<size_t>(c) * H * Z + z;
        matvec<H>(b.w + kWcl * H * H, x, [&](int j, float s) { lc[j * Z] = s; });
      }
    } else {
      const int rz = i - n, r = rz / Z, zc = rz - r * Z;
      for (int j = g.row_ptr[r]; j < g.row_ptr[r + 1]; ++j) {
        const int k = g.row_edge[j];
        int v = zc + g.shift[k];
        v = v >= Z ? v - Z : v;
        const __nv_bfloat16* fk = F + static_cast<size_t>(k) * H * Z + v;
#pragma unroll
        for (int q = 0; q < H; ++q) x[q] = __fadd_rn(x[q], __bfloat162float(fk[q * Z]));
      }
      const float inv = b.inv_dr[r];
#pragma unroll
      for (int q = 0; q < H; ++q) x[q] = bf16r(__fmul_rn(x[q], inv));
      float* pr = b.pre_row + static_cast<size_t>(r) * H * Z + zc;
      matvec<H>(b.w + kWca * H * H, x, [&](int j, float s) { pr[j * Z] = s; });
    }
  }
  __syncthreads();  // the scratch writes above are visible to the whole block
  stage_weights<H>(a, b, t, kWvf);
  __syncthreads();

  // Phase 2: per message, the two MLPs and the residual, in place.
  const bool inject = a.inject;
  const bool residual = t >= 1;
  const float* b1 = a.tab + static_cast<size_t>(t) * 2 * K * H;
  __nv_bfloat16* st = b.stage + tid;
  for (int i = tid; i < K * Z; i += nt) {
    const int k = i / Z, z = i - k * Z;
    const int c = g.col[k];
    int zc = z - g.shift[k];
    zc = zc < 0 ? zc + Z : zc;
    const float* pc = b.pre_col + static_cast<size_t>(c) * H * Z + z;
    const float* lv = b.pre_llr_v + static_cast<size_t>(c) * H * Z + z;
    const float* lc = b.pre_llr_c + static_cast<size_t>(c) * H * Z + z;
    const float* pr = b.pre_row + static_cast<size_t>(g.row[k]) * H * Z + zc;
    const float* b1v = b1 + static_cast<size_t>(k) * H;
    const float* b1c = b1 + static_cast<size_t>(K + k) * H;
    __nv_bfloat16* fk = b.feats + static_cast<size_t>(k) * H * Z + z;
    float x[H];
#pragma unroll
    for (int q = 0; q < H; ++q) x[q] = __bfloat162float(fk[q * Z]);
    matvec<H>(b.w + (kWvf - kWvf) * H * H, x, [&](int j, float s) {
      float p = __fadd_rn(__fadd_rn(s, pc[j * Z]), b1v[j]);
      if (V == 7 && inject) p = __fadd_rn(p, lv[j * Z]);
      st[j * kThreads] = __float2bfloat16_rn(fmaxf(p, 0.0f));
    });
    matvec<H>(b.w + (kWcf - kWvf) * H * H, x, [&](int j, float s) {
      float p = __fadd_rn(__fadd_rn(s, pr[j * Z]), b1c[j]);
      if (inject) p = __fadd_rn(p, lc[j * Z]);
      st[(H + j) * kThreads] = __float2bfloat16_rn(fmaxf(p, 0.0f));
    });
    float y[H];
#pragma unroll
    for (int q = 0; q < H; ++q) {
      x[q] = __bfloat162float(st[q * kThreads]);
      y[q] = __bfloat162float(st[(H + q) * kThreads]);
    }
    const float* b2 = b.small;
    second_layer<H, V>(b.w + (kW2v - kWvf) * H * H, b.w + (kW2c - kWvf) * H * H, x, y,
                       [&](int j, float sv, float sc) {
                         float out;
                         if constexpr (V == 6)
                           out = bf16r(__fadd_rn(bf16r(__fadd_rn(sv, b2[j])),
                                                 bf16r(__fadd_rn(sc, b2[H + j]))));
                         else
                           out = bf16r(__fadd_rn(sv, b2[j]));
                         if (residual) out = bf16r(__fadd_rn(out, __bfloat162float(fk[j * Z])));
                         fk[j * Z] = __float2bfloat16_rn(out);
                       });
  }
  __syncthreads();
}

// The decode both kernels share: frames from the atomic counter, the seed,
// T layers of layer<H, V>, the output.
template <int H, int V>
__device__ __forceinline__ void decode_frames(const Args& a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_frame;
  float* smem = reinterpret_cast<float*>(smem_raw);
  const int Z = a.Z, R = a.R, C = a.C, K = a.K;
  const int n = C * Z;
  const int tid = threadIdx.x, nt = blockDim.x;
  const Layout L = make_layout(H, Z, R, C, K);

  int* s_graph = reinterpret_cast<int*>(smem + L.graph);
  for (int i = tid; i < 6 * K + R + C + 2; i += nt) s_graph[i] = a.graph[i];
  for (int i = tid; i < C + R; i += nt) smem[L.inv + i] = a.inv[i];
  for (int i = tid; i < 3 * H + 1; i += nt) smem[L.emb + i] = a.emb[i];

  Block<H> b;
  b.g.row_ptr = s_graph;
  b.g.row_edge = b.g.row_ptr + R + 1;
  b.g.col_ptr = b.g.row_edge + K;
  b.g.col_edge = b.g.col_ptr + C + 1;
  b.g.shift = b.g.col_edge + K;
  b.g.col = b.g.shift + K;
  b.g.row = b.g.col + K;
  b.inv_dc = smem + L.inv;
  b.inv_dr = b.inv_dc + C;
  b.llr = smem + L.llr;
  b.emb_w = smem + L.emb;
  b.emb_b = b.emb_w + H;
  b.proj_w = b.emb_b + H;
  b.small = smem + L.small;
  b.w = smem + L.w;
  b.stage = reinterpret_cast<__nv_bfloat16*>(smem + L.stage);
  const size_t zh = static_cast<size_t>(Z) * H;
  b.pre_col = a.scratch + static_cast<size_t>(blockIdx.x) *
                              scratch_floats(H, Z, R, C, K, a.inject);
  b.pre_row = b.pre_col + C * zh;
  b.pre_llr_v = b.pre_row + R * zh;
  b.pre_llr_c = b.pre_llr_v + C * zh;
  b.feats = reinterpret_cast<__nv_bfloat16*>(b.pre_row + (R + (a.inject ? 2 * C : 0)) * zh);
  b.Z = Z;
  b.R = R;
  b.C = C;
  b.K = K;
  const Graph& g = b.g;
  __syncthreads();
  b.proj_b = smem[L.emb + 3 * H];

  for (;;) {
    if (tid == 0) s_frame = atomicAdd(a.counter, 1);
    __syncthreads();
    const int f = s_frame;
    if (f >= a.B) break;
    const float* llr_f = a.llr + static_cast<size_t>(f) * n;
    float* soft_f = a.soft + static_cast<size_t>(f) * n;
    for (int i = tid; i < n; i += nt) b.llr[i] = llr_f[i];
    __syncthreads();

    // Seed: every message's features from its variable's LLR.
    for (int i = tid; i < K * H * Z; i += nt) {
      const int k = i / (H * Z), qz = i - k * H * Z, q = qz / Z, z = qz - q * Z;
      const float m = b.llr[g.col[k] * Z + z];
      b.feats[i] = __float2bfloat16_rn(__fadd_rn(__fmul_rn(m, b.emb_w[q]), b.emb_b[q]));
    }
    __syncthreads();

    for (int t = 0; t < a.T; ++t) layer<H, V>(a, b, t);

    // Output: projection, per-variable sum, sigmoid of the bit-1 logit.
    for (int i = tid; i < n; i += nt) {
      const int c = i / Z, z = i - c * Z;
      float acc = 0.0f;
      for (int j = g.col_ptr[c]; j < g.col_ptr[c + 1]; ++j) {
        const __nv_bfloat16* fk = b.feats + static_cast<size_t>(g.col_edge[j]) * H * Z + z;
        float contrib = 0.0f;
#pragma unroll
        for (int q = 0; q < H; ++q)
          contrib = __fadd_rn(contrib, __fmul_rn(__bfloat162float(fk[q * Z]), b.proj_w[q]));
        acc = __fadd_rn(__fadd_rn(acc, contrib), b.proj_b);
      }
      soft_f[i] = 1.0f / (1.0f + expf(__fadd_rn(b.llr[i], acc)));
    }
    __syncthreads();
  }
}

// B6, _kernel: the second layer's two halves rounded apart, added in bf16.
template <int H>
__global__ void __launch_bounds__(kThreads, 1) msg_gnn_kernel(const Args a) {
  decode_frames<H, 6>(a);
}

// B7, _kernel_v2: one float32 sum over both halves, rounded once.
template <int H>
__global__ void __launch_bounds__(kThreads, 1) msg_gnn_v2_kernel(const Args a) {
  decode_frames<H, 7>(a);
}

using KernelFn = void (*)(const Args);

KernelFn pick_kernel(int variant, int H) {
  if (variant == 6) {
    switch (H) {
      case 16: return msg_gnn_kernel<16>;
      case 64: return msg_gnn_kernel<64>;
    }
  } else if (variant == 7) {
    switch (H) {
      case 16: return msg_gnn_v2_kernel<16>;
      case 64: return msg_gnn_v2_kernel<64>;
    }
  }
  return nullptr;
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs.
long long ldpc_msg_gnn_smem_bytes(int H, int Z, int R, int C, int K) {
  return 4LL * make_layout(H, Z, R, C, K).total;
}

// Floats of global scratch one block needs.
long long ldpc_msg_gnn_scratch_floats(int H, int Z, int R, int C, int K, int inject) {
  return scratch_floats(H, Z, R, C, K, inject);
}

// Resident blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or
// -cudaError_t; -cudaErrorInvalidValue for an unsupported (variant, H).
int ldpc_msg_gnn_occupancy(int variant, int H, int Z, int R, int C, int K) {
  KernelFn kernel = pick_kernel(variant, H);
  if (kernel == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  const long long smem = ldpc_msg_gnn_smem_bytes(H, Z, R, C, K);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// Launches one of the two kernels on `stream` with `grid` blocks, no sync.
static int launch(int variant, int H, const void* llr, void* soft, void* counter, void* scratch,
                  const void* graph, const void* inv, const void* w, const void* tab,
                  const void* small, const void* emb, int B, int Z, int R, int C, int K, int T,
                  int inject, int grid, void* stream) {
  KernelFn kernel = pick_kernel(variant, H);
  if (kernel == nullptr || grid < 1 || B < 1 || T < 1) return cudaErrorInvalidValue;
  const long long smem = ldpc_msg_gnn_smem_bytes(H, Z, R, C, K);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  Args a;
  a.llr = static_cast<const float*>(llr);
  a.soft = static_cast<float*>(soft);
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
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

// The entry point of msg_gnn_kernel (_kernel).  `counter` must hold 0.
// Returns a cudaError_t (0 on success).
int ldpc_msg_gnn(int H, const void* llr, void* soft, void* counter, void* scratch,
                 const void* graph, const void* inv, const void* w, const void* tab,
                 const void* small, const void* emb, int B, int Z, int R, int C, int K, int T,
                 int inject, int grid, void* stream) {
  return launch(6, H, llr, soft, counter, scratch, graph, inv, w, tab, small, emb, B, Z, R, C, K,
                T, inject, grid, stream);
}

// The entry point of msg_gnn_v2_kernel (_kernel_v2), same arguments.
int ldpc_msg_gnn_v2(int H, const void* llr, void* soft, void* counter, void* scratch,
                    const void* graph, const void* inv, const void* w, const void* tab,
                    const void* small, const void* emb, int B, int Z, int R, int C, int K, int T,
                    int inject, int grid, void* stream) {
  return launch(7, H, llr, soft, counter, scratch, graph, inv, w, tab, small, emb, B, Z, R, C, K,
                T, inject, grid, stream);
}

const char* ldpc_msg_gnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
