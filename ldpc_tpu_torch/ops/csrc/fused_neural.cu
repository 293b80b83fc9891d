// Fused trained neural / offset min-sum decoder for Hopper (sm_90a): the
// whole decode of a trained NeuralMinSumDecoder in one kernel launch.
//
// Replaces the TPU kernel of ldpc_tpu/ops/pallas_neural.py:
//   * neural_minsum_kernel<SHARED>  <- kernel  (make_fused_neural_minsum),
//                                      entry point ldpc_neural_minsum
// Python wrapper, weight packing (_pack_weights) and the plain PyTorch
// version: ldpc_tpu_torch/ops/fused_neural.py.  Built with -fmad=false: no
// a * b + c is contracted into an FMA, so w * llr and the residual taps round
// as the plain version rounds them, and the decisions are bit-identical.
//
// What it computes, per frame (the TPU kernel's order)
// ------------------------------------------------------
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
// What changed against the TPU kernel
// -----------------------------------
// No lane rolls: one thread owns one lifted check (check half) or one
// variable (variable half: its column sum, then each of its messages), and
// walks CSR structure arrays in shared memory; a roll by s is the index
// (z + s) mod Z.  LLRs are read as they come, (B, n) row-major.  The
// per-iteration channel weights (T * E floats, 252 KB at nr_2_0_32 Z=32
// T=10) stay in global memory, where L2 holds them for every block; alpha,
// offset and the taps go to shared memory.  The state of a frame (c2v, q and
// max(L, 1) - 1 more FIFO slots: (1 + max(L, 1)) * E floats, 75 KB at Z=32
// L=2, plus its LLRs) stays in shared memory, `fpb` frames a block
// (SHARED = true).  Where one frame's state does not fit (above Z of about
// 100 at L=2) it lives in a global scratch slice per block, reused frame
// after frame, and only the LLRs stay in shared memory (SHARED = false).
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
// arithmetic.  This source does more per edge than the decode needs: the
// second check pass recomputes |x| and sign(x), applies the offset, clamp,
// sentinel and alpha per edge, and the variable half re-reads every state
// word from shared memory; index arithmetic and structure reads come on top.
//
// What the design does about it: all per-iteration state of a frame stays on
// chip, so device memory sees each LLR read once and each bit written once;
// the lanes of one base row (check half) or one base column (variable half)
// are consecutive threads, so at Z=32 a warp runs one row or one column
// without divergence and its shared-memory accesses are conflict-free.
// What it does not yet do: balance the warps (a warp owns whole rows or
// columns, whose degrees run from 1 to 23 on NR BG2), or keep fewer state
// words than c2v, q and the FIFO (depth 2 takes 1.84x the time of depth 0).

#include <cuda_runtime.h>

namespace {

constexpr float kBig = 1e9f;  // stand-in for +inf, as _BIG in the JAX package
constexpr int kMaxFramesPerBlock = 32;
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

const char* ldpc_neural_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
