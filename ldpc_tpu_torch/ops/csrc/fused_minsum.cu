// Fused LDPC decoders for Hopper (sm_90a): the whole min-sum / sum-product
// decode loop of a frame in one kernel launch.
//
// Replaces the TPU kernels of ldpc_tpu/ops/pallas_minsum.py:
//   * fused_minsum_kernel  <- _kernel        (make_fused_minsum, make_fused_bp)
//   * zlane_minsum_kernel  <- _kernel_zlane  (make_fused_minsum_zlane)
// Every mode and schedule on the codes fused_retire.cu takes left them for
// that file's kernels: the wrapper sends min-sum flooding to
// retire_minsum_kernel (the main path), layered min-sum to
// retire_layered_kernel, sum-product flooding to retire_sumproduct_kernel,
// layered sum-product to retire_layered_sumproduct_kernel (rows of up to 27
// members on their 32-bit state word, 28 to 58 on their 64-bit word, 59 to
// 121 on their 128-bit word) and,
// at large Z and rows of up to 121 members (the same three words), min-sum
// flooding to retire_zlane_kernel (bench.py's z384 section), layered
// min-sum to retire_zlane_layered_kernel, sum-product flooding to
// retire_zlane_sumproduct_kernel and layered sum-product to
// retire_zlane_layered_sumproduct_kernel.  So fused_minsum_kernel and
// zlane_minsum_kernel serve rows of more than 121 members alone (no
// standard code has such rows; and both stay callable
// for the paths they served before, so the wrapper's _launch_fused and
// _launch_zlane can time them beside the kernels that replaced them).  The
// note below is this file's.
// Python wrappers, and the plain PyTorch version both kernels are held
// against: ldpc_tpu_torch/ops/fused_minsum.py.
//
// What the TPU kernels compute, and what changed in the port
// ----------------------------------------------------------
// Messages are var-aligned per base edge k: c2v[k*Z + v] belongs to the edge
// of variable (col[k], v).  Lifted check (r, z) reaches, through member k of
// base row r, the lane v = (z + shift[k]) mod Z.  The TPU kernels rolled
// (Z, batch) blocks by shift[k] and unrolled the base-graph loops at trace
// time; here one thread owns one lifted check, computes the index
// (z + shift[k]) mod Z, and walks CSR structure arrays (row members, column
// members, shifts, columns) that each block copies into shared memory.  LLRs
// are read as they come, (B, n) row-major: a frame is contiguous, so the
// TPU's batch-in-lanes transpose has no counterpart.
//
// Per iteration (flooding): every lifted check computes v2c = belief - c2v
// for its members, a running (min, 2nd min, sign product) and the
// leave-one-out output (min-sum: alpha * sign * (|x| > m1 ? m1 : m2), with
// m1 == m2 at a tie; sum-product: phi-domain sums, phi(x) = -log(tanh(x/2)
// + 1e-30), |x| clipped to [1e-7, 20]); then every variable's belief is
// llr + the sum of its c2v in col_members order; then hard bits, the
// syndrome (a block-wide OR of odd row parities per frame), first-valid
// freezing and conv_iter.  Layered: base rows in order, the Z checks of a row
// in parallel (they touch disjoint variables), each folding its new c2v into
// the beliefs at once; no column-sum pass.  The frozen bits of a frame are
// written straight to the output the iteration it converges, so no frozen
// buffer is kept; frames that never converge get their final decisions at
// the end.  Arithmetic order follows the TPU kernels exactly (sign(0) = +1,
// the 1e9 sentinel, (belief + new) - old), so min-sum is bit-identical to
// the plain version.  Built without fast-math.
//
// What bounds it on the card
// --------------------------
// The operations the decode itself needs per iteration of one frame
// (min-sum, flooding, convergence tracked), whatever this source does:
//   per lifted edge:   sub (v2c), abs, sign-product fold, min (m1), max and
//                      min (m2), leave-one-out select, sign apply, column-sum
//                      add = 9 float32; parity xor = 1 int32;
//   per lifted check:  alpha * m1, alpha * m2, two sentinel selects = 4
//                      float32; syndrome OR = 1 int32;
//   per variable:      llr + column sum, hard decision = 2 float32.
// None of these is an FMA, so float32 runs at half the data sheet's 67
// TFLOP/s (which counts an FMA as two): 33.5e12 per second; int32 has half
// the float32 lanes: 16.75e12 per second.  A frame needs conv_iter
// iterations: later ones change neither its frozen bits nor conv_iter.
// Main path (NR BG2 Z=32: E=6304, R*Z=1344, n=1664; B=65536, mean
// conv_iter 3.01): 65440 float32 + 7648 int32 operations per frame and
// iteration, 0.48 ms, against 0.87 GB of LLRs and bits at 3.35 TB/s (0.26
// ms): the bound is arithmetic.  At a fixed 20 iterations it would be 3.2 ms.
// Sum-product (flooding, tracked), per lifted edge: sub (v2c), abs, clamp
// (max, min), phi of |v2c| (halve, + 1e-30, negate: 3 float32; tanh and
// log: 2 special-function operations), phi-sum add, sign-product fold,
// leave-one-out subtract and clamp, phi of it (3 + 2), sign apply,
// column-sum add = 16 float32 and 4 special-function operations, parity
// xor = 1 int32; per lifted check the syndrome OR (1 int32); per variable
// llr + column sum and the hard decision (2 float32).  The special-function
// units do 16 operations an SM and clock against 128 float32 lanes:
// 4.19e12 per second.  chip_smoke.py (bp_bound_ms) adds the three times.
// Layered sum-product (retire_layered_sumproduct_kernel's path, which this
// file's kernels served until it took it), per lifted edge: the flooding count less the
// column-sum add, plus the fold of the new c2v into the belief, (belief +
// new) - old, two adds = 17 float32 and 4 special-function operations,
// parity xor = 1 int32; per lifted check the syndrome OR (1 int32); per
// variable the hard decision alone (1 float32), as layered min-sum counts
// it (chip_smoke.py OPS_PER_EDGE_SUMPRODUCT_LAYERED, bp_bound_ms(...,
// layered=True)).
// This source does more per edge than the decode needs (about 20
// operations): pass 2 recomputes pass 1's sub, abs and sign, it multiplies
// by alpha and the sign product per edge, and it applies the sentinel per
// edge; index arithmetic and structure reads come on top.
//
// What the design does about it: all per-iteration state of a frame stays
// on chip (shared memory), so device memory sees each LLR read once and each
// bit written once; the lanes of one base row are consecutive threads, so
// a warp runs one row without divergence at Z=32 and its shared-memory
// accesses (z + shift) mod Z are conflict-free.  What it does not yet do
// (later work): keep v2c in registers between the two passes instead of
// reading shared memory again, compress c2v to (m1, m2, argmin, signs) per
// check, and overlap the next frame's LLR load with the decode.
//
// fused_minsum_kernel keeps c2v, beliefs and LLRs of `fpb` frames in shared
// memory: (K*Z + 2*C*Z) * 4 bytes a frame, 38.5 KB at Z=32.  At Z=384 that
// is 462 KB, over the 227 KB one block can use, so zlane_minsum_kernel keeps
// c2v (K*Z*4 = 303 KB a frame) in a global scratch buffer (one slice per
// block, reused frame after frame), only the beliefs (80 KB) in shared
// memory, and reads LLRs from global memory in the column-sum pass.  Both
// kernels share the device functions below.

#include <cuda_runtime.h>

namespace {

constexpr float kBig = 1e9f;  // stand-in for +inf, as _BIG in the JAX package
constexpr int kMaxFramesPerBlock = 32;
constexpr int kFusedThreads = 256;
constexpr int kZlaneThreads = 512;

struct Graph {
  const int* row_ptr;   // (R+1) offsets into row_edge
  const int* row_edge;  // (K) base edges of each row, in row order
  const int* col_ptr;   // (C+1) offsets into col_edge
  const int* col_edge;  // (K) base edges of each column, in col_members order
  const int* shift;     // (K) circulant shift mod Z
  const int* col;       // (K) base column
  int Z, R, C, K;
};

__host__ __device__ inline int graph_words(int R, int C, int K) {
  return (4 * K + R + C + 2 + 3) / 4 * 4;
}

// Copies the structure into shared memory; the caller synchronises.
__device__ Graph load_graph(int* s, const int* __restrict__ g, int Z, int R, int C, int K) {
  const int total = 4 * K + R + C + 2;
  for (int i = threadIdx.x; i < total; i += blockDim.x) s[i] = g[i];
  Graph out;
  out.row_ptr = s;
  out.row_edge = out.row_ptr + R + 1;
  out.col_ptr = out.row_edge + K;
  out.col_edge = out.col_ptr + C + 1;
  out.shift = out.col_edge + K;
  out.col = out.shift + K;
  out.Z = Z;
  out.R = R;
  out.C = C;
  out.K = K;
  return out;
}

__device__ __forceinline__ float sign_of(float x) { return x < 0.0f ? -1.0f : 1.0f; }

__device__ __forceinline__ float phi(float x) { return -logf(tanhf(x / 2.0f) + 1e-30f); }

__device__ __forceinline__ int lane_of(const Graph& g, int k, int z) {
  const int v = z + g.shift[k];
  return v >= g.Z ? v - g.Z : v;
}

// Check update of lifted check (r, z) of one frame: bel (C*Z), c2v (K*Z).
template <bool SUMPRODUCT, bool LAYERED>
__device__ void check_update(const Graph& g, float* bel, float* c2v, int r, int z, float alpha) {
  const int j0 = g.row_ptr[r], j1 = g.row_ptr[r + 1];
  float sp = 1.0f;
  if (!SUMPRODUCT) {
    float m1 = kBig, m2 = kBig;
    for (int j = j0; j < j1; ++j) {
      const int k = g.row_edge[j];
      const int v = lane_of(g, k, z);
      const float x = bel[g.col[k] * g.Z + v] - c2v[k * g.Z + v];
      const float mag = fabsf(x);
      sp = sp * sign_of(x);
      const float new_min = fminf(mag, m1);
      m2 = fminf(fmaxf(mag, m1), m2);
      m1 = new_min;
    }
    for (int j = j0; j < j1; ++j) {
      const int k = g.row_edge[j];
      const int v = lane_of(g, k, z);
      const int b = g.col[k] * g.Z + v, e = k * g.Z + v;
      const float x = bel[b] - c2v[e];
      const float mag = fabsf(x);
      float loo = mag > m1 ? m1 : m2;
      loo = loo < kBig ? loo : 0.0f;
      const float out = alpha * sp * sign_of(x) * loo;
      if (LAYERED) bel[b] = bel[b] + out - c2v[e];
      c2v[e] = out;
    }
  } else {
    float phi_sum = 0.0f;
    for (int j = j0; j < j1; ++j) {
      const int k = g.row_edge[j];
      const int v = lane_of(g, k, z);
      const float x = bel[g.col[k] * g.Z + v] - c2v[k * g.Z + v];
      phi_sum = phi_sum + phi(fminf(fmaxf(fabsf(x), 1e-7f), 20.0f));
      sp = sp * sign_of(x);
    }
    for (int j = j0; j < j1; ++j) {
      const int k = g.row_edge[j];
      const int v = lane_of(g, k, z);
      const int b = g.col[k] * g.Z + v, e = k * g.Z + v;
      const float x = bel[b] - c2v[e];
      const float ph = phi(fminf(fmaxf(fabsf(x), 1e-7f), 20.0f));
      const float loo = fmaxf(phi_sum - ph, 1e-7f);
      const float out = sp * sign_of(x) * phi(loo);
      if (LAYERED) bel[b] = bel[b] + out - c2v[e];
      c2v[e] = out;
    }
  }
}

// Sum of the c2v messages of variable (c, z), in col_members order.
__device__ __forceinline__ float column_sum(const Graph& g, const float* c2v, int c, int z) {
  float cs = 0.0f;
  for (int j = g.col_ptr[c]; j < g.col_ptr[c + 1]; ++j) cs = cs + c2v[g.col_edge[j] * g.Z + z];
  return cs;
}

// Parity of lifted check (r, z) over the hard decisions of one frame.
__device__ __forceinline__ int check_parity(const Graph& g, const float* bel, int r, int z) {
  int p = 0;
  for (int j = g.row_ptr[r]; j < g.row_ptr[r + 1]; ++j) {
    const int k = g.row_edge[j];
    p ^= bel[g.col[k] * g.Z + lane_of(g, k, z)] < 0.0f;
  }
  return p;
}

// Decodes nf frames with the whole block.  llr, c2v and bel hold the frames
// one after another (n, K*Z and n floats a frame); bits and conv_out are the
// frames' rows of the outputs.  Ends with a barrier.
template <bool SUMPRODUCT, bool LAYERED>
__device__ void decode_tile(const Graph& g, const float* llr, float* c2v, float* bel,
                            float* __restrict__ bits, int* __restrict__ conv_out, int nf,
                            int max_iterations, float alpha, bool track, bool early_exit,
                            int* s_conv, int* s_newly, int* s_viol) {
  const int Z = g.Z, n = g.C * Z, E = g.K * Z, RZ = g.R * Z;
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < nf * E; i += nt) c2v[i] = 0.0f;
  for (int i = tid; i < nf * n; i += nt) bel[i] = llr[i];
  for (int f = tid; f < nf; f += nt) {
    s_conv[f] = 0;
    s_viol[f] = 0;
  }
  __syncthreads();

  for (int t = 0; t < max_iterations; ++t) {
    if (LAYERED) {
      for (int r = 0; r < g.R; ++r) {
        for (int i = tid; i < nf * Z; i += nt) {
          const int f = i / Z, z = i - f * Z;
          check_update<SUMPRODUCT, true>(g, bel + f * n, c2v + f * E, r, z, alpha);
        }
        __syncthreads();
      }
    } else {
      for (int i = tid; i < nf * RZ; i += nt) {
        const int f = i / RZ, rz = i - f * RZ, r = rz / Z;
        check_update<SUMPRODUCT, false>(g, bel + f * n, c2v + f * E, r, rz - r * Z, alpha);
      }
      __syncthreads();
      for (int i = tid; i < nf * n; i += nt) {
        const int f = i / n, v = i - f * n, c = v / Z;
        bel[i] = llr[i] + column_sum(g, c2v + f * E, c, v - c * Z);
      }
      __syncthreads();
    }
    if (!track) continue;

    for (int i = tid; i < nf * RZ; i += nt) {
      const int f = i / RZ, rz = i - f * RZ, r = rz / Z;
      if (check_parity(g, bel + f * n, r, rz - r * Z)) s_viol[f] = 1;
    }
    __syncthreads();
    for (int f = tid; f < nf; f += nt) {
      const int newly = !s_viol[f] && s_conv[f] == 0;
      s_newly[f] = newly;
      if (newly) s_conv[f] = t + 1;
      s_viol[f] = 0;
    }
    const int all_done = __syncthreads_and(tid < nf ? s_conv[tid] > 0 : 1);
    for (int i = tid; i < nf * n; i += nt) {
      if (s_newly[i / n]) bits[i] = bel[i] < 0.0f ? 1.0f : 0.0f;
    }
    __syncthreads();
    if (early_exit && all_done) break;
  }

  for (int i = tid; i < nf * n; i += nt) {
    if (s_conv[i / n] == 0) bits[i] = bel[i] < 0.0f ? 1.0f : 0.0f;
  }
  for (int f = tid; f < nf; f += nt) conv_out[f] = s_conv[f] > 0 ? s_conv[f] : max_iterations;
  __syncthreads();
}

template <bool SUMPRODUCT, bool LAYERED>
__global__ void __launch_bounds__(kFusedThreads)
fused_minsum_kernel(const float* __restrict__ llr, float* __restrict__ bits,
                    int* __restrict__ conv, const int* __restrict__ graph, int B, int Z,
                    int R, int C, int K, int max_iterations, float alpha, int track,
                    int early_exit, int fpb) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_conv[kMaxFramesPerBlock], s_newly[kMaxFramesPerBlock],
      s_viol[kMaxFramesPerBlock];
  int* s_graph = reinterpret_cast<int*>(smem);
  const Graph g = load_graph(s_graph, graph, Z, R, C, K);
  const int n = C * Z, E = K * Z;
  float* s_c2v = reinterpret_cast<float*>(s_graph + graph_words(R, C, K));
  float* s_bel = s_c2v + fpb * E;
  float* s_llr = s_bel + fpb * n;

  const int f0 = blockIdx.x * fpb;
  const int nf = min(fpb, B - f0);
  const float* llr_tile = llr + static_cast<size_t>(f0) * n;
  for (int i = threadIdx.x; i < nf * n; i += blockDim.x) s_llr[i] = llr_tile[i];
  __syncthreads();
  decode_tile<SUMPRODUCT, LAYERED>(g, s_llr, s_c2v, s_bel, bits + static_cast<size_t>(f0) * n,
                                   conv + f0, nf, max_iterations, alpha, track, early_exit,
                                   s_conv, s_newly, s_viol);
}

template <bool SUMPRODUCT, bool LAYERED>
__global__ void __launch_bounds__(kZlaneThreads)
zlane_minsum_kernel(const float* __restrict__ llr, float* __restrict__ bits,
                    int* __restrict__ conv, float* __restrict__ c2v_scratch,
                    const int* __restrict__ graph, int B, int Z, int R, int C, int K,
                    int max_iterations, float alpha, int track, int early_exit) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_conv[1], s_newly[1], s_viol[1];
  int* s_graph = reinterpret_cast<int*>(smem);
  const Graph g = load_graph(s_graph, graph, Z, R, C, K);
  const int n = C * Z;
  float* s_bel = reinterpret_cast<float*>(s_graph + graph_words(R, C, K));
  float* c2v = c2v_scratch + static_cast<size_t>(blockIdx.x) * K * Z;
  __syncthreads();
  for (int f = blockIdx.x; f < B; f += gridDim.x) {
    const size_t off = static_cast<size_t>(f) * n;
    decode_tile<SUMPRODUCT, LAYERED>(g, llr + off, c2v, s_bel, bits + off, conv + f, 1,
                                     max_iterations, alpha, track, early_exit, s_conv,
                                     s_newly, s_viol);
  }
}

long long fused_smem(int Z, int R, int C, int K, int fpb) {
  return 4LL * (graph_words(R, C, K) + static_cast<long long>(fpb) * (K * Z + 2 * C * Z));
}

long long zlane_smem(int Z, int R, int C, int K) {
  return 4LL * (graph_words(R, C, K) + static_cast<long long>(C) * Z);
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, long long smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <bool SUMPRODUCT, bool LAYERED>
cudaError_t launch_fused(const float* llr, float* bits, int* conv, const int* graph, int B,
                         int Z, int R, int C, int K, int T, float alpha, int track,
                         int early_exit, int fpb, cudaStream_t stream) {
  const long long smem = fused_smem(Z, R, C, K, fpb);
  auto kernel = fused_minsum_kernel<SUMPRODUCT, LAYERED>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const int grid = (B + fpb - 1) / fpb;
  kernel<<<grid, kFusedThreads, smem, stream>>>(llr, bits, conv, graph, B, Z, R, C, K, T,
                                                alpha, track, early_exit, fpb);
  return cudaGetLastError();
}

template <bool SUMPRODUCT, bool LAYERED>
cudaError_t launch_zlane(const float* llr, float* bits, int* conv, float* scratch,
                         const int* graph, int B, int Z, int R, int C, int K, int T,
                         float alpha, int track, int early_exit, int grid,
                         cudaStream_t stream) {
  const long long smem = zlane_smem(Z, R, C, K);
  auto kernel = zlane_minsum_kernel<SUMPRODUCT, LAYERED>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kZlaneThreads, smem, stream>>>(llr, bits, conv, scratch, graph, B, Z, R, C,
                                                K, T, alpha, track, early_exit);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success).  Launches on `stream`, no sync.
int ldpc_fused_minsum(const void* llr, void* bits, void* conv, const void* graph, int B, int Z,
                      int R, int C, int K, int T, float alpha, int sumproduct, int layered,
                      int track, int early_exit, int fpb, void* stream) {
  if (fpb < 1 || fpb > kMaxFramesPerBlock || B < 1) return cudaErrorInvalidValue;
  decltype(&launch_fused<false, false>) f =
      sumproduct ? (layered ? &launch_fused<true, true> : &launch_fused<true, false>)
                 : (layered ? &launch_fused<false, true> : &launch_fused<false, false>);
  return f(static_cast<const float*>(llr), static_cast<float*>(bits), static_cast<int*>(conv),
           static_cast<const int*>(graph), B, Z, R, C, K, T, alpha, track, early_exit, fpb,
           static_cast<cudaStream_t>(stream));
}

int ldpc_fused_zlane(const void* llr, void* bits, void* conv, void* c2v_scratch,
                     const void* graph, int B, int Z, int R, int C, int K, int T, float alpha,
                     int sumproduct, int layered, int track, int early_exit, int grid,
                     void* stream) {
  if (grid < 1 || B < 1) return cudaErrorInvalidValue;
  decltype(&launch_zlane<false, false>) f =
      sumproduct ? (layered ? &launch_zlane<true, true> : &launch_zlane<true, false>)
                 : (layered ? &launch_zlane<false, true> : &launch_zlane<false, false>);
  return f(static_cast<const float*>(llr), static_cast<float*>(bits), static_cast<int*>(conv),
           static_cast<float*>(c2v_scratch), static_cast<const int*>(graph), B, Z, R, C, K, T,
           alpha, track, early_exit, grid, static_cast<cudaStream_t>(stream));
}

long long ldpc_fused_smem_bytes(int Z, int R, int C, int K, int fpb) {
  return fused_smem(Z, R, C, K, fpb);
}

long long ldpc_zlane_smem_bytes(int Z, int R, int C, int K) { return zlane_smem(Z, R, C, K); }

// Resident blocks per SM of the kernel a launch with these arguments uses
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or -cudaError_t.
int ldpc_fused_occupancy(int Z, int R, int C, int K, int fpb, int sumproduct, int layered) {
  auto kernel = sumproduct ? (layered ? &fused_minsum_kernel<true, true>
                                      : &fused_minsum_kernel<true, false>)
                           : (layered ? &fused_minsum_kernel<false, true>
                                      : &fused_minsum_kernel<false, false>);
  const long long smem = fused_smem(Z, R, C, K, fpb);
  int blocks = 0;
  cudaError_t err = prepare(kernel, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kFusedThreads, smem);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

int ldpc_zlane_occupancy(int Z, int R, int C, int K, int sumproduct, int layered) {
  auto kernel = sumproduct ? (layered ? &zlane_minsum_kernel<true, true>
                                      : &zlane_minsum_kernel<true, false>)
                           : (layered ? &zlane_minsum_kernel<false, true>
                                      : &zlane_minsum_kernel<false, false>);
  const long long smem = zlane_smem(Z, R, C, K);
  int blocks = 0;
  cudaError_t err = prepare(kernel, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kZlaneThreads, smem);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

const char* ldpc_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
