// The check-relation aggregation stage of the message GNN, iterated L times,
// for Hopper (sm_90a): the probe of tools/probe_agg_mxu.py.
//
// Replaces the TPU kernel tools/probe_agg_mxu.py:48 `_kernel` (make_probe),
// both of its variants, entry point ldpc_probe_agg:
//   * variant 0, "vpu": each alignment by a circulant shift s is the index
//     (z + s) mod Z, on the CUDA cores (probe_vpu_kernel);
//   * variant 1, "mxu": each alignment is a product with the 0/1 rotation
//     matrix of the shift, bf16 in and float32 accumulate, on the tensor cores
//     through nvcuda::wmma 16x16x16 tiles (probe_mxu_kernel).
// Python wrapper and plain PyTorch version: ldpc_tpu_torch/tools/probe_agg_mxu.py.
//
// What it computes
// ----------------
// Features cur (frames, K, h, Z) bf16, one (h, Z) block per base edge k, lane
// z of edge k on variable z.  One iteration, per base row r with members k
// (in row order), inv = float32(1 / degree):
//   rowm[q][zc] = bf16((sum over members of cur[k][q][(zc + s_k) mod Z]) * inv)
//   cur[k][q][z] = rowm[q][(z - s_k) mod Z]
// The sum runs in float32 from 0 in member order, as the TPU kernel's does;
// the "mxu" variant adds each member's aligned block with one tensor-core
// product whose only non-zero term per output is the aligned value, so it
// equals "vpu" up to the tensor cores' float32 accumulation, which need not
// round as an IEEE addition does.
//
// What changed against the TPU kernel
// -----------------------------------
// No lane packing: every base edge belongs to exactly one base row, so the L
// iterations never mix rows, and a block owns one (frame, base row): it loads
// the members' features into shared memory once (at most 10 members x 64 x 32
// bf16, 40 KB, at nr_2_0_32 Z=32 h=64), iterates L times there and writes them
// back.  The TPU kernel walks every row of a tile of frames per iteration with
// the whole tile in VMEM.  For the tensor cores Z is padded to Zp, a multiple
// of 16, with zero lanes, and the rotation matrices are (Zp, Zp) blocks, one
// per shift (the TPU's are (128, 128) blocks over packed lanes).
//
// What bounds it on the card
// --------------------------
// Per frame and iteration the function needs E*h float32 additions and M*h
// multiplications (E = K*Z messages, M = R*Z checks); the features are read
// once and written once (2 * K*h*Z bf16 per frame).  At the probe's defaults
// (nr_2_0_32 Z=32 h=64, L=10, 128 frames) the bytes take 62 us at 3.35 TB/s
// and the operations 19 us at the float32 rate: the bound is the bytes.  The
// "mxu" variant does 2*h*Zp*Zp operations per member and product (align and
// roll back), 2.6e5 per member at Z=32, which at the dense bf16 rate add up to
// about 67 us for the same run; neither variant is designed to reach its bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 16;  // wmma m = n = k for bf16

struct Args {
  const __nv_bfloat16* in;   // (frames, K, H, Z)
  __nv_bfloat16* out;        // (frames, K, H, Z)
  const int* graph;          // row_ptr (R + 1), row_edge (K), shift (K)
  const float* inv;          // (R) float32(1 / degree)
  const __nv_bfloat16* rot;  // (Z, Zp, Zp): rot[u][v][w] = 1 iff v == (w + u) mod Z
  int K, R, H, Z, Zp, L;
};

// Bytes of dynamic shared memory: the members' features and the row mean,
// (max_deg + 1) * H * Zp bf16, then the tensor-core variant's per-warp
// float32 staging tile.
__host__ __device__ inline long long smem_bytes(int variant, int H, int Zp, int max_deg) {
  return 2LL * (max_deg + 1) * H * Zp + (variant == 1 ? 4LL * kWarps * kTile * kTile : 0);
}

// Loads the members of row r of frame f into cur[j][q][Zp] (zero pad lanes).
__device__ void load_members(const Args& a, __nv_bfloat16* cur, int f, int first, int deg) {
  const int HZp = a.H * a.Zp;
  for (int i = threadIdx.x; i < deg * HZp; i += blockDim.x) {
    const int j = i / HZp, rem = i - j * HZp, q = rem / a.Zp, z = rem - q * a.Zp;
    const int k = a.graph[a.R + 1 + first + j];
    cur[i] = z < a.Z ? a.in[((static_cast<size_t>(f) * a.K + k) * a.H + q) * a.Z + z]
                     : __float2bfloat16_rn(0.0f);
  }
}

__device__ void store_members(const Args& a, const __nv_bfloat16* cur, int f, int first,
                              int deg) {
  const int HZ = a.H * a.Z;
  for (int i = threadIdx.x; i < deg * HZ; i += blockDim.x) {
    const int j = i / HZ, rem = i - j * HZ, q = rem / a.Z, z = rem - q * a.Z;
    const int k = a.graph[a.R + 1 + first + j];
    a.out[((static_cast<size_t>(f) * a.K + k) * a.H + q) * a.Z + z] =
        cur[(j * a.H + q) * a.Zp + z];
  }
}

__global__ void __launch_bounds__(kThreads) probe_vpu_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int r = blockIdx.x, f = blockIdx.y;
  const int first = a.graph[r], deg = a.graph[r + 1] - first;
  const int* shift = a.graph + a.R + 1 + a.K;
  const int* edge = a.graph + a.R + 1 + first;
  const int H = a.H, Z = a.Z, Zp = a.Zp;
  __nv_bfloat16* cur = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* rowm = cur + static_cast<size_t>(deg) * H * Zp;
  const float inv = a.inv[r];
  load_members(a, cur, f, first, deg);
  __syncthreads();
  for (int it = 0; it < a.L; ++it) {
    for (int e = threadIdx.x; e < H * Z; e += blockDim.x) {
      const int q = e / Z, zc = e - q * Z;
      float acc = 0.0f;
      for (int j = 0; j < deg; ++j) {
        int v = zc + shift[edge[j]];
        v = v >= Z ? v - Z : v;
        acc = __fadd_rn(acc, __bfloat162float(cur[(j * H + q) * Zp + v]));
      }
      rowm[q * Zp + zc] = __float2bfloat16_rn(__fmul_rn(acc, inv));
    }
    __syncthreads();
    for (int e = threadIdx.x; e < deg * H * Z; e += blockDim.x) {
      const int j = e / (H * Z), rem = e - j * H * Z, q = rem / Z, z = rem - q * Z;
      int u = z - shift[edge[j]];
      u = u < 0 ? u + Z : u;
      cur[(j * H + q) * Zp + z] = rowm[q * Zp + u];
    }
    __syncthreads();
  }
  store_members(a, cur, f, first, deg);
}

__global__ void __launch_bounds__(kThreads) probe_mxu_kernel(const Args a) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int r = blockIdx.x, f = blockIdx.y;
  const int first = a.graph[r], deg = a.graph[r + 1] - first;
  const int* shift = a.graph + a.R + 1 + a.K;
  const int* edge = a.graph + a.R + 1 + first;
  const int H = a.H, Z = a.Z, Zp = a.Zp;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __nv_bfloat16* cur = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* rowm = cur + static_cast<size_t>(deg) * H * Zp;
  // The staging tiles follow this row's mean; deg <= max_deg keeps them
  // inside what smem_bytes allots.
  float* stage = reinterpret_cast<float*>(rowm + H * Zp) + warp * kTile * kTile;
  const float inv = a.inv[r];
  const int qt = H / kTile, zt = Zp / kTile, tiles = qt * zt;
  const size_t rot_block = static_cast<size_t>(Zp) * Zp;
  load_members(a, cur, f, first, deg);
  __syncthreads();
  for (int it = 0; it < a.L; ++it) {
    // rowm = bf16((sum over members of cur_j @ rot[s_j]) * inv), one output
    // tile per warp at a time.
    for (int tile = warp; tile < tiles; tile += kWarps) {
      const int q0 = (tile / zt) * kTile, z0 = (tile % zt) * kTile;
      wmma::fragment<wmma::accumulator, kTile, kTile, kTile, float> acc;
      wmma::fill_fragment(acc, 0.0f);
      for (int j = 0; j < deg; ++j) {
        const __nv_bfloat16* P = a.rot + shift[edge[j]] * rot_block;
        for (int kt = 0; kt < Zp; kt += kTile) {
          wmma::fragment<wmma::matrix_a, kTile, kTile, kTile, __nv_bfloat16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, kTile, kTile, kTile, __nv_bfloat16, wmma::row_major> fb;
          wmma::load_matrix_sync(fa, cur + (static_cast<size_t>(j) * H + q0) * Zp + kt, Zp);
          wmma::load_matrix_sync(fb, P + static_cast<size_t>(kt) * Zp + z0, Zp);
          wmma::mma_sync(acc, fa, fb, acc);
        }
      }
      wmma::store_matrix_sync(stage, acc, kTile, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < kTile * kTile; e += 32)
        rowm[(q0 + e / kTile) * Zp + z0 + e % kTile] =
            __float2bfloat16_rn(__fmul_rn(stage[e], inv));
      __syncwarp();
    }
    __syncthreads();
    // cur_j = rowm @ rot[(Z - s_j) mod Z]: the row mean rolled back.
    for (int task = warp; task < deg * tiles; task += kWarps) {
      const int j = task / tiles, tile = task - j * tiles;
      const int q0 = (tile / zt) * kTile, z0 = (tile % zt) * kTile;
      const int u = shift[edge[j]] == 0 ? 0 : Z - shift[edge[j]];
      const __nv_bfloat16* P = a.rot + u * rot_block;
      wmma::fragment<wmma::accumulator, kTile, kTile, kTile, float> acc;
      wmma::fill_fragment(acc, 0.0f);
      for (int kt = 0; kt < Zp; kt += kTile) {
        wmma::fragment<wmma::matrix_a, kTile, kTile, kTile, __nv_bfloat16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, kTile, kTile, kTile, __nv_bfloat16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, rowm + static_cast<size_t>(q0) * Zp + kt, Zp);
        wmma::load_matrix_sync(fb, P + static_cast<size_t>(kt) * Zp + z0, Zp);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(stage, acc, kTile, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < kTile * kTile; e += 32)
        cur[(static_cast<size_t>(j) * H + q0 + e / kTile) * Zp + z0 + e % kTile] =
            __float2bfloat16_rn(stage[e]);
      __syncwarp();
    }
    __syncthreads();
  }
  store_members(a, cur, f, first, deg);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block of `variant` (0 vpu, 1 mxu) needs.
long long ldpc_probe_smem_bytes(int variant, int H, int Zp, int max_deg) {
  return smem_bytes(variant, H, Zp, max_deg);
}

// Launches one block per (base row, frame) on `stream`, no sync.  Returns a
// cudaError_t (0 on success).
int ldpc_probe_agg(int variant, const void* in, void* out, const void* graph, const void* inv,
                   const void* rot, int frames, int K, int R, int H, int Z, int Zp, int max_deg,
                   int L, void* stream) {
  if ((variant != 0 && variant != 1) || frames < 1 || H % kTile || Zp % kTile || Zp < Z)
    return cudaErrorInvalidValue;
  void (*kernel)(const Args) = variant == 0 ? probe_vpu_kernel : probe_mxu_kernel;
  const long long smem = smem_bytes(variant, H, Zp, max_deg);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  Args a;
  a.in = static_cast<const __nv_bfloat16*>(in);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.graph = static_cast<const int*>(graph);
  a.inv = static_cast<const float*>(inv);
  a.rot = static_cast<const __nv_bfloat16*>(rot);
  a.K = K;
  a.R = R;
  a.H = H;
  a.Z = Z;
  a.Zp = Zp;
  a.L = L;
  kernel<<<dim3(R, frames), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

const char* ldpc_probe_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
