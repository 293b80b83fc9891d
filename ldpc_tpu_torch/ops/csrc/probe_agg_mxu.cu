// The check-relation aggregation stage of the message GNN, iterated L times,
// for Hopper (sm_90a): the probe of tools/probe_agg_mxu.py.
//
// Replaces the TPU kernel tools/probe_agg_mxu.py:48 `_kernel` (make_probe),
// both of its variants, entry point ldpc_probe_agg:
//   * variant 0, "vpu": each alignment by a circulant shift s is the index
//     (z + s) mod Z, on the CUDA cores: a warp shuffle where Z <= 32
//     (probe_vpu_kernel), a shared-memory read above (probe_vpu_smem_kernel);
//   * variant 1, "mxu": each alignment is a product with the 0/1 rotation
//     matrix of the shift, bf16 in and float32 accumulate, on the tensor cores
//     through mma.sync m16n8k16 (probe_mxu_kernel).
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
// the "mxu" variant adds each member's aligned block with tensor-core
// products whose only non-zero term per output is the aligned value, so it
// equals "vpu" up to the tensor cores' float32 accumulation, which need not
// round as an IEEE addition does (and equals it where every sum is exact,
// as on integer-valued features).
//
// What bounds it on the card
// --------------------------
// Per frame and iteration the function needs E*h float32 additions and M*h
// multiplications (E = K*Z messages, M = R*Z checks); the features are read
// once and written once (2 * K*h*Z bf16 per frame).  At the probe's defaults
// (nr_2_0_32 Z=32 h=64, L=10, 128 frames) the bytes take 62 us at 3.35 TB/s
// and the operations 19 us at the float32 rate: the bound is the bytes.  The
// designs below move each element through the SM's exchange path instead:
// "vpu" two warp shuffles per member, lane and iteration (align and roll
// back), 1.03e9 lane shuffles at the defaults, about 0.12 ms at one warp
// shuffle a clock per SM (132 SMs, 1.98 GHz); "mxu" 2*h*Zp*Zp tensor-core
// operations per member and product, 6.6e10 at the defaults, about 67 us at
// the dense bf16 rate, which mma.sync does not reach.
//
// What the design does about it
// -----------------------------
// Every base edge belongs to exactly one base row, and the function never
// mixes hidden units, so (frame, base row, hidden unit) is a task of its
// own for all L iterations.  A warp takes tasks and runs them to the end
// with no block barrier:
// 0. The graph holds the shifts in row order beside the edges, so a warp's
//    two index loads do not depend on each other.
// 1. vpu, Z <= 32 (probe_vpu_kernel): a warp segment of Z lanes owns one
//    hidden unit's Z lanes of a row (32 / Z segments a warp, consecutive
//    hidden units, so a member's loads are one contiguous run); each
//    member's value sits in a register of its lane, the alignment and the
//    roll-back are __shfl_sync from lanes base + (z +- s) mod Z of the
//    segment, formed once (the lane index is formed in the segment, not by
//    the shuffle's width, which must be a power of two), and the row sum
//    runs in float32 in member order.  Every loop over a row's members is
//    unrolled: a warp switches once on its row's degree d (uniform in the
//    warp) into a body specialised for d (the kernel, templated on MAXD,
//    the smallest of 8, 12, 24 that holds the code's widest row, takes d =
//    1..MAXD), so the values, shifts and lanes sit in registers and no
//    member is predicated off; one body for all degrees, predicated, took
//    128 registers and 8.5x the time.
// 2. vpu, Z > 32 (probe_vpu_smem_kernel): a warp owns one hidden unit of a
//    row; its members' lanes and the row mean sit in the warp's slice of
//    shared memory (float), lane z handles z, z + 32, ...: (q, z) fixed for
//    all L iterations, __syncwarp between the passes; run-time member loops.
// 3. mxu (probe_mxu_kernel): a warp owns 16 hidden units of a row; its
//    members' (16, Zp) blocks (Zp: Z rounded up to 32) and the row mean sit
//    in the warp's slice of shared memory (rows padded by 8 bf16, so
//    ldmatrix's eight rows fall in distinct banks) beside the row's shifts;
//    A fragments come by ldmatrix, the 0/1 rotation
//    fragment B is built in registers from the shift and the thread's (k, n)
//    coordinates (P[s][v][w] = 1 iff v == (w + s) mod Z), so no rotation
//    tensor is read; the d members of an output tile are summed in one
//    float32 fragment, and the bf16 row mean is rounded straight from it; the
//    roll-back is a product made the same way, u = (Z - s) mod Z.  Output
//    tiles go in groups of four adjacent ones, so each ldmatrix feeds four
//    independent mma chains.  Its member loops run at run time: bodies
//    specialised for each degree made 5-10x the instructions, and the
//    kernel ran slower than this one (and took 122 s of ptxas).
// The index of a task is split once per warp; no loop over elements divides.
// Rows may have at most kMaxDeg (24) members.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;          // probe_vpu_kernel, probe_vpu_smem_kernel
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDeg = 24;            // members a row may have
constexpr int kTileRows = 16;          // hidden units of an mxu task (mma m)
constexpr int kPad = 8;                // bf16 a row of the mxu slices is padded by
constexpr int kGroup = 4;              // 8-column mxu output tiles done together
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const __nv_bfloat16* in;   // (frames, K, H, Z)
  __nv_bfloat16* out;        // (frames, K, H, Z)
  const int* graph;          // row_ptr (R + 1), row_edge (K), row_shift (K): row order
  const float* inv;          // (R) float32(1 / degree)
  int K, R, H, Z, L, max_deg;
  int segs;                  // hidden units a warp takes (vpu: 32 / Z where Z <= 32, else 1;
                             // mxu: 16)
  int groups;                // tasks a row: ceil(H / segs)
  long long tasks;           // frames * R * groups
};

// (z + s) mod Z for 0 <= z, s < Z.
__device__ __forceinline__ int rolled(int z, int s, int Z) {
  const int v = z + s;
  return v >= Z ? v - Z : v;
}

// The shift that rolls a block back: (Z - s) mod Z.
__device__ __forceinline__ int back(int s, int Z) { return s == 0 ? 0 : Z - s; }

// A warp's task: (frame, row, group), split once, and its row's members.
struct Task {
  int f, r, g, first, deg;
  float inv;
};
__device__ __forceinline__ Task task_of(const Args& a, long long t) {
  Task k;
  const long long fr = t / a.groups;
  k.g = static_cast<int>(t - fr * a.groups);
  k.f = static_cast<int>(fr / a.R);
  k.r = static_cast<int>(fr - static_cast<long long>(k.f) * a.R);
  k.first = a.graph[k.r];
  k.deg = a.graph[k.r + 1] - k.first;
  k.inv = a.inv[k.r];
  return k;
}

// Member j's edge and shift.
__device__ __forceinline__ int edge_of(const Args& a, const Task& k, int j) {
  return a.graph[a.R + 1 + k.first + j];
}
__device__ __forceinline__ int shift_of(const Args& a, const Task& k, int j) {
  return a.graph[a.R + 1 + a.K + k.first + j];
}

__device__ __forceinline__ size_t feature(const Args& a, int f, int k, int q) {
  return ((static_cast<size_t>(f) * a.K + k) * a.H + q) * a.Z;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Calls body.run<D>() for D = the task's degree (1 .. MAXD).
template <int MAXD, int D = 1, typename Body>
__device__ __forceinline__ void for_degree(int deg, Body& body) {
  if constexpr (D <= MAXD) {
    if (deg == D)
      body.template run<D>();
    else
      for_degree<MAXD, D + 1>(deg, body);
  }
}

// vpu, Z <= 32: a row's D members in registers, alignment and roll-back by
// shuffles.
struct VpuRegs {
  const Args& a;
  const Task& k;
  int lane;
  template <int D>
  __device__ __forceinline__ void run() {
    const int Z = a.Z;
    const int seg = lane / Z, z = lane - seg * Z, base = seg * Z;  // once a thread
    const int q = k.g * a.segs + seg;
    const bool active = seg < a.segs && q < a.H;
    int up[D], down[D];
    float x[D];
#pragma unroll
    for (int j = 0; j < D; ++j) {
      const int s = shift_of(a, k, j);
      up[j] = base + rolled(z, s, Z);
      down[j] = base + rolled(z, back(s, Z), Z);
      x[j] = active ? __bfloat162float(a.in[feature(a, k.f, edge_of(a, k, j), q) + z]) : 0.0f;
    }
    for (int it = 0; it < a.L; ++it) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < D; ++j) acc = __fadd_rn(acc, __shfl_sync(kFull, x[j], up[j]));
      const float m = bf16_round(__fmul_rn(acc, k.inv));
#pragma unroll
      for (int j = 0; j < D; ++j) x[j] = __shfl_sync(kFull, m, down[j]);
    }
    if (active) {
#pragma unroll
      for (int j = 0; j < D; ++j)
        a.out[feature(a, k.f, edge_of(a, k, j), q) + z] = __float2bfloat16_rn(x[j]);
    }
  }
};

template <int MAXD>
__global__ void __launch_bounds__(kThreads) probe_vpu_kernel(const Args a) {
  const long long t = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (t >= a.tasks) return;  // whole warps
  const Task k = task_of(a, t);
  VpuRegs body{a, k, static_cast<int>(threadIdx.x & 31)};
  for_degree<MAXD>(k.deg, body);
}

// vpu, Z > 32: one hidden unit a warp, its members (D * Z floats) and row
// mean (Z) in the warp's slice of shared memory; one body for every degree.
__global__ void __launch_bounds__(kThreads) probe_vpu_smem_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long long t = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (t >= a.tasks) return;
  const Task k = task_of(a, t);
  const int lane = threadIdx.x & 31, Z = a.Z, q = k.g, deg = k.deg;
  float* cur = reinterpret_cast<float*>(smem_raw) +
               static_cast<size_t>(threadIdx.x >> 5) * (a.max_deg + 1) * Z;
  float* rowm = cur + deg * Z;
  for (int j = 0; j < deg; ++j) {
    const __nv_bfloat16* src = a.in + feature(a, k.f, edge_of(a, k, j), q);
    for (int z = lane; z < Z; z += 32) cur[j * Z + z] = __bfloat162float(src[z]);
  }
  __syncwarp();
  for (int it = 0; it < a.L; ++it) {
    for (int z = lane; z < Z; z += 32) {
      float acc = 0.0f;
      for (int j = 0; j < deg; ++j)
        acc = __fadd_rn(acc, cur[j * Z + rolled(z, shift_of(a, k, j), Z)]);
      rowm[z] = bf16_round(__fmul_rn(acc, k.inv));
    }
    __syncwarp();
    for (int j = 0; j < deg; ++j) {
      const int u = back(shift_of(a, k, j), Z);
      for (int z = lane; z < Z; z += 32) cur[j * Z + z] = rowm[rolled(z, u, Z)];
    }
    __syncwarp();
  }
  for (int j = 0; j < deg; ++j) {
    __nv_bfloat16* dst = a.out + feature(a, k.f, edge_of(a, k, j), q);
    for (int z = lane; z < Z; z += 32) dst[z] = __float2bfloat16_rn(cur[j * Z + z]);
  }
}

// A's fragment of the 16 x 16 bf16 tile at `tile` (row stride `stride`
// elements) by ldmatrix: lane l gives row l % 16 of column block l / 16.
__device__ __forceinline__ void load_a(const __nv_bfloat16* tile, int stride, unsigned (&a)[4]) {
  const int lane = threadIdx.x & 31;
  const unsigned addr = static_cast<unsigned>(
      __cvta_generic_to_shared(tile + (lane & 15) * stride + (lane >> 4) * 8));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// d += A (16 x 16) * B (16 x 8), bf16 in, float32 accumulate.
__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                    unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two bf16 ones or zeros in one register: low half (k, n), high half (k + 1, n)
// of the rotation fragment, where the one of column n sits at row `target`.
__device__ __forceinline__ unsigned ones(int k, int target) {
  return (k == target ? 0x3f80u : 0u) | (k + 1 == target ? 0x3f800000u : 0u);
}

// The row of the one in output column w of P[s]: rolled(w, s), or -1 for a
// pad column w >= Z (a zero column).
__device__ __forceinline__ int target_of(int w, int s, int Z) {
  return w < Z ? rolled(w, s, Z) : -1;
}

// d[n] += block (16 x Zp) * P[s] at output columns w0 + 8 n .. + 7, n < 4
// (the thread's column w0 + 8 n + g): one ldmatrix a k-step feeds four
// independent mma chains.
__device__ __forceinline__ void rotate_group(float (&d)[kGroup][4], const __nv_bfloat16* block,
                                             int stride, int w0, int s, int Z, int Zp, int g,
                                             int tq) {
  int target[kGroup];
#pragma unroll
  for (int n = 0; n < kGroup; ++n) target[n] = target_of(w0 + 8 * n + g, s, Z);
  for (int v0 = 0; v0 < Zp; v0 += 16) {
    unsigned a[4];
    load_a(block + v0, stride, a);
    const int kk = v0 + 2 * tq;
#pragma unroll
    for (int n = 0; n < kGroup; ++n) mma(d[n], a, ones(kk, target[n]), ones(kk + 8, target[n]));
  }
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}

// The four 16 x 8 accumulator tiles d at columns w0 of a slice: rows g and
// g + 8, columns w0 + 8 n + 2 tq and + 1, each value times `scale` where
// SCALED.
template <bool SCALED>
__device__ __forceinline__ void store_group(__nv_bfloat16* slice, int stride, int w0,
                                            const float (&d)[kGroup][4], float scale, int g,
                                            int tq) {
#pragma unroll
  for (int n = 0; n < kGroup; ++n) {
    const int c = w0 + 8 * n + 2 * tq;
    if (SCALED) {
      store_pair(slice + g * stride + c, __fmul_rn(d[n][0], scale), __fmul_rn(d[n][1], scale));
      store_pair(slice + (g + 8) * stride + c, __fmul_rn(d[n][2], scale),
                 __fmul_rn(d[n][3], scale));
    } else {
      store_pair(slice + g * stride + c, d[n][0], d[n][1]);
      store_pair(slice + (g + 8) * stride + c, d[n][2], d[n][3]);
    }
  }
}

__device__ __forceinline__ void zero_group(float (&d)[kGroup][4]) {
#pragma unroll
  for (int n = 0; n < kGroup; ++n) d[n][0] = d[n][1] = d[n][2] = d[n][3] = 0.0f;
}

// Lanes a row of the mxu slices holds: Z rounded up to 32 (a group of four
// 8-column output tiles), then kPad.
__host__ __device__ inline int mxu_stride(int Z) { return (Z + 31) / 32 * 32 + kPad; }

// mxu: 16 hidden units of a row a warp, every product on the tensor cores.
// The warp's slice: the row's shifts (max_deg ints, rounded up to 16
// bytes), then max_deg + 1 blocks of 16 x stride bf16 (the members', then
// the row mean's).  One body for every degree: the member loops run at run
// time, which keeps the kernel small enough for the instruction cache.
__global__ void __launch_bounds__(128) probe_mxu_kernel(const Args a, int warps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long long t = static_cast<long long>(blockIdx.x) * warps + (threadIdx.x >> 5);
  if (t >= a.tasks) return;
  const Task k = task_of(a, t);
  const int lane = threadIdx.x & 31, Z = a.Z, stride = mxu_stride(Z), Zp = stride - kPad;
  const int tile = kTileRows * stride, shift_words = (a.max_deg + 3) / 4 * 4;
  int* shift = reinterpret_cast<int*>(
      smem_raw + static_cast<size_t>(threadIdx.x >> 5) *
                     (4 * shift_words + 2 * (a.max_deg + 1) * tile));
  __nv_bfloat16* cur = reinterpret_cast<__nv_bfloat16*>(shift + shift_words);
  __nv_bfloat16* rowm = cur + k.deg * tile;
  const int q0 = k.g * kTileRows, g = lane >> 2, tq = lane & 3, deg = k.deg;
  for (int j = lane; j < deg; j += 32) shift[j] = shift_of(a, k, j);
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
  for (int j = 0; j < deg; ++j) {
    const __nv_bfloat16* src = a.in + feature(a, k.f, edge_of(a, k, j), q0);
    for (int z = lane; z < Zp; z += 32) {
      __nv_bfloat16 v[kTileRows];
#pragma unroll
      for (int row = 0; row < kTileRows; ++row) v[row] = z < Z ? src[row * Z + z] : zero;
#pragma unroll
      for (int row = 0; row < kTileRows; ++row) cur[j * tile + row * stride + z] = v[row];
    }
  }
  __syncwarp();
  float d[kGroup][4];
  for (int it = 0; it < a.L; ++it) {
    // rowm = bf16((sum over members of cur_j @ P[s_j]) * inv), four 16 x 8
    // tiles at a time.
    for (int w0 = 0; w0 < Zp; w0 += 8 * kGroup) {
      zero_group(d);
      for (int j = 0; j < deg; ++j)
        rotate_group(d, cur + j * tile, stride, w0, shift[j], Z, Zp, g, tq);
      store_group<true>(rowm, stride, w0, d, k.inv, g, tq);
    }
    __syncwarp();
    // cur_j = rowm @ P[(Z - s_j) mod Z]: the row mean rolled back.
    for (int j = 0; j < deg; ++j) {
      for (int w0 = 0; w0 < Zp; w0 += 8 * kGroup) {
        zero_group(d);
        rotate_group(d, rowm, stride, w0, back(shift[j], Z), Z, Zp, g, tq);
        store_group<false>(cur + j * tile, stride, w0, d, 1.0f, g, tq);
      }
    }
    __syncwarp();
  }
  for (int j = 0; j < deg; ++j) {
    __nv_bfloat16* dst = a.out + feature(a, k.f, edge_of(a, k, j), q0);
    for (int z = lane; z < Z; z += 32) {
#pragma unroll
      for (int row = 0; row < kTileRows; ++row) dst[row * Z + z] = cur[j * tile + row * stride + z];
    }
  }
}

// Whether variant 0 takes the register kernel.
bool vpu_in_registers(int Z) { return Z <= 32; }

// Dynamic shared memory of one block: vpu in registers none; vpu in shared
// memory a slice of (max_deg + 1) * Z floats a warp; mxu a slice a warp of
// the shifts (max_deg ints, rounded up to 16 bytes) and (max_deg + 1) * 16
// * mxu_stride(Z) bf16, `warps` warps.
long long smem_bytes(int variant, int Z, int max_deg, int warps) {
  if (variant == 0) return vpu_in_registers(Z) ? 0 : 4LL * kWarps * (max_deg + 1) * Z;
  return warps * (4LL * ((max_deg + 3) / 4 * 4) +
                  2LL * (max_deg + 1) * kTileRows * mxu_stride(Z));
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block of `variant` (0 vpu, 1 mxu) needs
// (`warps`: mxu's warps a block).
long long ldpc_probe_smem_bytes(int variant, int Z, int max_deg, int warps) {
  return smem_bytes(variant, Z, max_deg, warps);
}

// Launches the variant's kernel on `stream`, no sync: vpu 8 warps a block,
// mxu `warps` (1-4), each warp a task of hidden units of one (frame, base
// row); rows of at most 24 members.  Returns a cudaError_t (0 on success).
int ldpc_probe_agg(int variant, const void* in, void* out, const void* graph, const void* inv,
                   int frames, int K, int R, int H, int Z, int max_deg, int L, int warps,
                   void* stream) {
  if ((variant != 0 && variant != 1) || frames < 1 || Z < 1 || max_deg < 1 ||
      max_deg > kMaxDeg || H % kTileRows || warps < 1 || warps > 4)
    return cudaErrorInvalidValue;
  Args a;
  a.in = static_cast<const __nv_bfloat16*>(in);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.graph = static_cast<const int*>(graph);
  a.inv = static_cast<const float*>(inv);
  a.K = K;
  a.R = R;
  a.H = H;
  a.Z = Z;
  a.L = L;
  a.max_deg = max_deg;
  const bool regs = variant == 0 && vpu_in_registers(Z);
  a.segs = variant == 1 ? kTileRows : regs ? 32 / Z : 1;
  a.groups = (H + a.segs - 1) / a.segs;
  a.tasks = static_cast<long long>(frames) * R * a.groups;
  const long long smem = smem_bytes(variant, Z, max_deg, warps);
  const int per_block = variant == 1 ? warps : kWarps;
  const long long blocks = (a.tasks + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (variant == 1) {
    err = cudaFuncSetAttribute(probe_mxu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    probe_mxu_kernel<<<static_cast<unsigned>(blocks), 32 * warps, smem, s>>>(a, warps);
  } else if (regs) {
    // The instantiation whose MAXD (8, 12, 24) holds max_deg: a kernel takes
    // the registers of its widest body.
    const auto kernel = max_deg <= 8    ? &probe_vpu_kernel<8>
                        : max_deg <= 12 ? &probe_vpu_kernel<12>
                                        : &probe_vpu_kernel<24>;
    kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(a);
  } else {
    err = cudaFuncSetAttribute(probe_vpu_smem_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    probe_vpu_smem_kernel<<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(a);
  }
  return cudaGetLastError();
}

const char* ldpc_probe_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
