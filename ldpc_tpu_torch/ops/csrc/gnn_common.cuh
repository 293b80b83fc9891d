// Device helpers shared by the GNN decoders (fused_gnn.cu, fused_msg_gnn.cu):
// bf16 rounding, shared-memory word alignment and the float32 FMA product of
// an (H, H) weight matrix in shared memory by a vector in registers.  Each
// source includes this header and compiles on its own.
#pragma once

#include <cuda_bf16.h>

namespace {

__host__ __device__ inline int round4(int x) { return (x + 3) / 4 * 4; }

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Accumulates W rows j..j+3 times x into a0..a3, continuing the sums: every
// thread of a warp reads the same weight address (a broadcast), and the four
// rows give four independent FMA chains.
template <int H>
__device__ __forceinline__ void rows4(const float* __restrict__ W, int j, const float (&x)[H],
                                      float& a0, float& a1, float& a2, float& a3) {
  constexpr int Q = H / 4;
  const float4* w = reinterpret_cast<const float4*>(W + j * H);
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    const float4 p0 = w[i], p1 = w[i + Q], p2 = w[i + 2 * Q], p3 = w[i + 3 * Q];
    a0 = fmaf(p0.x, x[4 * i], a0);
    a1 = fmaf(p1.x, x[4 * i], a1);
    a2 = fmaf(p2.x, x[4 * i], a2);
    a3 = fmaf(p3.x, x[4 * i], a3);
    a0 = fmaf(p0.y, x[4 * i + 1], a0);
    a1 = fmaf(p1.y, x[4 * i + 1], a1);
    a2 = fmaf(p2.y, x[4 * i + 1], a2);
    a3 = fmaf(p3.y, x[4 * i + 1], a3);
    a0 = fmaf(p0.z, x[4 * i + 2], a0);
    a1 = fmaf(p1.z, x[4 * i + 2], a1);
    a2 = fmaf(p2.z, x[4 * i + 2], a2);
    a3 = fmaf(p3.z, x[4 * i + 2], a3);
    a0 = fmaf(p0.w, x[4 * i + 3], a0);
    a1 = fmaf(p1.w, x[4 * i + 3], a1);
    a2 = fmaf(p2.w, x[4 * i + 3], a2);
    a3 = fmaf(p3.w, x[4 * i + 3], a3);
  }
}

// sink(j, sum_i W[j*H + i] * x[i]) for j < H, four rows at a time; W in
// shared memory, x in registers.
template <int H, typename Sink>
__device__ __forceinline__ void matvec(const float* __restrict__ W, const float (&x)[H],
                                       Sink&& sink) {
#pragma unroll 1
  for (int j = 0; j < H; j += 4) {
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
    rows4<H>(W, j, x, a0, a1, a2, a3);
    sink(j, a0);
    sink(j + 1, a1);
    sink(j + 2, a2);
    sink(j + 3, a3);
  }
}

}  // namespace
