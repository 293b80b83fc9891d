// What one phi costs on the card, for the note of retire_sumproduct_kernel
// (fused_retire.cu) and PERF.md: its SASS instructions and its rate,
// accurate (phi.cuh: tanhf and logf, as the sum-product kernels compute it)
// and on the special-function unit's approximations (tanh.approx.f32 and
// __logf), and how far the two differ.  No decoder uses the approximate
// one.  Driven by ldpc_tpu_torch/tools/probe_phi.py.

#include <cuda_runtime.h>

#include "phi.cuh"

namespace {

__device__ __forceinline__ float phi_mufu(float x) {
  float t;
  asm("tanh.approx.f32 %0, %1;" : "=f"(t) : "f"(x * 0.5f));
  return -__logf(t + 1e-30f);
}

template <bool MUFU>
__device__ __forceinline__ float phi_of(float x) {
  return MUFU ? phi_mufu(x) : phi(x);
}

// y = phi(x), one phi a thread: its SASS less copy_kernel's is one phi.
template <bool MUFU>
__global__ void phi_once_kernel(const float* __restrict__ x, float* __restrict__ y, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = phi_of<MUFU>(x[i]);
}

__global__ void copy_kernel(const float* __restrict__ x, float* __restrict__ y, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = x[i];
}

// phi applied `reps` times a thread, its argument clamped to [1e-7, 20]
// each time as the check pass clamps it: with many reps the chain of phi,
// not memory, sets the time.
template <bool MUFU>
__global__ void phi_chain_kernel(const float* __restrict__ x, float* __restrict__ y, int n,
                                 int reps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = x[i];
  for (int r = 0; r < reps; ++r) v = phi_of<MUFU>(fminf(fmaxf(v, 1e-7f), 20.0f));
  y[i] = v;
}

constexpr int kThreads = 256;

}  // namespace

extern "C" {

// kind 0: phi_once, 1: phi_chain (reps), 2: copy; mufu: the approximate phi.
// Returns a cudaError_t (0 on success).  Launches on `stream`, no sync.
int ldpc_probe_phi(const void* x, void* y, int n, int kind, int reps, int mufu, void* stream) {
  if (n < 1 || kind < 0 || kind > 2) return cudaErrorInvalidValue;
  const int grid = (n + kThreads - 1) / kThreads;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto in = static_cast<const float*>(x);
  const auto out = static_cast<float*>(y);
  if (kind == 2) {
    copy_kernel<<<grid, kThreads, 0, s>>>(in, out, n);
  } else if (kind == 0) {
    const auto kernel = mufu ? &phi_once_kernel<true> : &phi_once_kernel<false>;
    kernel<<<grid, kThreads, 0, s>>>(in, out, n);
  } else {
    const auto kernel = mufu ? &phi_chain_kernel<true> : &phi_chain_kernel<false>;
    kernel<<<grid, kThreads, 0, s>>>(in, out, n, reps);
  }
  return cudaGetLastError();
}

const char* ldpc_probe_phi_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
