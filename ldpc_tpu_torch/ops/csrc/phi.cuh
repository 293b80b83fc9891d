// phi(x) = -log(tanh(x / 2) + 1e-30), the sum-product kernels' self-inverse
// check function, as fused_minsum.cu computes it: accurate tanhf and logf
// (the port's sources are built without fast-math).  Included by
// fused_retire.cu (retire_sumproduct_kernel) and probe_phi.cu.
#pragma once

__device__ __forceinline__ float phi(float x) { return -logf(tanhf(x / 2.0f) + 1e-30f); }
