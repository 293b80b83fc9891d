// neural_group (neural_group.cuh; described in fused_neural.cu's header) on
// the 128-bit check-state word: B3 (ldpc_tpu/ops/pallas_neural.py:111) on
// codes with rows of 59 to 121 members, route neural_group_w128 of
// ldpc_tpu_torch/ops/fused_neural.py.  Built with -fmad=false, as
// fused_neural.cu is.

#include <cuda_runtime.h>

#include "retire.cuh"

namespace {
using NeuralWord = Word128;
}  // namespace

#include "neural_group.cuh"
