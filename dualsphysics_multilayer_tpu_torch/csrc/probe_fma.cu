// FMA-issue probe for Hopper (sm_90a): the counterpart of vputime.py's
// make_kernel.kernel (a TPU VPU issue-rate microbenchmark).
//
// Each thread runs CHAINS independent dependency chains through the probe's
// recurrence (probebody.cuh fma_chains): PROBE_STEPS steps per iteration
// of one operation (fma alternating with max; the pair bodies' mix of fma,
// max, mul and compare; rsqrt; the approximate reciprocal), for rep
// iterations, and writes the sum of its chains.  The launcher runs one
// thread per element of x; the caller sizes x to fill every SM (132 on the
// H100, 2048 threads each).  What bounds it: issue, nothing else; it reads
// and writes 8 bytes a thread.  Its rate, steps per SM per clock, against
// the 128 f32 lanes of an SM, answers whether the pair kernels' candidate
// loop is held back by instruction issue (PERF.md section 7).
#include <cuda_runtime.h>

#include "probebody.cuh"

namespace {

constexpr int kBlock = 256;

template <int OP, int CHAINS>
__global__ void __launch_bounds__(kBlock)
probe_fma_kernel(const float* __restrict__ x, float* __restrict__ out, int n,
                 int rep) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i < n) out[i] = fma_chains<OP, CHAINS>(x[i], rep);
}

template <int OP>
int launch(const FmaParams* p, const float* x, float* out,
           cudaStream_t stream) {
  auto* kernel = p->chains == 1   ? probe_fma_kernel<OP, 1>
                 : p->chains == 2 ? probe_fma_kernel<OP, 2>
                 : p->chains == 4 ? probe_fma_kernel<OP, 4>
                                  : probe_fma_kernel<OP, 8>;
  kernel<<<(p->n + kBlock - 1) / kBlock, kBlock, 0, stream>>>(x, out, p->n,
                                                              p->rep);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`: x (n,) f32 in, out (n,) f32.  Returns the CUDA error
// code, 0 on success, cudaErrorInvalidValue for an unknown operation or a
// chain count other than 1, 2, 4 or 8.
extern "C" int dsph_probe_fma(const FmaParams* p, const void* x, void* out,
                              void* stream) {
  const int c = p->chains;
  if (p->op < PROBE_FMA || p->op > PROBE_RECIP
      || !(c == 1 || c == 2 || c == 4 || c == 8) || p->n <= 0 || p->rep < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* xs = static_cast<const float*>(x);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (p->op) {
    case PROBE_FMA: return launch<PROBE_FMA>(p, xs, o, s);
    case PROBE_MIX: return launch<PROBE_MIX>(p, xs, o, s);
    case PROBE_RSQRT: return launch<PROBE_RSQRT>(p, xs, o, s);
    default: return launch<PROBE_RECIP>(p, xs, o, s);
  }
}
