// Misaligned-window load probe for Hopper (sm_90a): the counterpart of
// probe_unaligned.py's kern (a TPU probe of dynamic lane-slice loads).
//
// A (16, 4096) f32 buffer, niter loads of a 16 x 128 window at offsets from
// a table, each followed by acc = acc + cw*1.000001 + acc*cw, over `groups`
// windows in flight.  Two blocks of 128 threads share a window, one thread
// per lane of 8 rows (probebody.cuh gather_lane), so that a block's rows of
// the buffer (128 KB) fit in shared memory.  Each load reads the window
// from global memory (through L1/L2: the buffer is 256 KB) or, staged,
// from the block's copy in shared memory, and each is aligned (offset
// rounded down to 128 floats) or not.  An unaligned window makes every warp
// read 128 bytes that straddle two 128-byte lines, as a pair kernel's walk
// over a cell range that starts at an arbitrary slot does (cellforce.cu,
// nnforce.cu).  What bounds it: the latency of the dependent window loads
// of each block (few blocks, one window at a time); its bound is the f32
// operations (2 FMA per element per load) over the card's peak.
#include <cuda_runtime.h>

#include "probebody.cuh"

namespace {

constexpr int kBlock = GATHER_LANES;
constexpr int kStagedBytes = GATHER_BLOCK_ROWS * GATHER_WIDTH * 4;

template <bool ALIGNED, bool STAGED>
__global__ void __launch_bounds__(kBlock)
probe_gather_kernel(const float* __restrict__ buf, const int* __restrict__ offs,
                    int niter, float* __restrict__ out) {
  extern __shared__ float4 staged[];
  const int half = blockIdx.x % 2;
  const float* rows = buf + half * GATHER_BLOCK_ROWS * GATHER_WIDTH;
  float* o = out + (blockIdx.x / 2) * GATHER_ROWS * GATHER_LANES
             + half * GATHER_BLOCK_ROWS * GATHER_LANES;
  if constexpr (STAGED) {
    const float4* src = reinterpret_cast<const float4*>(rows);
    for (int k = threadIdx.x; k < kStagedBytes / 16; k += kBlock) {
      staged[k] = src[k];
    }
    __syncthreads();
    gather_lane<ALIGNED>(reinterpret_cast<const float*>(staged), offs, niter,
                         threadIdx.x, o);
  } else {
    gather_lane<ALIGNED>(rows, offs, niter, threadIdx.x, o);
  }
}

template <bool ALIGNED, bool STAGED>
int launch(const GatherParams* p, const float* buf, const int* offs,
           float* out, cudaStream_t stream) {
  auto* kernel = probe_gather_kernel<ALIGNED, STAGED>;
  const int smem = STAGED ? kStagedBytes : 0;
  if (STAGED) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<2 * p->groups, kBlock, smem, stream>>>(buf, offs, p->niter, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`: buf (16, 4096) f32 and offs (niter,) i32 in (each
// offset clamped to [0, 4096 - 128]); out (groups, 16, 128) f32.  Returns the CUDA
// error code, 0 on success.
extern "C" int dsph_probe_gather(const GatherParams* p, const void* buf,
                                 const void* offs, void* out, void* stream) {
  if (p->niter < 0 || p->groups <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* b = static_cast<const float*>(buf);
  const auto* f = static_cast<const int*>(offs);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (p->aligned) {
    return p->staged ? launch<true, true>(p, b, f, o, s)
                     : launch<true, false>(p, b, f, o, s);
  }
  return p->staged ? launch<false, true>(p, b, f, o, s)
                   : launch<false, false>(p, b, f, o, s);
}
