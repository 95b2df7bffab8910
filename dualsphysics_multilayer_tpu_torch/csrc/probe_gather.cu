// Misaligned-window load probe for Hopper (sm_90a): the counterpart of
// probe_unaligned.py's kern (a TPU probe of dynamic lane-slice loads).
//
// A (16, 4096) f32 buffer, niter loads of a 16 x 128 window at offsets from
// a table, each followed by acc = acc + cw*1.000001 + acc*cw, over `groups`
// windows in flight.  Each load reads the window from global memory
// (through L1/L2: the buffer is 256 KB) or, staged, from the block's copy
// in shared memory, and each is aligned (offset rounded down to 128 floats)
// or not.  An unaligned window makes every warp read 128 bytes that
// straddle two 128-byte lines, as a pair kernel's walk over a cell range
// that starts at an arbitrary slot does (cellforce.cu, nnforce.cu).
//
// What bounds it: every window load passes through the SM's load path (L1
// or shared memory), 128 bytes per SM per clock, and costs 2 dependent
// FMAs per element.  So the work is spread over the card: one block of 128
// threads per (window, GATHER_CHAIN_ROWS = 4 rows), 256 blocks for 64
// windows, each thread the chains of its lane (probebody.cuh
// gather_chains) with the next chunk of window loads in flight ahead of
// the FMAs.  A block first turns the offset table into window offsets
// (clamped, aligned, padded) in shared memory, so a step costs a quarter
// of a 16-byte broadcast read, an address and the window loads, and no
// per-thread offset arithmetic or bounds test.  (The first design gave a
// block 8 rows of a window, 128 blocks in all, with a chain of dependent
// offset loads and per-load offset arithmetic; one row a block with a
// bounds test at every step ran no faster: the instructions around each
// load, not the loads, bound it.)
#include <cuda_runtime.h>

#include "probebody.cuh"

namespace {

constexpr int kBlock = GATHER_LANES;
constexpr int kStagedBytes = GATHER_CHAIN_ROWS * GATHER_WIDTH * 4;

// The window offsets a block holds, padded, in 16-byte units.
__host__ __device__ int offsets4(int niter) {
  return (niter + GATHER_STEPS + 3) / 4;
}

// Shared memory of a launch: the window offsets and, staged, the block's
// rows.
int smem_bytes(int niter, bool staged) {
  return offsets4(niter) * 16 + (staged ? kStagedBytes : 0);
}

// Block b computes rows (b % kGroups) * GATHER_CHAIN_ROWS .. of window
// b / kGroups, kGroups = GATHER_ROWS / GATHER_CHAIN_ROWS.
template <bool STAGED>
__global__ void __launch_bounds__(kBlock)
probe_gather_kernel(const float* __restrict__ buf, const int* __restrict__ offs,
                    int niter, int aligned, float* __restrict__ out) {
  constexpr int kGroups = GATHER_ROWS / GATHER_CHAIN_ROWS;
  extern __shared__ float4 smem[];
  int* woff = reinterpret_cast<int*>(smem);
  const int row0 = (blockIdx.x % kGroups) * GATHER_CHAIN_ROWS;
  const float* rows = buf + row0 * GATHER_WIDTH;
  for (int i = threadIdx.x; i < 4 * offsets4(niter); i += kBlock) {
    woff[i] = i < niter ? gather_offset(offs[i], aligned != 0) : 0;
  }
  if constexpr (STAGED) {
    float4* staged = smem + offsets4(niter);
    const float4* src = reinterpret_cast<const float4*>(rows);
    for (int k = threadIdx.x; k < kStagedBytes / 16; k += kBlock) {
      staged[k] = src[k];
    }
    rows = reinterpret_cast<const float*>(staged);
  }
  __syncthreads();
  float acc[GATHER_CHAIN_ROWS];
  gather_chains(rows, woff, niter, threadIdx.x, acc);
  float* o = out
             + ((blockIdx.x / kGroups) * GATHER_ROWS + row0) * GATHER_LANES;
#pragma unroll
  for (int r = 0; r < GATHER_CHAIN_ROWS; ++r) {
    o[r * GATHER_LANES + threadIdx.x] = acc[r];
  }
}

template <bool STAGED>
int launch(const GatherParams* p, const float* buf, const int* offs,
           float* out, cudaStream_t stream) {
  auto* kernel = probe_gather_kernel<STAGED>;
  const int smem = smem_bytes(p->niter, STAGED);
  if (smem > 48 * 1024) {   // above what a launch may ask for without this
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<p->groups * (GATHER_ROWS / GATHER_CHAIN_ROWS), kBlock, smem,
           stream>>>(buf, offs, p->niter, p->aligned, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`: buf (16, 4096) f32 and offs (niter,) i32 in (each
// offset clamped to [0, 4096 - 128]; niter at most GATHER_MAX_NITER); out
// (groups, 16, 128) f32.  Returns the CUDA error code, 0 on success.
extern "C" int dsph_probe_gather(const GatherParams* p, const void* buf,
                                 const void* offs, void* out, void* stream) {
  if (p->niter < 0 || p->niter > GATHER_MAX_NITER || p->groups <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* one = p->staged ? launch<true> : launch<false>;
  return one(p, static_cast<const float*>(buf), static_cast<const int*>(offs),
             static_cast<float*>(out), static_cast<cudaStream_t>(stream));
}
