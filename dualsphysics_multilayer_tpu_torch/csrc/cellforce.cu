// WCSPH pair interaction for Hopper (sm_90a), one thread per target.
//
// Replaces the TPU kernel dualsphysics_multilayer_tpu/ops/pallas/cellforce.py
// `_kernel_v3` with its fast pair body `_make_phys_v4`: the same momentum,
// continuity, density diffusion and viscdt outputs, over the GPU layout of
// the original DualSPHysics solver (state sorted by cell, a begin index per
// cell) instead of the TPU's row-padded lane windows.  The per-pair
// arithmetic lives in pairbody.cuh, shared with the g++-built CPU twin.
//
// What bounds it on the card: gathers of candidate fields through L1/L2.
// Each target walks 9 neighbour rows of 3 cells, about 27 x (cell occupancy)
// candidates (up to 68 slots per cell at the dp-lattice bound of
// ops/celldiv.py:98 in the JAX package), of which about a tenth lie inside
// the kernel support; every candidate costs one 16-byte position load and
// one kind load before the distance test.  The sorted layout is what makes
// this cheap: threads of one warp hold neighbouring targets, in the same or
// adjacent cells, so they read overlapping contiguous slot ranges and the
// loads of a warp coalesce and hit in cache.
#include <cuda_runtime.h>

#include "pairbody.cuh"

namespace {

constexpr int kBlock = 128;

__global__ void __launch_bounds__(kBlock)
cellforce_kernel(CfParams p, const F4* __restrict__ pospress,
                 const F4* __restrict__ velrho, const int* __restrict__ kind,
                 const int* __restrict__ cell, const int* __restrict__ begin,
                 float* __restrict__ ace, float* __restrict__ ar,
                 float* __restrict__ viscdt) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i < p.n) {
    target_forces(i, p, pospress, velrho, kind, cell, begin, ace, ar, viscdt);
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int dsph_cellforce(const CfParams* p, const void* pospress,
                              const void* velrho, const void* kind,
                              const void* cell, const void* begin, void* ace,
                              void* ar, void* viscdt, void* stream) {
  const int nblocks = (p->n + kBlock - 1) / kBlock;
  cellforce_kernel<<<nblocks, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      *p, static_cast<const F4*>(pospress), static_cast<const F4*>(velrho),
      static_cast<const int*>(kind), static_cast<const int*>(cell),
      static_cast<const int*>(begin), static_cast<float*>(ace),
      static_cast<float*>(ar), static_cast<float*>(viscdt));
  return static_cast<int>(cudaGetLastError());
}
