// Multiphase non-Newtonian (HBP) pair interaction for Hopper (sm_90a), one
// thread per target in blocks of 128.  Three kernels, over the GPU layout
// of the original DualSPHysics solver (state sorted by cell, a begin index
// per cell) instead of the TPU's row-padded lane windows:
//
//   nnforce_p1   replaces dualsphysics_multilayer_tpu/ops/pallas/nnforce.py
//                `_kernel_nn1` (pass 1: per-phase pressure force,
//                continuity, same-phase density diffusion, viscdt and the
//                6-component velocity gradient);
//   nnforce_p3   replaces `_kernel_nn3` (pass 3: Morris, ConsEq or per-phase
//                artificial viscosity, added into pass 1's acceleration);
//   nnforce_fda  replaces `_kernel_fda` (pass 1 plus the per-pair FDA strain
//                -> HBP eta -> Morris or ConsEq force, and the per-target
//                eta max, in one sweep).
//
// Pass 2 (strain rate -> effective viscosity -> tau) is elementwise torch
// between the p1 and p3 launches (ops/forces_nn.py).  The per-pair
// arithmetic lives in nnbody.cuh, shared with the g++-built CPU twins;
// per-phase constants come from the tables of NnParams instead of the
// TPU's per-particle constant channels.
//
// What bounds them on the card: gathers of candidate fields through L1/L2,
// as in cellforce.cu.  In 2D a target walks 3 rows of 3 cells, about
// 9 x (cell occupancy) candidates, of which about a third lie inside the
// kernel support; each candidate costs a 16-byte position load and a kind
// load before the distance test, and a 16-byte velocity load, a phase load
// and (p3) its eta or 24-byte tau after it.  FDA adds one expf and one powf
// per pair.  The sorted layout makes the gathers cheap: the threads of a
// warp hold neighbouring targets in the same or adjacent cells, so they read
// overlapping contiguous slot ranges and the loads coalesce and hit in cache.
#include <cuda_runtime.h>

#include "nnbody.cuh"

namespace {

constexpr int kBlock = 128;

__global__ void __launch_bounds__(kBlock)
nnforce_p1_kernel(NnParams p, const F4* __restrict__ pospress,
                  const F4* __restrict__ velrho, const int* __restrict__ kind,
                  const int* __restrict__ phase, const int* __restrict__ cell,
                  const int* __restrict__ begin, float* __restrict__ ace,
                  float* __restrict__ ar, float* __restrict__ viscdt,
                  float* __restrict__ gradvel) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i < p.n) {
    nn_pass1_target<false>(i, p, pospress, velrho, kind, phase, cell, begin,
                           ace, ar, viscdt, gradvel, nullptr);
  }
}

__global__ void __launch_bounds__(kBlock)
nnforce_fda_kernel(NnParams p, const F4* __restrict__ pospress,
                   const F4* __restrict__ velrho, const int* __restrict__ kind,
                   const int* __restrict__ phase, const int* __restrict__ cell,
                   const int* __restrict__ begin, float* __restrict__ ace,
                   float* __restrict__ ar, float* __restrict__ viscdt,
                   float* __restrict__ etamax) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i < p.n) {
    nn_pass1_target<true>(i, p, pospress, velrho, kind, phase, cell, begin,
                          ace, ar, viscdt, nullptr, etamax);
  }
}

__global__ void __launch_bounds__(kBlock)
nnforce_p3_kernel(NnParams p, const F4* __restrict__ pospress,
                  const F4* __restrict__ velrho, const int* __restrict__ kind,
                  const int* __restrict__ phase, const int* __restrict__ cell,
                  const int* __restrict__ begin, const float* __restrict__ eta,
                  const float* __restrict__ tau, float* __restrict__ ace) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i < p.n) {
    nn_pass3_target(i, p, pospress, velrho, kind, phase, cell, begin, eta,
                    tau, ace);
  }
}

int nblocks(const NnParams* p) { return (p->n + kBlock - 1) / kBlock; }

}  // namespace

// Each launcher launches on `stream` and returns cudaGetLastError() (0 on
// success).

extern "C" int dsph_nnforce_p1(const NnParams* p, const void* pospress,
                               const void* velrho, const void* kind,
                               const void* phase, const void* cell,
                               const void* begin, void* ace, void* ar,
                               void* viscdt, void* gradvel, void* stream) {
  nnforce_p1_kernel<<<nblocks(p), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      *p, static_cast<const F4*>(pospress), static_cast<const F4*>(velrho),
      static_cast<const int*>(kind), static_cast<const int*>(phase),
      static_cast<const int*>(cell), static_cast<const int*>(begin),
      static_cast<float*>(ace), static_cast<float*>(ar),
      static_cast<float*>(viscdt), static_cast<float*>(gradvel));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dsph_nnforce_fda(const NnParams* p, const void* pospress,
                                const void* velrho, const void* kind,
                                const void* phase, const void* cell,
                                const void* begin, void* ace, void* ar,
                                void* viscdt, void* etamax, void* stream) {
  nnforce_fda_kernel<<<nblocks(p), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      *p, static_cast<const F4*>(pospress), static_cast<const F4*>(velrho),
      static_cast<const int*>(kind), static_cast<const int*>(phase),
      static_cast<const int*>(cell), static_cast<const int*>(begin),
      static_cast<float*>(ace), static_cast<float*>(ar),
      static_cast<float*>(viscdt), static_cast<float*>(etamax));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dsph_nnforce_p3(const NnParams* p, const void* pospress,
                               const void* velrho, const void* kind,
                               const void* phase, const void* cell,
                               const void* begin, const void* eta,
                               const void* tau, void* ace, void* stream) {
  nnforce_p3_kernel<<<nblocks(p), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      *p, static_cast<const F4*>(pospress), static_cast<const F4*>(velrho),
      static_cast<const int*>(kind), static_cast<const int*>(phase),
      static_cast<const int*>(cell), static_cast<const int*>(begin),
      static_cast<const float*>(eta), static_cast<const float*>(tau),
      static_cast<float*>(ace));
  return static_cast<int>(cudaGetLastError());
}
