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
// Each is a template over the TPU kernels' static branches, one instance
// per combination, picked by its launcher from the parameters: the
// smoothing kernel KER (Wendland, or the cubic spline with the tensile
// correction in p1 and FDA), and for p1 and FDA whether a shifting mode
// adds the shifting sums (SHIFT).  A runtime test in one instance would
// cost the default (Wendland, no shifting) instance registers and time, as
// it did kernel 1's floating branch (cellforce.cu).
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
// per pair.  The cubic spline and the shifting sums add arithmetic and
// registers (4 sums), no loads per candidate.  The sorted layout makes the
// gathers cheap: the threads of a warp hold neighbouring targets in the
// same or adjacent cells, so they read overlapping contiguous slot ranges
// and the loads coalesce and hit in cache.
#include <cuda_runtime.h>

#include "nnbody.cuh"

namespace {

constexpr int kBlock = 128;

template <int KER, bool SHIFT>
__global__ void __launch_bounds__(kBlock)
nnforce_p1_kernel(NnParams p, const F4* __restrict__ pospress,
                  const F4* __restrict__ velrho, const int* __restrict__ kind,
                  const int* __restrict__ phase, const int* __restrict__ cell,
                  const int* __restrict__ begin, float* __restrict__ ace,
                  float* __restrict__ ar, float* __restrict__ viscdt,
                  float* __restrict__ gradvel, float* __restrict__ shift,
                  unsigned char* __restrict__ shiftblk) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i < p.n) {
    nn_pass1_target<KER, SHIFT, false>(i, p, pospress, velrho, kind, phase,
                                       cell, begin, ace, ar, viscdt, gradvel,
                                       nullptr, shift, shiftblk);
  }
}

template <int KER, bool SHIFT>
__global__ void __launch_bounds__(kBlock)
nnforce_fda_kernel(NnParams p, const F4* __restrict__ pospress,
                   const F4* __restrict__ velrho, const int* __restrict__ kind,
                   const int* __restrict__ phase, const int* __restrict__ cell,
                   const int* __restrict__ begin, float* __restrict__ ace,
                   float* __restrict__ ar, float* __restrict__ viscdt,
                   float* __restrict__ etamax, float* __restrict__ shift,
                   unsigned char* __restrict__ shiftblk) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i < p.n) {
    nn_pass1_target<KER, SHIFT, true>(i, p, pospress, velrho, kind, phase,
                                      cell, begin, ace, ar, viscdt, nullptr,
                                      etamax, shift, shiftblk);
  }
}

template <int KER>
__global__ void __launch_bounds__(kBlock)
nnforce_p3_kernel(NnParams p, const F4* __restrict__ pospress,
                  const F4* __restrict__ velrho, const int* __restrict__ kind,
                  const int* __restrict__ phase, const int* __restrict__ cell,
                  const int* __restrict__ begin, const float* __restrict__ eta,
                  const float* __restrict__ tau, float* __restrict__ ace) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i < p.n) {
    nn_pass3_target<KER>(i, p, pospress, velrho, kind, phase, cell, begin,
                         eta, tau, ace);
  }
}

int nblocks(const NnParams* p) { return (p->n + kBlock - 1) / kBlock; }

template <int KER, bool SHIFT, bool kFda>
void launch_p1_one(const NnParams* p, const void* pospress, const void* velrho,
                   const void* kind, const void* phase, const void* cell,
                   const void* begin, void* ace, void* ar, void* viscdt,
                   void* last, void* shift, void* shiftblk, void* stream) {
  auto* kernel = kFda ? nnforce_fda_kernel<KER, SHIFT>
                      : nnforce_p1_kernel<KER, SHIFT>;
  kernel<<<nblocks(p), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      *p, static_cast<const F4*>(pospress), static_cast<const F4*>(velrho),
      static_cast<const int*>(kind), static_cast<const int*>(phase),
      static_cast<const int*>(cell), static_cast<const int*>(begin),
      static_cast<float*>(ace), static_cast<float*>(ar),
      static_cast<float*>(viscdt), static_cast<float*>(last),
      static_cast<float*>(shift), static_cast<unsigned char*>(shiftblk));
}

// Pass 1 or FDA (``last`` is gradvel or etamax): the instance of the
// parameters' kernel and shifting mode; cudaErrorInvalidValue for another
// kernel, or a shifting mode without its outputs.
template <bool kFda>
int launch_p1(const NnParams* p, const void* pospress, const void* velrho,
              const void* kind, const void* phase, const void* cell,
              const void* begin, void* ace, void* ar, void* viscdt, void* last,
              void* shift, void* shiftblk, void* stream) {
  const bool shifting = p->shiftmode != SHIFT_NONE;
  if ((p->tkernel != KER_WENDLAND && p->tkernel != KER_CUBIC)
      || (shifting && (shift == nullptr || shiftblk == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool cubic = p->tkernel == KER_CUBIC;
  auto* one = cubic ? (shifting ? launch_p1_one<KER_CUBIC, true, kFda>
                                : launch_p1_one<KER_CUBIC, false, kFda>)
                    : (shifting ? launch_p1_one<KER_WENDLAND, true, kFda>
                                : launch_p1_one<KER_WENDLAND, false, kFda>);
  one(p, pospress, velrho, kind, phase, cell, begin, ace, ar, viscdt, last,
      shift, shiftblk, stream);
  return static_cast<int>(cudaGetLastError());
}

template <int KER>
void launch_p3_one(const NnParams* p, const void* pospress, const void* velrho,
                   const void* kind, const void* phase, const void* cell,
                   const void* begin, const void* eta, const void* tau,
                   void* ace, void* stream) {
  nnforce_p3_kernel<KER>
      <<<nblocks(p), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
          *p, static_cast<const F4*>(pospress), static_cast<const F4*>(velrho),
          static_cast<const int*>(kind), static_cast<const int*>(phase),
          static_cast<const int*>(cell), static_cast<const int*>(begin),
          static_cast<const float*>(eta), static_cast<const float*>(tau),
          static_cast<float*>(ace));
}

}  // namespace

// Each launcher launches on `stream` and returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue when the parameters name a kernel it
// has no instance of or a shifting mode without shift and shiftblk.
// Inputs: pospress, velrho (n,4) f32, kind, phase, cell (n,) i32, begin
// (ncells+1,) i32, eta (n,) and tau (n,6) f32 (p3).  Outputs: ace (n,3), ar,
// viscdt (n,) f32, gradvel (n,6) f32 (p1), etamax (n,) f32 (FDA), shift
// (n,4) f32 and shiftblk (n,) u8 (with a shifting mode, else null).

extern "C" int dsph_nnforce_p1(const NnParams* p, const void* pospress,
                               const void* velrho, const void* kind,
                               const void* phase, const void* cell,
                               const void* begin, void* ace, void* ar,
                               void* viscdt, void* gradvel, void* shift,
                               void* shiftblk, void* stream) {
  return launch_p1<false>(p, pospress, velrho, kind, phase, cell, begin, ace,
                          ar, viscdt, gradvel, shift, shiftblk, stream);
}

extern "C" int dsph_nnforce_fda(const NnParams* p, const void* pospress,
                                const void* velrho, const void* kind,
                                const void* phase, const void* cell,
                                const void* begin, void* ace, void* ar,
                                void* viscdt, void* etamax, void* shift,
                                void* shiftblk, void* stream) {
  return launch_p1<true>(p, pospress, velrho, kind, phase, cell, begin, ace,
                         ar, viscdt, etamax, shift, shiftblk, stream);
}

extern "C" int dsph_nnforce_p3(const NnParams* p, const void* pospress,
                               const void* velrho, const void* kind,
                               const void* phase, const void* cell,
                               const void* begin, const void* eta,
                               const void* tau, void* ace, void* stream) {
  if (p->tkernel != KER_WENDLAND && p->tkernel != KER_CUBIC) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* one = p->tkernel == KER_CUBIC ? launch_p3_one<KER_CUBIC>
                                      : launch_p3_one<KER_WENDLAND>;
  one(p, pospress, velrho, kind, phase, cell, begin, eta, tau, ace, stream);
  return static_cast<int>(cudaGetLastError());
}
