// WCSPH pair interaction for Hopper (sm_90a), one thread per target.
//
// Replaces three TPU kernels of
// dualsphysics_multilayer_tpu/ops/pallas/cellforce.py, one C launcher each:
//   * dsph_cellforce: `_kernel_v3` with its fast pair body `_make_phys_v4`
//     (Wendland, artificial viscosity);
//   * dsph_cellforce_cubic: `_kernel_v3` with `_make_phys_v3` (the cubic
//     spline with its tensile correction, artificial viscosity);
//   * dsph_cellforce_lamsps: the v1 `_kernel` (laminar viscosity, the SPS
//     stress divergence and the SPS velocity gradient; either kernel).
// Each takes the shifting sums when the launch parameters name a shifting
// mode, the floating bodies' particle masses (the TPU kernels' ftomassp
// channel) when given them, and the mDBC form of the Molteni diffusion when
// the parameters name mDBC walls.  The outputs are the TPU kernels':
// momentum, continuity with the density diffusion folded in, viscdt, and
// the SPS gradient and shifting sums where asked, over the GPU layout of
// the original DualSPHysics solver
// (state sorted by cell, a begin index per cell) instead of the TPU's
// row-padded lane windows.  The per-pair arithmetic lives in pairbody.cuh,
// one template shared with the g++-built CPU twins.
//
// What bounds it on the card: gathers of candidate fields through L1/L2.
// Each target walks 9 neighbour rows of 3 cells, about 27 x (cell occupancy)
// candidates, of which about a tenth lie inside the kernel support; every
// candidate costs one 16-byte position load and one kind load before the
// distance test, and an in-support pair one 16-byte velocity load (plus 24
// bytes of SPS stress under laminar+SPS).  The sorted layout is what makes
// this cheap: threads of one warp hold neighbouring targets, in the same or
// adjacent cells, so they read overlapping contiguous slot ranges and the
// loads of a warp coalesce and hit in cache.  The variants add registers
// (6 gradient and 4 shifting sums, 6 stress values of the target), not
// loads per candidate.  The floating mass is one load per floating
// candidate in support, in instances of their own (FT): a runtime test in
// every instance cost the main path's one a register (63 against 62) and
// 2-3% of its time on the H100.
#include <cuda_runtime.h>

#include "pairbody.cuh"

namespace {

constexpr int kBlock = 128;

template <int KER, int VISC, bool SHIFT, bool FT>
__global__ void __launch_bounds__(kBlock)
cellforce_kernel(CfParams p, const F4* __restrict__ pospress,
                 const F4* __restrict__ velrho, const int* __restrict__ kind,
                 const int* __restrict__ cell, const int* __restrict__ begin,
                 const float* __restrict__ tau,
                 const float* __restrict__ ftmass, float* __restrict__ ace,
                 float* __restrict__ ar, float* __restrict__ viscdt,
                 float* __restrict__ gradvel, float* __restrict__ shift,
                 unsigned char* __restrict__ shiftblk) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i < p.n) {
    target_forces<KER, VISC, SHIFT, FT>(i, p, pospress, velrho, kind, cell,
                                        begin, tau, ftmass, ace, ar, viscdt,
                                        gradvel, shift, shiftblk);
  }
}

template <int KER, int VISC, bool SHIFT, bool FT>
void launch_one(const CfParams* p, const void* pospress, const void* velrho,
                const void* kind, const void* cell, const void* begin,
                const void* tau, const void* ftmass, void* ace, void* ar,
                void* viscdt, void* gradvel, void* shift, void* shiftblk,
                void* stream) {
  const int nblocks = (p->n + kBlock - 1) / kBlock;
  cellforce_kernel<KER, VISC, SHIFT, FT>
      <<<nblocks, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
          *p, static_cast<const F4*>(pospress), static_cast<const F4*>(velrho),
          static_cast<const int*>(kind), static_cast<const int*>(cell),
          static_cast<const int*>(begin), static_cast<const float*>(tau),
          static_cast<const float*>(ftmass), static_cast<float*>(ace),
          static_cast<float*>(ar), static_cast<float*>(viscdt),
          static_cast<float*>(gradvel), static_cast<float*>(shift),
          static_cast<unsigned char*>(shiftblk));
}

// The SHIFT instance when the parameters name a shifting mode, the FT one
// when ftmass is not null; returns cudaGetLastError() (0 on success).
template <int KER, int VISC>
int launch(const CfParams* p, const void* pospress, const void* velrho,
           const void* kind, const void* cell, const void* begin,
           const void* tau, const void* ftmass, void* ace, void* ar,
           void* viscdt, void* gradvel, void* shift, void* shiftblk,
           void* stream) {
  const bool shifting = p->shiftmode != SHIFT_NONE;
  const bool floating = ftmass != nullptr;
  auto* one = shifting ? (floating ? launch_one<KER, VISC, true, true>
                                   : launch_one<KER, VISC, true, false>)
                       : (floating ? launch_one<KER, VISC, false, true>
                                   : launch_one<KER, VISC, false, false>);
  one(p, pospress, velrho, kind, cell, begin, tau, ftmass, ace, ar, viscdt,
      gradvel, shift, shiftblk, stream);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`.  Inputs: pospress, velrho (n,4) f32, kind, cell (n,)
// i32, begin (ncells+1,) i32, tau (n,6) f32 (laminar+SPS, else null),
// ftmass (n,) f32 (the particle mass of each floating slot when the run has
// floating bodies, else null).
// Outputs: ace (n,3), ar (n,), viscdt (n,) f32, gradvel (n,6) f32
// (laminar+SPS, else null), shift (n,4) f32 and shiftblk (n,) u8 (with a
// shifting mode, else null).  Returns the CUDA error code, 0 on success,
// cudaErrorInvalidValue when the parameters name another kernel.
extern "C" int dsph_cellforce(const CfParams* p, const void* pospress,
                              const void* velrho, const void* kind,
                              const void* cell, const void* begin,
                              const void* tau, const void* ftmass,
                              void* ace, void* ar, void* viscdt,
                              void* gradvel, void* shift, void* shiftblk,
                              void* stream) {
  if (p->tkernel != KER_WENDLAND) return static_cast<int>(cudaErrorInvalidValue);
  return launch<KER_WENDLAND, VISCO_ARTIFICIAL>(p, pospress, velrho, kind, cell,
                                               begin, tau, ftmass, ace, ar,
                                               viscdt, gradvel, shift, shiftblk,
                                               stream);
}

extern "C" int dsph_cellforce_cubic(const CfParams* p, const void* pospress,
                                    const void* velrho, const void* kind,
                                    const void* cell, const void* begin,
                                    const void* tau, const void* ftmass,
                                    void* ace, void* ar, void* viscdt,
                                    void* gradvel, void* shift, void* shiftblk,
                                    void* stream) {
  if (p->tkernel != KER_CUBIC) return static_cast<int>(cudaErrorInvalidValue);
  return launch<KER_CUBIC, VISCO_ARTIFICIAL>(p, pospress, velrho, kind, cell,
                                            begin, tau, ftmass, ace, ar,
                                            viscdt, gradvel, shift, shiftblk,
                                            stream);
}

extern "C" int dsph_cellforce_lamsps(const CfParams* p, const void* pospress,
                                     const void* velrho, const void* kind,
                                     const void* cell, const void* begin,
                                     const void* tau, const void* ftmass,
                                     void* ace, void* ar, void* viscdt,
                                     void* gradvel, void* shift,
                                     void* shiftblk, void* stream) {
  if (p->tkernel == KER_CUBIC) {
    return launch<KER_CUBIC, VISCO_LAMINAR_SPS>(p, pospress, velrho, kind, cell,
                                               begin, tau, ftmass, ace, ar,
                                               viscdt, gradvel, shift, shiftblk,
                                               stream);
  }
  return launch<KER_WENDLAND, VISCO_LAMINAR_SPS>(p, pospress, velrho, kind, cell,
                                                begin, tau, ftmass, ace, ar,
                                                viscdt, gradvel, shift, shiftblk,
                                                stream);
}
