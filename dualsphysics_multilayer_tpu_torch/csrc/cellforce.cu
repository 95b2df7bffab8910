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
// the parameters name mDBC walls; each also takes the lateral symmetry
// plane y = 0 (SYM instances, with or without shifting and floating bodies)
// when the parameters' symmetry field is set.  The TPU kernels had no
// symmetry: the JAX package ran it on its bucket path only.  The outputs
// are the TPU kernels':
// momentum, continuity with the density diffusion folded in, viscdt, and
// the SPS gradient and shifting sums where asked, over the GPU layout of
// the original DualSPHysics solver
// (state sorted by cell, a begin index per cell) instead of the TPU's
// row-padded lane windows.  The per-pair arithmetic lives in pairbody.cuh,
// one template shared with the g++-built CPU twins.
//
// What bounds it on the card: the candidate walk, not bytes (its bytes
// bound is ~5 us) and not the pair arithmetic alone.  Each target walks 9
// neighbour rows of 3 cells, ~967 candidates at 267,469 particles, to find
// ~129 pairs; the 32 lanes of a warp hold neighbouring targets and walk
// nearly the same candidates.  Run as one walk with the pair body inline,
// the warp ran the ~100-line body whenever any lane held a pair, with ~28%
// of its lanes active, and each candidate's two loads (kind, then
// position) stood in one dependent chain.  The design here, measured on the
// H100 against that walk (port_bodytime.py, in turns):
//   * each lane filters its candidates into a queue of in-support slots and
//     runs the body over the queue, so the body runs on lanes that hold a
//     pair;
//   * the lanes stay in step: they filter kRun candidates per turn with all
//     their loads in flight together, and the warp drains every queue at
//     once, when one has no room for another run or when every walk has
//     ended (a warp vote, so every lane runs the loop, past the last slot
//     too).  Lanes that drained on their own drifted apart, lost the shared
//     loads of one cell's lanes and ran up to 26% slower than the inline
//     walk; one candidate per turn in step was still up to 11% slower, and
//     runs of 4 with the body inline 8-15% slower;
//   * the queue is kQueue = 96 slots per thread in local memory: longer
//     queues mean fewer drains in which lanes wait for the fullest queue
//     (kernel 1 with 32 slots: -11% time; 64: -20%; 96: -22%; 128: -19%).
//     At 32 slots, shared and local memory ran within 3% of each other;
//     96 slots of shared memory would take 48 KB a block.
// Kernel 1 takes ~22% less time than the inline walk, kernel 2 ~16%,
// kernel 3 ~21%, with bit-equal outputs.  The variants add registers
// (6 gradient and 4 shifting sums, 6 stress values of the target), not
// loads per candidate.  The floating mass is one load per floating
// candidate in support, in instances of their own (FT): a runtime test in
// every instance cost the main path's one a register and 2-3% of its time.
// The symmetry plane is a template parameter (SYM) for the same reason: a
// target near y = 0 queues each candidate's image beside the candidate, a
// flag bit in the queued slot, and the body takes the image's dr_y and
// dv_y; the other instances compile as they did.
#include <cuda_runtime.h>

#include "pairbody.cuh"

namespace {

constexpr int kBlock = 128;

template <int KER, int VISC, bool SHIFT, bool FT, bool SYM>
__global__ void __launch_bounds__(kBlock)
cellforce_kernel(CfParams p, const F4* __restrict__ pospress,
                 const F4* __restrict__ velrho, const int* __restrict__ kind,
                 const int* __restrict__ cell, const int* __restrict__ begin,
                 const float* __restrict__ tau,
                 const float* __restrict__ ftmass, float* __restrict__ ace,
                 float* __restrict__ ar, float* __restrict__ viscdt,
                 float* __restrict__ gradvel, float* __restrict__ shift,
                 unsigned char* __restrict__ shiftblk) {
  // the queue is a per-thread array in local memory, which the card lays
  // out so that entry k of a warp's 32 lanes is one contiguous 128 bytes
  int q[kQueue];
  // every lane runs the body, past the last slot too: the queues drain
  // when the whole warp decides
  const int i = blockIdx.x * kBlock + threadIdx.x;
  target_forces<KER, VISC, SHIFT, FT, SYM>(i, p, pospress, velrho, kind,
                                           cell, begin, tau, ftmass, ace, ar,
                                           viscdt, gradvel, shift, shiftblk,
                                           q);
}

template <int KER, int VISC, bool SHIFT, bool FT, bool SYM>
void launch_one(const CfParams* p, const void* pospress, const void* velrho,
                const void* kind, const void* cell, const void* begin,
                const void* tau, const void* ftmass, void* ace, void* ar,
                void* viscdt, void* gradvel, void* shift, void* shiftblk,
                void* stream) {
  const int nblocks = (p->n + kBlock - 1) / kBlock;
  cellforce_kernel<KER, VISC, SHIFT, FT, SYM>
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
// when ftmass is not null, the SYM one when the parameters' symmetry field
// is set: one of eight instances per (KER, VISC), picked here and never
// tested inside the kernel.  Returns cudaGetLastError() (0 on success).
template <int KER, int VISC, bool SYM>
auto* pick(bool shifting, bool floating) {
  return shifting ? (floating ? launch_one<KER, VISC, true, true, SYM>
                              : launch_one<KER, VISC, true, false, SYM>)
                  : (floating ? launch_one<KER, VISC, false, true, SYM>
                              : launch_one<KER, VISC, false, false, SYM>);
}

template <int KER, int VISC>
int launch(const CfParams* p, const void* pospress, const void* velrho,
           const void* kind, const void* cell, const void* begin,
           const void* tau, const void* ftmass, void* ace, void* ar,
           void* viscdt, void* gradvel, void* shift, void* shiftblk,
           void* stream) {
  const bool shifting = p->shiftmode != SHIFT_NONE;
  const bool floating = ftmass != nullptr;
  auto* one = p->symmetry ? pick<KER, VISC, true>(shifting, floating)
                          : pick<KER, VISC, false>(shifting, floating);
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
