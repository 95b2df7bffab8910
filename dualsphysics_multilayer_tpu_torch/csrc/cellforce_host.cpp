// CPU twins of cellforce.cu: the same per-target body (pairbody.cuh) run in
// a loop over targets, one function per CUDA launcher, with its arguments
// but the stream.  Built with g++ by ops/cuda/build.py so the kernels'
// arithmetic can be tested on a machine without a GPU.
#include "pairbody.cuh"

namespace {

template <int KER, int VISC, bool SHIFT>
void run_one(const CfParams* p, const void* pospress, const void* velrho,
             const void* kind, const void* cell, const void* begin,
             const void* tau, void* ace, void* ar, void* viscdt, void* gradvel,
             void* shift, void* shiftblk) {
  for (int i = 0; i < p->n; ++i) {
    target_forces<KER, VISC, SHIFT>(
        i, *p, static_cast<const F4*>(pospress), static_cast<const F4*>(velrho),
        static_cast<const int*>(kind), static_cast<const int*>(cell),
        static_cast<const int*>(begin), static_cast<const float*>(tau),
        static_cast<float*>(ace), static_cast<float*>(ar),
        static_cast<float*>(viscdt), static_cast<float*>(gradvel),
        static_cast<float*>(shift), static_cast<unsigned char*>(shiftblk));
  }
}

template <int KER, int VISC>
int run(const CfParams* p, const void* pospress, const void* velrho,
        const void* kind, const void* cell, const void* begin, const void* tau,
        void* ace, void* ar, void* viscdt, void* gradvel, void* shift,
        void* shiftblk) {
  if (p->shiftmode != SHIFT_NONE) {
    run_one<KER, VISC, true>(p, pospress, velrho, kind, cell, begin, tau, ace,
                             ar, viscdt, gradvel, shift, shiftblk);
  } else {
    run_one<KER, VISC, false>(p, pospress, velrho, kind, cell, begin, tau, ace,
                              ar, viscdt, gradvel, shift, shiftblk);
  }
  return 0;
}

// cudaErrorInvalidValue, as the CUDA launchers return it
constexpr int kInvalidValue = 1;

}  // namespace

extern "C" int dsph_cellforce_host(const CfParams* p, const void* pospress,
                                   const void* velrho, const void* kind,
                                   const void* cell, const void* begin,
                                   const void* tau, void* ace, void* ar,
                                   void* viscdt, void* gradvel, void* shift,
                                   void* shiftblk) {
  if (p->tkernel != KER_WENDLAND) return kInvalidValue;
  return run<KER_WENDLAND, VISCO_ARTIFICIAL>(p, pospress, velrho, kind, cell,
                                            begin, tau, ace, ar, viscdt,
                                            gradvel, shift, shiftblk);
}

extern "C" int dsph_cellforce_cubic_host(const CfParams* p, const void* pospress,
                                         const void* velrho, const void* kind,
                                         const void* cell, const void* begin,
                                         const void* tau, void* ace, void* ar,
                                         void* viscdt, void* gradvel,
                                         void* shift, void* shiftblk) {
  if (p->tkernel != KER_CUBIC) return kInvalidValue;
  return run<KER_CUBIC, VISCO_ARTIFICIAL>(p, pospress, velrho, kind, cell, begin,
                                         tau, ace, ar, viscdt, gradvel, shift,
                                         shiftblk);
}

extern "C" int dsph_cellforce_lamsps_host(const CfParams* p, const void* pospress,
                                          const void* velrho, const void* kind,
                                          const void* cell, const void* begin,
                                          const void* tau, void* ace, void* ar,
                                          void* viscdt, void* gradvel,
                                          void* shift, void* shiftblk) {
  if (p->tkernel == KER_CUBIC) {
    return run<KER_CUBIC, VISCO_LAMINAR_SPS>(p, pospress, velrho, kind, cell,
                                            begin, tau, ace, ar, viscdt,
                                            gradvel, shift, shiftblk);
  }
  return run<KER_WENDLAND, VISCO_LAMINAR_SPS>(p, pospress, velrho, kind, cell,
                                             begin, tau, ace, ar, viscdt,
                                             gradvel, shift, shiftblk);
}
