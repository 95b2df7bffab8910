// CPU twins of cellforce.cu: the same per-target body (pairbody.cuh), with
// its queue of in-support slots, run in a loop over targets, one function
// per CUDA launcher, with its arguments but the stream.  Built with g++ by
// ops/cuda/build.py so the kernels' arithmetic can be tested on a machine
// without a GPU.
#include "pairbody.cuh"

namespace {

// cudaErrorInvalidValue, as the CUDA launchers return it
constexpr int kInvalidValue = 1;

template <int KER, int VISC, bool SHIFT, bool FT, bool SYM>
void run_one(const CfParams* p, const void* pospress, const void* velrho,
             const void* kind, const void* cell, const void* begin,
             const void* tau, const void* ftmass, void* ace, void* ar,
             void* viscdt, void* gradvel, void* shift, void* shiftblk) {
  int q[kQueue];
  for (int i = 0; i < p->n; ++i) {
    target_forces<KER, VISC, SHIFT, FT, SYM>(
        i, *p, static_cast<const F4*>(pospress), static_cast<const F4*>(velrho),
        static_cast<const int*>(kind), static_cast<const int*>(cell),
        static_cast<const int*>(begin), static_cast<const float*>(tau),
        static_cast<const float*>(ftmass), static_cast<float*>(ace),
        static_cast<float*>(ar), static_cast<float*>(viscdt),
        static_cast<float*>(gradvel), static_cast<float*>(shift),
        static_cast<unsigned char*>(shiftblk), q);
  }
}

// the instance the CUDA launcher picks (cellforce.cu `pick`)
template <int KER, int VISC, bool SYM>
auto* pick(bool shifting, bool floating) {
  return shifting ? (floating ? run_one<KER, VISC, true, true, SYM>
                              : run_one<KER, VISC, true, false, SYM>)
                  : (floating ? run_one<KER, VISC, false, true, SYM>
                              : run_one<KER, VISC, false, false, SYM>);
}

template <int KER, int VISC>
int run(const CfParams* p, const void* pospress, const void* velrho,
        const void* kind, const void* cell, const void* begin, const void* tau,
        const void* ftmass, void* ace, void* ar, void* viscdt, void* gradvel,
        void* shift, void* shiftblk) {
  const bool shifting = p->shiftmode != SHIFT_NONE;
  const bool floating = ftmass != nullptr;
  auto* one = p->symmetry ? pick<KER, VISC, true>(shifting, floating)
                          : pick<KER, VISC, false>(shifting, floating);
  one(p, pospress, velrho, kind, cell, begin, tau, ftmass, ace, ar, viscdt,
      gradvel, shift, shiftblk);
  return 0;
}

}  // namespace

// Each twin takes its CUDA launcher's arguments but the stream.
#define DSPH_TWIN_ARGS                                                      \
  const CfParams *p, const void *pospress, const void *velrho,               \
      const void *kind, const void *cell, const void *begin, const void *tau, \
      const void *ftmass, void *ace, void *ar, void *viscdt, void *gradvel,   \
      void *shift, void *shiftblk
#define DSPH_TWIN_PASS                                                      \
  p, pospress, velrho, kind, cell, begin, tau, ftmass, ace, ar, viscdt,      \
      gradvel, shift, shiftblk

extern "C" int dsph_cellforce_host(DSPH_TWIN_ARGS) {
  if (p->tkernel != KER_WENDLAND) return kInvalidValue;
  return run<KER_WENDLAND, VISCO_ARTIFICIAL>(DSPH_TWIN_PASS);
}

extern "C" int dsph_cellforce_cubic_host(DSPH_TWIN_ARGS) {
  if (p->tkernel != KER_CUBIC) return kInvalidValue;
  return run<KER_CUBIC, VISCO_ARTIFICIAL>(DSPH_TWIN_PASS);
}

extern "C" int dsph_cellforce_lamsps_host(DSPH_TWIN_ARGS) {
  if (p->tkernel == KER_CUBIC) {
    return run<KER_CUBIC, VISCO_LAMINAR_SPS>(DSPH_TWIN_PASS);
  }
  return run<KER_WENDLAND, VISCO_LAMINAR_SPS>(DSPH_TWIN_PASS);
}
