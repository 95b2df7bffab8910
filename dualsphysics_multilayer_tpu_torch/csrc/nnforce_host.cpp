// CPU twins of nnforce.cu: the same per-target bodies (nnbody.cuh) run in a
// loop over targets, each launcher picking the instance of the parameters'
// kernel and shifting mode as the CUDA one does.  Built with g++ by
// ops/cuda/build.py so the kernels' arithmetic can be tested on a machine
// without a GPU.
#include "nnbody.cuh"

namespace {

// cudaErrorInvalidValue, the CUDA launchers' code for parameters they have
// no instance of.
constexpr int kInvalidValue = 1;

template <int KER, bool SHIFT, bool kFda>
void pass1_all(const NnParams* p, const void* pospress, const void* velrho,
               const void* kind, const void* phase, const void* cell,
               const void* begin, void* ace, void* ar, void* viscdt,
               void* last, void* shift, void* shiftblk) {
  for (int i = 0; i < p->n; ++i) {
    nn_pass1_target<KER, SHIFT, kFda>(
        i, *p, static_cast<const F4*>(pospress), static_cast<const F4*>(velrho),
        static_cast<const int*>(kind), static_cast<const int*>(phase),
        static_cast<const int*>(cell), static_cast<const int*>(begin),
        static_cast<float*>(ace), static_cast<float*>(ar),
        static_cast<float*>(viscdt), kFda ? nullptr : static_cast<float*>(last),
        kFda ? static_cast<float*>(last) : nullptr, static_cast<float*>(shift),
        static_cast<unsigned char*>(shiftblk));
  }
}

template <bool kFda>
int pass1(const NnParams* p, const void* pospress, const void* velrho,
          const void* kind, const void* phase, const void* cell,
          const void* begin, void* ace, void* ar, void* viscdt, void* last,
          void* shift, void* shiftblk) {
  const bool shifting = p->shiftmode != SHIFT_NONE;
  if ((p->tkernel != KER_WENDLAND && p->tkernel != KER_CUBIC)
      || (shifting && (shift == nullptr || shiftblk == nullptr))) {
    return kInvalidValue;
  }
  const bool cubic = p->tkernel == KER_CUBIC;
  auto* all = cubic ? (shifting ? pass1_all<KER_CUBIC, true, kFda>
                                : pass1_all<KER_CUBIC, false, kFda>)
                    : (shifting ? pass1_all<KER_WENDLAND, true, kFda>
                                : pass1_all<KER_WENDLAND, false, kFda>);
  all(p, pospress, velrho, kind, phase, cell, begin, ace, ar, viscdt, last,
      shift, shiftblk);
  return 0;
}

template <int KER>
void pass3_all(const NnParams* p, const void* pospress, const void* velrho,
               const void* kind, const void* phase, const void* cell,
               const void* begin, const void* eta, const void* tau, void* ace) {
  for (int i = 0; i < p->n; ++i) {
    nn_pass3_target<KER>(
        i, *p, static_cast<const F4*>(pospress), static_cast<const F4*>(velrho),
        static_cast<const int*>(kind), static_cast<const int*>(phase),
        static_cast<const int*>(cell), static_cast<const int*>(begin),
        static_cast<const float*>(eta), static_cast<const float*>(tau),
        static_cast<float*>(ace));
  }
}

}  // namespace

extern "C" int dsph_nnforce_p1_host(const NnParams* p, const void* pospress,
                                    const void* velrho, const void* kind,
                                    const void* phase, const void* cell,
                                    const void* begin, void* ace, void* ar,
                                    void* viscdt, void* gradvel, void* shift,
                                    void* shiftblk) {
  return pass1<false>(p, pospress, velrho, kind, phase, cell, begin, ace, ar,
                      viscdt, gradvel, shift, shiftblk);
}

extern "C" int dsph_nnforce_fda_host(const NnParams* p, const void* pospress,
                                     const void* velrho, const void* kind,
                                     const void* phase, const void* cell,
                                     const void* begin, void* ace, void* ar,
                                     void* viscdt, void* etamax, void* shift,
                                     void* shiftblk) {
  return pass1<true>(p, pospress, velrho, kind, phase, cell, begin, ace, ar,
                     viscdt, etamax, shift, shiftblk);
}

extern "C" int dsph_nnforce_p3_host(const NnParams* p, const void* pospress,
                                    const void* velrho, const void* kind,
                                    const void* phase, const void* cell,
                                    const void* begin, const void* eta,
                                    const void* tau, void* ace) {
  if (p->tkernel != KER_WENDLAND && p->tkernel != KER_CUBIC) {
    return kInvalidValue;
  }
  auto* all = p->tkernel == KER_CUBIC ? pass3_all<KER_CUBIC>
                                      : pass3_all<KER_WENDLAND>;
  all(p, pospress, velrho, kind, phase, cell, begin, eta, tau, ace);
  return 0;
}
