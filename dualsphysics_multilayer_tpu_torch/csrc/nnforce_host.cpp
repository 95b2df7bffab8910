// CPU twins of nnforce.cu: the same per-target bodies (nnbody.cuh) run in a
// loop over targets.  Built with g++ by ops/cuda/build.py so the kernels'
// arithmetic can be tested on a machine without a GPU.
#include "nnbody.cuh"

extern "C" int dsph_nnforce_p1_host(const NnParams* p, const void* pospress,
                                    const void* velrho, const void* kind,
                                    const void* phase, const void* cell,
                                    const void* begin, void* ace, void* ar,
                                    void* viscdt, void* gradvel) {
  for (int i = 0; i < p->n; ++i) {
    nn_pass1_target<false>(
        i, *p, static_cast<const F4*>(pospress), static_cast<const F4*>(velrho),
        static_cast<const int*>(kind), static_cast<const int*>(phase),
        static_cast<const int*>(cell), static_cast<const int*>(begin),
        static_cast<float*>(ace), static_cast<float*>(ar),
        static_cast<float*>(viscdt), static_cast<float*>(gradvel), nullptr);
  }
  return 0;
}

extern "C" int dsph_nnforce_fda_host(const NnParams* p, const void* pospress,
                                     const void* velrho, const void* kind,
                                     const void* phase, const void* cell,
                                     const void* begin, void* ace, void* ar,
                                     void* viscdt, void* etamax) {
  for (int i = 0; i < p->n; ++i) {
    nn_pass1_target<true>(
        i, *p, static_cast<const F4*>(pospress), static_cast<const F4*>(velrho),
        static_cast<const int*>(kind), static_cast<const int*>(phase),
        static_cast<const int*>(cell), static_cast<const int*>(begin),
        static_cast<float*>(ace), static_cast<float*>(ar),
        static_cast<float*>(viscdt), nullptr, static_cast<float*>(etamax));
  }
  return 0;
}

extern "C" int dsph_nnforce_p3_host(const NnParams* p, const void* pospress,
                                    const void* velrho, const void* kind,
                                    const void* phase, const void* cell,
                                    const void* begin, const void* eta,
                                    const void* tau, void* ace) {
  for (int i = 0; i < p->n; ++i) {
    nn_pass3_target(
        i, *p, static_cast<const F4*>(pospress), static_cast<const F4*>(velrho),
        static_cast<const int*>(kind), static_cast<const int*>(phase),
        static_cast<const int*>(cell), static_cast<const int*>(begin),
        static_cast<const float*>(eta), static_cast<const float*>(tau),
        static_cast<float*>(ace));
  }
  return 0;
}
