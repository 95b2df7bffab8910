// CPU twin of cellforce.cu: the same per-target body (pairbody.cuh) run in
// a loop over targets.  Built with g++ by ops/cuda/build.py so the kernel's
// arithmetic can be tested on a machine without a GPU.
#include "pairbody.cuh"

extern "C" int dsph_cellforce_host(const CfParams* p, const void* pospress,
                                   const void* velrho, const void* kind,
                                   const void* cell, const void* begin,
                                   void* ace, void* ar, void* viscdt) {
  for (int i = 0; i < p->n; ++i) {
    target_forces(i, *p, static_cast<const F4*>(pospress),
                  static_cast<const F4*>(velrho), static_cast<const int*>(kind),
                  static_cast<const int*>(cell), static_cast<const int*>(begin),
                  static_cast<float*>(ace), static_cast<float*>(ar),
                  static_cast<float*>(viscdt));
  }
  return 0;
}
