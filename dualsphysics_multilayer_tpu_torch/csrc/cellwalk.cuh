// What the per-target pair bodies (pairbody.cuh, nnbody.cuh) share: the
// host/device qualifier, the particle kinds, the 16-byte particle rows, the
// Wendland gradient and the neighbour walk over the cell-sorted layout.
#pragma once

#include <math.h>

#if defined(__CUDACC__)
#define DSPH_HD __host__ __device__ __forceinline__
#else
#define DSPH_HD inline
#endif

// Density diffusion modes; values match typesdef.TpDensity.
enum { DDT_NONE = 0, DDT_MOLTENI = 1, DDT_FOURTAKAS = 2, DDT_FOURTAKAS_FULL = 3 };

// Particle kinds; values match typesdef.TYPE_*, and KIND_DEAD marks an
// inactive slot.
enum { KIND_DEAD = -1, KIND_FIXED = 0, KIND_MOVING = 1, KIND_FLOATING = 2,
       KIND_FLUID = 3 };

// One particle's position and pressure, or velocity and density: 16 bytes,
// read with one vector load on the card.
struct alignas(16) F4 { float x, y, z, w; };

// Wendland C2 (1/r) dW/dr at squared distance rr2 > 0.
DSPH_HD float wendland_fac(float rr2, float kernelh, float bwen) {
  const float rad = sqrtf(rr2);
  const float qq = rad / kernelh;
  const float wqq1 = 1.f - 0.5f * qq;
  return bwen * qq * wqq1 * wqq1 * wqq1 / rad;
}

// Calls visit(j) for every slot j of the neighbour rows of cell c: the 9
// (3 in 2D) (dy, dz) rows, dz-major then dy, each the contiguous slot range
// of its x-cells cx-1..cx+1 clamped to the grid, slots ascending.  The
// fixed order keeps the callers' f32 sums deterministic.
template <class Visit>
DSPH_HD void walk_neighbours(int c, int ncx, int ncy, int ncz, int sim2d,
                             const int* __restrict__ begin, Visit&& visit) {
  const int cx = c % ncx;
  const int cy = (c / ncx) % ncy;
  const int cz = c / (ncx * ncy);
  const int x0 = cx > 0 ? cx - 1 : 0;
  const int x1 = cx + 1 < ncx ? cx + 1 : ncx - 1;
  const int dy0 = sim2d ? 0 : -1;
  const int dy1 = sim2d ? 0 : 1;
  for (int dz = -1; dz <= 1; ++dz) {
    const int z = cz + dz;
    if (z < 0 || z >= ncz) continue;
    for (int dy = dy0; dy <= dy1; ++dy) {
      const int y = cy + dy;
      if (y < 0 || y >= ncy) continue;
      const int row = (z * ncy + y) * ncx;
      const int je = begin[row + x1 + 1];
      for (int j = begin[row + x0]; j < je; ++j) visit(j);
    }
  }
}
