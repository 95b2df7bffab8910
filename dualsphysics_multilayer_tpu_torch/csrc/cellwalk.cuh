// What the per-target pair bodies (pairbody.cuh, nnbody.cuh) share: the
// host/device qualifier, the particle kinds, the 16-byte particle rows, the
// two smoothing kernels (the Wendland gradient, the cubic spline with its
// tensile correction) and the neighbour walk over the cell-sorted layout,
// as a resumable cursor of one thread (NbrCursor) and as runs of a group of
// lanes that share one target (GroupWalk, group_run).
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

// Smoothing kernels and shifting modes; values match typesdef.TpKernel and
// TpShifting.
enum { KER_CUBIC = 1, KER_WENDLAND = 2 };
enum { SHIFT_NONE = 0, SHIFT_NO_BOUND = 1, SHIFT_NO_FIXED = 2, SHIFT_FULL = 3 };

// Cubic spline constants (typesdef.KCubicCte, FunSphKernel.h:51-84),
// embedded in both bodies' launch parameters (CfParams, NnParams) and
// mirrored by the ctypes Structure CubicCte in ops/cuda/cellforce.py.
struct CubicCte {
  float a2, a24, c1, d1, c2, od_wdeltap;
};

// Wendland C2 (1/r) dW/dr at squared distance rr2 > 0.
DSPH_HD float wendland_fac(float rr2, float kernelh, float bwen) {
  const float rad = sqrtf(rr2);
  const float qq = rad / kernelh;
  const float wqq1 = 1.f - 0.5f * qq;
  return bwen * qq * wqq1 * wqq1 * wqq1 / rad;
}

// Cubic spline (1/r) dW/dr and W at squared distance rr2 > 0.
DSPH_HD float cubic_fac(float rr2, float kernelh, const CubicCte& k) {
  const float rad = sqrtf(rr2);
  const float qq = rad / kernelh;
  const float wqq1 = 2.f - qq;
  const float f = rad > kernelh ? k.c2 * wqq1 * wqq1 : k.c1 * qq + k.d1 * qq * qq;
  return f / rad;
}

DSPH_HD float cubic_wab(float rr2, float kernelh, const CubicCte& k) {
  const float rad = sqrtf(rr2);
  const float qq = rad / kernelh;
  const float wqq1 = 2.f - qq;
  return rad > kernelh ? k.a24 * (wqq1 * wqq1 * wqq1)
                       : k.a2 * (1.f + (0.75f * qq - 1.5f) * (qq * qq));
}

// Tensile correction of the cubic spline (FunSphKernel.h:138-150), added
// to the pressure term (p1 + p2)/(rho1*rho2).
DSPH_HD float cubic_tensil(float rr2, float kernelh, const CubicCte& k,
                           float rho1, float press1, float rho2, float press2) {
  float fab = cubic_wab(rr2, kernelh, k) * k.od_wdeltap;
  fab = fab * fab;
  fab = fab * fab;
  const float t1 = (press1 / (rho1 * rho1)) * (press1 > 0.f ? 0.01f : -0.2f);
  const float t2 = (press2 / (rho2 * rho2)) * (press2 > 0.f ? 0.01f : -0.2f);
  return fab * (t1 + t2);
}

// (1/r) dW/dr of kernel KER, picked at compile time.
template <int KER>
DSPH_HD float kernel_fac(float rr2, float kernelh, float bwen,
                         const CubicCte& k) {
  if constexpr (KER == KER_WENDLAND) {
    return wendland_fac(rr2, kernelh, bwen);
  } else {
    return cubic_fac(rr2, kernelh, k);
  }
}

// The neighbour walk of cell c as a cursor that can stop and resume: the 9
// (3 in 2D) (dy, dz) rows, dz-major then dy, each the contiguous slot range
// of its x-cells cx-1..cx+1 clamped to the grid, slots ascending; this
// fixed order keeps the callers' f32 sums deterministic.  Each next(j0, n)
// takes the following run of at most n slots of the open row, j0 ..
// j0+m-1, and returns m, opening the next row when the open one is done;
// it returns 0 once every row is done.
struct NbrCursor {
  const int* begin;
  int ncx, ncy, ncz;
  int cy, cz, x0, x1;
  int dy, dz, dy0, dy1;  // the next row to open
  int j, je;             // the open row's next slot and its end

  DSPH_HD void init(int c, int ncx_, int ncy_, int ncz_, int sim2d,
                    const int* __restrict__ begin_) {
    begin = begin_;
    ncx = ncx_;
    ncy = ncy_;
    ncz = ncz_;
    const int cx = c % ncx;
    cy = (c / ncx) % ncy;
    cz = c / (ncx * ncy);
    x0 = cx > 0 ? cx - 1 : 0;
    x1 = cx + 1 < ncx ? cx + 1 : ncx - 1;
    dy0 = sim2d ? 0 : -1;
    dy1 = sim2d ? 0 : 1;
    dy = dy0;
    dz = -1;
    j = je = 0;
  }

  DSPH_HD int next(int& j0, int n) {
    while (j >= je) {
      if (dz > 1) return 0;
      const int z = cz + dz;
      const int y = cy + dy;
      if (++dy > dy1) {
        dy = dy0;
        ++dz;
      }
      if (z < 0 || z >= ncz || y < 0 || y >= ncy) continue;
      const int row = (z * ncy + y) * ncx;
      j = begin[row + x0];
      je = begin[row + x1 + 1];
    }
    const int m = je - j < n ? je - j : n;
    j0 = j;
    j += m;
    return m;
  }
};

// Group helpers: a group of `lanes` lanes (a power of two up to 32, lanes
// g = 0 .. lanes-1 of one warp) walks one target's rows together, each lane
// with its own copy of the walk's state.

// NbrCursor's walk (the same rows in the same order) in four registers per
// lane: the target cell's row coordinates packed in two (cy | cz << 16;
// x0 | (x1 - x0) << 24 | the next row to open << 26, dz-major, then dy)
// and the open row's slots; the grid and the begin index come in at each
// call (launch parameters on the card, so no register holds them).  The
// grid must have ncx < 2^24 and ncy, ncz < 2^16 (group_walk_fits).
struct GroupWalk {
  int yz, xr;
  int j, je;   // the open row's next slot and its end

  DSPH_HD void init(int c, int ncx, int ncy) {
    const int cx = c % ncx;
    const int x0 = cx > 0 ? cx - 1 : 0;
    const int x1 = cx + 1 < ncx ? cx + 1 : ncx - 1;
    yz = (c / ncx) % ncy | (c / (ncx * ncy)) << 16;
    xr = x0 | (x1 - x0) << 24;
    j = je = 0;
  }

  // As NbrCursor::next: the following run of at most n slots, j0 ..
  // j0+m-1; returns m, 0 once every row is done.
  DSPH_HD int next(int& j0, int n, int ncx, int ncy, int ncz, int sim2d,
                   const int* __restrict__ begin) {
    while (j >= je) {
      const int row = xr >> 26;
      if (row >= (sim2d ? 3 : 9)) return 0;
      xr += 1 << 26;
      const int cy = yz & 0xffff, cz = yz >> 16;
      const int z = cz + (sim2d ? row : row / 3) - 1;
      const int y = sim2d ? cy : cy + row % 3 - 1;
      if (z < 0 || z >= ncz || y < 0 || y >= ncy) continue;
      const int x0 = xr & 0xffffff;
      const int r = (z * ncy + y) * ncx;
      j = begin[r + x0];
      je = begin[r + x0 + ((xr >> 24) & 3) + 1];
    }
    const int m = je - j < n ? je - j : n;
    j0 = j;
    j += m;
    return m;
  }
};

// The grid dimensions GroupWalk packs.
DSPH_HD bool group_walk_fits(int ncx, int ncy, int ncz) {
  return ncx < (1 << 24) && ncy < (1 << 16) && ncz < (1 << 16);
}

// The group's next run: up to `lanes` slots in walk order, crossing row
// ends, lane g taking the g-th as j (when g is below the count returned).
// The count is below `lanes` only where the walk ends.  Every lane of the
// group calls it with the same walk state, so all advance alike.
DSPH_HD int group_run(GroupWalk& w, int lanes, int g, int& j, int ncx,
                      int ncy, int ncz, int sim2d,
                      const int* __restrict__ begin) {
  if (w.je - w.j >= lanes) {   // the open row holds the whole run
    j = w.j + g;
    w.j += lanes;
    return lanes;
  }
  int filled = 0;
  while (filled < lanes) {
    int j0 = 0;
    const int m = w.next(j0, lanes - filled, ncx, ncy, ncz, sim2d, begin);
    if (m == 0) break;
    if (g >= filled && g < filled + m) j = j0 + g - filled;
    filled += m;
  }
  return filled;
}

// Set bits of v.
DSPH_HD int popcount(unsigned v) {
#if defined(__CUDA_ARCH__)
  return __popc(v);
#else
  return __builtin_popcount(v);
#endif
}
