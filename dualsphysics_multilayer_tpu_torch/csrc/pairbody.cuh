// Per-target WCSPH interaction over the cell-sorted layout, shared by the
// CUDA kernel (cellforce.cu, one thread per target) and its CPU twin
// (cellforce_host.cpp, a loop over targets, compiled with g++ for tests).
//
// Semantics are those of ops/pairphys.py pair_terms (reference
// JSphCpu.cpp:631-822) for the Wendland kernel with artificial viscosity
// and every density diffusion mode:
//   * boundary targets get no acceleration and no diffusion;
//   * boundary-boundary pairs contribute nothing, not even to viscdt;
//   * the artificial viscosity uses visco*viscoboundfactor for boundary
//     candidates and acts only on approaching pairs (dot < 0);
//   * fluid targets lose their whole diffusion term when any boundary
//     neighbour is in range (Molteni, Fourtakas; not Fourtakas-full) or,
//     with Molteni, any floating one; floating targets never diffuse;
//   * Fourtakas' hydrostatic correction uses the exact pow form
//     rho0*(1 + ddtgz*dz)^(1/gamma) - rho0.
// Divisions are exact.  Sums run in registers in f32, in the fixed order of
// walk_neighbours, so results are deterministic.
#pragma once

#include "cellwalk.cuh"

// Launch parameters.  Field order and types are mirrored by the ctypes
// Structure in ops/cuda/cellforce.py: keep both in step.
struct CfParams {
  int n;           // slots (targets)
  int ncx, ncy, ncz;
  int ncells;
  int sim2d;
  int tdensity;
  float kernelsize2;
  float kernelh;
  float bwen;
  float eta2;
  float cs0;
  float visco;
  float viscobound;  // visco * viscoboundfactor
  float ddtkh;
  float ddtgz;
  float rhopzero;
  float ovgamma;     // 1/gamma
  float massfluid;
  float massbound;
  float almostzero;
};

DSPH_HD void target_forces(int i, const CfParams& p,
                           const F4* __restrict__ pospress,
                           const F4* __restrict__ velrho,
                           const int* __restrict__ kind,
                           const int* __restrict__ cell,
                           const int* __restrict__ begin,
                           float* __restrict__ ace, float* __restrict__ ar,
                           float* __restrict__ viscdt) {
  float ax = 0.f, ay = 0.f, az = 0.f, arr = 0.f, dlt = 0.f;
  float vmax = -3.4e38f;
  bool blocked = false;
  const int ki = kind[i];
  const int c = cell[i];
  if (ki != KIND_DEAD && c < p.ncells) {
    const F4 pi = pospress[i];
    const F4 vi = velrho[i];
    const bool bound_t = ki < KIND_FLOATING;
    const bool ft_t = ki == KIND_FLOATING;
    walk_neighbours(c, p.ncx, p.ncy, p.ncz, p.sim2d, begin, [&](int j) {
      if (j == i) return;
      const int kj = kind[j];
      if (kj == KIND_DEAD) return;
      const bool bound_c = kj < KIND_FLOATING;
      if (bound_t && bound_c) return;
      const F4 pj = pospress[j];
      const float drx = pi.x - pj.x;
      const float dry = pi.y - pj.y;
      const float drz = pi.z - pj.z;
      const float rr2 = drx * drx + dry * dry + drz * drz;
      if (rr2 < p.almostzero || rr2 >= p.kernelsize2) return;
      const F4 vj = velrho[j];
      const bool ft_c = kj == KIND_FLOATING;
      const float fac = wendland_fac(rr2, p.kernelh, p.bwen);
      const float frx = fac * drx, fry = fac * dry, frz = fac * drz;
      const float dvx = vi.x - vj.x, dvy = vi.y - vj.y, dvz = vi.z - vj.z;
      const float dvfr = dvx * frx + dvy * fry + dvz * frz;
      const float dot = drx * dvx + dry * dvy + drz * dvz;
      const float dot_rr2 = dot / (rr2 + p.eta2);
      const float mass2 = bound_c ? p.massbound : p.massfluid;
      const float rhoi = vi.w, rhoj = vj.w;
      vmax = fmaxf(vmax, dot_rr2);
      // continuity (JSphCpu.cpp:720)
      arr += mass2 * dvfr * (rhoi / rhoj);
      if (bound_t) return;
      // momentum: pressure + artificial viscosity (JSphCpu.cpp:713-716,757-764)
      const float prs = (pi.w + pj.w) / (rhoi * rhoj);
      float cf = prs * mass2;
      if (dot < 0.f) {
        const float visco = bound_c ? p.viscobound : p.visco;
        const float amubar = p.kernelh * dot_rr2;
        const float robar = (rhoi + rhoj) * 0.5f;
        cf += (-visco * p.cs0 * amubar / robar) * mass2;
      }
      ax -= cf * frx;
      ay -= cf * fry;
      az -= cf * frz;
      if (p.tdensity == DDT_NONE || ft_t) return;
      const float drfr = drx * frx + dry * fry + drz * frz;
      if (p.tdensity == DDT_MOLTENI) {
        // Molteni & Colagrossi 2009 (JSphCpu.cpp:724-731), DBC walls
        const float vd = p.ddtkh * p.cs0 * (rhoi / rhoj - 1.f) / (rr2 + p.eta2);
        dlt += vd * drfr * mass2;
        blocked = blocked || bound_c || ft_c;
      } else {
        // Fourtakas et al. 2019 (JSphCpu.cpp:733-740)
        if (!bound_c && !ft_c) {
          const float rh = 1.f + p.ddtgz * drz;
          const float drhop = p.rhopzero * powf(rh, p.ovgamma) - p.rhopzero;
          const float vd = p.ddtkh * p.cs0 * ((rhoj - rhoi) - drhop) / (rr2 + p.eta2);
          dlt -= vd * drfr * mass2 / rhoj;
        }
        blocked = blocked || (bound_c && p.tdensity == DDT_FOURTAKAS);
      }
    });
    if (ft_t) blocked = true;
  }
  if (p.tdensity != DDT_NONE && !blocked) arr += dlt;
  ace[3 * i + 0] = ax;
  ace[3 * i + 1] = p.sim2d ? 0.f : ay;
  ace[3 * i + 2] = az;
  ar[i] = arr;
  viscdt[i] = vmax;
}
