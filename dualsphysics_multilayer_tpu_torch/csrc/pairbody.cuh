// Per-target WCSPH interaction over the cell-sorted layout, shared by the
// CUDA kernels (cellforce.cu, one thread per target) and their CPU twins
// (cellforce_host.cpp, a loop over targets, compiled with g++ for tests).
//
// Semantics are those of ops/pairphys.py pair_terms (reference
// JSphCpu.cpp:631-822).  One body, four template parameters:
//   * KER: the Wendland C2 kernel, or the cubic spline with its tensile
//     correction added to the pressure term (FunSphKernel.h:104-150);
//   * VISC: artificial viscosity, or the laminar operator with the SPS
//     stress divergence and the 6-component velocity gradient
//     (JSphCpu.cpp:757-791);
//   * SHIFT: the four shifting sums and the blocked flag of the shifting
//     mode in the launch parameters (JSphCpu.cpp:743-750);
//   * FT: the run has floating bodies, and a floating candidate reads its
//     mass from ftmass (the TPU kernels' ftomassp channel); the launcher
//     picks FT when ftmass is not null.  Without FT the body is the one
//     without floating bodies, so the runs that have none keep its
//     registers and time.
// Rules every instance keeps:
//   * boundary targets get only continuity and viscdt;
//   * boundary-boundary pairs contribute nothing, not even to viscdt;
//   * both viscosities use visco*viscoboundfactor for boundary candidates;
//     the artificial one acts only on approaching pairs (dot < 0);
//   * fluid targets lose their whole diffusion term when any boundary
//     neighbour is in range (Molteni under DBC walls, Fourtakas; not
//     Fourtakas-full) or, with Molteni, any floating one; under mDBC walls a
//     boundary neighbour adds its Molteni term instead (the JAX bucket path,
//     pairphys.py:107-116); floating targets never diffuse;
//   * a floating candidate's mass is its body's particle mass from ftmass
//     (n,) with FT, else massfluid, as a fluid candidate's;
//   * Fourtakas' hydrostatic correction uses the exact pow form
//     rho0*(1 + ddtgz*dz)^(1/gamma) - rho0;
//   * the SPS stress of a candidate counts only for fluid candidates; the
//     velocity gradient is summed for fluid targets only;
//   * shifting: floating targets are always blocked; NO_BOUND blocks a
//     target with a boundary or floating neighbour, NO_FIXED one with a
//     fixed neighbour, FULL never.
// Divisions are exact.  Sums run in registers in f32, in the fixed order of
// the neighbour walk (NbrCursor), so results are deterministic.
// The sum order is the walk order: each target filters its candidates into
// a queue of in-support slots and drains the queue through the pair body in
// the order it was filled.
#pragma once

#include "cellwalk.cuh"

// Viscosity modes; values match typesdef.TpVisco (the kernels, KER_*, and
// the shifting modes, SHIFT_*, are in cellwalk.cuh).
enum { VISCO_ARTIFICIAL = 1, VISCO_LAMINAR_SPS = 2 };
// Boundary conditions; values match typesdef.TpBoundary.
enum { BOUNDARY_DBC = 1, BOUNDARY_MDBC = 2 };

// In-support slots a target queues before it runs the pair body over them,
// and the candidates it filters at a time.
constexpr int kQueue = 96;
constexpr int kRun = 4;

// True when v holds on any lane of the calling warp; every lane of the warp
// calls it together.  On the host a thread is a warp of one.
DSPH_HD bool warp_any(bool v) {
#if defined(__CUDA_ARCH__)
  return __any_sync(0xffffffffu, v);
#else
  return v;
#endif
}

// Launch parameters.  Field order and types are mirrored by the ctypes
// Structure in ops/cuda/cellforce.py: keep both in step.
struct CfParams {
  int n;           // slots (targets)
  int ncx, ncy, ncz;
  int ncells;
  int sim2d;
  int tdensity;
  int tkernel;
  int shiftmode;
  int tboundary;
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
  CubicCte cubic;
};

// Target i's sums.  tau (n,6) is read and gradvel (n,6) written only with
// VISCO_LAMINAR_SPS; shift (n,4) and shiftblk (n,) only with SHIFT; ftmass
// (n,) only with FT, at floating candidates.  q is the caller's queue of
// kQueue slots.  On the card every lane of a warp calls it, i >= n
// included (such a lane walks nothing and writes nothing), as the drains
// are decided by the whole warp.
template <int KER, int VISC, bool SHIFT, bool FT>
DSPH_HD void target_forces(int i, const CfParams& p,
                           const F4* __restrict__ pospress,
                           const F4* __restrict__ velrho,
                           const int* __restrict__ kind,
                           const int* __restrict__ cell,
                           const int* __restrict__ begin,
                           const float* __restrict__ tau,
                           const float* __restrict__ ftmass,
                           float* __restrict__ ace, float* __restrict__ ar,
                           float* __restrict__ viscdt,
                           float* __restrict__ gradvel,
                           float* __restrict__ shift,
                           unsigned char* __restrict__ shiftblk,
                           int* __restrict__ q) {
  float ax = 0.f, ay = 0.f, az = 0.f, arr = 0.f, dlt = 0.f;
  float vmax = -3.4e38f;
  bool blocked = false;
  // laminar+SPS: velocity-gradient sums
  float gxx = 0.f, gxy = 0.f, gxz = 0.f, gyy = 0.f, gyz = 0.f, gzz = 0.f;
  // shifting sums and flag
  float shx = 0.f, shy = 0.f, shz = 0.f, shc = 0.f;
  bool sblk = false;
  const bool slot = i < p.n;
  const int ki = slot ? kind[i] : KIND_DEAD;
  const int c = slot ? cell[i] : p.ncells;
  const bool walks = ki != KIND_DEAD && c < p.ncells;
  F4 pi = {0.f, 0.f, 0.f, 0.f}, vi = {0.f, 0.f, 0.f, 0.f};
  if (walks) {
    pi = pospress[i];
    vi = velrho[i];
  }
  const bool bound_t = ki < KIND_FLOATING;
  const bool ft_t = ki == KIND_FLOATING;
  // the target's SPS stress, read once (fluid-side targets only)
  float ti0 = 0.f, ti1 = 0.f, ti2 = 0.f, ti3 = 0.f, ti4 = 0.f, ti5 = 0.f;
  if constexpr (VISC == VISCO_LAMINAR_SPS) {
    if (walks && !bound_t) {
      const float* t = tau + 6 * i;
      ti0 = t[0]; ti1 = t[1]; ti2 = t[2]; ti3 = t[3]; ti4 = t[4]; ti5 = t[5];
    }
  }
  // the filter: candidate j, of kind kj at pj, is a pair of target i
  auto in_support = [&](int j, int kj, const F4& pj) {
    if (j == i) return false;
    if (kj == KIND_DEAD) return false;
    if (bound_t && kj < KIND_FLOATING) return false;
    const float drx = pi.x - pj.x;
    const float dry = pi.y - pj.y;
    const float drz = pi.z - pj.z;
    const float rr2 = drx * drx + dry * dry + drz * drz;
    return rr2 >= p.almostzero && rr2 < p.kernelsize2;
  };
  // the pair body, on a pair the filter passed
  auto pair = [&](int j) {
    const int kj = kind[j];
    const bool bound_c = kj < KIND_FLOATING;
    const F4 pj = pospress[j];
    const float drx = pi.x - pj.x;
    const float dry = pi.y - pj.y;
    const float drz = pi.z - pj.z;
    const float rr2 = drx * drx + dry * dry + drz * drz;
    const F4 vj = velrho[j];
    const bool ft_c = kj == KIND_FLOATING;
    const float fac = kernel_fac<KER>(rr2, p.kernelh, p.bwen, p.cubic);
    const float frx = fac * drx, fry = fac * dry, frz = fac * drz;
    const float dvx = vi.x - vj.x, dvy = vi.y - vj.y, dvz = vi.z - vj.z;
    const float dvfr = dvx * frx + dvy * fry + dvz * frz;
    const float dot = drx * dvx + dry * dvy + drz * dvz;
    const float dot_rr2 = dot / (rr2 + p.eta2);
    float mass2 = bound_c ? p.massbound : p.massfluid;
    if constexpr (FT) {
      if (ft_c) mass2 = ftmass[j];
    }
    const float rhoi = vi.w, rhoj = vj.w;
    vmax = fmaxf(vmax, dot_rr2);
    // continuity (JSphCpu.cpp:720)
    arr += mass2 * dvfr * (rhoi / rhoj);
    if (bound_t) return;
    // momentum: pressure (+ tensile correction) and artificial viscosity
    // (JSphCpu.cpp:713-716,757-764)
    float prs = (pi.w + pj.w) / (rhoi * rhoj);
    if constexpr (KER == KER_CUBIC) {
      prs += cubic_tensil(rr2, p.kernelh, p.cubic, rhoi, pi.w, rhoj, pj.w);
    }
    float cf = prs * mass2;
    if constexpr (VISC == VISCO_ARTIFICIAL) {
      if (dot < 0.f) {
        const float visco = bound_c ? p.viscobound : p.visco;
        const float amubar = p.kernelh * dot_rr2;
        const float robar = (rhoi + rhoj) * 0.5f;
        cf += (-visco * p.cs0 * amubar / robar) * mass2;
      }
    }
    ax -= cf * frx;
    ay -= cf * fry;
    az -= cf * frz;
    if constexpr (VISC == VISCO_LAMINAR_SPS) {
      // laminar operator (JSphCpu.cpp:765-775)
      const float drfr = drx * frx + dry * fry + drz * frz;
      const float visco = bound_c ? p.viscobound : p.visco;
      const float temp = 4.f * visco / ((rr2 + p.eta2) * (rhoi + rhoj));
      const float vtemp = mass2 * temp * drfr;
      ax += vtemp * dvx;
      ay += vtemp * dvy;
      az += vtemp * dvz;
      // SPS stress divergence (JSphCpu.cpp:776-782)
      float t0 = ti0, t1 = ti1, t2 = ti2, t3 = ti3, t4 = ti4, t5 = ti5;
      if (!bound_c && !ft_c) {
        const float* t = tau + 6 * j;
        t0 += t[0]; t1 += t[1]; t2 += t[2]; t3 += t[3]; t4 += t[4]; t5 += t[5];
      }
      ax += mass2 * (t0 * frx + t1 * fry + t2 * frz);
      ay += mass2 * (t1 * frx + t3 * fry + t4 * frz);
      az += mass2 * (t2 * frx + t4 * fry + t5 * frz);
      // velocity gradient (GetVelocityGradients_SPH_tsym)
      if (!ft_t) {
        const float volp2 = -mass2 / rhoj;
        const float gvx = dvx * volp2, gvy = dvy * volp2, gvz = dvz * volp2;
        gxx += gvx * frx;
        gxy += gvx * fry + gvy * frx;
        gxz += gvx * frz + gvz * frx;
        gyy += gvy * fry;
        gyz += gvy * frz + gvz * fry;
        gzz += gvz * frz;
      }
    }
    if constexpr (SHIFT) {
      // shifting sums (JSphCpu.cpp:743-750)
      const float drfr = drx * frx + dry * fry + drz * frz;
      const float massrhop = mass2 / rhoj;
      shx += massrhop * frx;
      shy += massrhop * fry;
      shz += massrhop * frz;
      shc -= massrhop * drfr;
      if (p.shiftmode == SHIFT_NO_BOUND) {
        sblk = sblk || bound_c || ft_c;
      } else if (p.shiftmode == SHIFT_NO_FIXED) {
        sblk = sblk || kj == KIND_FIXED;
      }
    }
    if (p.tdensity == DDT_NONE || ft_t) return;
    const float drfr = drx * frx + dry * fry + drz * frz;
    if (p.tdensity == DDT_MOLTENI) {
      // Molteni & Colagrossi 2009 (JSphCpu.cpp:724-731)
      const float vd = p.ddtkh * p.cs0 * (rhoi / rhoj - 1.f) / (rr2 + p.eta2);
      dlt += vd * drfr * mass2;
      blocked = blocked || ft_c || (bound_c && p.tboundary == BOUNDARY_DBC);
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
  };
  // The lanes of a warp walk their candidates in step, kRun at a time with
  // their loads in flight together, so that lanes of one cell read the
  // same slots at once; each lane queues its in-support slots, and the
  // warp drains every queue through the pair body, in the order it was
  // filled, when one of them has no room for another run or when every
  // walk has ended.
  NbrCursor cur;
  cur.init(walks ? c : 0, p.ncx, p.ncy, p.ncz, p.sim2d, begin);
  bool more = walks;
  int cnt = 0;
  for (;;) {
    int j0 = 0, m = 0;
    if (more) {
      m = cur.next(j0, kRun);
      more = m > 0;
    }
    int kj[kRun];
    F4 pj[kRun];
    for (int u = 0; u < kRun; ++u) {
      kj[u] = u < m ? kind[j0 + u] : KIND_DEAD;
      if (u < m) pj[u] = pospress[j0 + u];
    }
    for (int u = 0; u < kRun; ++u) {
      if (u < m && in_support(j0 + u, kj[u], pj[u])) q[cnt++] = j0 + u;
    }
    const bool going = warp_any(more);
    if (!going || warp_any(cnt > kQueue - kRun)) {
      for (int k = 0; k < cnt; ++k) pair(q[k]);
      cnt = 0;
      if (!going) break;
    }
  }
  if (walks && ft_t) {
    blocked = true;
    sblk = true;
  }
  if (!slot) return;
  if (p.tdensity != DDT_NONE && !blocked) arr += dlt;
  ace[3 * i + 0] = ax;
  ace[3 * i + 1] = p.sim2d ? 0.f : ay;
  ace[3 * i + 2] = az;
  ar[i] = arr;
  viscdt[i] = vmax;
  if constexpr (VISC == VISCO_LAMINAR_SPS) {
    float* g = gradvel + 6 * i;
    g[0] = gxx; g[1] = gxy; g[2] = gxz; g[3] = gyy; g[4] = gyz; g[5] = gzz;
  }
  if constexpr (SHIFT) {
    float* s = shift + 4 * i;
    s[0] = shx; s[1] = shy; s[2] = shz; s[3] = shc;
    shiftblk[i] = sblk ? 1 : 0;
  }
}
