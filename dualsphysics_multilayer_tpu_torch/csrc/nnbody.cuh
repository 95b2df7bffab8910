// Per-target multiphase non-Newtonian (HBP) interaction over the
// cell-sorted layout, shared by the CUDA kernels (nnforce.cu, one thread per
// target) and their CPU twins (nnforce_host.cpp, compiled with g++ for tests).
//
// Semantics are those of ops/forces_nn.py (the plain torch version) and of
// the JAX package's ops/forces_nn.py interaction_forces_nn, for the Wendland
// kernel and DBC walls:
//   * a pair is j != i, both live, not boundary-boundary, with
//     ALMOSTZERO <= rr2 <= kernelsize^2;
//   * a candidate's mass is its phase's (massbound for boundaries); phase
//     constants come from the per-phase tables of NnParams, indexed by the
//     per-particle phase (the fluid typecode value clipped to the table, so
//     boundaries carry phase 0);
//   * boundary targets take continuity and viscdt only;
//   * density diffusion acts on same-phase fluid pairs with the candidate's
//     cs0 as cbar; a boundary neighbour in range blocks a target's whole
//     diffusion term under Molteni and Fourtakas, never under Fourtakas-full;
//   * the velocity gradient and the viscous forces use the no-slip wall
//     trick: dv = 2*v_i against a boundary candidate, whose eta or tau is
//     the target's.
// Exact forms throughout: exact division, Fourtakas' hydrostatic term as
// rho0*(1 + ddtgz*dz)^(1/gamma) - rho0 with powf, and the HBP power law
// dm^(n-1) with powf (the TPU kernels used a 3-term series and
// exp((n-1)*log(dm))).  Sums run in registers in f32, in the fixed order of
// walk_neighbours.
#pragma once

#include "cellwalk.cuh"

// Largest phase table the kernels take; ops/forces_nn.py MAX_PHASES.
constexpr int NN_MAX_PHASES = 8;

// Viscosity modes of the viscous pass.
enum { VISC_ARTIFICIAL = 0, VISC_MORRIS = 1, VISC_CONSEQ = 2 };

// Launch parameters.  Field order and types are mirrored by the ctypes
// Structure in ops/cuda/nnforce.py: keep both in step.
struct NnParams {
  int n;           // slots (targets)
  int ncx, ncy, ncz;
  int ncells;
  int sim2d;
  int tdensity;
  int visc;        // VISC_* of the viscous pass (Morris or ConsEq for FDA)
  int gradvel;     // pass 1 accumulates the velocity gradient
  float kernelsize2;
  float kernelh;
  float bwen;
  float eta2;
  float ddtkh;
  float ddtgz;
  float rhopzero;  // system (phase 0) rho0, Fourtakas' hydrostatic term
  float ovgamma;   // 1/gamma of the system EOS
  float massbound;
  float almostzero;
  // per-phase tables
  float cs0[NN_MAX_PHASES];
  float mass[NN_MAX_PHASES];
  float visco[NN_MAX_PHASES];
  float tauy[NN_MAX_PHASES];
  float taumax[NN_MAX_PHASES];
  float bimul[NN_MAX_PHASES];
  float hbpm[NN_MAX_PHASES];
  float hbpn[NN_MAX_PHASES];
};

// HBP effective viscosity (forces_nn.eta_effective, JSphCpu_Tensors.cpp:
// 116-136): tau_yield, visco, m and n of phase ph, the bi-viscosity
// constants tau_max and Bi_multi of phase ppx.  A particle at rest
// (magn <= ALMOSTZERO) takes the low-rate branch without evaluating the
// Papanastasiou term, so its tau/(2*ALMOSTZERO)-sized yield term never
// meets the zero factor 1 - exp(-m*dm); the power law runs only where it
// is selected.
DSPH_HD float eta_effective(const NnParams& p, float magn, int ph, int ppx) {
  const float eps = p.almostzero;
  const float visco = p.visco[ph], tauy = p.tauy[ph];
  const float m = p.hbpm[ph], n = p.hbpn[ph];
  const float taumax = p.taumax[ppx], bimul = p.bimul[ppx];
  const float dm = fmaxf(magn, eps);
  const bool has_tm = taumax > 0.f;
  const bool bi = has_tm && dm <= taumax / (2.f * fmaxf(bimul * visco, eps));
  const float miou_yield = bi ? bimul * visco
                              : (has_tm ? taumax : tauy) / (2.f * dm);
  const bool at_rest = magn <= eps;
  const float miou_pap = at_rest ? 0.f : miou_yield * (1.f - expf(-m * dm));
  const bool low = at_rest || miou_pap > m * tauy;
  const float term1 = has_tm ? miou_yield : (low ? m * tauy : miou_pap);
  const float term2 = (bi || low) ? visco : visco * powf(dm, n - 1.f);
  return term1 + term2;
}

// Pass 1 (kFda false: pressure, continuity, diffusion, viscdt and, when
// p.gradvel, the 6-component velocity gradient) or the fused FDA pass
// (kFda true: the same without the gradient, plus the per-pair strain ->
// eta -> Morris or ConsEq force and the per-target eta max) for target i.
// Outputs: ace (n,3), ar (n) with diffusion folded in, viscdt (n) the
// target's max dot/(rr2+eta2) (-3.4e38 without pairs), gradvel (n,6) for
// pass 1, etamax (n) for FDA; the unused one may be null.
template <bool kFda>
DSPH_HD void nn_pass1_target(int i, const NnParams& p,
                             const F4* __restrict__ pospress,
                             const F4* __restrict__ velrho,
                             const int* __restrict__ kind,
                             const int* __restrict__ phase,
                             const int* __restrict__ cell,
                             const int* __restrict__ begin,
                             float* __restrict__ ace, float* __restrict__ ar,
                             float* __restrict__ viscdt,
                             float* __restrict__ gradvel,
                             float* __restrict__ etamax) {
  float ax = 0.f, ay = 0.f, az = 0.f, arr = 0.f, dlt = 0.f, emax = 0.f;
  float gxx = 0.f, gxy = 0.f, gxz = 0.f, gyy = 0.f, gyz = 0.f, gzz = 0.f;
  float vmax = -3.4e38f;
  bool blocked = false;
  const int ki = kind[i];
  const int c = cell[i];
  if (ki != KIND_DEAD && c < p.ncells) {
    const F4 pi = pospress[i];
    const F4 vi = velrho[i];
    const int phi = phase[i];
    const bool bound_t = ki < KIND_FLOATING;
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
      if (rr2 < p.almostzero || rr2 > p.kernelsize2) return;
      const F4 vj = velrho[j];
      const int phj = phase[j];
      const float fac = wendland_fac(rr2, p.kernelh, p.bwen);
      const float frx = fac * drx, fry = fac * dry, frz = fac * drz;
      const float dvx = vi.x - vj.x, dvy = vi.y - vj.y, dvz = vi.z - vj.z;
      const float dvfr = dvx * frx + dvy * fry + dvz * frz;
      const float dot = drx * dvx + dry * dvy + drz * dvz;
      const float rr2e = rr2 + p.eta2;
      const float mass2 = bound_c ? p.massbound : p.mass[phj];
      const float rhoi = vi.w, rhoj = vj.w;
      vmax = fmaxf(vmax, dot / rr2e);
      // continuity with per-phase masses
      arr += mass2 * dvfr * (rhoi / rhoj);
      if (bound_t) return;
      // pressure force, per-phase EOS (pressure comes with the position)
      const float prs = (pi.w + pj.w) / (rhoi * rhoj);
      ax -= prs * mass2 * frx;
      ay -= prs * mass2 * fry;
      az -= prs * mass2 * frz;
      const float drfr = drx * frx + dry * fry + drz * frz;
      if (p.tdensity != DDT_NONE) {
        const bool same = !bound_c && phi == phj;
        const float cbar = p.cs0[phj];
        if (p.tdensity == DDT_MOLTENI) {
          if (same) dlt += p.ddtkh * cbar * (rhoi / rhoj - 1.f) / rr2e * drfr * mass2;
          blocked = blocked || bound_c;
        } else {
          if (same) {
            const float rh = 1.f + p.ddtgz * drz;
            const float drhop = p.rhopzero * powf(rh, p.ovgamma) - p.rhopzero;
            const float vd = p.ddtkh * cbar * ((rhoj - rhoi) - drhop) / rr2e;
            dlt -= vd * drfr * mass2 / rhoj;
          }
          blocked = blocked || (bound_c && p.tdensity == DDT_FOURTAKAS);
        }
      }
      if (!kFda && !p.gradvel) return;
      // no-slip wall trick
      const float dvwx = bound_c ? 2.f * vi.x : dvx;
      const float dvwy = bound_c ? 2.f * vi.y : dvy;
      const float dvwz = bound_c ? 2.f * vi.z : dvz;
      if (!kFda) {
        // SPH velocity gradient, off-diagonals summed (du/dy + dv/dx)
        const float volp2 = -mass2 / rhoj;
        const float gx = dvwx * volp2, gy = dvwy * volp2, gz = dvwz * volp2;
        gxx += gx * frx;
        gxy += gx * fry + gy * frx;
        gxz += gx * frz + gz * frx;
        gyy += gy * fry;
        gyz += gy * frz + gz * fry;
        gzz += gz * frz;
        return;
      }
      // FDA: per-pair gradient dvw (outer) dr / rr2, deviatoric strain and
      // its full-matrix magnitude |II1 - II2| (forces_nn.strain_magn_pair)
      const float inv = 1.f / rr2;
      const float d11 = dvwx * drx * inv, d12 = dvwx * dry * inv, d13 = dvwx * drz * inv;
      const float d21 = dvwy * drx * inv, d22 = dvwy * dry * inv, d23 = dvwy * drz * inv;
      const float d31 = dvwz * drx * inv, d32 = dvwz * dry * inv, d33 = dvwz * drz * inv;
      const float divv = (d11 + d22 + d33) / 3.f;
      const float sxx = d11 - divv, syy = d22 - divv, szz = d33 - divv;
      const float sxy = 0.5f * (d12 + d21), sxz = 0.5f * (d13 + d31);
      const float syz = 0.5f * (d23 + d32);
      const float ii1 = sxx * syy + syy * szz + sxx * szz;
      const float ii2 = sxy * sxy + syz * syz + sxz * sxz;
      // rheology of the candidate's phase (the target's for a boundary
      // candidate), bi-viscosity constants of the target's
      const float eta = eta_effective(p, fabsf(ii1 - ii2), bound_c ? phi : phj, phi);
      emax = fmaxf(emax, eta);
      if (p.visc == VISC_MORRIS) {
        const float vtemp = mass2 * (2.f * eta / (rr2e * rhoj)) * drfr;
        ax += vtemp * dvwx;
        ay += vtemp * dvwy;
        az += vtemp * dvwz;
      } else {
        const float m2r = mass2 / rhoj * (2.f * eta);
        ax += m2r * (sxx * frx + sxy * fry + sxz * frz);
        ay += m2r * (sxy * frx + syy * fry + syz * frz);
        az += m2r * (sxz * frx + syz * fry + szz * frz);
      }
    });
  }
  if (p.tdensity != DDT_NONE && !blocked) arr += dlt;
  ace[3 * i + 0] = ax;
  ace[3 * i + 1] = ay;
  ace[3 * i + 2] = az;
  ar[i] = arr;
  viscdt[i] = vmax;
  if (kFda) {
    etamax[i] = emax;
  } else {
    gradvel[6 * i + 0] = gxx;
    gradvel[6 * i + 1] = gxy;
    gradvel[6 * i + 2] = gxz;
    gradvel[6 * i + 3] = gyy;
    gradvel[6 * i + 4] = gyz;
    gradvel[6 * i + 5] = gzz;
  }
}

// Pass 3, the viscous forces of a fluid-side target i, added into ace:
// Morris with per-particle eta (eta_i + eta_j), ConsEq with per-particle
// tau (tau_i + tau_j, rows xx xy xz yy yz zz), or artificial viscosity
// with the candidate phase's visco and cs0 on approaching pairs.  eta and
// tau may be null in the modes that do not read them.
DSPH_HD void nn_pass3_target(int i, const NnParams& p,
                             const F4* __restrict__ pospress,
                             const F4* __restrict__ velrho,
                             const int* __restrict__ kind,
                             const int* __restrict__ phase,
                             const int* __restrict__ cell,
                             const int* __restrict__ begin,
                             const float* __restrict__ eta,
                             const float* __restrict__ tau,
                             float* __restrict__ ace) {
  float ax = 0.f, ay = 0.f, az = 0.f;
  const int ki = kind[i];
  const int c = cell[i];
  if (ki >= KIND_FLOATING && c < p.ncells) {
    const F4 pi = pospress[i];
    const F4 vi = velrho[i];
    const float eta1 = p.visc == VISC_MORRIS ? eta[i] : 0.f;
    float tau1[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (p.visc == VISC_CONSEQ) {
      for (int k = 0; k < 6; ++k) tau1[k] = tau[6 * i + k];
    }
    walk_neighbours(c, p.ncx, p.ncy, p.ncz, p.sim2d, begin, [&](int j) {
      if (j == i) return;
      const int kj = kind[j];
      if (kj == KIND_DEAD) return;
      const bool bound_c = kj < KIND_FLOATING;
      const F4 pj = pospress[j];
      const float drx = pi.x - pj.x;
      const float dry = pi.y - pj.y;
      const float drz = pi.z - pj.z;
      const float rr2 = drx * drx + dry * dry + drz * drz;
      if (rr2 < p.almostzero || rr2 > p.kernelsize2) return;
      const F4 vj = velrho[j];
      const int phj = phase[j];
      const float fac = wendland_fac(rr2, p.kernelh, p.bwen);
      const float frx = fac * drx, fry = fac * dry, frz = fac * drz;
      const float rr2e = rr2 + p.eta2;
      const float mass2 = bound_c ? p.massbound : p.mass[phj];
      const float rhoj = vj.w;
      const float dvx = vi.x - vj.x, dvy = vi.y - vj.y, dvz = vi.z - vj.z;
      if (p.visc == VISC_MORRIS) {
        const float eta2 = bound_c ? eta1 : eta[j];
        const float drfr = drx * frx + dry * fry + drz * frz;
        const float vtemp = mass2 * ((eta1 + eta2) / (rr2e * rhoj)) * drfr;
        ax += vtemp * (bound_c ? 2.f * vi.x : dvx);
        ay += vtemp * (bound_c ? 2.f * vi.y : dvy);
        az += vtemp * (bound_c ? 2.f * vi.z : dvz);
      } else if (p.visc == VISC_CONSEQ) {
        float ts[6];
        for (int k = 0; k < 6; ++k) ts[k] = tau1[k] + (bound_c ? tau1[k] : tau[6 * j + k]);
        const float m2r = mass2 / rhoj;
        ax += m2r * (ts[0] * frx + ts[1] * fry + ts[2] * frz);
        ay += m2r * (ts[1] * frx + ts[3] * fry + ts[4] * frz);
        az += m2r * (ts[2] * frx + ts[4] * fry + ts[5] * frz);
      } else {
        const float dot = drx * dvx + dry * dvy + drz * dvz;
        if (dot >= 0.f) return;
        const float amubar = p.kernelh * (dot / rr2e);
        const float robar = (vi.w + rhoj) * 0.5f;
        const float pi_visc = (-p.visco[phj] * p.cs0[phj] * amubar / robar) * mass2;
        ax -= pi_visc * frx;
        ay -= pi_visc * fry;
        az -= pi_visc * frz;
      }
    });
  }
  ace[3 * i + 0] += ax;
  ace[3 * i + 1] += ay;
  ace[3 * i + 2] += az;
}
