// Per-target multiphase non-Newtonian (HBP) interaction over the
// cell-sorted layout, a group of kGroup lanes per target in every pass,
// shared by the CUDA kernels (nnforce.cu) and their CPU twins
// (nnforce_host.cpp, compiled with g++ for tests).
//
// Semantics are those of ops/forces_nn.py (the plain torch version) and of
// the JAX package's ops/forces_nn.py interaction_forces_nn, for DBC walls:
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
//     the target's;
//   * KER (a template parameter of every pass): the Wendland kernel, or the
//     cubic spline, whose tensile correction passes 1 and FDA add to the
//     pressure term (nnforce.py:146-158, :329-341);
//   * SHIFT (passes 1 and FDA): the four shifting sums of a fluid-side
//     target, over its pairs but those with a lighter candidate of another
//     fluid phase (the mphase fork's heavy-phase gate: such a pair adds
//     nothing), and under NO_BOUND the flag of a boundary neighbour in range
//     (nnforce.py:197-206, :379-388); the NN path blocks no other mode.
// Exact forms throughout: exact division, Fourtakas' hydrostatic term as
// rho0*(1 + ddtgz*dz)^(1/gamma) - rho0 with powf, and the HBP power law
// dm^(n-1) with powf (the TPU kernels used a 3-term series and
// exp((n-1)*log(dm))).  Sums run in registers in f32 in a fixed order: lane
// partials that a fixed butterfly combines (NnGroupLane).
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
  int tkernel;     // KER_* of the instance the launchers pick
  int shiftmode;   // typesdef.TpShifting; not NONE picks the SHIFT instance
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
  CubicCte cubic;
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

// Lanes per target, the runs of kGroup slots a group filters per round,
// and the in-support slots its queue holds: a ring with
// room for a round on top of the runs a group may hold while the others
// in its warp catch up.
constexpr int kGroup = 8;
constexpr int kRuns = 2;
constexpr int kGroupQueue = 64;
static_assert(kGroup >= 1 && kGroup <= 32 && (kGroup & (kGroup - 1)) == 0,
              "a group is a power-of-two share of a warp");
static_assert(kGroupQueue >= (kRuns + 1) * kGroup
              && (kGroupQueue & (kGroupQueue - 1)) == 0,
              "the queue is a power-of-two ring of a round and a run");

// The arrays the passes read, and those they write (the unused ones may be
// null): eta (n) under Morris and tau (n,6) under ConsEq for pass 3; ace
// (n,3) (pass 3 adds into it), ar (n) with diffusion folded in, viscdt (n)
// the target's max dot/(rr2+eta2) (-3.4e38 without pairs), gradvel (n,6)
// for pass 1, etamax (n) for FDA, shift (n,4) and shiftblk (n) with SHIFT.
struct NnInputs {
  const F4* pospress;
  const F4* velrho;
  const int* kind;
  const int* phase;
  const int* cell;
  const int* begin;
  const float* eta;
  const float* tau;
};

// The launchers' input pointers as NnInputs.
inline NnInputs nn_inputs(const void* pospress, const void* velrho,
                          const void* kind, const void* phase,
                          const void* cell, const void* begin, const void* eta,
                          const void* tau) {
  return NnInputs{static_cast<const F4*>(pospress),
                  static_cast<const F4*>(velrho),
                  static_cast<const int*>(kind), static_cast<const int*>(phase),
                  static_cast<const int*>(cell), static_cast<const int*>(begin),
                  static_cast<const float*>(eta), static_cast<const float*>(tau)};
}

struct NnOutputs {
  float* ace;
  float* ar;
  float* viscdt;
  float* gradvel;
  float* etamax;
  float* shift;
  unsigned char* shiftblk;
};

// Read-only loads, through the non-coherent cache on the card.
DSPH_HD F4 load4(const F4* a, int k) {
#if defined(__CUDA_ARCH__)
  const float4 v = __ldg(reinterpret_cast<const float4*>(a) + k);
  return F4{v.x, v.y, v.z, v.w};
#else
  return a[k];
#endif
}

DSPH_HD int load1(const int* a, int k) {
#if defined(__CUDA_ARCH__)
  return __ldg(a + k);
#else
  return a[k];
#endif
}

DSPH_HD float load1(const float* a, int k) {
#if defined(__CUDA_ARCH__)
  return __ldg(a + k);
#else
  return a[k];
#endif
}

// One lane of the group of kGroup lanes that walks target i's candidates
// and queues the in-support ones, for the passes' lanes (NnPass1Lane,
// NnPass3Lane: each adds its sums, its pair body and its outputs).
//
// The group walks the target's rows in rounds of kRuns runs of kGroup slots
// (group_run), lane g filtering each run's g-th slot; the group's
// in-support slots go to its queue in walk order (enqueue, a run at a
// time: each slot at the count of in-support lanes below it), and a drain
// hands the queue's next kGroup slots to the lanes, one each, through the
// pair body, again while the queue has no room for another round.  A group
// takes a drain only with kGroup slots waiting or its walk ended, so the
// k-th in-support slot of the walk always goes to lane k % kGroup,
// whenever the drains come: the lanes' partial sums depend on the walk
// alone.  At the end the lanes' partials combine by a fixed butterfly (the
// pass's fold, lane g with lane g ^ off for off = kGroup/2 .. 1), so the
// sums are deterministic.  The caller runs init, then rounds of fill,
// enqueue (each run) and drain (through the pass's pair), then the
// butterfly and write (nnforce.cu on the card, nnforce_host.cpp in the g++
// twin).
struct NnGroupLane {
  int i, g;            // the target and this lane's place in its group
  bool bound_t;
  F4 pi, vi;
  GroupWalk walk;
  bool more;           // the walk has slots left
  int head, tail;      // the queue's slots head .. tail-1 wait (ring indices)

  // Target i as lane g, a boundary target if `bound`, walking the rows
  // around cell c if `walks` (else it has no candidate).
  DSPH_HD void start(int i_, int g_, bool walks, bool bound, int c,
                     const NnParams& p, const NnInputs& x) {
    i = i_;
    g = g_;
    bound_t = bound;
    pi = vi = F4{0.f, 0.f, 0.f, 0.f};
    if (walks) {
      pi = load4(x.pospress, i);
      vi = load4(x.velrho, i);
    }
    walk.init(walks ? c : 0, p.ncx, p.ncy);
    more = walks;
    head = tail = 0;
  }

  // The next round: this lane's slot j[r] of each run r, loaded together,
  // and the filter's verdict in[r] (j != i, both live, not
  // boundary-boundary, ALMOSTZERO <= rr2 <= kernelsize^2).
  DSPH_HD void fill(const NnParams& p, const NnInputs& x, int (&j)[kRuns],
                    bool (&in)[kRuns]) {
    int m[kRuns];
    int kj[kRuns];
    F4 pj[kRuns];
    for (int r = 0; r < kRuns; ++r) {
      j[r] = 0;
      m[r] = more ? group_run(walk, kGroup, g, j[r], p.ncx, p.ncy, p.ncz,
                              p.sim2d, x.begin)
                  : 0;
      more = m[r] == kGroup;
    }
    for (int r = 0; r < kRuns; ++r) {
      if (g < m[r]) {
        kj[r] = load1(x.kind, j[r]);
        pj[r] = load4(x.pospress, j[r]);
      }
    }
    for (int r = 0; r < kRuns; ++r) {
      in[r] = false;
      if (g >= m[r]) continue;
      if (j[r] == i || kj[r] == KIND_DEAD
          || (bound_t && kj[r] < KIND_FLOATING)) {
        continue;
      }
      const float drx = pi.x - pj[r].x;
      const float dry = pi.y - pj[r].y;
      const float drz = pi.z - pj[r].z;
      const float rr2 = drx * drx + dry * dry + drz * drz;
      in[r] = !(rr2 < p.almostzero || rr2 > p.kernelsize2);
    }
  }

  // Queue a run's pairs in walk order: this lane's slot j if `in`; `bits`
  // holds the group's verdicts, bit g for lane g (a ballot).
  DSPH_HD void enqueue(int j, bool in, unsigned bits, int* q) {
    if (in) q[(tail + popcount(bits & ((1u << g) - 1u))) & (kGroupQueue - 1)] = j;
    tail += popcount(bits);
  }

  // The group would take a drain (a full run waits, or the walk is over);
  // it must (no room for another round); it has work left.
  DSPH_HD bool ready() const { return tail - head >= kGroup || !more; }
  DSPH_HD bool crowded() const {
    return tail - head > kGroupQueue - kRuns * kGroup;
  }
  DSPH_HD bool busy() const { return more || tail != head; }

  // Hand the queue's slots to the lanes' pair body `pair(j)`.
  template <class Pair>
  DSPH_HD void drain(const int* q, Pair&& pair) {
    do {
      if (!ready()) return;
      const int take = tail - head < kGroup ? tail - head : kGroup;
      if (g < take) pair(q[(head + g) & (kGroupQueue - 1)]);
      head += take;
    } while (crowded());
  }
};

// One lane of pass 1 (kFda false: pressure, continuity, diffusion, viscdt
// and, when p.gradvel, the 6-component velocity gradient) or of the fused
// FDA pass (kFda true: the same without the gradient, plus the per-pair
// strain -> eta -> Morris or ConsEq force and the per-target eta max) for
// target i, with kernel KER and, with SHIFT, the shifting sums.  Every live
// target walks, boundary targets for their continuity and viscdt.  Before
// the butterfly the group votes its flags (settle, which folds each lane's
// diffusion term into its continuity sum unless blocked).
template <int KER, bool SHIFT, bool kFda>
struct NnPass1Lane : NnGroupLane {
  // One lane's partial sums.
  struct Sums {
    float ax = 0.f, ay = 0.f, az = 0.f, arr = 0.f, dlt = 0.f, emax = 0.f;
    float vmax = -3.4e38f;
    float gxx = 0.f, gxy = 0.f, gxz = 0.f, gyy = 0.f, gyz = 0.f, gzz = 0.f;
    float shx = 0.f, shy = 0.f, shz = 0.f, shc = 0.f;
    bool blocked = false, sblk = false;
  };

  int phi;
  Sums s;

  DSPH_HD void init(int i_, int g_, const NnParams& p, const NnInputs& x) {
    const bool slot = i_ < p.n;
    const int ki = slot ? load1(x.kind, i_) : KIND_DEAD;
    const int c = slot ? load1(x.cell, i_) : p.ncells;
    const bool walks = ki != KIND_DEAD && c < p.ncells;
    start(i_, g_, walks, ki < KIND_FLOATING, c, p, x);
    phi = walks ? load1(x.phase, i) : 0;
  }

  // The pair body, on a slot the filter passed.
  DSPH_HD void pair(const NnParams& p, const NnInputs& x, int j) {
    const int kj = load1(x.kind, j);
    const F4 pj = load4(x.pospress, j);
    const F4 vj = load4(x.velrho, j);
    const int phj = load1(x.phase, j);
    const bool bound_c = kj < KIND_FLOATING;
    const float drx = pi.x - pj.x;
    const float dry = pi.y - pj.y;
    const float drz = pi.z - pj.z;
    const float rr2 = drx * drx + dry * dry + drz * drz;
    const float fac = kernel_fac<KER>(rr2, p.kernelh, p.bwen, p.cubic);
    const float frx = fac * drx, fry = fac * dry, frz = fac * drz;
    const float dvx = vi.x - vj.x, dvy = vi.y - vj.y, dvz = vi.z - vj.z;
    const float dvfr = dvx * frx + dvy * fry + dvz * frz;
    const float dot = drx * dvx + dry * dvy + drz * dvz;
    const float rr2e = rr2 + p.eta2;
    const float mass2 = bound_c ? p.massbound : p.mass[phj];
    const float rhoi = vi.w, rhoj = vj.w;
    s.vmax = fmaxf(s.vmax, dot / rr2e);
    // continuity with per-phase masses
    s.arr += mass2 * dvfr * (rhoi / rhoj);
    if (bound_t) return;
    // pressure force, per-phase EOS (pressure comes with the position),
    // plus the cubic spline's tensile correction
    float prs = (pi.w + pj.w) / (rhoi * rhoj);
    if constexpr (KER == KER_CUBIC) {
      prs += cubic_tensil(rr2, p.kernelh, p.cubic, rhoi, pi.w, rhoj, pj.w);
    }
    s.ax -= prs * mass2 * frx;
    s.ay -= prs * mass2 * fry;
    s.az -= prs * mass2 * frz;
    const float drfr = drx * frx + dry * fry + drz * frz;
    if constexpr (SHIFT) {
      // a lighter candidate of another fluid phase adds nothing
      const bool heavy = !bound_c && phi != phj && p.mass[phi] > p.mass[phj];
      const float massrhop = heavy ? 0.f : mass2 / rhoj;
      s.shx += massrhop * frx;
      s.shy += massrhop * fry;
      s.shz += massrhop * frz;
      s.shc -= massrhop * drfr;
      if (p.shiftmode == SHIFT_NO_BOUND) s.sblk = s.sblk || bound_c;
    }
    if (p.tdensity != DDT_NONE) {
      const bool same = !bound_c && phi == phj;
      const float cbar = p.cs0[phj];
      if (p.tdensity == DDT_MOLTENI) {
        if (same) s.dlt += p.ddtkh * cbar * (rhoi / rhoj - 1.f) / rr2e * drfr * mass2;
        s.blocked = s.blocked || bound_c;
      } else {
        if (same) {
          const float rh = 1.f + p.ddtgz * drz;
          const float drhop = p.rhopzero * powf(rh, p.ovgamma) - p.rhopzero;
          const float vd = p.ddtkh * cbar * ((rhoj - rhoi) - drhop) / rr2e;
          s.dlt -= vd * drfr * mass2 / rhoj;
        }
        s.blocked = s.blocked || (bound_c && p.tdensity == DDT_FOURTAKAS);
      }
    }
    if (!kFda && !p.gradvel) return;
    // no-slip wall trick
    const float dvwx = bound_c ? 2.f * vi.x : dvx;
    const float dvwy = bound_c ? 2.f * vi.y : dvy;
    const float dvwz = bound_c ? 2.f * vi.z : dvz;
    if constexpr (!kFda) {
      // SPH velocity gradient, off-diagonals summed (du/dy + dv/dx)
      const float volp2 = -mass2 / rhoj;
      const float gx = dvwx * volp2, gy = dvwy * volp2, gz = dvwz * volp2;
      s.gxx += gx * frx;
      s.gxy += gx * fry + gy * frx;
      s.gxz += gx * frz + gz * frx;
      s.gyy += gy * fry;
      s.gyz += gy * frz + gz * fry;
      s.gzz += gz * frz;
    } else {
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
      s.emax = fmaxf(s.emax, eta);
      if (p.visc == VISC_MORRIS) {
        const float vtemp = mass2 * (2.f * eta / (rr2e * rhoj)) * drfr;
        s.ax += vtemp * dvwx;
        s.ay += vtemp * dvwy;
        s.az += vtemp * dvwz;
      } else {
        const float m2r = mass2 / rhoj * (2.f * eta);
        s.ax += m2r * (sxx * frx + sxy * fry + sxz * frz);
        s.ay += m2r * (sxy * frx + syy * fry + syz * frz);
        s.az += m2r * (sxz * frx + syz * fry + szz * frz);
      }
    }
  }

  // Once the walk is over: the group's flags (the OR of its lanes'), and
  // the diffusion term folded into continuity unless blocked.
  DSPH_HD void settle(const NnParams& p, bool blocked, bool sblk) {
    s.blocked = blocked;
    s.sblk = sblk;
    if (p.tdensity != DDT_NONE && !blocked) s.arr += s.dlt;
  }

  // One butterfly step, after settle: a's sums with b's (the partner
  // lane's) folded in, own first.
  DSPH_HD static void fold(Sums& a, const Sums& b) {
    a.ax = a.ax + b.ax;
    a.ay = a.ay + b.ay;
    a.az = a.az + b.az;
    a.arr = a.arr + b.arr;
    a.vmax = fmaxf(a.vmax, b.vmax);
    if constexpr (kFda) {
      a.emax = fmaxf(a.emax, b.emax);
    } else {
      a.gxx = a.gxx + b.gxx;
      a.gxy = a.gxy + b.gxy;
      a.gxz = a.gxz + b.gxz;
      a.gyy = a.gyy + b.gyy;
      a.gyz = a.gyz + b.gyz;
      a.gzz = a.gzz + b.gzz;
    }
    if constexpr (SHIFT) {
      a.shx = a.shx + b.shx;
      a.shy = a.shy + b.shy;
      a.shz = a.shz + b.shz;
      a.shc = a.shc + b.shc;
    }
  }

#if defined(__CUDACC__)
  // The sums of lane (this lane) ^ off of the warp; every lane of the warp
  // calls it together.
  __device__ static Sums partner(const Sums& a, int off) {
    const auto x = [off](float v) { return __shfl_xor_sync(0xffffffffu, v, off); };
    Sums o;
    o.ax = x(a.ax);
    o.ay = x(a.ay);
    o.az = x(a.az);
    o.arr = x(a.arr);
    o.vmax = x(a.vmax);
    if constexpr (kFda) {
      o.emax = x(a.emax);
    } else {
      o.gxx = x(a.gxx);
      o.gxy = x(a.gxy);
      o.gxz = x(a.gxz);
      o.gyy = x(a.gyy);
      o.gyz = x(a.gyz);
      o.gzz = x(a.gzz);
    }
    if constexpr (SHIFT) {
      o.shx = x(a.shx);
      o.shy = x(a.shy);
      o.shz = x(a.shz);
      o.shc = x(a.shc);
    }
    return o;
  }
#endif

  // The target's outputs from the combined sums (lane 0 of the group).
  DSPH_HD void write(const NnParams& p, const NnOutputs& o) const {
    if (g != 0 || i >= p.n) return;
    o.ace[3 * i + 0] = s.ax;
    o.ace[3 * i + 1] = s.ay;
    o.ace[3 * i + 2] = s.az;
    o.ar[i] = s.arr;
    o.viscdt[i] = s.vmax;
    if constexpr (SHIFT) {
      float* sh = o.shift + 4 * i;
      sh[0] = s.shx; sh[1] = s.shy; sh[2] = s.shz; sh[3] = s.shc;
      o.shiftblk[i] = s.sblk ? 1 : 0;
    }
    if constexpr (kFda) {
      o.etamax[i] = s.emax;
    } else {
      float* gv = o.gradvel + 6 * i;
      gv[0] = s.gxx; gv[1] = s.gxy; gv[2] = s.gxz;
      gv[3] = s.gyy; gv[4] = s.gyz; gv[5] = s.gzz;
    }
  }
};

// One lane of pass 3, the viscous forces of a fluid-side target i, added
// into ace: VISC_MORRIS with per-particle eta (eta_i + eta_j), VISC_CONSEQ
// with per-particle tau (tau_i + tau_j, rows xx xy xz yy yz zz), or
// VISC_ARTIFICIAL with the candidate phase's visco and cs0 on approaching
// pairs, with kernel KER; the form is a template parameter, as the TPU
// kernel picks it statically (nnforce.py:485-487), so no instance carries
// another form's registers.  Boundary and dead targets do not walk: their
// groups end at once and add nothing.
template <int KER, int VISC>
struct NnPass3Lane : NnGroupLane {
  static_assert(VISC == VISC_ARTIFICIAL || VISC == VISC_MORRIS
                || VISC == VISC_CONSEQ, "a viscous form of pass 3");

  // One lane's partial sums.
  struct Sums {
    float ax = 0.f, ay = 0.f, az = 0.f;
  };

  float eta1;          // the target's eta (Morris)
  float tau1[6];       // the target's tau (ConsEq)
  Sums s;

  DSPH_HD void init(int i_, int g_, const NnParams& p, const NnInputs& x) {
    const bool slot = i_ < p.n;
    const int ki = slot ? load1(x.kind, i_) : KIND_DEAD;
    const int c = slot ? load1(x.cell, i_) : p.ncells;
    const bool walks = ki >= KIND_FLOATING && c < p.ncells;
    start(i_, g_, walks, false, c, p, x);
    eta1 = 0.f;
    for (int k = 0; k < 6; ++k) tau1[k] = 0.f;
    if (!walks) return;
    if constexpr (VISC == VISC_MORRIS) eta1 = load1(x.eta, i);
    if constexpr (VISC == VISC_CONSEQ) {
      for (int k = 0; k < 6; ++k) tau1[k] = load1(x.tau, 6 * i + k);
    }
  }

  // The pair body, on a slot the filter passed, with the no-slip wall
  // trick: against a boundary candidate dv = 2*v_i and the candidate's eta
  // or tau is the target's.
  DSPH_HD void pair(const NnParams& p, const NnInputs& x, int j) {
    const int kj = load1(x.kind, j);
    const F4 pj = load4(x.pospress, j);
    const F4 vj = load4(x.velrho, j);
    const int phj = load1(x.phase, j);
    const bool bound_c = kj < KIND_FLOATING;
    const float drx = pi.x - pj.x;
    const float dry = pi.y - pj.y;
    const float drz = pi.z - pj.z;
    const float rr2 = drx * drx + dry * dry + drz * drz;
    const float fac = kernel_fac<KER>(rr2, p.kernelh, p.bwen, p.cubic);
    const float frx = fac * drx, fry = fac * dry, frz = fac * drz;
    const float rr2e = rr2 + p.eta2;
    const float mass2 = bound_c ? p.massbound : p.mass[phj];
    const float rhoj = vj.w;
    const float dvx = vi.x - vj.x, dvy = vi.y - vj.y, dvz = vi.z - vj.z;
    if constexpr (VISC == VISC_MORRIS) {
      const float eta2 = bound_c ? eta1 : load1(x.eta, j);
      const float drfr = drx * frx + dry * fry + drz * frz;
      const float vtemp = mass2 * ((eta1 + eta2) / (rr2e * rhoj)) * drfr;
      s.ax += vtemp * (bound_c ? 2.f * vi.x : dvx);
      s.ay += vtemp * (bound_c ? 2.f * vi.y : dvy);
      s.az += vtemp * (bound_c ? 2.f * vi.z : dvz);
    } else if constexpr (VISC == VISC_CONSEQ) {
      float ts[6];
      for (int k = 0; k < 6; ++k) {
        ts[k] = tau1[k] + (bound_c ? tau1[k] : load1(x.tau, 6 * j + k));
      }
      const float m2r = mass2 / rhoj;
      s.ax += m2r * (ts[0] * frx + ts[1] * fry + ts[2] * frz);
      s.ay += m2r * (ts[1] * frx + ts[3] * fry + ts[4] * frz);
      s.az += m2r * (ts[2] * frx + ts[4] * fry + ts[5] * frz);
    } else {
      const float dot = drx * dvx + dry * dvy + drz * dvz;
      if (dot >= 0.f) return;
      const float amubar = p.kernelh * (dot / rr2e);
      const float robar = (vi.w + rhoj) * 0.5f;
      const float pi_visc = (-p.visco[phj] * p.cs0[phj] * amubar / robar) * mass2;
      s.ax -= pi_visc * frx;
      s.ay -= pi_visc * fry;
      s.az -= pi_visc * frz;
    }
  }

  // One butterfly step: a's sums with b's (the partner lane's) folded in,
  // own first.
  DSPH_HD static void fold(Sums& a, const Sums& b) {
    a.ax = a.ax + b.ax;
    a.ay = a.ay + b.ay;
    a.az = a.az + b.az;
  }

#if defined(__CUDACC__)
  // The sums of lane (this lane) ^ off of the warp; every lane of the warp
  // calls it together.
  __device__ static Sums partner(const Sums& a, int off) {
    Sums o;
    o.ax = __shfl_xor_sync(0xffffffffu, a.ax, off);
    o.ay = __shfl_xor_sync(0xffffffffu, a.ay, off);
    o.az = __shfl_xor_sync(0xffffffffu, a.az, off);
    return o;
  }
#endif

  // The combined sums added into the target's ace (lane 0 of the group).
  DSPH_HD void write(const NnParams& p, const NnOutputs& o) const {
    if (g != 0 || i >= p.n) return;
    o.ace[3 * i + 0] += s.ax;
    o.ace[3 * i + 1] += s.ay;
    o.ace[3 * i + 2] += s.az;
  }
};

// Whether pass 3 has an instance for these parameters and inputs: the
// Wendland or cubic kernel, a viscous form VISC_*, eta under Morris, tau
// under ConsEq, and a grid GroupWalk can hold.
DSPH_HD bool nn_pass3_takes(const NnParams* p, const void* eta,
                            const void* tau) {
  return (p->tkernel == KER_WENDLAND || p->tkernel == KER_CUBIC)
         && (p->visc == VISC_ARTIFICIAL || p->visc == VISC_MORRIS
             || p->visc == VISC_CONSEQ)
         && (p->visc != VISC_MORRIS || eta != nullptr)
         && (p->visc != VISC_CONSEQ || tau != nullptr)
         && group_walk_fits(p->ncx, p->ncy, p->ncz);
}
