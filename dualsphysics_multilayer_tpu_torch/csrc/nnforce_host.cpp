// CPU twins of nnforce.cu: the same bodies (nnbody.cuh) in the card's lane
// groups, emulated a warp at a time, each launcher picking the instance of
// the parameters' kernel, shifting mode, viscous form and phase table as
// the CUDA one does.  Built with g++ by ops/cuda/build.py so the kernels' arithmetic can
// be tested on a machine without a GPU.
#include "nnbody.cuh"

namespace {

// cudaErrorInvalidValue, the CUDA launchers' code for parameters they have
// no instance of.
constexpr int kInvalidValue = 1;

constexpr int kWarp = 32;
// A group's lanes in a warp's ballot, shifted down to bit 0.
constexpr unsigned kGroupBits =
    kGroup == 32 ? 0xffffffffu : (1u << kGroup) - 1u;

// The walk of one warp as the card runs it (nnforce.cu group_walk): the
// warp's targets in kWarp / kGroup groups of kGroup lanes, each lane a
// NnGroupLane `Lane` starting at thread t0, every step of a round taken by
// the warp's lanes in turn; a vote is the OR (or AND) over the warp's
// lanes, a ballot the mask of lanes.
template <class Lane>
void warp_walk(Lane (&lane)[kWarp], int t0, const NnParams& p,
               const NnInputs& x) {
  int queue[kWarp / kGroup][kGroupQueue];
  for (int l = 0; l < kWarp; ++l) {
    lane[l].init((t0 + l) / kGroup, (t0 + l) % kGroup, p, x);
  }
  for (;;) {
    int j[kWarp][kRuns];
    bool in[kWarp][kRuns];
    for (int l = 0; l < kWarp; ++l) lane[l].fill(p, x, j[l], in[l]);
    for (int r = 0; r < kRuns; ++r) {
      unsigned ballot = 0;
      for (int l = 0; l < kWarp; ++l) {
        if (in[l][r]) ballot |= 1u << l;
      }
      for (int l = 0; l < kWarp; ++l) {
        const int base = l & ~(kGroup - 1);
        lane[l].enqueue(j[l][r], in[l][r], (ballot >> base) & kGroupBits,
                        queue[l / kGroup]);
      }
    }
    bool all_ready = true, any_crowded = false;
    for (int l = 0; l < kWarp; ++l) {
      all_ready = all_ready && lane[l].ready();
      any_crowded = any_crowded || lane[l].crowded();
    }
    if (all_ready || any_crowded) {
      for (int l = 0; l < kWarp; ++l) {
        lane[l].drain(queue[l / kGroup],
                      [&](int j) { lane[l].pair(p, x, j); });
      }
    }
    bool busy = false;
    for (int l = 0; l < kWarp; ++l) busy = busy || lane[l].busy();
    if (!busy) break;
  }
}

// The butterfly (nnforce.cu group_fold): each lane folds lane ^ off.
template <class Lane>
void warp_fold(Lane (&lane)[kWarp]) {
  for (int off = kGroup / 2; off > 0; off >>= 1) {
    typename Lane::Sums before[kWarp];
    for (int l = 0; l < kWarp; ++l) before[l] = lane[l].s;
    for (int l = 0; l < kWarp; ++l) Lane::fold(lane[l].s, before[l ^ off]);
  }
}

// Pass 1 or FDA (nnforce.cu pass1_group): a group's flags are the OR over
// its lanes.
template <int KER, bool SHIFT, bool kFda, bool kWide>
void pass1_all(const NnParams* p, const NnInputs& x, const NnOutputs& o) {
  using Lane = NnPass1Lane<KER, SHIFT, kFda, kWide>;
  for (int t0 = 0; t0 < p->n * kGroup; t0 += kWarp) {
    Lane lane[kWarp];
    warp_walk(lane, t0, *p, x);
    for (int l0 = 0; l0 < kWarp; l0 += kGroup) {
      bool blocked = false, sblk = false;
      for (int l = l0; l < l0 + kGroup; ++l) {
        blocked = blocked || lane[l].s.blocked;
        sblk = sblk || lane[l].s.sblk;
      }
      for (int l = l0; l < l0 + kGroup; ++l) lane[l].settle(*p, blocked, sblk);
    }
    warp_fold(lane);
    for (int l = 0; l < kWarp; ++l) lane[l].write(*p, o);
  }
}

template <bool kFda>
int pass1(const NnParams* p, const void* pospress, const void* velrho,
          const void* kind, const void* phase, const void* cell,
          const void* begin, void* ace, void* ar, void* viscdt, void* last,
          void* shift, void* shiftblk) {
  const bool shifting = p->shiftmode != SHIFT_NONE;
  if ((p->tkernel != KER_WENDLAND && p->tkernel != KER_CUBIC)
      || (shifting && (shift == nullptr || shiftblk == nullptr))
      || !nn_phases_fit(p) || !group_walk_fits(p->ncx, p->ncy, p->ncz)) {
    return kInvalidValue;
  }
  const NnOutputs o{static_cast<float*>(ace), static_cast<float*>(ar),
                    static_cast<float*>(viscdt),
                    kFda ? nullptr : static_cast<float*>(last),
                    kFda ? static_cast<float*>(last) : nullptr,
                    static_cast<float*>(shift),
                    static_cast<unsigned char*>(shiftblk)};
  // [wide][cubic][shifting]
  static void (*const all[2][2][2])(const NnParams*, const NnInputs&,
                                    const NnOutputs&) = {
      {{pass1_all<KER_WENDLAND, false, kFda, false>,
        pass1_all<KER_WENDLAND, true, kFda, false>},
       {pass1_all<KER_CUBIC, false, kFda, false>,
        pass1_all<KER_CUBIC, true, kFda, false>}},
      {{pass1_all<KER_WENDLAND, false, kFda, true>,
        pass1_all<KER_WENDLAND, true, kFda, true>},
       {pass1_all<KER_CUBIC, false, kFda, true>,
        pass1_all<KER_CUBIC, true, kFda, true>}}};
  all[p->phtab != nullptr][p->tkernel == KER_CUBIC][shifting](p, nn_inputs(pospress, velrho, kind, phase, cell, begin, nullptr,
                   nullptr), o);
  return 0;
}

template <int KER, int VISC, bool kWide>
void pass3_all(const NnParams* p, const NnInputs& x, const NnOutputs& o) {
  using Lane = NnPass3Lane<KER, VISC, kWide>;
  for (int t0 = 0; t0 < p->n * kGroup; t0 += kWarp) {
    Lane lane[kWarp];
    warp_walk(lane, t0, *p, x);
    warp_fold(lane);
    for (int l = 0; l < kWarp; ++l) lane[l].write(*p, o);
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
  if (!nn_pass3_takes(p, eta, tau)) return kInvalidValue;
  // [wide][wendland][visc]
  static void (*const all[2][2][3])(const NnParams*, const NnInputs&,
                                    const NnOutputs&) = {
      {{pass3_all<KER_CUBIC, VISC_ARTIFICIAL, false>,
        pass3_all<KER_CUBIC, VISC_MORRIS, false>,
        pass3_all<KER_CUBIC, VISC_CONSEQ, false>},
       {pass3_all<KER_WENDLAND, VISC_ARTIFICIAL, false>,
        pass3_all<KER_WENDLAND, VISC_MORRIS, false>,
        pass3_all<KER_WENDLAND, VISC_CONSEQ, false>}},
      {{pass3_all<KER_CUBIC, VISC_ARTIFICIAL, true>,
        pass3_all<KER_CUBIC, VISC_MORRIS, true>,
        pass3_all<KER_CUBIC, VISC_CONSEQ, true>},
       {pass3_all<KER_WENDLAND, VISC_ARTIFICIAL, true>,
        pass3_all<KER_WENDLAND, VISC_MORRIS, true>,
        pass3_all<KER_WENDLAND, VISC_CONSEQ, true>}}};
  const NnOutputs o{static_cast<float*>(ace)};
  all[p->phtab != nullptr][p->tkernel == KER_WENDLAND][p->visc](
      p, nn_inputs(pospress, velrho, kind, phase, cell, begin, eta, tau), o);
  return 0;
}
