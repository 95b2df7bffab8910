// CPU twins of nnforce.cu: the same bodies (nnbody.cuh), pass 3 in a loop
// over targets, passes 1 and FDA in the card's lane groups emulated a warp
// at a time, each launcher picking the instance of the parameters' kernel
// and shifting mode as the CUDA one does.  Built with g++ by
// ops/cuda/build.py so the kernels' arithmetic can be tested on a machine
// without a GPU.
#include "nnbody.cuh"

namespace {

// cudaErrorInvalidValue, the CUDA launchers' code for parameters they have
// no instance of.
constexpr int kInvalidValue = 1;

constexpr int kWarp = 32;

// Pass 1 or FDA as the card runs it (nnforce.cu pass1_group): the targets
// in warps of kWarp / kGroup groups of kGroup lanes, each lane a
// NnPass1Lane, every step of a round taken by the warp's lanes in turn; a
// vote is the OR (or AND) over the warp's lanes, a ballot the mask of
// lanes, a group's flags the OR over its lanes, and the butterfly folds
// each lane with lane ^ off.
template <int KER, bool SHIFT, bool kFda>
void pass1_all(const NnParams* p, const void* pospress, const void* velrho,
               const void* kind, const void* phase, const void* cell,
               const void* begin, void* ace, void* ar, void* viscdt,
               void* last, void* shift, void* shiftblk) {
  using Lane = NnPass1Lane<KER, SHIFT, kFda>;
  const NnInputs x{static_cast<const F4*>(pospress),
                   static_cast<const F4*>(velrho),
                   static_cast<const int*>(kind), static_cast<const int*>(phase),
                   static_cast<const int*>(cell), static_cast<const int*>(begin)};
  const NnOutputs o{static_cast<float*>(ace), static_cast<float*>(ar),
                    static_cast<float*>(viscdt),
                    kFda ? nullptr : static_cast<float*>(last),
                    kFda ? static_cast<float*>(last) : nullptr,
                    static_cast<float*>(shift),
                    static_cast<unsigned char*>(shiftblk)};
  const unsigned group = kGroup == 32 ? 0xffffffffu : (1u << kGroup) - 1u;
  for (int t0 = 0; t0 < p->n * kGroup; t0 += kWarp) {
    Lane lane[kWarp];
    int queue[kWarp / kGroup][kGroupQueue];
    for (int l = 0; l < kWarp; ++l) {
      lane[l].init((t0 + l) / kGroup, (t0 + l) % kGroup, *p, x);
    }
    for (;;) {
      int j[kWarp][kRuns];
      bool in[kWarp][kRuns];
      for (int l = 0; l < kWarp; ++l) lane[l].fill(*p, x, j[l], in[l]);
      for (int r = 0; r < kRuns; ++r) {
        unsigned ballot = 0;
        for (int l = 0; l < kWarp; ++l) {
          if (in[l][r]) ballot |= 1u << l;
        }
        for (int l = 0; l < kWarp; ++l) {
          const int base = l & ~(kGroup - 1);
          lane[l].enqueue(j[l][r], in[l][r], (ballot >> base) & group,
                          queue[l / kGroup]);
        }
      }
      bool all_ready = true, any_crowded = false;
      for (int l = 0; l < kWarp; ++l) {
        all_ready = all_ready && lane[l].ready();
        any_crowded = any_crowded || lane[l].crowded();
      }
      if (all_ready || any_crowded) {
        for (int l = 0; l < kWarp; ++l) lane[l].drain(*p, x, queue[l / kGroup]);
      }
      bool busy = false;
      for (int l = 0; l < kWarp; ++l) busy = busy || lane[l].busy();
      if (!busy) break;
    }
    for (int l0 = 0; l0 < kWarp; l0 += kGroup) {
      bool blocked = false, sblk = false;
      for (int l = l0; l < l0 + kGroup; ++l) {
        blocked = blocked || lane[l].s.blocked;
        sblk = sblk || lane[l].s.sblk;
      }
      for (int l = l0; l < l0 + kGroup; ++l) lane[l].settle(*p, blocked, sblk);
    }
    for (int off = kGroup / 2; off > 0; off >>= 1) {
      typename Lane::Sums before[kWarp];
      for (int l = 0; l < kWarp; ++l) before[l] = lane[l].s;
      for (int l = 0; l < kWarp; ++l) Lane::fold(lane[l].s, before[l ^ off]);
    }
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
      || !group_walk_fits(p->ncx, p->ncy, p->ncz)) {
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
