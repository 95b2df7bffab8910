// Multiphase non-Newtonian (HBP) pair interaction for Hopper (sm_90a), in
// blocks of 128 threads.  Three kernels, over the GPU layout of the
// original DualSPHysics solver (state sorted by cell, a begin index per
// cell) instead of the TPU's row-padded lane windows:
//
//   nnforce_p1   replaces dualsphysics_multilayer_tpu/ops/pallas/nnforce.py
//                `_kernel_nn1` (pass 1: per-phase pressure force,
//                continuity, same-phase density diffusion, viscdt and the
//                6-component velocity gradient);
//   nnforce_p3   replaces `_kernel_nn3` (pass 3: Morris, ConsEq or per-phase
//                artificial viscosity, added into pass 1's acceleration);
//   nnforce_fda  replaces `_kernel_fda` (pass 1 plus the per-pair FDA strain
//                -> HBP eta -> Morris or ConsEq force, and the per-target
//                eta max, in one sweep).
//
// Each is a template over the TPU kernels' static branches, one instance
// per combination, picked by its launcher from the parameters: the
// smoothing kernel KER (Wendland, or the cubic spline with the tensile
// correction in p1 and FDA), for p1 and FDA whether a shifting mode adds
// the shifting sums (SHIFT), for p3 the viscous form (VISC: artificial,
// Morris or ConsEq), and for all three where the phase table lies (kWide:
// up to NN_TABLE_PHASES phases in the parameters' own table, read from the
// constant bank as before; any count in a device array, NnParams.phtab,
// read through the read-only cache, phase_cte).  A runtime test in one
// instance would cost the default instance registers and time, as it did
// kernel 1's floating branch (cellforce.cu).
//
// Pass 2 (strain rate -> effective viscosity -> tau) is elementwise torch
// between the p1 and p3 launches (ops/forces_nn.py).  The per-pair
// arithmetic lives in nnbody.cuh, shared with the g++-built CPU twins;
// per-phase constants come from a phase table instead of the TPU's
// per-particle constant channels.
//
// What bounds them on the card: gathers of candidate fields through L1/L2,
// and their latency.  In 2D a target walks 3 rows of 3 cells, about
// 9 x (cell occupancy) candidates, of which about a third lie inside the
// kernel support; each candidate costs a 16-byte position load and a kind
// load before the distance test, and a 16-byte velocity load, a phase load
// and (p3) its eta or 24-byte tau after it.  FDA adds one expf and one powf
// per pair.  The NN path runs 2D cases of some 37k particles, too few
// targets for one thread each to fill 132 SMs, and a thread's walk is a
// chain of dependent loads with little to hide their latency.  So every
// pass gives each target a group of kGroup lanes: the group filters kGroup
// candidates at a time (contiguous slots, one load per array), queues the
// in-support ones in shared memory and runs the pair body with every lane
// on a pair (NnGroupLane); the grid has kGroup times the threads, and
// boundary and fluid targets no longer share the lanes of one walk (in p3,
// whose boundary targets do no work, their groups end at once).
#include <cuda_runtime.h>

#include "nnbody.cuh"

namespace {

constexpr int kBlock = 128;
static_assert(kBlock % 32 == 0, "blocks of whole warps");

constexpr unsigned kFull = 0xffffffffu;
// Blocks an SM must hold at once: the register cap that keeps the lane
// groups' loop as resident as one thread per target.
constexpr int kMinBlocks = 7;
// A group's lanes in a warp's ballot, shifted down to bit 0.
constexpr unsigned kGroupBits = kGroup == 32 ? kFull : (1u << kGroup) - 1u;

// The first lane of this thread's group in its warp.
__device__ __forceinline__ int group_base() {
  return (threadIdx.x % 32) & ~(kGroup - 1);
}

// Thread t serves target t / kGroup as lane t % kGroup of a NnGroupLane
// `Lane` (with the group's queue `q`) through the walk: every lane of a
// warp runs the loop until every group of the warp is done (targets past n
// with an empty walk), so the warp-wide votes and shuffles name only lanes
// that are present.  The warp drains when every group has a full run
// waiting or its walk ended, or when one group's queue has no room for
// another round; the lanes' share of the pairs does not depend on when.
template <class Lane>
__device__ __forceinline__ void group_walk(Lane& lane, const NnParams& p,
                                           const NnInputs& x, int* q) {
  const int t = blockIdx.x * kBlock + threadIdx.x;
  const int base = group_base();
  lane.init(t / kGroup, t % kGroup, p, x);
  for (;;) {
    int j[kRuns];
    bool in[kRuns];
    lane.fill(p, x, j, in);
#pragma unroll
    for (int r = 0; r < kRuns; ++r) {
      const unsigned bits = __ballot_sync(kFull, in[r]) >> base;
      lane.enqueue(j[r], in[r], bits & kGroupBits, q);
    }
    __syncwarp();
    if (__all_sync(kFull, lane.ready()) || __any_sync(kFull, lane.crowded())) {
      lane.drain(q, [&](int j) { lane.pair(p, x, j); });
    }
    __syncwarp();
    if (!__any_sync(kFull, lane.busy())) break;
  }
}

// The group's sums combined, every lane's (a fixed butterfly).
template <class Lane>
__device__ __forceinline__ void group_fold(Lane& lane) {
#pragma unroll
  for (int off = kGroup / 2; off > 0; off >>= 1) {
    Lane::fold(lane.s, Lane::partner(lane.s, off));
  }
}

// Pass 1 or FDA: the walk, the group's flags by ballot, the butterfly.
template <int KER, bool SHIFT, bool kFda, bool kWide>
__device__ __forceinline__ void pass1_group(const NnParams& p,
                                            const NnInputs& x,
                                            const NnOutputs& o) {
  __shared__ int queue[kBlock / kGroup][kGroupQueue];
  NnPass1Lane<KER, SHIFT, kFda, kWide> lane;
  group_walk(lane, p, x, queue[threadIdx.x / kGroup]);
  const int base = group_base();
  const unsigned blocked = __ballot_sync(kFull, lane.s.blocked) >> base;
  const unsigned sblk = SHIFT ? __ballot_sync(kFull, lane.s.sblk) >> base : 0u;
  lane.settle(p, (blocked & kGroupBits) != 0, (sblk & kGroupBits) != 0);
  group_fold(lane);
  lane.write(p, o);
}

template <int KER, bool SHIFT, bool kWide>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
nnforce_p1_kernel(NnParams p, NnInputs x, NnOutputs o) {
  pass1_group<KER, SHIFT, false, kWide>(p, x, o);
}

template <int KER, bool SHIFT, bool kWide>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
nnforce_fda_kernel(NnParams p, NnInputs x, NnOutputs o) {
  pass1_group<KER, SHIFT, true, kWide>(p, x, o);
}

// Pass 3: the walk, the butterfly.
template <int KER, int VISC, bool kWide>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
nnforce_p3_kernel(NnParams p, NnInputs x, NnOutputs o) {
  __shared__ int queue[kBlock / kGroup][kGroupQueue];
  NnPass3Lane<KER, VISC, kWide> lane;
  group_walk(lane, p, x, queue[threadIdx.x / kGroup]);
  group_fold(lane);
  lane.write(p, o);
}

int nblocks(int threads) { return (threads + kBlock - 1) / kBlock; }

template <int KER, bool SHIFT, bool kFda, bool kWide>
void launch_p1_one(const NnParams* p, const void* pospress, const void* velrho,
                   const void* kind, const void* phase, const void* cell,
                   const void* begin, void* ace, void* ar, void* viscdt,
                   void* last, void* shift, void* shiftblk, void* stream) {
  auto* kernel = kFda ? nnforce_fda_kernel<KER, SHIFT, kWide>
                      : nnforce_p1_kernel<KER, SHIFT, kWide>;
  const NnOutputs o{static_cast<float*>(ace), static_cast<float*>(ar),
                    static_cast<float*>(viscdt),
                    kFda ? nullptr : static_cast<float*>(last),
                    kFda ? static_cast<float*>(last) : nullptr,
                    static_cast<float*>(shift),
                    static_cast<unsigned char*>(shiftblk)};
  const NnInputs x = nn_inputs(pospress, velrho, kind, phase, cell, begin,
                               nullptr, nullptr);
  kernel<<<nblocks(p->n * kGroup), kBlock, 0,
           static_cast<cudaStream_t>(stream)>>>(*p, x, o);
}

// Pass 1 or FDA (``last`` is gradvel or etamax): the instance of the
// parameters' kernel, shifting mode and phase table; cudaErrorInvalidValue
// for another kernel, a shifting mode without its outputs, a phase table
// neither instance reads, or a grid GroupWalk cannot hold.
template <bool kFda>
int launch_p1(const NnParams* p, const void* pospress, const void* velrho,
              const void* kind, const void* phase, const void* cell,
              const void* begin, void* ace, void* ar, void* viscdt, void* last,
              void* shift, void* shiftblk, void* stream) {
  const bool shifting = p->shiftmode != SHIFT_NONE;
  if ((p->tkernel != KER_WENDLAND && p->tkernel != KER_CUBIC)
      || (shifting && (shift == nullptr || shiftblk == nullptr))
      || !nn_phases_fit(p) || !group_walk_fits(p->ncx, p->ncy, p->ncz)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  using One = void (*)(const NnParams*, const void*, const void*, const void*,
                       const void*, const void*, const void*, void*, void*,
                       void*, void*, void*, void*, void*);
  // [wide][cubic][shifting]
  static const One one[2][2][2] = {
      {{launch_p1_one<KER_WENDLAND, false, kFda, false>,
        launch_p1_one<KER_WENDLAND, true, kFda, false>},
       {launch_p1_one<KER_CUBIC, false, kFda, false>,
        launch_p1_one<KER_CUBIC, true, kFda, false>}},
      {{launch_p1_one<KER_WENDLAND, false, kFda, true>,
        launch_p1_one<KER_WENDLAND, true, kFda, true>},
       {launch_p1_one<KER_CUBIC, false, kFda, true>,
        launch_p1_one<KER_CUBIC, true, kFda, true>}}};
  one[p->phtab != nullptr][p->tkernel == KER_CUBIC][shifting](
      p, pospress, velrho, kind, phase, cell, begin, ace, ar, viscdt, last,
      shift, shiftblk, stream);
  return static_cast<int>(cudaGetLastError());
}

template <int KER, int VISC, bool kWide>
void launch_p3_one(const NnParams* p, const NnInputs& x, const NnOutputs& o,
                   cudaStream_t stream) {
  nnforce_p3_kernel<KER, VISC, kWide>
      <<<nblocks(p->n * kGroup), kBlock, 0, stream>>>(*p, x, o);
}

}  // namespace

// Each launcher launches on `stream` and returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue when the parameters name a kernel or
// (p3) a viscous form it has no instance of, a shifting mode without shift
// and shiftblk, (p3) Morris without eta or ConsEq without tau, no phase or
// more than NN_TABLE_PHASES without phtab, or a grid of 2^24 x-cells or
// 2^16 y- or z-cells or more.  A set phtab picks the kWide instances.
// Inputs: pospress, velrho (n,4) f32, kind, phase, cell (n,) i32, begin
// (ncells+1,) i32, eta (n,) and tau (n,6) f32 (p3).  Outputs: ace (n,3), ar,
// viscdt (n,) f32, gradvel (n,6) f32 (p1), etamax (n,) f32 (FDA), shift
// (n,4) f32 and shiftblk (n,) u8 (with a shifting mode, else null).

extern "C" int dsph_nnforce_p1(const NnParams* p, const void* pospress,
                               const void* velrho, const void* kind,
                               const void* phase, const void* cell,
                               const void* begin, void* ace, void* ar,
                               void* viscdt, void* gradvel, void* shift,
                               void* shiftblk, void* stream) {
  return launch_p1<false>(p, pospress, velrho, kind, phase, cell, begin, ace,
                          ar, viscdt, gradvel, shift, shiftblk, stream);
}

extern "C" int dsph_nnforce_fda(const NnParams* p, const void* pospress,
                                const void* velrho, const void* kind,
                                const void* phase, const void* cell,
                                const void* begin, void* ace, void* ar,
                                void* viscdt, void* etamax, void* shift,
                                void* shiftblk, void* stream) {
  return launch_p1<true>(p, pospress, velrho, kind, phase, cell, begin, ace,
                         ar, viscdt, etamax, shift, shiftblk, stream);
}

extern "C" int dsph_nnforce_p3(const NnParams* p, const void* pospress,
                               const void* velrho, const void* kind,
                               const void* phase, const void* cell,
                               const void* begin, const void* eta,
                               const void* tau, void* ace, void* stream) {
  if (!nn_pass3_takes(p, eta, tau)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // [wide][wendland][visc]
  static void (*const one[2][2][3])(const NnParams*, const NnInputs&,
                                    const NnOutputs&, cudaStream_t) = {
      {{launch_p3_one<KER_CUBIC, VISC_ARTIFICIAL, false>,
        launch_p3_one<KER_CUBIC, VISC_MORRIS, false>,
        launch_p3_one<KER_CUBIC, VISC_CONSEQ, false>},
       {launch_p3_one<KER_WENDLAND, VISC_ARTIFICIAL, false>,
        launch_p3_one<KER_WENDLAND, VISC_MORRIS, false>,
        launch_p3_one<KER_WENDLAND, VISC_CONSEQ, false>}},
      {{launch_p3_one<KER_CUBIC, VISC_ARTIFICIAL, true>,
        launch_p3_one<KER_CUBIC, VISC_MORRIS, true>,
        launch_p3_one<KER_CUBIC, VISC_CONSEQ, true>},
       {launch_p3_one<KER_WENDLAND, VISC_ARTIFICIAL, true>,
        launch_p3_one<KER_WENDLAND, VISC_MORRIS, true>,
        launch_p3_one<KER_WENDLAND, VISC_CONSEQ, true>}}};
  const NnOutputs o{static_cast<float*>(ace)};
  one[p->phtab != nullptr][p->tkernel == KER_WENDLAND][p->visc](
      p, nn_inputs(pospress, velrho, kind, phase, cell, begin, eta, tau), o,
      static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
