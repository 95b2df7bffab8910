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
// correction in p1 and FDA), and for p1 and FDA whether a shifting mode
// adds the shifting sums (SHIFT).  A runtime test in one instance would
// cost the default (Wendland, no shifting) instance registers and time, as
// it did kernel 1's floating branch (cellforce.cu).
//
// Pass 2 (strain rate -> effective viscosity -> tau) is elementwise torch
// between the p1 and p3 launches (ops/forces_nn.py).  The per-pair
// arithmetic lives in nnbody.cuh, shared with the g++-built CPU twins;
// per-phase constants come from the tables of NnParams instead of the
// TPU's per-particle constant channels.
//
// What bounds them on the card: gathers of candidate fields through L1/L2,
// and their latency.  In 2D a target walks 3 rows of 3 cells, about
// 9 x (cell occupancy) candidates, of which about a third lie inside the
// kernel support; each candidate costs a 16-byte position load and a kind
// load before the distance test, and a 16-byte velocity load, a phase load
// and (p3) its eta or 24-byte tau after it.  FDA adds one expf and one powf
// per pair.  The NN path runs 2D cases of some 37k particles, too few
// targets for one thread each to fill 132 SMs, and a thread's walk is a
// chain of dependent loads with little to hide their latency.  So p1 and
// FDA give each target a group of kGroup lanes: the group filters kGroup
// candidates at a time (contiguous slots, one load per array), queues the
// in-support ones in shared memory and runs the pair body with every lane
// on a pair (NnPass1Lane); the grid has kGroup times the threads, and
// boundary and fluid targets no longer share the lanes of one walk.  Pass
// 3 keeps one thread per target and walk_neighbours.
#include <cuda_runtime.h>

#include "nnbody.cuh"

namespace {

constexpr int kBlock = 128;
static_assert(kBlock % 32 == 0, "blocks of whole warps");

constexpr unsigned kFull = 0xffffffffu;
// Blocks of passes 1 and FDA an SM must hold at once: the register cap
// that keeps the lane groups' loop as resident as one thread per target.
constexpr int kMinBlocks = 7;

// Pass 1 or FDA, kGroup lanes per target: thread t serves target
// t / kGroup as lane t % kGroup.  Every lane of a warp runs the loop until
// every group of the warp is done (targets past n with an empty walk), so
// the warp-wide votes and shuffles name only lanes that are present.  The
// warp drains when every group has a full run waiting or its walk ended,
// or when one group's queue has no room for another round; the lanes'
// share of the pairs does not depend on when (NnPass1Lane).
template <int KER, bool SHIFT, bool kFda>
__device__ __forceinline__ void pass1_group(const NnParams& p,
                                            const NnInputs& x,
                                            const NnOutputs& o) {
  using Lane = NnPass1Lane<KER, SHIFT, kFda>;
  __shared__ int queue[kBlock / kGroup][kGroupQueue];
  int* q = queue[threadIdx.x / kGroup];
  const int t = blockIdx.x * kBlock + threadIdx.x;
  // this group's lanes in the warp's ballot
  const int base = (threadIdx.x % 32) & ~(kGroup - 1);
  const unsigned group = kGroup == 32 ? kFull : (1u << kGroup) - 1u;
  Lane lane;
  lane.init(t / kGroup, t % kGroup, p, x);
  for (;;) {
    int j[kRuns];
    bool in[kRuns];
    lane.fill(p, x, j, in);
#pragma unroll
    for (int r = 0; r < kRuns; ++r) {
      lane.enqueue(j[r], in[r], (__ballot_sync(kFull, in[r]) >> base) & group,
                   q);
    }
    __syncwarp();
    if (__all_sync(kFull, lane.ready()) || __any_sync(kFull, lane.crowded())) {
      lane.drain(p, x, q);
    }
    __syncwarp();
    if (!__any_sync(kFull, lane.busy())) break;
  }
  const unsigned blocked = __ballot_sync(kFull, lane.s.blocked) >> base;
  const unsigned sblk = SHIFT ? __ballot_sync(kFull, lane.s.sblk) >> base : 0u;
  lane.settle(p, (blocked & group) != 0, (sblk & group) != 0);
#pragma unroll
  for (int off = kGroup / 2; off > 0; off >>= 1) {
    Lane::fold(lane.s, Lane::partner(lane.s, off));
  }
  lane.write(p, o);
}

template <int KER, bool SHIFT>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
nnforce_p1_kernel(NnParams p, NnInputs x, NnOutputs o) {
  pass1_group<KER, SHIFT, false>(p, x, o);
}

template <int KER, bool SHIFT>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
nnforce_fda_kernel(NnParams p, NnInputs x, NnOutputs o) {
  pass1_group<KER, SHIFT, true>(p, x, o);
}

template <int KER>
__global__ void __launch_bounds__(kBlock)
nnforce_p3_kernel(NnParams p, const F4* __restrict__ pospress,
                  const F4* __restrict__ velrho, const int* __restrict__ kind,
                  const int* __restrict__ phase, const int* __restrict__ cell,
                  const int* __restrict__ begin, const float* __restrict__ eta,
                  const float* __restrict__ tau, float* __restrict__ ace) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i < p.n) {
    nn_pass3_target<KER>(i, p, pospress, velrho, kind, phase, cell, begin,
                         eta, tau, ace);
  }
}

int nblocks(int threads) { return (threads + kBlock - 1) / kBlock; }

template <int KER, bool SHIFT, bool kFda>
void launch_p1_one(const NnParams* p, const void* pospress, const void* velrho,
                   const void* kind, const void* phase, const void* cell,
                   const void* begin, void* ace, void* ar, void* viscdt,
                   void* last, void* shift, void* shiftblk, void* stream) {
  auto* kernel = kFda ? nnforce_fda_kernel<KER, SHIFT>
                      : nnforce_p1_kernel<KER, SHIFT>;
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
  kernel<<<nblocks(p->n * kGroup), kBlock, 0,
           static_cast<cudaStream_t>(stream)>>>(*p, x, o);
}

// Pass 1 or FDA (``last`` is gradvel or etamax): the instance of the
// parameters' kernel and shifting mode; cudaErrorInvalidValue for another
// kernel, a shifting mode without its outputs, or a grid GroupWalk cannot
// hold.
template <bool kFda>
int launch_p1(const NnParams* p, const void* pospress, const void* velrho,
              const void* kind, const void* phase, const void* cell,
              const void* begin, void* ace, void* ar, void* viscdt, void* last,
              void* shift, void* shiftblk, void* stream) {
  const bool shifting = p->shiftmode != SHIFT_NONE;
  if ((p->tkernel != KER_WENDLAND && p->tkernel != KER_CUBIC)
      || (shifting && (shift == nullptr || shiftblk == nullptr))
      || !group_walk_fits(p->ncx, p->ncy, p->ncz)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool cubic = p->tkernel == KER_CUBIC;
  auto* one = cubic ? (shifting ? launch_p1_one<KER_CUBIC, true, kFda>
                                : launch_p1_one<KER_CUBIC, false, kFda>)
                    : (shifting ? launch_p1_one<KER_WENDLAND, true, kFda>
                                : launch_p1_one<KER_WENDLAND, false, kFda>);
  one(p, pospress, velrho, kind, phase, cell, begin, ace, ar, viscdt, last,
      shift, shiftblk, stream);
  return static_cast<int>(cudaGetLastError());
}

template <int KER>
void launch_p3_one(const NnParams* p, const void* pospress, const void* velrho,
                   const void* kind, const void* phase, const void* cell,
                   const void* begin, const void* eta, const void* tau,
                   void* ace, void* stream) {
  nnforce_p3_kernel<KER>
      <<<nblocks(p->n), kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
          *p, static_cast<const F4*>(pospress), static_cast<const F4*>(velrho),
          static_cast<const int*>(kind), static_cast<const int*>(phase),
          static_cast<const int*>(cell), static_cast<const int*>(begin),
          static_cast<const float*>(eta), static_cast<const float*>(tau),
          static_cast<float*>(ace));
}

}  // namespace

// Each launcher launches on `stream` and returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue when the parameters name a kernel it
// has no instance of, a shifting mode without shift and shiftblk, or (p1,
// FDA) a grid of 2^24 x-cells or 2^16 y- or z-cells or more.
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
  if (p->tkernel != KER_WENDLAND && p->tkernel != KER_CUBIC) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* one = p->tkernel == KER_CUBIC ? launch_p3_one<KER_CUBIC>
                                      : launch_p3_one<KER_WENDLAND>;
  one(p, pospress, velrho, kind, phase, cell, begin, eta, tau, ace, stream);
  return static_cast<int>(cudaGetLastError());
}
