// Per-thread bodies of the two hardware probes, shared by the CUDA kernels
// (probe_fma.cu, probe_gather.cu) and their CPU twins (probes_host.cpp,
// compiled with g++ for tests).  The plain torch versions are in
// tools/probes.py.
#pragma once

#include <math.h>

#if defined(__CUDACC__)
#define PROBE_HD __host__ __device__ __forceinline__
#else
#define PROBE_HD inline
#endif

// The FMA probe's operations; values match tools/probes.py OPS.
enum { PROBE_FMA = 0, PROBE_MIX = 1, PROBE_RSQRT = 2, PROBE_RECIP = 3 };
// Recurrence steps per iteration, vputime.py's OPS.
constexpr int PROBE_STEPS = 64;

// Launch parameters of probe_fma.cu, mirrored by FmaParams in
// tools/probes.py.
struct FmaParams {
  int op;        // PROBE_*
  int chains;    // independent chains per thread: 1, 2, 4 or 8
  int rep;       // iterations of PROBE_STEPS steps
  int n;         // threads, one element of x and out each
};

// The window of the gather probe: rows x lanes, over a buffer of
// rows x GATHER_WIDTH (probe_unaligned.py's C, CW and W).
constexpr int GATHER_ROWS = 16;
constexpr int GATHER_LANES = 128;
constexpr int GATHER_WIDTH = 4096;
// Rows of a window each block holds: two blocks share a window, so a
// block's rows of the buffer (128 KB) fit in shared memory.
constexpr int GATHER_BLOCK_ROWS = 8;

// Launch parameters of probe_gather.cu, mirrored by GatherParams in
// tools/probes.py.
struct GatherParams {
  int niter;     // window loads per block
  int aligned;   // round each offset down to a multiple of GATHER_LANES
  int staged;    // read the block's rows from shared memory, not global
  int groups;    // windows in flight (probe_unaligned.py's grid G)
};

// rsqrt and the approximate reciprocal: the MUFU instructions on the card
// (rsqrtf; rcp.approx, the counterpart of pl.reciprocal(approx=True)),
// exact forms on the host.
PROBE_HD float probe_rsqrt(float y) {
#if defined(__CUDA_ARCH__)
  return rsqrtf(y);
#else
  return 1.f / sqrtf(y);
#endif
}

PROBE_HD float probe_recip(float y) {
#if defined(__CUDA_ARCH__)
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(y));
  return r;
#else
  return 1.f / y;
#endif
}

// One thread of vputime.py's make_kernel: CHAINS chains starting at x + c,
// rep iterations of PROBE_STEPS steps of operation OP, step j on chain
// j % CHAINS with f = i * 1e-9 in iteration i; returns the chains' sum.
template <int OP, int CHAINS>
PROBE_HD float fma_chains(float x, int rep) {
  float acc[CHAINS];
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) acc[c] = x + static_cast<float>(c);
  for (int i = 0; i < rep; ++i) {
    const float f = static_cast<float>(i) * 1e-9f;
#pragma unroll
    for (int j = 0; j < PROBE_STEPS; ++j) {
      float& a = acc[j % CHAINS];
      if constexpr (OP == PROBE_FMA) {
        // fma alternating with max, so nothing folds
        a = (j % 2) ? fmaxf(a, x * f - a) : a * (1.f + f) + x;
      } else if constexpr (OP == PROBE_MIX) {
        // the pair body's mix: fma, max, mul, compare
        switch (j % 4) {
          case 0: a = a * (1.f + f) + x; break;
          case 1: a = fmaxf(a, x - f); break;
          case 2: a = a * (x + f); break;
          default: a = a + (a > f ? 1.f : 0.f); break;
        }
      } else if constexpr (OP == PROBE_RSQRT) {
        a = probe_rsqrt(fabsf(a) + x + f);
      } else {
        a = probe_recip(fabsf(a) + x + f);
      }
    }
  }
  float s = acc[0];
#pragma unroll
  for (int c = 1; c < CHAINS; ++c) s = s + acc[c];
  return s;
}

// One thread of probe_unaligned.py's kern: lane l of GATHER_BLOCK_ROWS
// rows (rows, row stride GATHER_WIDTH), niter window loads at offs[i]
// (clamped to [0, GATHER_WIDTH - GATHER_LANES], so no load leaves the
// buffer, then rounded down to a multiple of GATHER_LANES when ALIGNED),
// each followed by acc = acc + cw*1.000001 + acc*cw; writes the rows' sums
// to out (row stride GATHER_LANES).
template <bool ALIGNED>
PROBE_HD void gather_lane(const float* rows, const int* __restrict__ offs,
                          int niter, int l, float* out) {
  float acc[GATHER_BLOCK_ROWS];
#pragma unroll
  for (int r = 0; r < GATHER_BLOCK_ROWS; ++r) acc[r] = 0.f;
#pragma unroll 4
  for (int i = 0; i < niter; ++i) {
    int off = offs[i];
    off = off < 0 ? 0 : (off > GATHER_WIDTH - GATHER_LANES
                             ? GATHER_WIDTH - GATHER_LANES : off);
    if (ALIGNED) off = off / GATHER_LANES * GATHER_LANES;
#pragma unroll
    for (int r = 0; r < GATHER_BLOCK_ROWS; ++r) {
      const float cw = rows[r * GATHER_WIDTH + off + l];
      acc[r] = acc[r] + cw * 1.000001f + acc[r] * cw;
    }
  }
#pragma unroll
  for (int r = 0; r < GATHER_BLOCK_ROWS; ++r) out[r * GATHER_LANES + l] = acc[r];
}
