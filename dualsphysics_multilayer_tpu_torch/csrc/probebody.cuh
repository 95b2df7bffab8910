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
// Rows of a window one thread carries, one chain each, and the window-load
// steps of a chunk: a thread has the next chunk's loads in flight while its
// chains run through one.  The offset table is padded with GATHER_STEPS
// zero offsets, so the pipeline's loads past the last step stay in the
// buffer.
constexpr int GATHER_CHAIN_ROWS = 4;
constexpr int GATHER_STEPS = 8;
static_assert(GATHER_ROWS % GATHER_CHAIN_ROWS == 0, "whole rows per block");
static_assert(GATHER_STEPS % 4 == 0, "offsets read four at a time");
// Window loads a launch may ask for: a block holds its window offsets in
// shared memory (64 KB).
constexpr int GATHER_MAX_NITER = 16384;

// Four window offsets, read with one 16-byte load.
struct alignas(16) GatherOffsets4 { int v[4]; };

// Launch parameters of probe_gather.cu, mirrored by GatherParams in
// tools/probes.py.
struct GatherParams {
  int niter;     // window loads of each chain, at most GATHER_MAX_NITER
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

// The window offset of a load at offs' entry `off`: clamped to [0,
// GATHER_WIDTH - GATHER_LANES], so no load leaves the buffer, then rounded
// down to a multiple of GATHER_LANES when `aligned`.
PROBE_HD int gather_offset(int off, bool aligned) {
  off = off < 0 ? 0 : (off > GATHER_WIDTH - GATHER_LANES
                           ? GATHER_WIDTH - GATHER_LANES : off);
  return aligned ? off / GATHER_LANES * GATHER_LANES : off;
}

// The window loads of steps i0 .. i0 + GATHER_STEPS - 1 (i0 a multiple of
// 4) of lane `base` (row stride GATHER_WIDTH) at window offsets woff.
PROBE_HD void gather_load(const float* base, const int* woff, int i0,
                          float (&cw)[GATHER_STEPS][GATHER_CHAIN_ROWS]) {
  const auto* o4 = reinterpret_cast<const GatherOffsets4*>(woff + i0);
#pragma unroll
  for (int q = 0; q < GATHER_STEPS / 4; ++q) {
    const GatherOffsets4 o = o4[q];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
#pragma unroll
      for (int r = 0; r < GATHER_CHAIN_ROWS; ++r) {
        cw[4 * q + t][r] = base[o.v[t] + r * GATHER_WIDTH];
      }
    }
  }
}

// The first n steps of a chunk through the chains.
PROBE_HD void gather_steps(const float (&cw)[GATHER_STEPS][GATHER_CHAIN_ROWS],
                           int n, float (&acc)[GATHER_CHAIN_ROWS]) {
#pragma unroll
  for (int k = 0; k < GATHER_STEPS; ++k) {
    if (k < n) {
#pragma unroll
      for (int r = 0; r < GATHER_CHAIN_ROWS; ++r) {
        acc[r] = acc[r] + cw[k][r] * 1.000001f + acc[r] * cw[k][r];
      }
    }
  }
}

// GATHER_CHAIN_ROWS elements of probe_unaligned.py's kern: lane l of the
// rows at `rows` (row stride GATHER_WIDTH), niter window loads at the
// window offsets woff[i] (gather_offset's, 16-byte aligned, padded with
// GATHER_STEPS zeros), each followed by acc = acc + cw*1.000001 + acc*cw.
// The loads' addresses do not depend on acc, so the next chunk's loads are
// issued before the chains run through the last chunk's (two chunks in
// registers, in turns); each chain's operations and their order are the
// plain loop's.
PROBE_HD void gather_chains(const float* rows, const int* woff, int niter,
                            int l, float (&acc)[GATHER_CHAIN_ROWS]) {
  constexpr int S = GATHER_STEPS;
  const float* base = rows + l;
#pragma unroll
  for (int r = 0; r < GATHER_CHAIN_ROWS; ++r) acc[r] = 0.f;
  if (niter <= 0) return;
  float a[S][GATHER_CHAIN_ROWS], b[S][GATHER_CHAIN_ROWS];
  gather_load(base, woff, 0, a);
  int i0 = 0;
  for (; i0 + 2 * S <= niter; i0 += 2 * S) {
    gather_load(base, woff, i0 + S, b);
    gather_steps(a, S, acc);
    gather_load(base, woff, i0 + 2 * S, a);   // into the padding at the end
    gather_steps(b, S, acc);
  }
  // fewer than 2 * S steps left, the first S of them in a
  gather_steps(a, niter - i0, acc);
  if (i0 + S < niter) {
    gather_load(base, woff, i0 + S, b);
    gather_steps(b, niter - i0 - S, acc);
  }
}
