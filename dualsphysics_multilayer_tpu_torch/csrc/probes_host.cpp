// CPU twins of probe_fma.cu and probe_gather.cu: the same per-thread
// bodies (probebody.cuh) in a loop over threads, with the launchers'
// arguments but the stream.  Built with g++ by ops/cuda/build.py so the
// probes' arithmetic can be tested on a machine without a GPU (the twins
// use exact rsqrt and reciprocal where the card uses its MUFU forms).
#include <vector>

#include "probebody.cuh"

namespace {

// cudaErrorInvalidValue, as the CUDA launchers return it
constexpr int kInvalidValue = 1;

template <int OP>
void fma_all(const FmaParams* p, const float* x, float* out) {
  for (int i = 0; i < p->n; ++i) {
    switch (p->chains) {
      case 1: out[i] = fma_chains<OP, 1>(x[i], p->rep); break;
      case 2: out[i] = fma_chains<OP, 2>(x[i], p->rep); break;
      case 4: out[i] = fma_chains<OP, 4>(x[i], p->rep); break;
      default: out[i] = fma_chains<OP, 8>(x[i], p->rep); break;
    }
  }
}

}  // namespace

extern "C" int dsph_probe_fma_host(const FmaParams* p, const void* x,
                                   void* out) {
  const int c = p->chains;
  if (p->op < PROBE_FMA || p->op > PROBE_RECIP
      || !(c == 1 || c == 2 || c == 4 || c == 8) || p->n <= 0 || p->rep < 0) {
    return kInvalidValue;
  }
  const auto* xs = static_cast<const float*>(x);
  auto* o = static_cast<float*>(out);
  switch (p->op) {
    case PROBE_FMA: fma_all<PROBE_FMA>(p, xs, o); break;
    case PROBE_MIX: fma_all<PROBE_MIX>(p, xs, o); break;
    case PROBE_RSQRT: fma_all<PROBE_RSQRT>(p, xs, o); break;
    default: fma_all<PROBE_RECIP>(p, xs, o); break;
  }
  return 0;
}

extern "C" int dsph_probe_gather_host(const GatherParams* p, const void* buf,
                                      const void* offs, void* out) {
  if (p->niter < 0 || p->niter > GATHER_MAX_NITER || p->groups <= 0) {
    return kInvalidValue;
  }
  const auto* rows = static_cast<const float*>(buf);
  const auto* f = static_cast<const int*>(offs);
  auto* o = static_cast<float*>(out);
  // the window offsets, padded (probebody.cuh gather_chains)
  std::vector<GatherOffsets4> woff4((p->niter + GATHER_STEPS + 3) / 4);
  int* woff = reinterpret_cast<int*>(woff4.data());
  for (int i = 0; i < 4 * static_cast<int>(woff4.size()); ++i) {
    woff[i] = i < p->niter ? gather_offset(f[i], p->aligned) : 0;
  }
  // block b: rows (b % kGroups) * GATHER_CHAIN_ROWS .. of window b / kGroups
  constexpr int kGroups = GATHER_ROWS / GATHER_CHAIN_ROWS;
  for (int b = 0; b < p->groups * kGroups; ++b) {
    const int row0 = (b % kGroups) * GATHER_CHAIN_ROWS;
    float* dst = o + ((b / kGroups) * GATHER_ROWS + row0) * GATHER_LANES;
    for (int l = 0; l < GATHER_LANES; ++l) {
      float acc[GATHER_CHAIN_ROWS];
      gather_chains(rows + row0 * GATHER_WIDTH, woff, p->niter, l, acc);
      for (int r = 0; r < GATHER_CHAIN_ROWS; ++r) {
        dst[r * GATHER_LANES + l] = acc[r];
      }
    }
  }
  return 0;
}
