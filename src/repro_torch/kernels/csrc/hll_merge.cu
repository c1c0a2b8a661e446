// HLL merge + cardinality estimate, one block per query.
//
// Replaces: repro/kernels/hll_merge.py, hll_merge_estimate_pallas (body
// _kernel): per query, max-merge the (L, m) uint8 registers gathered from
// the L hit buckets, then the HLL estimator with the small-range (linear
// counting) and large-range (2^32) corrections, in float32.
//
// Bound on an H100: neither bytes nor operations.  The input is Q*L*m
// bytes (100 * 20 * 64 = 128 KB at the Webspam shape), well under a
// microsecond of device memory time, so launch latency bounds it.  The
// design therefore stays simple: thread t of block q owns register t,
// takes its max over L (coalesced byte loads, one row of m per table), and
// the block reduces sum(2^-R) and the count of zero registers with warp
// shuffles and one shared-memory pass.  Thread 0 applies the estimator
// exactly as repro/core/hll.py estimate_cardinality does.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxWarps = 32;   // m <= 1024

__global__ void hll_merge_estimate_kernel(const uint8_t* __restrict__ regs,
                                          float* __restrict__ out, int L,
                                          int m, float coef) {
  const int q = blockIdx.x;
  const int t = threadIdx.x;
  const uint8_t* base = regs + static_cast<int64_t>(q) * L * m;
  float s = 0.f;
  float z = 0.f;
  if (t < m) {
    int r = 0;
    for (int l = 0; l < L; ++l) r = max(r, static_cast<int>(base[l * m + t]));
    s = ldexpf(1.f, -r);          // exact 2^-r
    z = (r == 0) ? 1.f : 0.f;
  }
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
    z += __shfl_xor_sync(0xffffffffu, z, off);
  }
  __shared__ float ss[kMaxWarps];
  __shared__ float zs[kMaxWarps];
  const int warp = t >> 5;
  const int lane = t & 31;
  if (lane == 0) {
    ss[warp] = s;
    zs[warp] = z;
  }
  __syncthreads();
  if (t == 0) {
    float sum = 0.f;
    float zeros = 0.f;
    for (int w = 0; w < (blockDim.x >> 5); ++w) {
      sum += ss[w];
      zeros += zs[w];
    }
    const float mf = static_cast<float>(m);
    const float raw = coef / sum;                       // alpha * m^2 / sum
    float est = raw;
    if (raw <= 2.5f * mf && zeros > 0.f) {
      est = mf * logf(mf / fmaxf(zeros, 1e-9f));         // linear counting
    }
    const float two32 = 4294967296.f;
    if (est > two32 / 30.f) est = -two32 * log1pf(-est / two32);
    out[q] = est;
  }
}

}  // namespace

// regs: (Q, L, m) uint8, contiguous; out: (Q,) float32.  m is a power of
// two <= 1024; coef = float32(alpha(m) * m * m).
extern "C" int hll_merge_estimate(const void* regs, void* out, int Q, int L,
                                  int m, float coef, void* stream) {
  if (Q <= 0) return 0;
  const int threads = m < 32 ? 32 : m;
  hll_merge_estimate_kernel<<<Q, threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(regs), static_cast<float*>(out), L, m, coef);
  return static_cast<int>(cudaGetLastError());
}
