// The two query-route scans: the fused linear scan (dot form) and the
// fused LSH-route candidate verification.
//
// ---------------------------------------------------------------------------
// linear_scan_dot
// Replaces: repro/kernels/fused_scan.py, linear_scan_dot_pallas (body
// _linear_dot_kernel).  For a (Q, d) query chunk against the (N, d) corpus
// it computes ||q||^2 + ||x||^2 - 2 q.x clamped at 0 (l2) or 1 - q.x on
// pre-normalised rows (cosine), compares with the threshold, and writes the
// distances (f32), the report mask (0/1 bytes) and the column ids (i32),
// all (Q, N), in one pass.  The norms and the cosine normalisation are
// computed by the caller, as in repro's ops.py.
//
// Bound on an H100 SXM: device memory.  At the Webspam shape (one chunk of
// Q = 32 queries, N = 349,900, d = 254) it must read x once (355.5 MB) and
// write 9 B per (q, n) pair (100.8 MB): 456 MB, about 136 us at 3.35 TB/s,
// against 5.69 GFLOP, about 85 us at 67 TFLOP/s on the CUDA cores.
// Design: a block owns 32 queries x 128 corpus rows, so every corpus row is
// read from device memory once per query chunk, not once per query.  q and
// x are staged through shared memory in d-chunks of 32 (rows padded by one
// word so neither the transposing stores nor the reads conflict on banks);
// each of the 256 threads keeps a 4 x 4 tile of float32 sums in registers
// and accumulates with FMAs in IEEE float32 (no TF32, so distances near the
// radius do not move).  The epilogue writes all three outputs coalesced.
// No tensor cores, TMA or pipelining yet.
//
// ---------------------------------------------------------------------------
// lsh_scan
// Replaces: repro/kernels/fused_scan.py, lsh_scan_pallas (body _lsh_kernel).
// For each (query, candidate slot) of the sorted (Q, C) candidate ids it
// masks duplicate runs and sentinels ((id != prev) & (id < n)), gathers the
// candidate's corpus row, computes the l2 / l1 / cosine / Hamming distance
// and applies the threshold, writing (Q, C) distances and mask.
//
// Bound on an H100 SXM: device memory, in the gathered rows: distinct
// candidates x d x 4 B (at most 32 x 5,120 x 254 x 4 B = 166.5 MB per
// chunk, about 50 us), plus the ids in and the outputs out.  Design: one
// warp per candidate slot.  The lanes read the row in coalesced 128-byte
// strides straight from device memory (the corpus is not staged: at 355 MB
// it fits no on-chip memory), and reduce with warp shuffles.  A slot that
// is a duplicate or a sentinel skips its gather entirely, so only distinct
// rows are read; its distance is written as +inf and is not part of the
// contract (the mask is 0 there).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 32;    // queries per block
constexpr int kBN = 128;   // corpus rows per block
constexpr int kBK = 32;    // d-chunk staged per step
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
linear_scan_dot_kernel(const float* __restrict__ q, const float* __restrict__ x,
                       const float* __restrict__ qn,
                       const float* __restrict__ xn, float thresh, int mode,
                       float* __restrict__ dist, uint8_t* __restrict__ mask,
                       int32_t* __restrict__ ids, int Q, int N, int d) {
  __shared__ float qs[kBK][kBQ + 1];
  __shared__ float xs[kBK][kBN + 1];
  const int tid = threadIdx.x;
  const int tx = tid & 31;   // corpus columns tx + 32 j
  const int ty = tid >> 5;   // query rows ty + 8 i
  const int n0 = blockIdx.x * kBN;
  const int q0 = blockIdx.y * kBQ;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += kBK) {
#pragma unroll
    for (int s = 0; s < (kBQ * kBK) / kThreads; ++s) {
      const int idx = tid + s * kThreads;
      const int row = idx / kBK;
      const int k = idx % kBK;
      const int gq = q0 + row;
      const int gk = k0 + k;
      qs[k][row] = (gq < Q && gk < d) ? q[static_cast<int64_t>(gq) * d + gk] : 0.f;
    }
#pragma unroll
    for (int s = 0; s < (kBN * kBK) / kThreads; ++s) {
      const int idx = tid + s * kThreads;
      const int row = idx / kBK;
      const int k = idx % kBK;
      const int gn = n0 + row;
      const int gk = k0 + k;
      xs[k][row] = (gn < N && gk < d) ? x[static_cast<int64_t>(gn) * d + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kBK; ++k) {
      float a[4];
      float b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[k][ty + 8 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = xs[k][tx + 32 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gq = q0 + ty + 8 * i;
    if (gq >= Q) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 32 * j;
      if (gn >= N) continue;
      float v;
      if (mode == 0) {   // l2: norms - 2 q.x, clamped at 0
        v = fmaxf((qn[gq] + xn[gn]) - 2.f * acc[i][j], 0.f);
      } else {           // cosine on pre-normalised rows
        v = 1.f - acc[i][j];
      }
      const int64_t o = static_cast<int64_t>(gq) * N + gn;
      dist[o] = v;
      mask[o] = v <= thresh ? 1 : 0;
      ids[o] = gn;
    }
  }
}

enum Metric { kL2 = 0, kL1 = 1, kCosine = 2, kHamming = 3 };
constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int METRIC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
lsh_scan_kernel(const void* __restrict__ xv, const void* __restrict__ qv,
                const int32_t* __restrict__ ids,
                const int32_t* __restrict__ prev, float thresh,
                float* __restrict__ dist, uint8_t* __restrict__ mask, int Q,
                int C, int n, int d) {
  const int lane = threadIdx.x & 31;
  const int64_t slot =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (slot >= static_cast<int64_t>(Q) * C) return;   // warp-uniform
  const int id = ids[slot];
  const bool uniq = (id != prev[slot]) && (id < n);
  if (!uniq) {                                       // warp-uniform
    if (lane == 0) {
      dist[slot] = __int_as_float(0x7f800000);       // +inf, masked
      mask[slot] = 0;
    }
    return;
  }
  const int64_t row = min(max(id, 0), n - 1);
  const int64_t qi = slot / C;
  float v;
  if (METRIC == kHamming) {
    const int32_t* xr = static_cast<const int32_t*>(xv) + row * d;
    const int32_t* qr = static_cast<const int32_t*>(qv) + qi * d;
    int c = 0;
    for (int k = lane; k < d; k += 32) c += __popc(xr[k] ^ qr[k]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) c += __shfl_xor_sync(0xffffffffu, c, off);
    v = static_cast<float>(c);
  } else {
    const float* xr = static_cast<const float*>(xv) + row * d;
    const float* qr = static_cast<const float*>(qv) + qi * d;
    if (METRIC == kCosine) {
      float xx = 0.f, xq = 0.f, qq = 0.f;
#pragma unroll 4
      for (int k = lane; k < d; k += 32) {
        const float a = xr[k];
        const float b = qr[k];
        xx = fmaf(a, a, xx);
        xq = fmaf(a, b, xq);
        qq = fmaf(b, b, qq);
      }
      xx = warp_sum(xx);
      xq = warp_sum(xq);
      qq = warp_sum(qq);
      // 1 - sum (x / max(|x|, 1e-12)) (q / max(|q|, 1e-12)), with the two
      // norms factored out of the sum.
      v = 1.f - xq / (fmaxf(sqrtf(xx), 1e-12f) * fmaxf(sqrtf(qq), 1e-12f));
    } else {
      float s = 0.f;
#pragma unroll 4
      for (int k = lane; k < d; k += 32) {
        const float diff = xr[k] - qr[k];
        s += (METRIC == kL2) ? diff * diff : fabsf(diff);
      }
      v = warp_sum(s);
    }
  }
  if (lane == 0) {
    dist[slot] = v;
    mask[slot] = v <= thresh ? 1 : 0;
  }
}

}  // namespace

// q: (Q, d), x: (N, d), qn: (Q,), xn: (N,) float32, contiguous (qn, xn
// are read only for mode 0 = l2; mode 1 = cosine).  Outputs dist (Q, N)
// f32, mask (Q, N) u8, ids (Q, N) i32.
extern "C" int linear_scan_dot(const void* q, const void* x, const void* qn,
                               const void* xn, float thresh, int mode,
                               void* dist, void* mask, void* ids, int Q, int N,
                               int d, void* stream) {
  if (Q <= 0 || N <= 0) return 0;
  const dim3 grid((N + kBN - 1) / kBN, (Q + kBQ - 1) / kBQ);
  linear_scan_dot_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(x),
      static_cast<const float*>(qn), static_cast<const float*>(xn), thresh, mode,
      static_cast<float*>(dist), static_cast<uint8_t*>(mask),
      static_cast<int32_t*>(ids), Q, N, d);
  return static_cast<int>(cudaGetLastError());
}

// metric: 0 l2, 1 l1, 2 cosine (x, q float32), 3 hamming (x, q int32 bit
// views of packed uint32 codes).  x: (n, d), q: (Q, d), ids and prev:
// (Q, C) int32, contiguous.  Outputs dist (Q, C) f32, mask (Q, C) u8.
extern "C" int lsh_scan(int metric, const void* x, const void* q,
                        const void* ids, const void* prev, float thresh,
                        void* dist, void* mask, int Q, int C, int n, int d,
                        void* stream) {
  const int64_t slots = static_cast<int64_t>(Q) * C;
  if (slots <= 0) return 0;
  const unsigned blocks =
      static_cast<unsigned>((slots + kWarpsPerBlock - 1) / kWarpsPerBlock);
  auto s = static_cast<cudaStream_t>(stream);
  auto* i = static_cast<const int32_t*>(ids);
  auto* p = static_cast<const int32_t*>(prev);
  auto* dd = static_cast<float*>(dist);
  auto* mm = static_cast<uint8_t*>(mask);
  switch (metric) {
    case kL2:
      lsh_scan_kernel<kL2><<<blocks, kWarpsPerBlock * 32, 0, s>>>(x, q, i, p, thresh, dd, mm, Q, C, n, d);
      break;
    case kL1:
      lsh_scan_kernel<kL1><<<blocks, kWarpsPerBlock * 32, 0, s>>>(x, q, i, p, thresh, dd, mm, Q, C, n, d);
      break;
    case kCosine:
      lsh_scan_kernel<kCosine><<<blocks, kWarpsPerBlock * 32, 0, s>>>(x, q, i, p, thresh, dd, mm, Q, C, n, d);
      break;
    case kHamming:
      lsh_scan_kernel<kHamming><<<blocks, kWarpsPerBlock * 32, 0, s>>>(x, q, i, p, thresh, dd, mm, Q, C, n, d);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
