// The query-route scans: the fused linear scans (dot form, L1, Hamming)
// and the fused LSH-route candidate verification; and the distance
// matrices (dot form, L1, Hamming) that share the linear scans' kernels.
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
// linear_scan_l1
// Replaces: repro/kernels/fused_scan.py, linear_scan_l1_pallas (body
// _linear_l1_kernel).  sum_d |q - x| in float32 for a (Q, d) query chunk
// against the (N, d) corpus, then the threshold, the mask and the ids, as
// linear_scan_dot writes them.
//
// Bound on an H100 SXM: device memory.  At the CoverType shape (one chunk
// of Q = 32 queries, N = 524,288, d = 54) it reads x once (113.2 MB) and
// writes 9 B per pair (151.0 MB): 0.079 ms at 3.35 TB/s, against 2.7 GFLOP
// (a subtract, an absolute value and an add per term), 0.041 ms at
// 67 TFLOP/s.  The sum has no matmul form, so it runs on the CUDA cores.
// Design: the tile of linear_scan_dot (32 queries x 128 rows per block, d
// through shared memory in chunks of 32, a 4 x 4 register tile of sums per
// thread), with |a - b| summed in place of the FMA.  A d that is not a
// multiple of the chunk (54, 37) is masked on load: the tail loads zeros on
// both sides, which add |0 - 0| = 0.
//
// ---------------------------------------------------------------------------
// pairwise_dot and pairwise_l1
// Replace: repro/kernels/distances.py, pairwise_dot_pallas (body _dot_kernel)
// and pairwise_l1_pallas (body _l1_kernel).  The (Q, N) distance matrix
// alone, with no threshold, mask or ids: ||q||^2 + ||x||^2 - 2 q.x clamped
// at 0 (l2; repro's ops.pairwise_dist clamps the kernel's output, which
// gives the same values), 1 - q.x on rows the caller normalised (cosine),
// or sum |q - x| (l1).  They are the tile of linear_scan_dot and
// linear_scan_l1 with a distances-only epilogue (template DIST_ONLY), so
// each pair costs 4 B of output instead of 9.
//
// Bound on an H100 SXM, at the shapes cost_model.calibrate's callers give
// (100 queries, the whole corpus): operations for cosine at Webspam
// (N = 349,900, d = 254: 17.8 GFLOP, 0.265 ms at 67 TFLOP/s, against
// 496 MB, 0.148 ms at 3.35 TB/s) and for l1 at CoverType (N = 580,912,
// d = 54: 9.41 G operations, 0.140 ms, against 358 MB); bytes for l2 at
// Corel (N = 67,940, d = 32: 35.9 MB, 0.011 ms).  A block computes 32
// queries whatever Q is, so Q = 100 runs four query blocks, the last with
// 4 real rows: 28 % more FMAs than the work needs.  The blocks of one row
// tile are numbered consecutively (query block fastest), so they run
// together and the corpus tile they share is read from device memory about
// once, not once per query block (the 355 MB Webspam corpus does not fit
// the 50 MB L2).
//
// ---------------------------------------------------------------------------
// linear_scan_hamming and hamming
// Replace: repro/kernels/fused_scan.py, linear_scan_hamming_pallas (body
// _linear_hamming_kernel), and repro/kernels/hamming.py, hamming_pallas
// (body _kernel).  XOR and __popc over the W packed 32-bit words of each
// (query, row) pair, summed as int32.  linear_scan_hamming writes it as
// float32 (exact for distances up to 2^24), the mask float(d) <= thresh,
// as the reference casts it, and the ids as above; hamming writes the
// (Q, N) int32 matrix alone (template DIST_ONLY).  Any W: the TPU kernels
// put a whole code in VMEM whatever W is, and so take any W too.
//
// Bound on an H100 SXM: device memory, and in practice launch latency.  At
// the MNIST shape (W = 2, N = 59,900) the scan of one chunk of Q = 32
// reads 0.5 MB of codes and writes 17.3 MB (about 5 us at 3.35 TB/s); the
// matrix of Q = 100 writes 24.0 MB (about 7 us).  Design: one corpus row
// per thread, the block's 32 query codes in shared memory, read as
// broadcasts, the 32 per-query sums in registers, and a warp's writes
// consecutive in n, so they coalesce.  The words are walked in chunks of
// 8: each chunk of the 32 query codes is staged in shared memory and the
// row's chunk is held in registers.  Words past W in the last chunk are
// skipped (the chunk's word count is the same for every thread).
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

enum LinearMode { kDotL2 = 0, kDotCosine = 1, kAbsL1 = 2 };

// Blocks of the tile kernel for a (Q, N) output: one per 32 queries x 128
// rows, on a 1-D grid.  0 if the count does not fit a launch.
unsigned tile_blocks(int Q, int N) {
  const int64_t b = static_cast<int64_t>((N + kBN - 1) / kBN) * ((Q + kBQ - 1) / kBQ);
  return b > 0x7fffffff ? 0u : static_cast<unsigned>(b);
}

// DIST_ONLY: write the distances only (pairwise_dot / pairwise_l1); mask
// and ids are then null and unwritten.
template <int MODE, bool DIST_ONLY>
__global__ void __launch_bounds__(kThreads)
linear_scan_tile_kernel(const float* __restrict__ q, const float* __restrict__ x,
                        const float* __restrict__ qn,
                        const float* __restrict__ xn, float thresh,
                        float* __restrict__ dist, uint8_t* __restrict__ mask,
                        int32_t* __restrict__ ids, int Q, int N, int d) {
  __shared__ float qs[kBK][kBQ + 1];
  __shared__ float xs[kBK][kBN + 1];
  const int tid = threadIdx.x;
  const int tx = tid & 31;   // corpus columns tx + 32 j
  const int ty = tid >> 5;   // query rows ty + 8 i
  const int qblocks = (Q + kBQ - 1) / kBQ;
  const int n0 = (blockIdx.x / qblocks) * kBN;   // < N, so it fits an int
  const int q0 = (blockIdx.x % qblocks) * kBQ;

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
        for (int j = 0; j < 4; ++j) {
          if (MODE == kAbsL1) {
            acc[i][j] += fabsf(a[i] - b[j]);
          } else {
            acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
          }
        }
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
      if (MODE == kDotL2) {          // norms - 2 q.x, clamped at 0
        v = fmaxf((qn[gq] + xn[gn]) - 2.f * acc[i][j], 0.f);
      } else if (MODE == kDotCosine) {  // on pre-normalised rows
        v = 1.f - acc[i][j];
      } else {                       // sum |q - x|
        v = acc[i][j];
      }
      const int64_t o = static_cast<int64_t>(gq) * N + gn;
      dist[o] = v;
      if (!DIST_ONLY) {
        mask[o] = v <= thresh ? 1 : 0;
        ids[o] = gn;
      }
    }
  }
}

constexpr int kHamRows = 256;   // corpus rows per block, one per thread
constexpr int kHamQ = 32;       // queries per block
constexpr int kHamWords = 8;    // words of each code staged per step
static_assert(kHamQ * kHamWords == kHamRows, "one staged query word per thread");

// DIST_ONLY: write the int32 distances only (hamming); mask and ids are
// then null and unwritten.  Otherwise dist is float32 (linear_scan_hamming).
template <bool DIST_ONLY>
__global__ void __launch_bounds__(kHamRows)
linear_scan_hamming_kernel(const uint32_t* __restrict__ q,
                           const uint32_t* __restrict__ x, float thresh,
                           void* __restrict__ dist, uint8_t* __restrict__ mask,
                           int32_t* __restrict__ ids, int Q, int N, int W) {
  __shared__ uint32_t qs[kHamQ][kHamWords];
  const int n = blockIdx.x * kHamRows + threadIdx.x;
  const int q0 = blockIdx.y * kHamQ;
  const int nq = min(kHamQ, Q - q0);
  const int si = threadIdx.x / kHamWords;   // the query word this thread stages
  const int sw = threadIdx.x % kHamWords;
  int c[kHamQ];
#pragma unroll
  for (int i = 0; i < kHamQ; ++i) c[i] = 0;
  for (int w0 = 0; w0 < W; w0 += kHamWords) {
    const int nw = min(kHamWords, W - w0);
    __syncthreads();   // every thread is done with the previous chunk
    qs[si][sw] = (si < nq && sw < nw)
                     ? q[static_cast<int64_t>(q0 + si) * W + w0 + sw] : 0u;
    __syncthreads();
    uint32_t xr[kHamWords];
#pragma unroll
    for (int w = 0; w < kHamWords; ++w)
      xr[w] = (n < N && w < nw) ? x[static_cast<int64_t>(n) * W + w0 + w] : 0u;
#pragma unroll
    for (int i = 0; i < kHamQ; ++i)
#pragma unroll
      for (int w = 0; w < kHamWords; ++w)
        if (w < nw) c[i] += __popc(xr[w] ^ qs[i][w]);
  }
  if (n >= N) return;
#pragma unroll
  for (int i = 0; i < kHamQ; ++i) {
    if (i >= nq) continue;
    const int64_t o = static_cast<int64_t>(q0 + i) * N + n;
    if (DIST_ONLY) {
      static_cast<int32_t*>(dist)[o] = c[i];
    } else {
      const float v = static_cast<float>(c[i]);
      static_cast<float*>(dist)[o] = v;
      mask[o] = v <= thresh ? 1 : 0;
      ids[o] = n;
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
  const unsigned grid = tile_blocks(Q, N);
  if (grid == 0) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto* qf = static_cast<const float*>(q);
  auto* xf = static_cast<const float*>(x);
  auto* qnf = static_cast<const float*>(qn);
  auto* xnf = static_cast<const float*>(xn);
  auto* dd = static_cast<float*>(dist);
  auto* mm = static_cast<uint8_t*>(mask);
  auto* ii = static_cast<int32_t*>(ids);
  switch (mode) {
    case kDotL2:
      linear_scan_tile_kernel<kDotL2, false><<<grid, kThreads, 0, s>>>(qf, xf, qnf, xnf, thresh, dd, mm, ii, Q, N, d);
      break;
    case kDotCosine:
      linear_scan_tile_kernel<kDotCosine, false><<<grid, kThreads, 0, s>>>(qf, xf, qnf, xnf, thresh, dd, mm, ii, Q, N, d);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// q: (Q, d), x: (N, d) float32, contiguous.  Outputs dist (Q, N) f32,
// mask (Q, N) u8, ids (Q, N) i32.
extern "C" int linear_scan_l1(const void* q, const void* x, float thresh,
                              void* dist, void* mask, void* ids, int Q, int N,
                              int d, void* stream) {
  if (Q <= 0 || N <= 0) return 0;
  const unsigned grid = tile_blocks(Q, N);
  if (grid == 0) return static_cast<int>(cudaErrorInvalidValue);
  linear_scan_tile_kernel<kAbsL1, false><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(x), nullptr,
      nullptr, thresh, static_cast<float*>(dist), static_cast<uint8_t*>(mask),
      static_cast<int32_t*>(ids), Q, N, d);
  return static_cast<int>(cudaGetLastError());
}

// q: (Q, d), x: (N, d), qn: (Q,), xn: (N,) float32, contiguous (qn, xn
// are read only for mode 0 = l2; mode 1 = cosine).  Output dist (Q, N) f32.
extern "C" int pairwise_dot(const void* q, const void* x, const void* qn,
                            const void* xn, int mode, void* dist, int Q, int N,
                            int d, void* stream) {
  if (Q <= 0 || N <= 0) return 0;
  const unsigned grid = tile_blocks(Q, N);
  if (grid == 0) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto* qf = static_cast<const float*>(q);
  auto* xf = static_cast<const float*>(x);
  auto* qnf = static_cast<const float*>(qn);
  auto* xnf = static_cast<const float*>(xn);
  auto* dd = static_cast<float*>(dist);
  switch (mode) {
    case kDotL2:
      linear_scan_tile_kernel<kDotL2, true><<<grid, kThreads, 0, s>>>(qf, xf, qnf, xnf, 0.f, dd, nullptr, nullptr, Q, N, d);
      break;
    case kDotCosine:
      linear_scan_tile_kernel<kDotCosine, true><<<grid, kThreads, 0, s>>>(qf, xf, qnf, xnf, 0.f, dd, nullptr, nullptr, Q, N, d);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// q: (Q, d), x: (N, d) float32, contiguous.  Output dist (Q, N) f32.
extern "C" int pairwise_l1(const void* q, const void* x, void* dist, int Q,
                           int N, int d, void* stream) {
  if (Q <= 0 || N <= 0) return 0;
  const unsigned grid = tile_blocks(Q, N);
  if (grid == 0) return static_cast<int>(cudaErrorInvalidValue);
  linear_scan_tile_kernel<kAbsL1, true><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(x), nullptr,
      nullptr, 0.f, static_cast<float*>(dist), nullptr, nullptr, Q, N, d);
  return static_cast<int>(cudaGetLastError());
}

// q: (Q, W), x: (N, W) packed 32-bit codes (int32 bit views read as
// unsigned), contiguous, W >= 1.  Outputs dist (Q, N) f32, mask (Q, N) u8,
// ids (Q, N) i32.
extern "C" int linear_scan_hamming(const void* q, const void* x, float thresh,
                                   void* dist, void* mask, void* ids, int Q,
                                   int N, int W, void* stream) {
  if (Q <= 0 || N <= 0) return 0;
  if (W < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + kHamRows - 1) / kHamRows, (Q + kHamQ - 1) / kHamQ);
  linear_scan_hamming_kernel<false><<<grid, kHamRows, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(x), thresh,
      dist, static_cast<uint8_t*>(mask), static_cast<int32_t*>(ids), Q, N, W);
  return static_cast<int>(cudaGetLastError());
}

// q: (Q, W), x: (N, W) packed 32-bit codes (int32 bit views read as
// unsigned), contiguous, W >= 1.  Output out (Q, N) int32.
extern "C" int hamming(const void* q, const void* x, void* out, int Q, int N,
                       int W, void* stream) {
  if (Q <= 0 || N <= 0) return 0;
  if (W < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + kHamRows - 1) / kHamRows, (Q + kHamQ - 1) / kHamQ);
  linear_scan_hamming_kernel<true><<<grid, kHamRows, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(x), 0.f,
      out, nullptr, nullptr, Q, N, W);
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
