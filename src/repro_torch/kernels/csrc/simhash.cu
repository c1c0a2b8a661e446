// simhash
// Replaces: repro/kernels/simhash.py, simhash_pallas (body _kernel).  SimHash
// fingerprints: the projection x @ R of (N, d) points onto the (d, C)
// hyperplanes, C = L * words * 32 (each table's k columns zero-padded to a
// whole number of words, as ops.pad_projection does), then the sign bits
// packed LSB-first, bit j of word t = (projection onto column 32 t + j) > 0.
// Output (N, L * words) 32-bit words.  A zero-padded column projects to 0.0
// and so gives bit 0, as in the reference.
//
// Bound on an H100 SXM: operations.  2 N d L k FLOP for the family's k
// real columns per table: at the Webspam corpus (N = 349,900, d = 254,
// L = 20, k = 4) 14.2 GFLOP, about 0.21 ms at 67 TFLOP/s on the CUDA
// cores, against 384 MB moved (0.11 ms at 3.35 TB/s).  The projection runs
// in IEEE float32 FMAs, summed over d in order: no TF32, whose 10-bit
// mantissa would flip the bits of points near a hyperplane.
// Design: a block owns 64 rows x 128 lane columns.  The TPU kernel keeps R
// resident in VMEM; here R does not fit shared memory (0.65 MB per word at
// d = 254, L = 20), so x and R go through shared memory together in
// d-chunks of 32: the x tile row-major with rows padded to 36 floats (16 B
// aligned, so a float4 reads 4 consecutive d), the R tile with the block's
// 128 lane columns side by side.  Each warp owns 8 rows and the 4 groups
// of 32 lane columns: lane j accumulates lane column j of each group for
// each of the 8 rows (32 sums in registers), reading x as float4
// broadcasts and R conflict-free.  A word owns kp consecutive lane
// columns: kp = 32 when k > 16, else the power of two at or above k, so a
// word whose table has k = 4 costs 4 lanes, not 32 (R's zero columns past
// k within those kp give 0.0, bit 0).  The epilogue needs no shifts for
// the sums: __ballot_sync(full, sum > 0) over the warp is 32 / kp packed
// words side by side (bit j of a word = lane j of its kp), and each lane
// writes the words of one of the warp's 32 (row, group) ballots.  Blocks
// that share rows are numbered consecutively, so an x tile is read from
// device memory about once and its other word groups find it in L2.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 8;
constexpr int kBR = kWarps * kRowsPerWarp;   // rows per block
constexpr int kBW = 4;                       // groups of 32 lane columns
constexpr int kBC = kBW * 32;                // lane columns per block
constexpr int kBK = 32;                      // d-chunk
constexpr int kXStride = kBK + 4;            // padded x-tile row, 16 B aligned
static_assert(kRowsPerWarp * kBW == 32, "one ballot per lane");

// ptxas gives this 212 registers (a d-chunk's loads hoisted), room for one
// block per SM.  Capping it at two blocks per SM (128 registers) spills and
// was slower on an H100, so there is no cap.
__global__ void __launch_bounds__(kThreads)
simhash_kernel(const float* __restrict__ x, const float* __restrict__ r,
               uint32_t* __restrict__ out, int N, int d, int TW, int kp) {
  __shared__ __align__(16) float xs[kBR * kXStride];
  __shared__ float rs[kBK * kBC];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int per = 32 / kp;                      // words per 32 lane columns
  const int bw = kBW * per;                     // words per block
  const int groups = (TW + bw - 1) / bw;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x / groups) * kBR;
  const int t0 = (blockIdx.x % groups) * bw;    // first word of the block
  const int64_t C = static_cast<int64_t>(TW) * 32;

  float acc[kRowsPerWarp][kBW];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
    for (int w = 0; w < kBW; ++w) acc[i][w] = 0.f;

  for (int k0 = 0; k0 < d; k0 += kBK) {
#pragma unroll
    for (int s = 0; s < (kBR * kBK) / kThreads; ++s) {
      const int idx = tid + s * kThreads;
      const int row = idx / kBK;
      const int k = idx % kBK;
      const int64_t gn = n0 + row;
      const int gk = k0 + k;
      xs[row * kXStride + k] = (gn < N && gk < d) ? x[gn * d + gk] : 0.f;
    }
#pragma unroll
    for (int s = 0; s < (kBK * kBC) / kThreads; ++s) {
      const int idx = tid + s * kThreads;
      const int k = idx / kBC;
      const int c = idx % kBC;
      const int gk = k0 + k;
      // lane column c is bit c % kp of word t0 + c / kp
      const int64_t gc = static_cast<int64_t>(t0 + c / kp) * 32 + c % kp;
      rs[k * kBC + c] = (gk < d && gc < C) ? r[gk * C + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 xv[kRowsPerWarp];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i)
        xv[i] = *reinterpret_cast<const float4*>(
            &xs[(warp * kRowsPerWarp + i) * kXStride + kk]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float rv[kBW];
#pragma unroll
        for (int w = 0; w < kBW; ++w) rv[w] = rs[(kk + j) * kBC + w * 32 + lane];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          const float xe = j == 0 ? xv[i].x : j == 1 ? xv[i].y
                         : j == 2 ? xv[i].z : xv[i].w;
#pragma unroll
          for (int w = 0; w < kBW; ++w) acc[i][w] = fmaf(xe, rv[w], acc[i][w]);
        }
      }
    }
    __syncthreads();
  }

  uint32_t mine = 0;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
    for (int w = 0; w < kBW; ++w) {
      const uint32_t bits = __ballot_sync(0xffffffffu, acc[i][w] > 0.f);
      if (lane == i * kBW + w) mine = bits;
    }
  const int64_t row = n0 + warp * kRowsPerWarp + lane / kBW;
  const uint32_t keep = kp == 32 ? 0xffffffffu : (1u << kp) - 1u;
  for (int g = 0; g < per; ++g) {
    const int t = t0 + (lane % kBW) * per + g;
    if (row < N && t < TW) out[row * TW + t] = (mine >> (g * kp)) & keep;
  }
}

}  // namespace

// x: (N, d) float32, r: (d, TW * 32) float32 (TW = L * words, each
// word's columns past the family's k zero), contiguous.  kp: lane columns
// per word, a power of two from 1 to 32, and 32 when a table has more than
// one word; the columns of a word from kp on must be zero.  Output out
// (N, TW) 32-bit words.
extern "C" int simhash(const void* x, const void* r, void* out, int N, int d,
                       int TW, int kp, void* stream) {
  if (N <= 0 || TW <= 0) return 0;
  if (d < 1 || kp < 1 || kp > 32 || (kp & (kp - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bw = kBW * (32 / kp);
  const int64_t blocks =
      static_cast<int64_t>((N + kBR - 1) / kBR) * ((TW + bw - 1) / bw);
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  simhash_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(r),
      static_cast<uint32_t*>(out), N, d, TW, kp);
  return static_cast<int>(cudaGetLastError());
}
