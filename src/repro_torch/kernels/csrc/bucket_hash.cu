// The bucket hash: a batch's LSH projection -> its (n, L) int32 bucket ids in
// one launch.
//
// Replaces no Pallas kernel.  The reference hashes with a jnp chain
// (repro/core/lsh/families.py: the codes, then _mix_words_to_bucket's
// hash32 over the code words), which XLA fused into one kernel on the TPU.
// Run eagerly by PyTorch, the same chain is one launch an integer op:
// repro_torch/u32.py splits each uint32 multiply into masked 16-bit halves
// on int64 tensors, so fmix32 is ~22 ops a code word, and a p-stable code of
// k = 8 words takes ~196 launches a batch.  This kernel is everything after
// the projection's matmul, which stays a torch.matmul (fp32).
//
// One thread per (row, table) group g.  It reads the group's k inputs, builds
// each 32-bit code word in registers (no code word goes to device memory) and
// mixes the words in order with murmur3's fmix32 in native uint32 arithmetic,
// as repro_torch/core/lsh/families.py _mix_words_to_bucket does:
//   acc = 17;  acc = fmix32(acc ^ word_j, seed 17 + j) for j = 0..W-1;
//   out[g] = acc & (B - 1).
// The front end that makes the words is the family's:
//   sign  (SimHash): bit i = proj[g, i] > 0, packed LSB-first into
//         ceil(k / 32) words, the last zero-padded (_pack_bits);
//   floor (p-stable L1 / L2): word i = the low 32 bits of
//         (long long) floorf(__fdiv_rn(__fadd_rn(proj[g, i], b[t, i]), w)),
//         t = g % L: a true division, never a reciprocal multiply, and the
//         float -> int64 conversion torch's CUDA .to(int64) uses, so
//         out-of-range and non-finite values land where the plain path's do;
//   words (BitSampling, multi-probe's perturbed codes): word i = the low 32
//         bits of the int64 input, the port's carrier of a uint32 value.
// So the bucket ids equal the plain path's on the same projection, bit for
// bit: the CSR tables, the HLL registers and the routes key on them.
//
// Bound on an H100: bytes.  A Webspam / CoverType batch of 1,024 queries
// reads n * L * k * 4 B of projection (0.66 MB at L = 20, k = 8) and writes
// n * L * 4 B, about 0.2 us at 3.35 TB/s; the integer work (~16 instructions
// a word) is smaller still.  So a launch's latency bounds it, and the design
// is one launch with every intermediate in registers.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr uint32_t kSeed = 17u;   // families._mix_words_to_bucket's seed

enum Front { kSign = 0, kFloor = 1, kWords = 2 };

// repro_torch/core/hll.py hash32: murmur3 fmix32 of x + seed * golden ratio.
__device__ __forceinline__ uint32_t fmix32(uint32_t x, uint32_t seed) {
  uint32_t h = x + seed * 0x9E3779B9u;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// src: (G, k) float32 (sign, floor) or int64 (words), contiguous;
// b: (L, k) float32 offsets (floor only); out: (G,) int32.
template <int F>
__global__ void __launch_bounds__(kThreads)
bucket_hash_kernel(const void* __restrict__ src, const float* __restrict__ b,
                   float w, int64_t groups, int k, int L, uint32_t mask,
                   int32_t* __restrict__ out) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (g >= groups) return;
  uint32_t acc = kSeed;
  if constexpr (F == kWords) {
    const int64_t* x = static_cast<const int64_t*>(src) + g * k;
    for (int j = 0; j < k; ++j)
      acc = fmix32(acc ^ static_cast<uint32_t>(x[j]), kSeed + j);
  } else if constexpr (F == kFloor) {
    const float* p = static_cast<const float*>(src) + g * k;
    const float* bt = b + static_cast<int64_t>(g % L) * k;
    for (int j = 0; j < k; ++j) {
      const float v = __fdiv_rn(__fadd_rn(p[j], bt[j]), w);
      const uint32_t word =
          static_cast<uint32_t>(static_cast<long long>(floorf(v)));
      acc = fmix32(acc ^ word, kSeed + j);
    }
  } else {
    const float* p = static_cast<const float*>(src) + g * k;
    for (int j = 0; j * 32 < k; ++j) {
      const int n = min(32, k - j * 32);
      uint32_t word = 0;
      for (int i = 0; i < n; ++i)
        word |= static_cast<uint32_t>(p[j * 32 + i] > 0.0f) << i;
      acc = fmix32(acc ^ word, kSeed + j);
    }
  }
  out[g] = static_cast<int32_t>(acc & mask);
}

}  // namespace

// front: 0 sign, 1 floor, 2 words.  groups = rows * L (sign, floor) or the
// number of code-word rows (words, k = words a row, L = 1); mask = B - 1.
extern "C" int bucket_hash(int front, const void* src, const void* b, float w,
                           long long groups, int k, int L, unsigned mask,
                           void* out, void* stream) {
  if (groups <= 0) return 0;
  const dim3 grid(static_cast<unsigned>((groups + kThreads - 1) / kThreads));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* bb = static_cast<const float*>(b);
  auto* o = static_cast<int32_t*>(out);
  switch (front) {
    case kSign:
      bucket_hash_kernel<kSign><<<grid, kThreads, 0, s>>>(src, bb, w, groups,
                                                          k, L, mask, o);
      break;
    case kFloor:
      bucket_hash_kernel<kFloor><<<grid, kThreads, 0, s>>>(src, bb, w, groups,
                                                           k, L, mask, o);
      break;
    case kWords:
      bucket_hash_kernel<kWords><<<grid, kThreads, 0, s>>>(src, bb, w, groups,
                                                           k, L, mask, o);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
