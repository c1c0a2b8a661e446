// simhash (K9)
// Replaces: repro/kernels/simhash.py, simhash_pallas (:34, body _kernel).
// SimHash fingerprints: the sign bits of the projection x @ R of (N, d)
// points onto the family's hyperplanes, packed LSB-first into 32-bit
// words, bit j of word t = (projection onto word t's column j) > 0.
// Output (N, TW) words, TW = L * words.  A zero (padding) column projects
// to 0.0 and gives bit 0, as in the reference; so does a NaN.
//
// Bound on an H100 SXM: device memory.  x read once, R once, the words
// written once: at the Webspam corpus (N = 349,900, d = 254, L = 20,
// k = 4) 355.5 + 0.08 + 28.0 = 383.6 MB, 0.1145 ms at 3.35 TB/s, against
// 3 x 2 N d L k = 42.7 GFLOP of TF32 tensor-core work, 0.086 ms at
// 495 TFLOP/s.
//
// Arithmetic: tensor cores, mma.sync m16n8k8 in TF32, three passes: each
// operand v split as hi = tf32_rna(v), lo = tf32_rna(v - hi), and
// lo.hi' + hi.lo' + hi.hi' summed in fp32.  This is the dot tile's
// arithmetic (fused_scan.cu, tests/test_torch_tf32.py), the rounding done
// in integer adds: about as close to float64 as fp32 FMAs, so bits move
// only where the float64 projection lies within the 1e-5 band the checks
// allow.
//
// Design:
//  * Only the real columns, laid out by the wrapper
//    (simhash.compact_projection): a word of a k-bit table takes npw
//    nibbles of 4 columns (npw = lanes_per_word(k) / 4, at least 1), so
//    Webspam computes 80 columns, not 640.  Each column group is stored
//    (16 NFW, d), K-contiguous: the .col B operand.  Columns are permuted
//    so that the accumulator's sign ballots are the packed words.  In
//    m16n8k8 lane (g, t) holds columns 2t and 2t + 1 of rows g and g + 8;
//    slot s = 2 f + e of a warp (its fragment f, column parity e) holds
//    nibble s % npw of word s / npw, bit t of the nibble in lane t, and
//    __ballot_sync of one accumulator register is that slot's nibbles of
//    8 rows side by side (row g at bits 4g..4g+3).
//  * R resident in shared memory.  A block stages its column group once
//    for its whole life, columns padded to (d rounded up to 32) + 4 words
//    so that fragment loads do not conflict on banks: 80 x 260 x 4 B =
//    83 KB at Webspam.  A group holds at most 128 columns (32 / npw
//    words); more words take more groups (gridDim.y), whose blocks of one
//    row tile run together, so x comes from L2 after its first read.
//  * Warps in pairs.  Each of a block's 4 pairs owns 32 rows at a time;
//    each of its 2 warps those rows (2 m-fragments) and one half of the
//    group's words (NFW fragments, whole words: ceil(words / 2) a half).
//    Per 8-wide k step a warp splits its 2 A and NFW B fragments, then
//    runs each of the three passes over all 2 NFW accumulators.  Two
//    m-fragments a warp halve the B loads and splits an MMA.
//  * x read once, whole rows (kBulk).  Each pair walks its own 32-row
//    tiles of a persistent block's share (pair p the block's tiles p,
//    p + 4, ...), at its own pace: while one pair waits for its rows or
//    packs its words, the others keep the tensor cores busy.  A tile of
//    contiguous x is one span of 32 d floats: one thread fetches it with
//    one cp.async.bulk (TMA's 1-D copy, completion on an mbarrier) into
//    the pair's stage (1 or 2 a pair, 32.5 KB at Webspam).  The span is
//    aligned down to 16 B, so the tile starts 0-3 floats into its stage,
//    whatever x's alignment (x[1:] views); its last 0-3 floats past a
//    16-B boundary are loaded by that thread before it arrives.  A stage
//    is refilled as soon as both warps have left it, so the copy is in
//    flight during the pair's epilogue.  Rows are not padded (at d = 254
//    the A-fragment loads conflict 2-way on banks).  The last k step of a
//    row reads the next row's first floats: a select zeroes the columns
//    past d (R's zero padding would not: Inf . 0 = NaN).
//  * Where R's group and a stage a pair do not fit (128 columns at
//    d = 254; 80 columns past d = 275), kChunk: the dot tile's loader, a
//    cp.async ring of 32-column chunks of 128 rows (rows padded to 36
//    words; copy width 16, 8 or 4 B by alignment; past d and N
//    zero-filled) that the whole block steps through together, with R
//    staged whole or, where it does not fit, in d-panels restaged for
//    every tile.  sim_plan chooses the loader.
//  * Epilogue: each warp ballots its 8 NFW registers into shared memory;
//    the pair meets at a named barrier and assembles its 32 rows' words
//    from the nibbles, at positions computed once per thread.  With one
//    column group those words are one contiguous span, 16-B aligned:
//    16-byte stores.
//  * What holds it back (tools/simhash_ab.py at Webspam on an H100 SXM,
//    PERF.md): the arithmetic, not the loads.  Computing again on rows
//    already in shared memory takes about as long as the kernel (0.26 of
//    0.27 ms); the copies alone take 0.15 ms, as long as torch.sum(x).
//    The three mma.sync passes (0.16 ms at the rate the dot tile reaches)
//    share two warps' instruction slots an SMSP with the loads and splits of
//    the fragments; the split by cvt.rna.tf32.f32 took 0.31 ms.
//    Shared memory (R and a 32-row stage a pair) holds no more warps.
//
// The helpers from ceil_div to cp_async_wait_at_most are copies of
// fused_scan.cu's (split_tf32 in integer adds), so that file (K1-K8)
// stays as it was measured.
#include <algorithm>
#include <cstdint>
#include <mutex>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;     // 8 warps: 4 pairs x 2 column halves
constexpr int kPairs = 4;
constexpr int kPairRows = 32;     // rows a pair's tile: 2 m-fragments a warp
constexpr int kChunkRows = kPairs * kPairRows;   // kChunk: rows a block tile
constexpr int kBK = 32;           // kChunk: d-columns a ring stage
constexpr int kXS = kBK + 4;      // kChunk: words a row in a stage
constexpr int kMaxPairStages = 2; // kBulk: stages a pair
constexpr int kChunkMinStages = 3;
constexpr int kMaxStages = 4;     // kChunk
constexpr int kMaxNfw = 8;        // 128 columns a group

enum Mode { kBulk = 0, kChunk = 1 };

struct SimArgs {
  const float* x;        // (N, d)
  const float* r;        // (groups, 16 NFW, d): the compact projection
  uint32_t* out;         // (N, TW)
  int N, d, TW;
  int npw;               // nibbles (4 columns) a word
  int wg;                // words a column group
  int wh;                // words a warp's column half
  int tiles;             // row tiles: a pair's 32 (kBulk), a block's 128
  int panel;             // d-columns of R staged at once (a multiple of 32)
  int stages;            // depth of the ring (kBulk: a pair's)
  int sstride;           // kBulk: floats a stage
};

// How a call is laid out on the card (sim_plan, run).
struct SimPlan {
  int mode, vec, nfw, groups, tiles, panel, stages, smem, occupancy, grid_x;
};

__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int round_up(int a, int b) { return ceil_div(a, b) * b; }

// v = hi + lo up to 2^-22 |v|: both TF32, rounded to nearest, ties away,
// as fused_scan.cu's cvt.rna.tf32.f32 split, in integer adds: half the
// unit of the 13 dropped bits is added to the magnitude's bits.  The
// tensor cores ignore a TF32 operand's 13 low bits, so only the value
// subtracted for lo has them cleared.  Two IADDs, a LOP3 and an FADD
// where the conversions took 2 CVTs and an FADD, and were most of the
// k step's instruction slots (variant split_cvt of tools/simhash_ab.py).  A NaN
// whose payload carries into the sign bit becomes a zero; the NaNs that
// arithmetic makes do not.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(v) + 0x1000u;
  lo = __float_as_uint(v - __uint_as_float(hi & 0xffffe000u)) + 0x1000u;
}

// c += a b: a 16 x 8 (rows x k) A and an 8 x 8 (k x columns) B fragment.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy VEC floats to shared memory, or zeros where !valid (src unread).
template <int VEC>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 4 * VEC : 0;
  if (VEC == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(s), "l"(src), "n"(4 * VEC), "r"(bytes));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Wait until at most n (0 to kMaxStages - 2) groups are pending.
__device__ __forceinline__ void cp_async_wait_at_most(int n) {
  static_assert(kMaxStages == 4, "one case per depth");
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    default: cp_async_wait<2>(); break;
  }
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

// ---- mbarriers and the bulk copy (kBulk) -----------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// Arrive, and expect `bytes` more of the transaction (a bulk copy's).
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// Wait until the phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  }
}

// One TMA 1-D copy of `bytes` (a multiple of 16, both addresses 16-B
// aligned) from device memory to this block's shared memory.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// ---- the tile's arithmetic and epilogue ----------------------------------

// One 8-wide k step of a warp over its 32 rows (two m-fragments) and its
// half's NFW fragments: A row g of each 8-row quarter at xa + 8 q xs
// (column t added), B at rb (column g, k t added; fragment f 8 rstride
// further).  EDGE: columns k + t and k + t + 4 at or past d are zeroed
// (`left` = d - k).
template <int NFW, bool EDGE>
__device__ __forceinline__ void kstep(float (&acc)[2][NFW][4], const float* xa,
                                      int xs, const float* rb, int rstride,
                                      int k, int left) {
  float v[2][4];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const float* x0 = xa + 16 * m * xs + k;
    v[m][0] = x0[0];              // (row g,     k t)
    v[m][1] = x0[8 * xs];         // (row g + 8, k t)
    v[m][2] = x0[4];              // (row g,     k t + 4)
    v[m][3] = x0[8 * xs + 4];     // (row g + 8, k t + 4)
    if (EDGE) {
      const int t = threadIdx.x & 3;
      if (t >= left) v[m][0] = v[m][1] = 0.f;
      if (t + 4 >= left) v[m][2] = v[m][3] = 0.f;
    }
  }
  uint32_t ah[2][4], al[2][4], bh[NFW][2], bl[NFW][2];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) split_tf32(v[m][j], ah[m][j], al[m][j]);
#pragma unroll
  for (int f = 0; f < NFW; ++f) {
    split_tf32(rb[f * 8 * rstride + k], bh[f][0], bl[f][0]);
    split_tf32(rb[f * 8 * rstride + k + 4], bh[f][1], bl[f][1]);
  }
  // Each pass over both m-fragments and all NFW fragments: 2 NFW
  // independent MMAs in a row.
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int f = 0; f < NFW; ++f) mma_tf32(acc[m][f], al[m], bh[f][0], bh[f][1]);
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int f = 0; f < NFW; ++f) mma_tf32(acc[m][f], ah[m], bl[f][0], bl[f][1]);
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int f = 0; f < NFW; ++f) mma_tf32(acc[m][f], ah[m], bh[f][0], bh[f][1]);
}

__device__ __forceinline__ void pair_sync(int pair) {
  asm volatile("bar.sync %0, 64;\n" :: "r"(1 + pair) : "memory");
}

// Where word w (of the group) of row `row` (of the pair's 32) finds its
// first nibble: (ballot index in the pair's area) << 5 | shift.  The
// pair's area is [half][m-fragment][slot][row half] (4 x 4 NFW ballots).
__device__ __forceinline__ int nibble_at(const SimArgs& a, int nfw, int row, int w) {
  const int half = w / a.wh;
  const int slot = (w - half * a.wh) * a.npw;
  const int idx = ((half * 2 + (row >> 4)) * 2 * nfw + slot) * 2 + ((row >> 3) & 1);
  return idx << 5 | 4 * (row & 7);
}

// A word from its npw nibbles (consecutive slots, 2 ballots apart).
__device__ __forceinline__ uint32_t gather_word(const uint32_t* b, int at, int npw) {
  const uint32_t* p = b + (at >> 5);
  const int sh = at & 31;
  uint32_t v = 0;
  for (int j = 0; j < npw; ++j) v |= ((p[2 * j] >> sh) & 15u) << (4 * j);
  return v;
}

// Each of the 64 threads of a pair stores up to 4 quads of the pair's
// words (32 rows x TW, contiguous with one column group): the nibble
// positions of the 16 words, computed once (-1 past the words).
struct Quads {
  int at[4][4];
};

template <int NFW>
__device__ __forceinline__ Quads make_quads(const SimArgs& a, int p) {
  Quads qd;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = 4 * p + 256 * j + i;
      qd.at[j][i] = q < 32 * a.TW ? nibble_at(a, NFW, q / a.TW, q % a.TW) : -1;
    }
  return qd;
}

// The pair's 32 rows' words from its warps' sign ballots; acc is zeroed
// after.  r0: the pair's first row.  balls: the pair's area.
template <int NFW>
__device__ __forceinline__ void epilogue(float (&acc)[2][NFW][4], uint32_t* balls,
                                         const SimArgs& a, const Quads& qd,
                                         int pair, int half, int64_t r0) {
  const int lane = threadIdx.x & 31;
  uint32_t* mine = balls + half * 8 * NFW;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int f = 0; f < NFW; ++f)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t b = __ballot_sync(0xffffffffu, acc[m][f][2 * h + e] > 0.f);
          if (lane == 0) mine[(m * 2 * NFW + 2 * f + e) * 2 + h] = b;
          acc[m][f][2 * h + e] = 0.f;
        }
  pair_sync(pair);

  const int p = half * 32 + lane;
  const int rows = static_cast<int>(a.N > r0 ? min64(32, a.N - r0) : 0);
  if (gridDim.y == 1 && rows == 32) {   // 32 TW words, contiguous, 16-B aligned
    uint32_t* o = a.out + r0 * a.TW + 4 * p;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (qd.at[j][3] < 0) break;
      *reinterpret_cast<uint4*>(o + 256 * j) = make_uint4(
          gather_word(balls, qd.at[j][0], a.npw), gather_word(balls, qd.at[j][1], a.npw),
          gather_word(balls, qd.at[j][2], a.npw), gather_word(balls, qd.at[j][3], a.npw));
    }
    return;
  }
  const int t0 = blockIdx.y * a.wg;           // the group's first word
  const int nw = min(a.wg, a.TW - t0);        // and its words
  for (int q = p; q < rows * nw; q += 64) {
    const int row = q / nw, w = q - row * nw;
    a.out[(r0 + row) * a.TW + t0 + w] = gather_word(balls, nibble_at(a, NFW, row, w), a.npw);
  }
}

// NFW: n-fragments (8 columns) a warp's half.  MODE kBulk (VEC unused) or
// kChunk with VEC floats a cp.async.  Grid: (walkers, column groups).
// Warp w is half w % 2 of pair w / 2; a pair owns 32 rows of a tile.
template <int NFW, int MODE, int VEC>
__global__ void __launch_bounds__(kThreads, 1)
simhash_kernel(const SimArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int pair = warp >> 1, half = warp & 1;
  const int cols = 16 * NFW;
  const int rstride = a.panel + 4;
  float* rs = smem;                                    // [cols][rstride]
  float* ring = rs + cols * rstride;
  const int stage = MODE == kBulk ? a.sstride : kChunkRows * kXS;
  const int nstages = MODE == kBulk ? kPairs * a.stages : a.stages;
  uint32_t* balls = reinterpret_cast<uint32_t*>(ring + nstages * stage);
  uint32_t* my_balls = balls + pair * 16 * NFW;
  uint64_t* full = reinterpret_cast<uint64_t*>(balls + kPairs * 16 * NFW);
  const float* rsrc = a.r + static_cast<int64_t>(blockIdx.y) * cols * a.d;
  auto stage_r = [&](int panel) {        // R's columns [k0, k0 + a.panel)
    const int k0 = panel * a.panel;
    for (int i = tid; i < cols * a.panel; i += kThreads) {
      const int c = i / a.panel;
      const int k = i - c * a.panel;
      const bool ok = k0 + k < a.d;
      cp_async<1>(rs + c * rstride + k,
                  ok ? rsrc + static_cast<int64_t>(c) * a.d + k0 + k : rsrc, ok);
    }
    cp_async_commit();
  };
  // B of this warp's half: column g of its first fragment, k t
  const float* rb = rs + (half * 8 * NFW + g) * rstride + t;
  const Quads qd = make_quads<NFW>(a, half * 32 + lane);

  float acc[2][NFW][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int f = 0; f < NFW; ++f)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[m][f][j] = 0.f;

  if constexpr (MODE == kBulk) {
    // Pair p walks the block's tiles p, p + 4, ...: its j-th is tile
    // blockIdx.x + (4 j + p) gridDim.x, in its stage j % stages.
    auto tile_row = [&](int pr, int j) {
      return (static_cast<int64_t>(blockIdx.x) +
              static_cast<int64_t>(kPairs * j + pr) * gridDim.x) * kPairRows;
    };
    // pair pr's j-th tile: its bytes [start, end), and [lo, hi) the
    // 16-B aligned part a bulk copy takes
    struct Span { const char *start, *end, *lo, *hi; };
    auto span = [&](int pr, int j) {
      const int64_t n0 = tile_row(pr, j);
      Span sp;
      sp.start = reinterpret_cast<const char*>(a.x + n0 * a.d);
      sp.end = sp.start + min64(kPairRows, a.N - n0) * a.d * 4;
      sp.lo = reinterpret_cast<const char*>(
          reinterpret_cast<uintptr_t>(sp.start) & ~static_cast<uintptr_t>(15));
      sp.hi = reinterpret_cast<const char*>(
          reinterpret_cast<uintptr_t>(sp.end) & ~static_cast<uintptr_t>(15));
      return sp;
    };
    // pair pr's j-th tile into its stage j % stages (one thread)
    auto fetch = [&](int pr, int j) {
      const int s = pr * a.stages + j % a.stages;
      const Span sp = span(pr, j);
      float* dst = ring + s * stage;
      for (const char* q = sp.hi > sp.start ? sp.hi : sp.start; q < sp.end; q += 4)
        dst[(q - sp.lo) / 4] = __ldg(reinterpret_cast<const float*>(q));
      const uint32_t bytes = static_cast<uint32_t>(sp.hi - sp.lo);
      if (bytes) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive_tx(&full[s], bytes);
        bulk_copy(dst, sp.lo, bytes, &full[s]);
      } else {
        mbar_arrive(&full[s]);
      }
    };
    auto pair_tiles = [&](int pr) {   // tiles blockIdx.x + (4 j + pr) gridDim.x
      const int f0 = static_cast<int>(blockIdx.x) + pr * static_cast<int>(gridDim.x);
      return f0 < a.tiles ? ceil_div(a.tiles - f0, kPairs * gridDim.x) : 0;
    };
    const int my_tiles = pair_tiles(pair);
    if (tid == 0) {
      for (int s = 0; s < nstages; ++s) mbar_init(&full[s], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      for (int pr = 0; pr < kPairs; ++pr) {
        const int n = pair_tiles(pr);
        for (int j = 0; j < a.stages && j < n; ++j) fetch(pr, j);
      }
    }
    stage_r(0);                             // the whole of d, once
    cp_async_wait<0>();
    __syncthreads();

    for (int j = 0; j < my_tiles; ++j) {
      const int s = pair * a.stages + j % a.stages;
      mbar_wait(&full[s], (j / a.stages) & 1);
      const int64_t n0 = tile_row(pair, j);
      const int off = static_cast<int>(
          (reinterpret_cast<uintptr_t>(a.x + n0 * a.d) & 15) >> 2);
      const float* xa = ring + s * stage + off + g * a.d + t;
      int k = 0;
#pragma unroll 2
      for (; k + 8 <= a.d; k += 8) kstep<NFW, false>(acc, xa, a.d, rb, rstride, k, 0);
      if (k < a.d) kstep<NFW, true>(acc, xa, a.d, rb, rstride, k, a.d - k);
      pair_sync(pair);                      // both warps have left stage s
      if (half == 0 && lane == 0 && j + a.stages < my_tiles)
        fetch(pair, j + a.stages);
      epilogue<NFW>(acc, my_balls, a, qd, pair, half, n0);
    }
  } else {
    // A block tile is 128 rows, pair p's the 32 from 32 p.
    const int my_tiles = ceil_div(a.tiles - static_cast<int>(blockIdx.x),
                                  static_cast<int>(gridDim.x));
    auto tile_row = [&](int i) {
      return (static_cast<int64_t>(blockIdx.x) + static_cast<int64_t>(i) * gridDim.x) *
             kChunkRows;
    };
    const int chunks = ceil_div(a.d, kBK);
    const int per_panel = a.panel / kBK;
    const int steps = my_tiles * chunks;
    auto load_step = [&](int s) {
      if (s < steps) {
        const int64_t n0 = tile_row(s / chunks);
        const int k0 = (s % chunks) * kBK;
        float* dst = ring + (s % a.stages) * stage;
        constexpr int per_row = kBK / VEC;
#pragma unroll
        for (int j = 0; j < kChunkRows * per_row / kThreads; ++j) {
          const int i = tid + j * kThreads;
          const int r = i / per_row;
          const int k = (i % per_row) * VEC;
          const bool ok = n0 + r < a.N && k0 + k < a.d;
          cp_async<VEC>(dst + r * kXS + k,
                        ok ? a.x + (n0 + r) * a.d + k0 + k : a.x, ok);
        }
      }
      cp_async_commit();                    // empty past the end
    };
    stage_r(0);
    for (int s = 0; s < a.stages - 1; ++s) load_step(s);

    for (int s = 0; s < steps; ++s) {
      cp_async_wait_at_most(a.stages - 2);  // step s has landed
      __syncthreads();                      // and step s - 1 is consumed
      const int c = s % chunks;
      if (per_panel < chunks && c % per_panel == 0 && s > 0) {
        stage_r(c / per_panel);             // the next d-panel
        cp_async_wait<0>();
        __syncthreads();
      }
      load_step(s + a.stages - 1);
      const float* xa = ring + (s % a.stages) * stage + (pair * kPairRows + g) * kXS + t;
      const float* rk = rb + (c % per_panel) * kBK;
#pragma unroll
      for (int k = 0; k < kBK; k += 8) kstep<NFW, false>(acc, xa, kXS, rk, rstride, k, 0);
      if (c == chunks - 1)
        epilogue<NFW>(acc, my_balls, a, qd, pair, half,
                      tile_row(s / chunks) + pair * kPairRows);
    }
    cp_async_wait<0>();                     // the trailing empty groups
  }
}

// The current device's SM count and per-block shared memory limit, read
// once per device.
struct DeviceInfo {
  int sms = 0, optin = 0;
};

DeviceInfo device_info() {
  constexpr int kMaxDevices = 64;
  static std::mutex mu;
  static DeviceInfo known[kMaxDevices];
  int dev = 0;
  cudaGetDevice(&dev);
  DeviceInfo info;
  if (dev >= 0 && dev < kMaxDevices) {
    std::lock_guard<std::mutex> lock(mu);
    if (known[dev].sms) return known[dev];
  }
  cudaDeviceGetAttribute(&info.sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&info.optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (dev >= 0 && dev < kMaxDevices) {
    std::lock_guard<std::mutex> lock(mu);
    known[dev] = info;
  }
  return info;
}

// The launch's layout.  kBulk where the column group's R (all of d) and
// a 32-row stage for each pair fit the block's shared memory, with a
// second stage a pair where the rest allows; else kChunk, R in d-panels
// as wide as fit beside a 3-stage ring of 128-row chunks, and a fourth
// stage where the rest allows.  Copy width (kChunk) from x's and the row
// stride's alignment.  Returns a cudaError_t.
int sim_plan(const void* x, int N, int d, int nfw, int groups, SimPlan& p,
             int& sstride) {
  if (N <= 0 || d < 1 || nfw < 1 || nfw > kMaxNfw || groups < 1 || groups > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int optin = device_info().optin;
  const int cols = 16 * nfw;
  const int dp = round_up(d, kBK);
  // ballots (4 pairs x 16 NFW words) and the mbarriers
  const int64_t fixed = 4 * kPairs * 16 * nfw + 8 * kPairs * kMaxPairStages;
  p.nfw = nfw;
  p.groups = groups;
  const int64_t rbytes = 4LL * cols * (dp + 4);
  const int64_t sfloats = (static_cast<int64_t>(kPairRows) * d + 12 + 3) / 4 * 4;
  const int64_t bulk = (optin - fixed - rbytes) / (4 * sfloats * kPairs);
  if (bulk >= 1) {
    p.mode = kBulk;
    p.vec = 0;
    p.tiles = ceil_div(N, kPairRows);
    p.panel = dp;
    p.stages = static_cast<int>(std::min<int64_t>(kMaxPairStages, bulk));
    sstride = static_cast<int>(sfloats);
    p.smem = static_cast<int>(rbytes + 4 * sfloats * kPairs * p.stages + fixed);
    return 0;
  }
  p.mode = kChunk;
  p.tiles = ceil_div(N, kChunkRows);
  const uintptr_t al = reinterpret_cast<uintptr_t>(x);
  p.vec = (d % 4 == 0 && al % 16 == 0) ? 4 : (d % 2 == 0 && al % 8 == 0) ? 2 : 1;
  const int stage = 4 * kChunkRows * kXS;
  const int64_t width = (optin - fixed - kChunkMinStages * stage) / (4 * cols) - 4;
  p.panel = static_cast<int>(std::min<int64_t>(dp, width / kBK * kBK));
  if (p.panel < kBK) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t rb = 4LL * cols * (p.panel + 4);
  p.stages = static_cast<int>(std::min<int64_t>(kMaxStages, (optin - fixed - rb) / stage));
  sstride = kChunkRows * kXS;
  p.smem = static_cast<int>(rb + static_cast<int64_t>(stage) * p.stages + fixed);
  return 0;
}

// The grid: blocks a group = min(the blocks the tiles need, SMs x
// resident blocks an SM / groups).  Launches if `launch`; fills
// p.occupancy and p.grid_x either way.
template <int NFW, int MODE, int VEC>
int run(const SimArgs& a, SimPlan& p, cudaStream_t s, bool launch) {
  auto kernel = simhash_kernel<NFW, MODE, VEC>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, device_info().optin);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  static std::mutex mu;
  static int last_smem = -1, last_occupancy = 0;
  {
    std::lock_guard<std::mutex> lock(mu);
    if (p.smem != last_smem) {
      const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &last_occupancy, kernel, kThreads, p.smem);
      if (e != cudaSuccess) return static_cast<int>(e);
      last_smem = p.smem;
    }
    p.occupancy = last_occupancy;
  }
  if (p.occupancy < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int walkers = device_info().sms * p.occupancy / p.groups;
  const int need = MODE == kBulk ? ceil_div(p.tiles, kPairs) : p.tiles;
  p.grid_x = std::min(need, std::max(1, walkers));
  if (!launch) return 0;
  kernel<<<dim3(p.grid_x, p.groups), kThreads, p.smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int NFW>
int run_nfw(const SimArgs& a, SimPlan& p, cudaStream_t s, bool launch) {
  if (p.mode == kBulk) return run<NFW, kBulk, 0>(a, p, s, launch);
  switch (p.vec) {
    case 4: return run<NFW, kChunk, 4>(a, p, s, launch);
    case 2: return run<NFW, kChunk, 2>(a, p, s, launch);
    default: return run<NFW, kChunk, 1>(a, p, s, launch);
  }
}

// Plan and (if `launch`) run; fills p either way.
int simhash_run(SimArgs a, int nfw, int groups, SimPlan& p, cudaStream_t s,
                bool launch) {
  const int err = sim_plan(a.x, a.N, a.d, nfw, groups, p, a.sstride);
  if (err) return err;
  a.tiles = p.tiles;
  a.panel = p.panel;
  a.stages = p.stages;
  switch (nfw) {
    case 1: return run_nfw<1>(a, p, s, launch);
    case 2: return run_nfw<2>(a, p, s, launch);
    case 3: return run_nfw<3>(a, p, s, launch);
    case 4: return run_nfw<4>(a, p, s, launch);
    case 5: return run_nfw<5>(a, p, s, launch);
    case 6: return run_nfw<6>(a, p, s, launch);
    case 7: return run_nfw<7>(a, p, s, launch);
    default: return run_nfw<8>(a, p, s, launch);
  }
}

}  // namespace

// x: (N, d) float32, contiguous rows (any 4-byte aligned base).  rc:
// (groups, 16 nfw, d) float32, contiguous: the compact projection of
// simhash.compact_projection (npw nibbles a word, wg words a group, wh
// words a warp's half).  Output out (N, TW) 32-bit words.
extern "C" int simhash(const void* x, const void* rc, void* out, int N, int d,
                       int TW, int npw, int wg, int wh, int nfw, int groups,
                       void* stream) {
  if (N <= 0 || TW <= 0) return 0;
  if (npw < 1 || npw > 8 || wg < 1 || wh < 1 || 2 * wh < wg ||
      static_cast<int64_t>(wg) * groups < TW || 2 * nfw < wh * npw)
    return static_cast<int>(cudaErrorInvalidValue);
  SimArgs a{static_cast<const float*>(x), static_cast<const float*>(rc),
            static_cast<uint32_t*>(out), N, d, TW, npw, wg, wh};
  SimPlan p{};
  return simhash_run(a, nfw, groups, p, static_cast<cudaStream_t>(stream), true);
}

// The layout simhash launches for this x, shape and compact layout,
// without launching: out[0..9] = mode (0 bulk, 1 chunk), copy width
// (floats, chunk), n-fragments a warp's half, column groups, row tiles,
// d-columns of R staged at once, ring stages, dynamic shared memory
// (bytes), resident blocks an SM, blocks a group.  Returns a cudaError_t.
extern "C" int simhash_plan(const void* x, int N, int d, int nfw, int groups,
                            int* out) {
  SimArgs a{static_cast<const float*>(x), nullptr, nullptr, N, d};
  SimPlan p{};
  const int err = simhash_run(a, nfw, groups, p, nullptr, false);
  const int v[10] = {p.mode, p.vec, p.nfw, p.groups, p.tiles,
                     p.panel, p.stages, p.smem, p.occupancy, p.grid_x};
  std::copy(v, v + 10, out);
  return err;
}
