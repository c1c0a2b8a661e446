// The query-route scans: the fused linear scans (dot form, L1, Hamming)
// and the fused LSH-route candidate verification; and the distance
// matrices (dot form, L1, Hamming) that share the linear scans' kernels.
//
// ---------------------------------------------------------------------------
// linear_scan_dot and pairwise_dot: the dot-form tile
// Replace: repro/kernels/fused_scan.py, linear_scan_dot_pallas (:145, body
// _linear_dot_kernel), and repro/kernels/distances.py, pairwise_dot_pallas
// (:62, body _dot_kernel).  For (Q, d) queries against the (N, d) corpus
// they compute ||q||^2 + ||x||^2 - 2 q.x clamped at 0 (l2) or 1 - q.x on
// rows the caller normalised (cosine).  linear_scan_dot then compares with
// the threshold and writes the distances (f32), the report mask (0/1
// bytes) and the column ids (i32), all (Q, N), in one pass; pairwise_dot
// writes the distances alone (repro's ops.pairwise_dist clamps the
// kernel's l2 output, which gives the same values).  The norms and the
// cosine normalisation are computed by the caller, as in repro's ops.py.
//
// Arithmetic: tensor cores, mma.sync m16n8k8 in TF32, three passes.  Each
// input v is split as hi = cvt.rna.tf32(v), lo = cvt.rna.tf32(v - hi), and
// the tile accumulates lo.hi' + hi.lo' + hi.hi' in fp32 (the dropped
// lo.lo' is 2^-22 of the product).  This is as close to float64 as fp32
// FMAs are (about 1e-6 on unit rows at d = 254), so reported sets move only
// within the 1e-5 band the checks allow; one TF32 pass would not (7.6e-5
// there; tests/test_torch_tf32.py).  The precision is fixed here and does
// not read torch.backends.cuda.matmul.allow_tf32.
//
// Bound on an H100 SXM: device memory.  The least time is the larger of
// the bytes (x, q and the norms read once, the outputs written once) at
// 3.35 TB/s and 3 x 2 Q N d TF32 operations at 495 TFLOP/s.  K1 at Webspam
// (one chunk of Q = 32, N = 349,900, d = 254): 456 MB, 0.136 ms, against
// 17.1 GFLOP, 0.034 ms.  K6 cosine at Webspam (Q = 100): 496 MB, 0.148 ms,
// against 53.3 GFLOP, 0.108 ms.  (On the CUDA cores, 67 TFLOP/s, the same
// products in fp32 would be bound by operations at 0.265 ms.)
//
// Design:
//  * Corpus rows are the M side (the .row A operand, 16 rows a fragment)
//    and queries the N side (the .col B operand, 8 queries a fragment):
//    both are K-contiguous as stored, so nothing is transposed.  A warp
//    owns 16 rows and NF n-fragments (a power of two up to 16: 8 NF
//    queries, the rows past Q zeros; Q = 100 computes 128 columns); a
//    block of 2-8 warps owns 32-128 rows.  Per 8-wide k step a warp
//    splits its A and all NF B fragments, then issues each of the three
//    passes over all NF fragments, so NF independent MMAs run back to back
//    (one fragment at a time, the chained MMAs of each stalled the warp).
//  * The group's queries (8 NF, up to 128) are staged in shared memory
//    once per block, rows padded to (d rounded up to 32) + 4 words, so the
//    fragment loads do not conflict on banks.  If they do not fit whole,
//    they are staged in d-panels, again for each tile.  More queries than
//    a group take more groups (gridDim.y); blocks of one tile index in
//    every group run together, so the corpus tile is read from device
//    memory about once per call.
//  * The corpus streams through a cp.async ring of 32 KS-column chunks
//    (rows padded by 4 words), 3 or 4 stages as shared memory allows, so
//    the next chunks' loads overlap this chunk's MMAs.  The copy width is
//    16 B when both base pointers are 16-byte aligned and d % 4 == 0, else
//    8 B when d is even and they are 8-byte aligned, else 4 B (Webspam's
//    1,016-byte rows take 8 B); the ragged d tail and rows past N are
//    zero-filled by cp.async's src-size.  No copy of the corpus is padded.
//  * Each operand is split where it is read, once per fragment load.
//  * Epilogue through shared memory, 32 queries at a time: the fragments
//    go to a (queries x rows) tile, then each thread finishes 4 adjacent
//    rows of one query and stores them as one 16-byte store of distances,
//    one of ids and one 32-bit store of 4 masks where the address allows
//    (scalar stores otherwise): 512 contiguous bytes a warp.
//  * The grid is persistent: blocks a group = min(tiles, SMs x resident
//    blocks an SM / groups), each walking tiles blockIdx.x, + gridDim.x,
//    ... and prefetching the next tile's chunks during this tile's
//    epilogue.  Small problems take fewer row warps a block (down to 2),
//    then smaller groups (down to 8 queries), until there are at least as
//    many blocks as SMs (calibrate's 64 x 4,096: 128 tiles of 32 rows x 2
//    groups of 32 queries).
//  * K-split: where that leaves fewer than 8 warps a block, KS = 8 / (row
//    warps) warps share each tile (while d holds two chunks of 32 KS
//    columns): a stage is 32 KS columns wide and each warp of a row slice
//    multiplies its own 32 of them, so a block keeps 8 warps and KS times
//    the bytes in flight; the epilogue sums the KS partial tiles in a
//    fixed order.  Such blocks size their query panel for two blocks an
//    SM, twice the stages in flight again (the panels then restage more
//    often, behind the other block).  At the retrieval service's width
//    (Q = 32, N = 8,192, d = 4,096: 256 tiles of 32 rows) one 2-warp block
//    an SM had 4 KB stages in flight and took 0.39 ms; KS = 4 with 16 KB
//    stages 0.15 ms, and two such blocks an SM 0.13-0.15 ms (an H100
//    SXM; PERF.md).
//  * What holds it back (measured, PERF.md): at Webspam the reads of a
//    tile are 128-byte pieces of 1,016-byte rows, 8-byte aligned, and
//    stream at about 1.5 TB/s even with the MMAs taken out; at Q = 100 the
//    three mma.sync passes over 128 columns cost about 0.25 ms more.
//  ptxas (sm_90a, chip_smoke.py's build log): 63-192 registers a thread
//  (NF 1-16, the most at NF 16 with 4-byte copies), no spills, no static
//  shared memory; a launch's dynamic shared memory (27-224 KB at the main
//  path's shapes) is in dot_tile_plan's report.
//
// ---------------------------------------------------------------------------
// linear_scan_l1 and pairwise_l1
// Replace: repro/kernels/fused_scan.py, linear_scan_l1_pallas (:177, body
// _linear_l1_kernel), and repro/kernels/distances.py, pairwise_l1_pallas
// (:93, body _l1_kernel).  sum_d |q - x| in float32 for (Q, d) queries
// against the (N, d) corpus; linear_scan_l1 then writes the threshold's
// mask and the ids as linear_scan_dot does, pairwise_l1 the distances
// alone (template DIST_ONLY, 4 B of output a pair instead of 9).
//
// Bound on an H100 SXM.  acc += |q - x| is two FP32 instructions (an FADD,
// then an FADD with the |.| modifier on its operand); the card issues
// 33.5 T of them a second (its 67 TFLOP/s counts an FMA as two).  So the
// least time is the larger of the bytes (x and q read once, 9 B a pair
// written, 4 B for pairwise_l1) at 3.35 TB/s and 2 Q N d instructions at
// 33.5 T/s.  K4 at CoverType (one chunk of Q = 32, N = 524,288, d = 54):
// 264.3 MB, 0.0789 ms, against 1.81 G instructions, 0.0541 ms: bytes.  K7 at
// Q = 100, N = 580,912: 6.27 G instructions, 0.1873 ms, against 358 MB,
// 0.1068 ms: operations.  The sum has no matmul form: CUDA cores.
// Design:
//  * A block owns a group of up to 32 queries (8 a warp) and walks row
//    tiles of 128 (persistent grid: SMs x resident blocks, shared evenly
//    by the groups; the 8-query sets are spread evenly over the groups, so
//    Q = 100 runs groups of 32, 24, 24, 20; a warp whose 8 queries are all
//    past the group computes nothing).  Each thread keeps an 8 x 4 register tile (queries
//    x rows lane + 32 j), so one k step is two broadcast 16-byte reads of
//    the queries, a quarter of a 16-byte read of each row, and 64 FP32
//    instructions.
//  * The group's queries are staged k-major in shared memory, once for the
//    whole of d up to 64 columns (what four blocks an SM leave beside the
//    ring and the epilogue); a wider d is staged in 64-column panels,
//    restaged each tile, and each restage drains the ring
//    (cp_async_wait<0>) first.
//  * The corpus streams through a cp.async ring of 16-column chunks (rows
//    padded to 20 words, so the 16-byte row reads do not conflict on
//    banks), 3 stages at four blocks an SM; copy width 16, 8 or 4 B as
//    for the dot tile (CoverType's 216-byte rows take 8 B).  The
//    last chunk is ragged: columns past d are neither copied nor summed,
//    so d = 54 runs 54 steps, not 64.  The next tile's chunks load during
//    this tile's epilogue.
//  * The sum runs in k order, 0 to d - 1, as the earlier kernel summed it,
//    so its distances are bit for bit the same.
//  * Epilogue through shared memory, as the dot tile's: each thread
//    finishes 4 adjacent rows of one query, one 16-byte store of distances,
//    one of ids and one 32-bit store of 4 masks where aligned.
//
// ---------------------------------------------------------------------------
// grouped_hamming_scan (K5) and hamming (K8)
// Replace: repro/kernels/fused_scan.py, linear_scan_hamming_pallas (:202,
// body _linear_hamming_kernel), and repro/kernels/hamming.py, hamming_pallas
// (:33, body _kernel).  XOR and __popc over the W packed 32-bit words of each
// (query, row) pair, summed as int32.  K5 writes it as float32 (exact for
// distances up to 2^24), the mask float(d) <= thresh, as the reference casts
// it, and the ids; K8 writes the (Q, N) int32 matrix alone (DIST_ONLY).  Any
// W: the TPU kernels put a whole code in VMEM whatever W is, and so take any
// W too.
//
// K5 is the linear route of a whole routed group over every segment of the
// index in one launch, where the reference runs one kernel per segment and
// per 32-query chunk and then concatenates.  Each segment (every frozen
// segment, then the delta) writes its own columns [col, col + n) of the
// (Q, ld) outputs, with the epilogue of repro/core/engine.py's
// TableSegment.search and repro/streaming/delta.py's DeltaView.search:
// mask = (float(d) <= thresh) & live[n], ids = mask ? ext[n] : EXT_SENTINEL
// on a streaming index (live and ext given), ids = n on a static one.  The
// segment table travels by value in the kernel's parameters
// (__grid_constant__): no copy to the device per batch.  A group of more than
// kHamMaxSegs segments takes more launches.  K8 is the one-segment case
// with no epilogue.
//
// Bound on an H100 SXM: device memory (the outputs), and at small sizes
// launch latency.  At the churned MNIST index (W = 2, Q = 100, 61,441 rows
// over five segments) K5 reads 0.8 MB of codes, live flags and ids and
// writes 9 B a (query, row) pair, 55.3 MB: 0.0167 ms at 3.35 TB/s; the
// matrix of K8 at Q = 100, N = 59,900 writes 24.0 MB (0.0073 ms).
// Design:
//  * Grid: the row tiles of all segments laid end to end (512 rows a tile)
//    x even shares of the queries, at most 32 each (Q = 100: 4 of 25),
//    and more shares where the tiles x shares would not make kHamFillPerSm
//    blocks an SM (the delta's 9 tiles at Q = 100: 30 shares of 3-4); a
//    block finds its segment from the tiles' prefix in the parameter
//    struct.  All Q queries go in one launch.
//  * The block's query codes are staged in shared memory, read as
//    broadcasts.  Each thread owns 4 adjacent rows: at W = 1, 2 and 4 it
//    holds their 4 W contiguous words in registers, loaded with 16-byte
//    loads; at other W it rereads them for each query from L1.
//  * For each query the thread stores 4 distances and 4 ids as one 16-byte
//    streaming store each (st.global.cs: nothing rereads the outputs) and 4
//    masks as one 32-bit store: a warp writes 512, 512 and 128 contiguous
//    bytes.  The wrapper pads the output rows to a multiple of 4 columns
//    (ld), and the streaming index pads every frozen segment to a power of
//    two of at least 8 rows, so all stores but the delta's last partial
//    group of 4 are vector stores; elsewhere (a misaligned row start, a
//    ragged end) the thread stores scalars.
//  * What holds it back (measured, PERF.md): the card's write rate, not a
//    choice of the design.  Fewer queries a block (16, 8), 64 or 256
//    threads a block, or plain stores all run within 3 % of it, and it
//    takes 1.05 times what PyTorch's fill kernel takes to write the same
//    bytes (0.0281 against 0.0268 ms at churned MNIST).
//
// ---------------------------------------------------------------------------
// lsh_scan
// Replaces: repro/kernels/fused_scan.py, lsh_scan_pallas (:272, body
// _lsh_kernel), together with the jnp.sort that feeds it in
// repro/core/search.py (:163).  For each query it takes the (Q, C)
// candidate ids as the bucket gather leaves them (unsorted, sentinel = n)
// and writes what the sort and the TPU kernel return together: the ids
// sorted (bit for bit torch.sort's: equal keys are equal ids), and for each
// slot the distance and the report mask, (id is a run's first) & (id < n)
// & (distance <= thresh), for l2 / l1 / cosine / Hamming.  A run's other
// slots and the sentinel tail get +inf and mask 0.  Cosine reads corpus
// rows the caller scaled to unit length (ops scales them when the index
// keeps none).
//
// Bound on an H100 SXM: device memory, in the ids read (4 Q C B), the
// distinct rows gathered (distinct x d x 4 B), the query rows and 9 B a slot
// written.  At Webspam q3 (Q = 32, C = 5,120, 89,357 distinct rows) the
// rows dominate: 92.9 MB, 0.0277 ms.
// Design (a sort by counting: the ids of one query span only [0, n]):
//  * Grid (splits, Q), 512 threads, two blocks an SM.  Block s of query q
//    owns the ids [s w, (s + 1) w): as many splits as fill the card in one
//    wave (8 for 32 queries; one block a query would use 32 of the 132
//    SMs), w up to 2^18.  The LSH route launches a whole group at once
//    (the wrapper takes Q <= 65,535 a launch): at 1,024 queries that is
//    ceil(n / 2^18) splits (2 for Webspam's 350,000 rows, 4 for a 2^20-row
//    segment) in 8-16 waves.  At that size 4 and 8 splits were 13 and 38 %
//    slower on Webspam, and 8 splits on the 2^20-row segment (dcap then C)
//    7 % faster (PERF.md), so the rule stays one for every Q.
//  * The block streams its query's C ids (16-byte loads, four in flight a
//    thread), counts those below its range, which is its output offset,
//    and sets a presence bit in shared memory for each id of its range
//    (w / 8 bytes: 5 KB at Webspam's 43,738).  Sentinels are counted by no
//    block: the last block writes the tail after the ids below n.
//  * A block scan of the bitmap words' popcounts gives each word its rank,
//    so an id's place among the distinct ids is its word's rank plus a
//    popcount.  A second pass over the ids counts each at that place: the
//    runs (duplicates) are counters, so the dedup needs no comparison with
//    a left neighbour, and the caller's sort and `prev` are gone.  A block
//    scan of the counts gives each distinct id its output offset.
//  * Any C: the counters are per distinct id, at most dcap at once (what
//    shared memory holds beside the bitmap: 5,120 at the main path's
//    shapes, about 9,400 at most); a block that owns
//    more distinct ids walks them dcap at a time, one more pass over the
//    ids each.  A run of one id is one counter whatever its length.
//  * Each distinct row is gathered once, by a lane group sized to the row:
//    16 words a lane, all loaded before any is used (16 lanes at Webspam's
//    d = 254, 4 at d = 54, 2 at d = 32, one thread for Hamming W = 2), in
//    16, 8 or 4-byte pieces as x's alignment and d allow (Webspam's
//    1,016-byte rows: 8 B), against the query row staged once per block.
//    The gather is latency-bound, not bandwidth-bound: a row's time is one
//    trip to memory plus its reduction, so rows of 1 KB pay for every
//    instruction after the loads (tools/lsh_scan_ab.py, PERF.md).  Hence:
//  * Cosine reads the unit rows the indexes keep for the linear scan:
//    1 - x.q is one sum, where cosine on x takes three, two square roots
//    and a division.  The block scales its query row once.
//  * The block writes its slots in order, coalesced: a thread per slot,
//    its run found by a binary search over the offsets.
//  ptxas figures (registers, spills) are in chip_smoke.py's build log.
#include <algorithm>
#include <cstdint>
#include <mutex>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

// ---- the dot-form tile (linear_scan_dot, pairwise_dot) --------------------

constexpr int kDotBK = 32;              // d-columns of a ring stage
constexpr int kDotMinStages = 3;        // depth of the cp.async ring: at
constexpr int kDotMaxStages = 4;        // least 3, at most 4
constexpr int kDotMaxGroup = 128;       // queries per group: 16 n-fragments
constexpr int kDotEpiQ = 32;            // queries per epilogue pass

enum DotMode { kDotL2 = 0, kDotCosine = 1 };

struct DotArgs {
  const float* q;        // (Q, d)
  const float* x;        // (N, d)
  const float* qn;       // (Q,) squared norms, read for l2 only
  const float* xn;       // (N,)
  float thresh;
  int mode;
  float* dist;           // (Q, N)
  uint8_t* mask;         // (Q, N), or null: distances only
  int32_t* ids;          // (Q, N), null with mask
  int Q, N, d;
  int group;             // queries per group, 8 NF
  int panel;             // d-columns of the queries staged at once
  int tiles;             // row tiles of 16 rows a row warp
  int stages;            // depth of the ring
};

// How a call is laid out on the card (dot_plan, run_dot).
struct DotPlan {
  int vec, nf, warps, group, groups, tiles, panel, stages, smem, occupancy,
      grid_x, ks;
};

__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int round_up(int a, int b) { return ceil_div(a, b) * b; }

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// v = hi + lo up to 2^-22 |v|: both TF32, rounded to nearest, ties away.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

// c += a b: a 16 x 8 (rows x k) A and an 8 x 8 (k x queries) B fragment.
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

// Wait until at most n (0 to kDotMaxStages - 2) groups are pending.
__device__ __forceinline__ void cp_async_wait_at_most(int n) {
  static_assert(kDotMaxStages == 4, "one case per depth");
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    default: cp_async_wait<2>(); break;
  }
}

// VEC: floats a cp.async (4, 2 or 1).  NF: n-fragments (8 queries each)
// a warp computes: the group's 8 NF queries, the rows past Q zeros.  KS
// (1, 2 or 4): warps of a row slice, each on its own 32 columns of a
// stage.  Grid: (walkers, groups); block: 2-8 row warps of 16 rows times
// KS, 8 warps at most.
template <int VEC, int NF, int KS>
__global__ void __launch_bounds__(256, NF <= 4 ? 2 : 1)
dot_tile_kernel(const DotArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;          // fragment row, query within 8
  const int t = tid & 3;                  // fragment k within 4
  const int bm = blockDim.x / (2 * KS);   // 16 rows a row warp
  const int wr = KS == 1 ? warp : warp % (bm / 16);   // the warp's 16 rows
  const int kw = KS == 1 ? 0 : warp / (bm / 16);      // its 32 columns of a stage
  constexpr int kc = kDotBK * KS;         // d-columns a stage
  constexpr int xs = kc + 4;              // words per corpus row in a stage
  const int q0 = blockIdx.y * a.group;
  const int nq = min(a.group, a.Q - q0);  // real queries of the group
  const int chunks = ceil_div(max(a.d, 1), kc);       // ring steps a tile
  const int per_panel = a.panel / kc;
  const int qstride = a.panel + 4;
  constexpr int kEpiQ = 8 * NF < kDotEpiQ ? 8 * NF : kDotEpiQ;
  const int epi_words = kEpiQ * (bm + 4);             // one warp column's
  float* qs = smem;                                   // [8 NF][qstride]
  float* ring = qs + 8 * NF * qstride;                // [stages][bm][xs]
  float* epi = ring + a.stages * bm * xs;            // [KS][kEpiQ][bm + 4]
  const int steps = ceil_div(a.tiles - static_cast<int>(blockIdx.x),
                             static_cast<int>(gridDim.x)) * chunks;

  auto stage_queries = [&](int panel) {
    const int k0 = panel * a.panel;
    const int per_row = a.panel / VEC;
    for (int i = tid; i < 8 * NF * per_row; i += blockDim.x) {
      const int r = i / per_row;
      const int k = (i - r * per_row) * VEC;
      const bool ok = r < nq && k0 + k < a.d;
      cp_async<VEC>(qs + r * qstride + k,
                    ok ? a.q + static_cast<int64_t>(q0 + r) * a.d + k0 + k : a.q, ok);
    }
    cp_async_commit();
  };
  auto load_step = [&](int s) {
    if (s < steps) {
      const int n0 = (blockIdx.x + (s / chunks) * gridDim.x) * bm;
      const int k0 = (s % chunks) * kc;
      float* dst = ring + (s % a.stages) * bm * xs;
      constexpr int per_row = kc / VEC;
#pragma unroll
      for (int j = 0; j < kDotBK / (2 * VEC); ++j) {   // bm per_row / blockDim
        const int i = tid + j * blockDim.x;
        const int r = i / per_row;
        const int k = (i % per_row) * VEC;
        const bool ok = n0 + r < a.N && k0 + k < a.d;
        cp_async<VEC>(dst + r * xs + k,
                      ok ? a.x + static_cast<int64_t>(n0 + r) * a.d + k0 + k : a.x, ok);
      }
    }
    cp_async_commit();                            // empty past the end
  };

  float acc[NF][4];
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[f][j] = 0.f;

  stage_queries(0);
  for (int s = 0; s < a.stages - 1; ++s) load_step(s);

  for (int s = 0; s < steps; ++s) {
    cp_async_wait_at_most(a.stages - 2);          // step s has landed
    __syncthreads();                              // and step s - 1 is consumed
    const int c = s % chunks;
    if (per_panel < chunks && c % per_panel == 0 && s > 0) {
      stage_queries(c / per_panel);               // the next d-panel
      cp_async_wait<0>();
      __syncthreads();
    }
    load_step(s + a.stages - 1);

    const float* xa = ring + (s % a.stages) * bm * xs
                      + (wr * 16 + g) * xs + kw * kDotBK + t;   // fragment row g
    const float* xb = xa + 8 * xs;                              // and g + 8
    const float* qb = qs + g * qstride + (c % per_panel) * kc + kw * kDotBK + t;
#pragma unroll
    for (int k = 0; k < kDotBK; k += 8) {
      uint32_t ah[4], al[4], bh[NF][2], bl[NF][2];
      split_tf32(xa[k], ah[0], al[0]);
      split_tf32(xb[k], ah[1], al[1]);
      split_tf32(xa[k + 4], ah[2], al[2]);
      split_tf32(xb[k + 4], ah[3], al[3]);
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        split_tf32(qb[f * 8 * qstride + k], bh[f][0], bl[f][0]);
        split_tf32(qb[f * 8 * qstride + k + 4], bh[f][1], bl[f][1]);
      }
      // Each pass over all NF fragments: NF independent MMAs in a row.
#pragma unroll
      for (int f = 0; f < NF; ++f) mma_tf32(acc[f], al, bh[f][0], bh[f][1]);
#pragma unroll
      for (int f = 0; f < NF; ++f) mma_tf32(acc[f], ah, bl[f][0], bl[f][1]);
#pragma unroll
      for (int f = 0; f < NF; ++f) mma_tf32(acc[f], ah, bh[f][0], bh[f][1]);
    }
    if (c != chunks - 1) continue;

    // The tile's epilogue, 32 queries at a time through epi, one partial
    // tile for each warp of a row slice.  A thread finishes the same 4 rows
    // (gn..gn+3) in every pass, 8 KS queries apart.
    const int n0 = (blockIdx.x + (s / chunks) * gridDim.x) * bm;
    const int quads = bm / 4;
    const int gn = n0 + (tid % quads) * 4;
    bool in[4];
    float xn[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      in[j] = gn + j < a.N;
      xn[j] = (a.mode == kDotL2 && in[j]) ? a.xn[gn + j] : 0.f;
    }
    for (int f0 = 0; 8 * f0 < nq; f0 += kDotEpiQ / 8) {
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        if (f < f0 || f >= f0 + kDotEpiQ / 8) continue;
        float* e = epi + kw * epi_words + (8 * (f - f0) + 2 * t) * (bm + 4)
                   + wr * 16 + g;
        e[0] = acc[f][0];                 // (row g,     query 2t)
        e[bm + 4] = acc[f][1];            // (row g,     query 2t + 1)
        e[8] = acc[f][2];                 // (row g + 8, query 2t)
        e[bm + 4 + 8] = acc[f][3];        // (row g + 8, query 2t + 1)
      }
      __syncthreads();
      const int eq = min(kDotEpiQ, nq - 8 * f0);
      for (int ql = tid / quads; in[0] && ql < eq; ql += blockDim.x / quads) {
        const int gq = q0 + 8 * f0 + ql;
        const float* ep = epi + ql * (bm + 4) + gn - n0;
        const float4 e4 = *reinterpret_cast<const float4*>(ep);
        float v[4] = {e4.x, e4.y, e4.z, e4.w};
#pragma unroll
        for (int w = 1; w < KS; ++w) {         // the other partial tiles, in order
          const float4 p4 = *reinterpret_cast<const float4*>(ep + w * epi_words);
          v[0] += p4.x;
          v[1] += p4.y;
          v[2] += p4.z;
          v[3] += p4.w;
        }
        if (a.mode == kDotL2) {                // norms - 2 q.x, clamped at 0
          const float qn = a.qn[gq];
#pragma unroll
          for (int j = 0; j < 4; ++j) v[j] = fmaxf((qn + xn[j]) - 2.f * v[j], 0.f);
        } else {                               // on pre-normalised rows
#pragma unroll
          for (int j = 0; j < 4; ++j) v[j] = 1.f - v[j];
        }
        const int64_t o = static_cast<int64_t>(gq) * a.N + gn;
        float* dd = a.dist + o;
        uint8_t* mm = a.mask + o;               // unused for distances only
        int32_t* ii = a.ids + o;
        // 16-byte (4-byte for the masks) stores where all 4 rows are live
        // and the address is aligned; one element at a time elsewhere.
        if (in[3] && (reinterpret_cast<uintptr_t>(dd) & 15) == 0) {
          *reinterpret_cast<float4*>(dd) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (in[j]) dd[j] = v[j];
        }
        if (a.mask == nullptr) continue;
        uint32_t m[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) m[j] = v[j] <= a.thresh ? 1u : 0u;
        if (in[3] && (reinterpret_cast<uintptr_t>(mm) & 3) == 0) {
          *reinterpret_cast<uint32_t*>(mm) = m[0] | m[1] << 8 | m[2] << 16 | m[3] << 24;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (in[j]) mm[j] = static_cast<uint8_t>(m[j]);
        }
        if (in[3] && (reinterpret_cast<uintptr_t>(ii) & 15) == 0) {
          *reinterpret_cast<int4*>(ii) = make_int4(gn, gn + 1, gn + 2, gn + 3);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (in[j]) ii[j] = gn + j;
        }
      }
      __syncthreads();                   // epi is free for the next pass
    }
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[f][j] = 0.f;
  }
  cp_async_wait<0>();                    // the trailing empty groups
}

// The current device's SM count and per-block shared memory limit, read
// once per device (a launch is on the host's clock of every query).
struct DeviceInfo {
  int sms = 0, optin = 0, per_sm = 0;
};

DeviceInfo read_device_info(int dev) {
  DeviceInfo info;
  cudaDeviceGetAttribute(&info.sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&info.optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaDeviceGetAttribute(&info.per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  return info;
}

DeviceInfo device_info() {
  constexpr int kMaxDevices = 64;
  static std::mutex mu;
  static DeviceInfo known[kMaxDevices];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= kMaxDevices) return read_device_info(dev);
  std::lock_guard<std::mutex> lock(mu);
  if (known[dev].sms == 0) known[dev] = read_device_info(dev);
  return known[dev];
}

// The launch's layout.  Copy width from the pointers' and the row
// stride's alignment.  NF (a power of two up to 16) n-fragments cover the
// queries, and a group is 8 NF queries; 8 warps (128 rows) a block where
// that gives at least a block per SM, else fewer row warps (down to 2),
// then smaller groups (down to 8 queries); then KS warps to a row slice,
// up to 8 warps a block while d holds two stages of 32 KS columns; the
// queries' d-panel as wide as the block's share of shared memory (all of
// it at KS = 1, half an SM's at KS > 1) allows with a 3-stage ring
// (smaller KS, then smaller groups, where not one stage of columns fits),
// and a fourth stage where the rest allows.  Returns a cudaError_t.
int dot_plan(const void* q, const void* x, int Q, int N, int d, DotPlan& p) {
  const DeviceInfo dev = device_info();
  const int sms = dev.sms;
  const int optin = dev.optin;
  const uintptr_t al = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(x);
  p.vec = (d % 4 == 0 && al % 16 == 0) ? 4 : (d % 2 == 0 && al % 8 == 0) ? 2 : 1;
  const int dp = round_up(std::max(d, 1), kDotBK);
  p.nf = 1;
  while (p.nf < kDotMaxGroup / 8 && 8 * p.nf < Q) p.nf *= 2;
  p.warps = 8;
  auto blocks = [&] {
    return static_cast<int64_t>(ceil_div(N, 16 * p.warps)) * ceil_div(Q, 8 * p.nf);
  };
  while (p.warps > 2 && blocks() < sms) p.warps /= 2;
  while (p.nf > 1 && blocks() < sms) p.nf /= 2;
  p.ks = 1;
  while (p.warps * p.ks < 8 && 4 * kDotBK * p.ks <= dp) p.ks *= 2;
  for (;;) {
    const int bm = 16 * p.warps;
    const int kc = kDotBK * p.ks;
    const int stage = 4 * bm * (kc + 4);
    const int epi = 4 * p.ks * std::min(8 * p.nf, kDotEpiQ) * (bm + 4);
    // few tiles (KS > 1): two blocks an SM, so twice the stages in flight
    const int budget = p.ks > 1 ? std::min(optin, dev.per_sm / 2 - 1024) : optin;
    const int cols = (budget - epi - kDotMinStages * stage) / (32 * p.nf) - 4;
    p.panel = std::min(round_up(dp, kc), cols / kc * kc);
    if (p.panel >= kc) {                // the rest of shared memory: the ring
      const int qs = 32 * p.nf * (p.panel + 4);
      p.stages = std::min(kDotMaxStages, (budget - epi - qs) / stage);
      p.smem = qs + epi + p.stages * stage;
      break;
    }
    if (p.ks > 1) {
      p.ks /= 2;
    } else if (p.nf > 1) {
      p.nf /= 2;
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  p.group = 8 * p.nf;
  p.groups = ceil_div(Q, p.group);
  p.tiles = ceil_div(N, 16 * p.warps);
  return p.groups > 65535 ? static_cast<int>(cudaErrorInvalidValue) : 0;
}

// The grid: blocks a group = min(tiles, SMs x resident blocks an SM /
// groups).  Launches if `launch`; fills p.occupancy and p.grid_x either way.
// The resident-block count of the last (warps, shared memory) is kept.
template <int VEC, int NF, int KS>
int run_dot(const DotArgs& a, DotPlan& p, cudaStream_t s, bool launch) {
  auto kernel = dot_tile_kernel<VEC, NF, KS>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, device_info().optin);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  static std::mutex mu;
  static int last_threads = 0, last_smem = 0, last_occupancy = 0;
  const int threads = 32 * p.warps * p.ks;
  {
    std::lock_guard<std::mutex> lock(mu);
    if (threads != last_threads || p.smem != last_smem) {
      const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &last_occupancy, kernel, threads, p.smem);
      if (e != cudaSuccess) return static_cast<int>(e);
      last_threads = threads;
      last_smem = p.smem;
    }
    p.occupancy = last_occupancy;
  }
  if (p.occupancy < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int walkers = device_info().sms * p.occupancy / p.groups;
  p.grid_x = std::min(p.tiles, std::max(1, walkers));
  if (!launch) return 0;
  kernel<<<dim3(p.grid_x, p.groups), threads, p.smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int VEC, int NF>
int run_dot_nf(const DotArgs& a, DotPlan& p, cudaStream_t s, bool launch) {
  switch (p.ks) {
    case 1: return run_dot<VEC, NF, 1>(a, p, s, launch);
    case 2: return run_dot<VEC, NF, 2>(a, p, s, launch);
    default: return run_dot<VEC, NF, 4>(a, p, s, launch);
  }
}

template <int VEC>
int run_dot_vec(const DotArgs& a, DotPlan& p, cudaStream_t s, bool launch) {
  switch (p.nf) {
    case 1: return run_dot_nf<VEC, 1>(a, p, s, launch);
    case 2: return run_dot_nf<VEC, 2>(a, p, s, launch);
    case 4: return run_dot_nf<VEC, 4>(a, p, s, launch);
    case 8: return run_dot_nf<VEC, 8>(a, p, s, launch);
    default: return run_dot_nf<VEC, 16>(a, p, s, launch);
  }
}

// Plan and (if `launch`) run the dot-form tile; fills p either way.
int dot_tile(DotArgs a, DotPlan& p, cudaStream_t s, bool launch) {
  if (a.mode != kDotL2 && a.mode != kDotCosine) return static_cast<int>(cudaErrorInvalidValue);
  const int err = dot_plan(a.q, a.x, a.Q, a.N, a.d, p);
  if (err) return err;
  a.group = p.group;
  a.panel = p.panel;
  a.tiles = p.tiles;
  a.stages = p.stages;
  switch (p.vec) {
    case 4: return run_dot_vec<4>(a, p, s, launch);
    case 2: return run_dot_vec<2>(a, p, s, launch);
    default: return run_dot_vec<1>(a, p, s, launch);
  }
}

// ---- the L1 tile (linear_scan_l1, pairwise_l1) ---------------------------

constexpr int kL1Threads = 128;         // 4 warps
constexpr int kL1Group = 32;            // queries per group: 8 a warp
constexpr int kL1TQ = 8;                // queries a thread
constexpr int kL1TN = 4;                // rows a thread: lane + 32 j
constexpr int kL1BN = 32 * kL1TN;       // rows per tile
constexpr int kL1BK = 16;               // d-columns of a ring stage
constexpr int kL1XS = kL1BK + 4;        // words per row in a stage
constexpr int kL1MinStages = 3;
constexpr int kL1MaxStages = 4;
constexpr int kL1BlocksPerSm = 4;       // the shared memory budget's divisor
constexpr int kL1EpiS = kL1BN + 4;      // words per query row of the epilogue
static_assert(kL1MaxStages == kDotMaxStages, "cp_async_wait_at_most's depths");
static_assert(kL1Threads / 32 * kL1TQ == kL1Group, "a warp per 8 queries");

struct L1Args {
  const float* q;        // (Q, d)
  const float* x;        // (N, d)
  float thresh;
  float* dist;           // (Q, N)
  uint8_t* mask;         // (Q, N), or null: distances only
  int32_t* ids;          // (Q, N), null with mask
  int Q, N, d;
  int panel;             // d-columns of the queries staged at once
  int tiles;             // row tiles of kL1BN rows
  int stages;            // depth of the ring
  int sets, extra;       // 8-query sets a group (the first `extra` one more)
};

struct L1Plan {
  int vec, panel, stages, smem, groups, tiles, occupancy, walkers, sets, extra;
};

// One column k: acc += |q - x| for the thread's 8 queries (two broadcast
// 16-byte reads at qk) and 4 rows, in k order, as every version sums it.
__device__ __forceinline__ void l1_step(float (&acc)[kL1TQ][kL1TN],
                                        const float (&xk)[kL1TN], const float* qk) {
  const float4 qa = *reinterpret_cast<const float4*>(qk);
  const float4 qb = *reinterpret_cast<const float4*>(qk + 4);
  const float qv[kL1TQ] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
#pragma unroll
  for (int i = 0; i < kL1TQ; ++i)
#pragma unroll
    for (int j = 0; j < kL1TN; ++j) acc[i][j] += fabsf(qv[i] - xk[j]);
}

// VEC: floats a cp.async (4, 2 or 1).  Grid: (walkers, groups); group g
// owns a.sets (+1 for g < a.extra) consecutive sets of 8 queries.
template <bool DIST_ONLY, int VEC>
__global__ void __launch_bounds__(kL1Threads, kL1BlocksPerSm)
l1_tile_kernel(const L1Args a) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = blockIdx.y;
  const int q0 = kL1TQ * (g * a.sets + min(g, a.extra));
  const int nq = min(kL1TQ * (a.sets + (g < a.extra)), a.Q - q0);   // real queries
  const int walkers = gridDim.x;
  const bool busy = warp * kL1TQ < nq;               // warp-uniform
  const int chunks = ceil_div(max(a.d, 1), kL1BK);
  const int per_panel = a.panel / kL1BK;
  float* qs = smem;                                  // [panel][kL1Group]
  float* ring = qs + a.panel * kL1Group;             // [stages][kL1BN][kL1XS]
  float* epi = ring + a.stages * kL1BN * kL1XS;      // [kL1Group][kL1EpiS]
  const int steps = ceil_div(a.tiles - static_cast<int>(blockIdx.x), walkers) * chunks;

  // The queries go in k-major ([k][query]), so a warp's 8 queries at one k
  // are two broadcast 16-byte reads; copied a float at a time, once.
  auto stage_queries = [&](int panel) {
    const int k0 = panel * a.panel;
    for (int i = tid; i < kL1Group * a.panel; i += kL1Threads) {
      const int r = i / a.panel;
      const int k = i - r * a.panel;
      const bool ok = r < nq && k0 + k < a.d;
      cp_async<1>(qs + k * kL1Group + r,
                  ok ? a.q + static_cast<int64_t>(q0 + r) * a.d + k0 + k : a.q, ok);
    }
    cp_async_commit();
  };
  // Step s: chunk s % chunks of the block's tile s / chunks.  Columns past d
  // are not copied (never read); rows past N are zero-filled.
  auto load_step = [&](int s) {
    if (s < steps) {
      const int n0 = (blockIdx.x + (s / chunks) * walkers) * kL1BN;
      const int k0 = (s % chunks) * kL1BK;
      float* dst = ring + (s % a.stages) * kL1BN * kL1XS;
      constexpr int per_row = kL1BK / VEC;
#pragma unroll
      for (int j = 0; j < kL1BK / VEC; ++j) {      // kL1BN per_row / kL1Threads
        const int i = tid + j * kL1Threads;
        const int r = i / per_row;
        const int k = (i % per_row) * VEC;
        if (k0 + k >= a.d) continue;
        const bool ok = n0 + r < a.N;
        cp_async<VEC>(dst + r * kL1XS + k,
                      ok ? a.x + static_cast<int64_t>(n0 + r) * a.d + k0 + k : a.x, ok);
      }
    }
    cp_async_commit();                            // empty past the end
  };

  float acc[kL1TQ][kL1TN];
#pragma unroll
  for (int i = 0; i < kL1TQ; ++i)
#pragma unroll
    for (int j = 0; j < kL1TN; ++j) acc[i][j] = 0.f;

  stage_queries(0);
  for (int s = 0; s < a.stages - 1; ++s) load_step(s);

  for (int s = 0; s < steps; ++s) {
    cp_async_wait_at_most(a.stages - 2);          // step s has landed
    __syncthreads();                              // and step s - 1 is consumed
    const int c = s % chunks;
    if (per_panel < chunks && c % per_panel == 0 && s > 0) {
      stage_queries(c / per_panel);               // the next d-panel
      cp_async_wait<0>();
      __syncthreads();
    }
    load_step(s + a.stages - 1);

    if (busy) {
      const float* xs = ring + (s % a.stages) * kL1BN * kL1XS + lane * kL1XS;
      const float* qp = qs + (c % per_panel) * kL1BK * kL1Group + warp * kL1TQ;
      const int kc = min(kL1BK, a.d - c * kL1BK);  // exactly d: no padded columns
      int k = 0;
      for (; k + 4 <= kc; k += 4) {               // a 16-byte read a row
        float4 xv[kL1TN];
#pragma unroll
        for (int j = 0; j < kL1TN; ++j)
          xv[j] = *reinterpret_cast<const float4*>(xs + j * 32 * kL1XS + k);
        const float x0[kL1TN] = {xv[0].x, xv[1].x, xv[2].x, xv[3].x};
        const float x1[kL1TN] = {xv[0].y, xv[1].y, xv[2].y, xv[3].y};
        const float x2[kL1TN] = {xv[0].z, xv[1].z, xv[2].z, xv[3].z};
        const float x3[kL1TN] = {xv[0].w, xv[1].w, xv[2].w, xv[3].w};
        l1_step(acc, x0, qp + k * kL1Group);
        l1_step(acc, x1, qp + (k + 1) * kL1Group);
        l1_step(acc, x2, qp + (k + 2) * kL1Group);
        l1_step(acc, x3, qp + (k + 3) * kL1Group);
      }
      for (; k < kc; ++k) {                       // d % 4 columns
        float xk[kL1TN];
#pragma unroll
        for (int j = 0; j < kL1TN; ++j) xk[j] = xs[j * 32 * kL1XS + k];
        l1_step(acc, xk, qp + k * kL1Group);
      }
    }
    if (c < chunks - 1) continue;

    // The tile's epilogue through epi: each thread then finishes 4 adjacent
    // rows of one query, 4 queries a pass.
    const int n0 = (blockIdx.x + (s / chunks) * walkers) * kL1BN;
    if (busy) {
#pragma unroll
      for (int i = 0; i < kL1TQ; ++i)
#pragma unroll
        for (int j = 0; j < kL1TN; ++j)
          epi[(warp * kL1TQ + i) * kL1EpiS + lane + 32 * j] = acc[i][j];
    }
    __syncthreads();
    const int gn = n0 + lane * 4;
    for (int ql = warp; gn < a.N && ql < nq; ql += kL1Threads / 32) {
      const float4 e4 = *reinterpret_cast<const float4*>(epi + ql * kL1EpiS + lane * 4);
      const float v[4] = {e4.x, e4.y, e4.z, e4.w};
      bool in[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) in[j] = gn + j < a.N;
      const int64_t o = static_cast<int64_t>(q0 + ql) * a.N + gn;
      float* dd = a.dist + o;
      if (in[3] && (reinterpret_cast<uintptr_t>(dd) & 15) == 0) {
        *reinterpret_cast<float4*>(dd) = e4;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (in[j]) dd[j] = v[j];
      }
      if (DIST_ONLY) continue;
      uint8_t* mm = a.mask + o;
      int32_t* ii = a.ids + o;
      uint32_t m[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) m[j] = v[j] <= a.thresh ? 1u : 0u;
      if (in[3] && (reinterpret_cast<uintptr_t>(mm) & 3) == 0) {
        *reinterpret_cast<uint32_t*>(mm) = m[0] | m[1] << 8 | m[2] << 16 | m[3] << 24;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (in[j]) mm[j] = static_cast<uint8_t>(m[j]);
      }
      if (in[3] && (reinterpret_cast<uintptr_t>(ii) & 15) == 0) {
        *reinterpret_cast<int4*>(ii) = make_int4(gn, gn + 1, gn + 2, gn + 3);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (in[j]) ii[j] = gn + j;
      }
    }
    __syncthreads();                     // epi is free for the next tile
#pragma unroll
    for (int i = 0; i < kL1TQ; ++i)
#pragma unroll
      for (int j = 0; j < kL1TN; ++j) acc[i][j] = 0.f;
  }
  cp_async_wait<0>();                    // the trailing empty groups
}

// The L1 tile's layout.  Copy width as the dot tile's; the queries' d-panel
// as wide as kL1BlocksPerSm blocks an SM allow beside a 3-stage ring and
// the epilogue: 64 columns at four blocks (all of d up to 64, else panels
// restaged each tile, each behind a drain of the ring), a fourth stage
// where the rest allows.  Returns a cudaError_t.
int l1_plan(const void* q, const void* x, int Q, int N, int d, L1Plan& p) {
  const DeviceInfo dev = device_info();
  const uintptr_t al = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(x);
  p.vec = (d % 4 == 0 && al % 16 == 0) ? 4 : (d % 2 == 0 && al % 8 == 0) ? 2 : 1;
  // 1 KB a block is reserved
  const int budget = std::min(dev.optin, dev.per_sm / kL1BlocksPerSm - 1024);
  const int stage = 4 * kL1BN * kL1XS;
  const int epi = 4 * kL1Group * kL1EpiS;
  const int cols = (budget - epi - kL1MinStages * stage) / (4 * kL1Group);
  p.panel = std::min(round_up(std::max(d, 1), kL1BK), cols / kL1BK * kL1BK);
  if (p.panel < kL1BK) return static_cast<int>(cudaErrorInvalidValue);
  const int qs = 4 * kL1Group * p.panel;
  p.stages = std::min(kL1MaxStages, (budget - qs - epi) / stage);
  p.smem = qs + epi + p.stages * stage;
  const int sets = ceil_div(Q, kL1TQ);
  p.groups = ceil_div(sets, kL1Group / kL1TQ);
  p.sets = sets / p.groups;
  p.extra = sets % p.groups;
  p.tiles = ceil_div(N, kL1BN);
  return p.groups > 65535 ? static_cast<int>(cudaErrorInvalidValue) : 0;
}

// Walkers = SMs x resident blocks an SM, shared evenly by the groups (a
// tile takes a block about as long whether 3 or 4 of its warps are busy,
// so the plan spreads the 8-query sets evenly over the groups), at most one
// per tile.  Launches if `launch`; fills p.occupancy and p.walkers either way.
template <bool DIST_ONLY, int VEC>
int run_l1(L1Args a, L1Plan& p, cudaStream_t s, bool launch) {
  auto kernel = l1_tile_kernel<DIST_ONLY, VEC>;
  static const cudaError_t attr = [&] {    // and the largest carveout
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
    return e != cudaSuccess ? e : cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, device_info().optin);
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  static std::mutex mu;
  static int last_smem = 0, last_occupancy = 0;
  {
    std::lock_guard<std::mutex> lock(mu);
    if (p.smem != last_smem) {
      const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &last_occupancy, kernel, kL1Threads, p.smem);
      if (e != cudaSuccess) return static_cast<int>(e);
      last_smem = p.smem;
    }
    p.occupancy = last_occupancy;
  }
  if (p.occupancy < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  p.walkers = std::min(p.tiles, std::max(1, device_info().sms * p.occupancy / p.groups));
  if (!launch) return 0;
  a.panel = p.panel;
  a.tiles = p.tiles;
  a.stages = p.stages;
  a.sets = p.sets;
  a.extra = p.extra;
  kernel<<<dim3(p.walkers, p.groups), kL1Threads, p.smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Plan and (if `launch`) run the L1 tile; fills p either way.
int l1_tile(const L1Args& a, L1Plan& p, cudaStream_t s, bool launch) {
  const int err = l1_plan(a.q, a.x, a.Q, a.N, a.d, p);
  if (err) return err;
  const bool dist_only = a.mask == nullptr;
  switch (p.vec) {
    case 4: return dist_only ? run_l1<true, 4>(a, p, s, launch) : run_l1<false, 4>(a, p, s, launch);
    case 2: return dist_only ? run_l1<true, 2>(a, p, s, launch) : run_l1<false, 2>(a, p, s, launch);
    default: return dist_only ? run_l1<true, 1>(a, p, s, launch) : run_l1<false, 1>(a, p, s, launch);
  }
}

// ---- the Hamming scan: K5 over a group of segments, and K8 ----------------

constexpr int kHamThreads = 128;
constexpr int kHamRowsPerThread = 4;
constexpr int kHamTile = kHamThreads * kHamRowsPerThread;   // rows a block
constexpr int kHamQ = 32;                          // queries a block, at most
constexpr int kHamFillPerSm = 2;   // blocks an SM the grid aims at, at least
constexpr int kHamMaxSegs = 64;   // segments a launch; 2.6 KB of parameters
constexpr int32_t kExtSentinel = 0x7fffffff;   // engine.EXT_SENTINEL

struct HamSeg {
  const uint32_t* x;     // (n, W) packed codes
  const uint8_t* live;   // (>= n,) 0/1, or null: every row live
  const int32_t* ext;    // (>= n,) external ids, or null: report the row index
  int64_t col;           // the segment's first output column
  int n;                 // rows
  int tile0;             // its first row tile (blockIdx.x); set by the launcher
};

struct HamArgs {
  const uint32_t* q;     // (Q, W)
  void* dist;            // (Q, ld) f32; int32 when mask is null (hamming)
  uint8_t* mask;         // (Q, ld), or null: distances only
  int32_t* ids;          // (Q, ld)
  int64_t ld;            // row stride of the outputs, in elements
  float thresh;
  int Q, W, nseg;
  int tiles;             // row tiles of all segments; set by the launcher
  HamSeg seg[kHamMaxSegs];
};

// One block: 512 rows of one segment (4 adjacent rows a thread) x one of
// gridDim.y even shares of the queries (at most kHamQ).  WR > 0: W == WR
// and a thread's 4 rows (4 * WR contiguous words) are held in registers, loaded with 16-byte loads; WR == 0: any W, the
// rows' words reread (from L1) for each query.  DIST_ONLY: int32
// distances only (hamming).
template <bool DIST_ONLY, int WR>
__global__ void __launch_bounds__(kHamThreads)
hamming_scan_kernel(const __grid_constant__ HamArgs a) {
  extern __shared__ uint32_t qs[];   // the block's query codes, (nq, W)
  const int tile = blockIdx.x;
  int s = 0;
  while (s + 1 < a.nseg && a.seg[s + 1].tile0 <= tile) ++s;
  const HamSeg& g = a.seg[s];
  const int W = WR > 0 ? WR : a.W;
  const int q0 = static_cast<int>(static_cast<int64_t>(blockIdx.y) * a.Q / gridDim.y);
  const int nq = static_cast<int>(static_cast<int64_t>(blockIdx.y + 1) * a.Q / gridDim.y) - q0;
  const uint32_t* qsrc = a.q + static_cast<int64_t>(q0) * W;
  for (int i = threadIdx.x; i < nq * W; i += kHamThreads) qs[i] = qsrc[i];
  __syncthreads();
  const int n0 = (tile - g.tile0) * kHamTile + threadIdx.x * kHamRowsPerThread;
  if (n0 >= g.n) return;
  const int nr = min(kHamRowsPerThread, g.n - n0);
  const uint32_t* xr = g.x + static_cast<int64_t>(n0) * W;
  uint32_t xv[WR > 0 ? kHamRowsPerThread * WR : 1];
  if constexpr (WR > 0) {
    if (nr == kHamRowsPerThread && (reinterpret_cast<uintptr_t>(xr) & 15) == 0) {
#pragma unroll
      for (int k = 0; k < WR; ++k) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(xr) + k);
        xv[4 * k] = v.x; xv[4 * k + 1] = v.y; xv[4 * k + 2] = v.z; xv[4 * k + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < kHamRowsPerThread * WR; ++k)
        xv[k] = k < nr * WR ? __ldg(xr + k) : 0u;
    }
  }
  bool live[kHamRowsPerThread];
  int32_t ext[kHamRowsPerThread];
#pragma unroll
  for (int r = 0; r < kHamRowsPerThread; ++r) {
    live[r] = r < nr && (g.live == nullptr || g.live[n0 + r] != 0);
    ext[r] = (r < nr && g.ext != nullptr) ? g.ext[n0 + r] : n0 + r;
  }
  for (int i = 0; i < nq; ++i) {
    const uint32_t* qi = qs + i * W;
    int d[kHamRowsPerThread] = {0, 0, 0, 0};
    if constexpr (WR > 0) {
#pragma unroll
      for (int w = 0; w < WR; ++w) {
        const uint32_t qw = qi[w];
#pragma unroll
        for (int r = 0; r < kHamRowsPerThread; ++r) d[r] += __popc(xv[r * WR + w] ^ qw);
      }
    } else {
      for (int w = 0; w < W; ++w) {
        const uint32_t qw = qi[w];
#pragma unroll
        for (int r = 0; r < kHamRowsPerThread; ++r)
          if (r < nr) d[r] += __popc(__ldg(xr + r * W + w) ^ qw);
      }
    }
    const int64_t o = static_cast<int64_t>(q0 + i) * a.ld + g.col + n0;
    const bool vec = nr == kHamRowsPerThread && (o & 3) == 0;
    if constexpr (DIST_ONLY) {
      int32_t* out = static_cast<int32_t*>(a.dist) + o;
      if (vec) {
        __stcs(reinterpret_cast<int4*>(out), make_int4(d[0], d[1], d[2], d[3]));
      } else {
        for (int r = 0; r < nr; ++r) out[r] = d[r];
      }
    } else {
      float dv[kHamRowsPerThread];
      int32_t iv[kHamRowsPerThread];
      uint32_t mk = 0;
#pragma unroll
      for (int r = 0; r < kHamRowsPerThread; ++r) {
        dv[r] = static_cast<float>(d[r]);
        const bool m = dv[r] <= a.thresh && live[r];
        mk |= static_cast<uint32_t>(m) << (8 * r);
        iv[r] = (g.ext == nullptr || m) ? ext[r] : kExtSentinel;
      }
      float* dist = static_cast<float*>(a.dist) + o;
      if (vec) {
        __stcs(reinterpret_cast<float4*>(dist), make_float4(dv[0], dv[1], dv[2], dv[3]));
        __stcs(reinterpret_cast<int4*>(a.ids + o), make_int4(iv[0], iv[1], iv[2], iv[3]));
        __stcs(reinterpret_cast<unsigned int*>(a.mask + o), mk);
      } else {
        for (int r = 0; r < nr; ++r) {
          dist[r] = dv[r];
          a.ids[o + r] = iv[r];
          a.mask[o + r] = static_cast<uint8_t>((mk >> (8 * r)) & 1u);
        }
      }
    }
  }
}

template <bool DIST_ONLY, int WR>
int run_hamming(const HamArgs& a, int shares, cudaStream_t s) {
  auto kernel = hamming_scan_kernel<DIST_ONLY, WR>;
  const size_t smem = sizeof(uint32_t) * kHamQ * a.W;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(a.tiles, shares), kHamThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Lay the row tiles of the segments end to end, share out the queries,
// then launch.
int hamming_scan(HamArgs a, cudaStream_t s) {
  if (a.W < 1 || a.nseg < 1 || a.nseg > kHamMaxSegs || a.ld < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int64_t tiles = 0;
  for (int i = 0; i < a.nseg; ++i) {
    if (a.seg[i].n < 0) return static_cast<int>(cudaErrorInvalidValue);
    a.seg[i].tile0 = static_cast<int>(tiles);
    tiles += (static_cast<int64_t>(a.seg[i].n) + kHamTile - 1) / kHamTile;
  }
  if (a.Q <= 0 || tiles == 0) return 0;
  // At most kHamQ queries a share, and more shares (down to one query
  // each) where the row tiles alone leave SMs idle: a one-segment scan of
  // the 4,097-row delta is 9 tiles.
  const int64_t fill = static_cast<int64_t>(kHamFillPerSm) * device_info().sms;
  const int64_t shares = std::max<int64_t>(
      (a.Q + kHamQ - 1) / kHamQ, std::min<int64_t>(a.Q, (fill + tiles - 1) / tiles));
  if (tiles > 0x7fffffff || shares > 65535) return static_cast<int>(cudaErrorInvalidValue);
  a.tiles = static_cast<int>(tiles);
  const int y = static_cast<int>(shares);
  const bool dist_only = a.mask == nullptr;
  switch (a.W) {
    case 1: return dist_only ? run_hamming<true, 1>(a, y, s) : run_hamming<false, 1>(a, y, s);
    case 2: return dist_only ? run_hamming<true, 2>(a, y, s) : run_hamming<false, 2>(a, y, s);
    case 4: return dist_only ? run_hamming<true, 4>(a, y, s) : run_hamming<false, 4>(a, y, s);
    default: return dist_only ? run_hamming<true, 0>(a, y, s) : run_hamming<false, 0>(a, y, s);
  }
}

// ---- lsh_scan: sort, dedup, gather and verify --------------------------

// kCosineUnit: 1 - x.q on corpus rows the caller scaled to unit length, the
// query row scaled in the kernel.
enum Metric { kL2 = 0, kL1 = 1, kCosineUnit = 2, kHamming = 3 };
constexpr int kLshThreads = 512;
constexpr int kLshWarps = kLshThreads / 32;
constexpr int kLshBlocksPerSm = 2;
constexpr int kLshWords = 16;           // words of a row a lane loads before using any
constexpr int kLshMaxWidth = 1 << 18;   // ids a block owns, at most: 64 KB of bitmap and ranks

struct LshArgs {
  const void* x;         // (n, d) float32, or int32 bit views of packed codes
  const void* q;         // (Q, d)
  const int32_t* cands;  // (Q, C), unsorted, sentinel = n
  float thresh;
  int32_t* ids;          // (Q, C) out: cands sorted
  float* dist;           // (Q, C)
  uint8_t* mask;         // (Q, C)
  int Q, C, n, d;
  int width;             // ids a block owns; gridDim.x blocks a query
  int dcap;              // distinct ids a block holds at once
  int group;             // lanes a gathered row (a power of two, 1-32)
};

struct LshPlan {
  int splits, width, dcap, vec, group, smem;
};

template <typename T, int VEC> struct Vec;
template <> struct Vec<float, 4> { using type = float4; };
template <> struct Vec<float, 2> { using type = float2; };
template <> struct Vec<float, 1> { using type = float; };
template <> struct Vec<uint32_t, 4> { using type = uint4; };
template <> struct Vec<uint32_t, 2> { using type = uint2; };
template <> struct Vec<uint32_t, 1> { using type = uint32_t; };

__device__ __forceinline__ void unpack(const float4& v, float* o) {
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void unpack(const float2& v, float* o) { o[0] = v.x; o[1] = v.y; }
__device__ __forceinline__ void unpack(const float& v, float* o) { o[0] = v; }
__device__ __forceinline__ void unpack(const uint4& v, uint32_t* o) {
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void unpack(const uint2& v, uint32_t* o) { o[0] = v.x; o[1] = v.y; }
__device__ __forceinline__ void unpack(const uint32_t& v, uint32_t* o) { o[0] = v; }

// Sum over the `group` lanes (a power of two) that share a row.
template <typename T>
__device__ __forceinline__ T group_sum(T v, int group) {
  for (int off = group >> 1; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Pieces (VEC-wide loads) a lane holds in flight.
template <int VEC>
constexpr int kLshPieces = kLshWords / VEC;

// The distance of the row at xrow (device or shared memory) to the staged
// query qs, by the lanes lg = 0..group-1 of its group; every lane returns
// it.  Each lane issues all its loads of a round (pieces lg, lg + group, ...,
// kLshPieces of them) before it uses any, so a row costs one trip to
// memory.  `ok` false: no read, any value.
template <int METRIC, int VEC>
__device__ __forceinline__ float row_dist(const void* xrow, const void* qsv, int d,
                                          int lg, int group, bool ok) {
  constexpr int U = kLshPieces<VEC>;
  const int pieces = ok ? d / VEC : 0;
  using T = std::conditional_t<METRIC == kHamming, uint32_t, float>;
  using V = typename Vec<T, VEC>::type;
  const V* xr = static_cast<const V*>(xrow);
  const V* qr = static_cast<const V*>(qsv);
  float s0 = 0.f;                       // l2 / l1: the sum; cosine: x.q
  int bits = 0;                         // Hamming
  for (int p0 = lg; p0 < pieces; p0 += U * group) {
    V xp[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (p0 + u * group < pieces) xp[u] = xr[p0 + u * group];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (p0 + u * group >= pieces) break;
      T a[VEC], b[VEC];
      unpack(xp[u], a);
      unpack(qr[p0 + u * group], b);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        if constexpr (METRIC == kHamming) {
          bits += __popc(a[e] ^ b[e]);
        } else if constexpr (METRIC == kCosineUnit) {
          s0 = fmaf(a[e], b[e], s0);
        } else {
          const float diff = a[e] - b[e];
          s0 += (METRIC == kL2) ? diff * diff : fabsf(diff);
        }
      }
    }
  }
  if constexpr (METRIC == kHamming) {
    return static_cast<float>(group_sum(bits, group));
  } else if constexpr (METRIC == kCosineUnit) {
    return 1.f - group_sum(s0, group);
  } else {
    return group_sum(s0, group);
  }
}

// Exclusive scan of one int a thread over the block; `total` gets the sum.
// Barriers before and after its use of `scratch` (kLshWarps ints).
__device__ __forceinline__ int block_scan(int v, int& total, int* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += u;
  }
  __syncthreads();                      // the last scan's readers are done
  if (lane == 31) scratch[warp] = inc;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int i = 0; i < kLshWarps; ++i) {
    const int t = scratch[i];
    if (i < warp) before += t;
    total += t;
  }
  return before + inc - v;
}

// Call visit(v) for each of the C ids at c, four loads a thread in flight
// before any is used (16-byte loads where C and c allow).
template <typename F>
__device__ __forceinline__ void for_each_id(const int32_t* c, int C, F&& visit) {
  const int tid = threadIdx.x;
  if ((C & 3) == 0 && (reinterpret_cast<uintptr_t>(c) & 15) == 0) {
    const int4* c4 = reinterpret_cast<const int4*>(c);
    const int n4 = C / 4;
    for (int i0 = tid; i0 < n4; i0 += 4 * kLshThreads) {
      int4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (i0 + u * kLshThreads < n4) v[u] = c4[i0 + u * kLshThreads];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (i0 + u * kLshThreads >= n4) break;
        visit(v[u].x);
        visit(v[u].y);
        visit(v[u].z);
        visit(v[u].w);
      }
    }
  } else {
    for (int i0 = tid; i0 < C; i0 += 4 * kLshThreads) {
      int v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (i0 + u * kLshThreads < C) v[u] = c[i0 + u * kLshThreads];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (i0 + u * kLshThreads >= C) break;
        visit(v[u]);
      }
    }
  }
}

// Block (s, qi) owns the ids [lo, hi) = [s w, min((s + 1) w, n)) of query qi.
// Grid: (splits, Q); 512 threads.  Shared memory: a presence bit per id of
// the range, each bitmap word's rank (distinct ids before it), and for up
// to dcap distinct ids at once their counts (then output offsets), their
// ids relative to lo and their distances; the query row.
template <int METRIC, int VEC>
__global__ void __launch_bounds__(kLshThreads, kLshBlocksPerSm)
lsh_scan_kernel(const LshArgs a) {
  extern __shared__ __align__(16) unsigned char lsh_smem[];
  __shared__ int scratch[kLshWarps];
  const int tid = threadIdx.x;
  const int qi = blockIdx.y;
  const int lo = blockIdx.x * a.width;
  const int hi = min(lo + a.width, a.n);
  const int words = ceil_div(a.width, 32);
  uint32_t* bits = reinterpret_cast<uint32_t*>(lsh_smem);        // [words]
  int* rank = reinterpret_cast<int*>(bits + round_up(words, 4));  // [words]
  int* cnt = rank + round_up(words, 4);                           // [dcap], then offsets
  int* rel = cnt + round_up(a.dcap, 4);                           // [dcap]
  float* dist_s = reinterpret_cast<float*>(rel + round_up(a.dcap, 4));   // [dcap]
  uint32_t* qs = reinterpret_cast<uint32_t*>(dist_s + round_up(a.dcap, 4));  // [d]
  const int32_t* c = a.cands + static_cast<int64_t>(qi) * a.C;

  // 1. Mark the ids of [lo, hi) present and count those below lo (this
  //    block's output offset).  Sentinels (>= n) are counted by no block:
  //    the tail is what is left.
  for (int i = tid; i < words; i += kLshThreads) bits[i] = 0;
  const uint32_t* qrow = static_cast<const uint32_t*>(a.q) + static_cast<int64_t>(qi) * a.d;
  for (int k = tid; k < a.d; k += kLshThreads) qs[k] = qrow[k];
  __syncthreads();
  if (METRIC == kCosineUnit && tid < 32) {       // q / max(|q|, 1e-12), as unit_rows
    float* qf = reinterpret_cast<float*>(qs);
    float ss = 0.f;
    for (int k = tid; k < a.d; k += 32) ss = fmaf(qf[k], qf[k], ss);
    const float nrm = fmaxf(sqrtf(group_sum(ss, 32)), 1e-12f);
    for (int k = tid; k < a.d; k += 32) qf[k] = qf[k] / nrm;
  }                                     // read after the barriers of step 2
  int below = 0;
  for_each_id(c, a.C, [&](int v) {
    if (v < lo) {
      ++below;
    } else if (v < hi) {
      const int r = v - lo;
      atomicOr(bits + (r >> 5), 1u << (r & 31));
    }
  });
  __syncthreads();

  // 2. Rank the words: thread t owns a run of consecutive words.
  const int wpt = ceil_div(words, kLshThreads);
  const int w0 = min(tid * wpt, words);
  const int w1 = min(w0 + wpt, words);
  int nd = 0;
  for (int i = w0; i < w1; ++i) nd += __popc(bits[i]);
  int n_distinct, below_all;
  int k = block_scan(nd, n_distinct, scratch);
  for (int i = w0; i < w1; ++i) {
    rank[i] = k;
    k += __popc(bits[i]);
  }
  block_scan(below, below_all, scratch);          // its barriers publish rank

  // 3. The distinct ids in order, dcap of them at a time (one pass unless
  //    a block owns more distinct ids than its shared memory holds): count
  //    each id at its rank, turn the counts into output offsets, gather and
  //    verify each distinct row once, write the slots.
  const int64_t base = static_cast<int64_t>(qi) * a.C + below_all;
  const float inf = __int_as_float(0x7f800000);
  const int lg = tid & (a.group - 1);
  const int rows_at_once = kLshThreads / a.group;
  int done = 0;                                   // slots written so far
  for (int k_lo = 0; k_lo < n_distinct; k_lo += a.dcap) {   // block-uniform
    const int nk = min(a.dcap, n_distinct - k_lo);
    for (int i = tid; i < nk; i += kLshThreads) cnt[i] = 0;
    __syncthreads();
    for_each_id(c, a.C, [&](int v) {
      if (v < lo || v >= hi) return;
      const int r = v - lo;
      const int kk = rank[r >> 5] + __popc(bits[r >> 5] & ((1u << (r & 31)) - 1u)) - k_lo;
      if (kk < 0 || kk >= nk) return;
      atomicAdd(cnt + kk, 1);
      rel[kk] = r;                                // every duplicate writes the same
    });
    __syncthreads();
    const int ept = ceil_div(nk, kLshThreads);    // thread t owns a run of entries
    const int e0 = min(tid * ept, nk);
    const int e1 = min(e0 + ept, nk);
    int cs = 0;
    for (int i = e0; i < e1; ++i) cs += cnt[i];
    int n_in;
    int o = block_scan(cs, n_in, scratch);
    int* offs = cnt;
    for (int i = e0; i < e1; ++i) {
      const int m = cnt[i];
      offs[i] = o;
      o += m;
    }
    __syncthreads();

    using T = std::conditional_t<METRIC == kHamming, uint32_t, float>;
    const T* x = static_cast<const T*>(a.x);
    for (int k0 = 0; k0 < nk; k0 += rows_at_once) {   // block-uniform
      const int kk = k0 + tid / a.group;
      const bool ok = kk < nk;
      const T* row = x + static_cast<int64_t>(lo + (ok ? rel[kk] : 0)) * a.d;
      const float v = row_dist<METRIC, VEC>(row, qs, a.d, lg, a.group, ok);
      if (ok && lg == 0) dist_s[kk] = v;
    }
    __syncthreads();

    // A thread a slot, in order (coalesced): a run's first slot carries the
    // distance and the mask, its duplicates +inf and 0.
    for (int p = tid; p < n_in; p += kLshThreads) {
      int l = 0, h = nk - 1;            // the last run starting at or before p
      while (l < h) {
        const int mid = (l + h + 1) >> 1;
        if (offs[mid] <= p) l = mid;
        else h = mid - 1;
      }
      const bool first = offs[l] == p;
      const float v = first ? dist_s[l] : inf;
      const int64_t o64 = base + done + p;
      a.ids[o64] = lo + rel[l];
      a.dist[o64] = v;
      a.mask[o64] = first && v <= a.thresh ? 1 : 0;
    }
    done += n_in;
    __syncthreads();                    // cnt, rel and dist_s are free again
  }
  if (blockIdx.x + 1 == gridDim.x) {    // the sentinel tail
    for (int p = done + tid; below_all + p < a.C; p += kLshThreads) {
      a.ids[base + p] = a.n;
      a.dist[base + p] = inf;
      a.mask[base + p] = 0;
    }
  }
}

// How lsh_scan lays out a call: splits (blocks a query) = as many as two
// blocks an SM give the Q queries in one wave, and at least n / 2^18, at
// most n; the width w = ceil(n / splits) (the splits then ceil(n / w)); dcap
// = the distinct ids a block can hold beside its bitmap when two blocks
// share an SM, at most min(w, C); the gather's copy width from x's
// alignment and d; `group` lanes a row = the power of two at or above the
// row's words / 16, at most 32.  Returns a cudaError_t.
int lsh_plan(const void* x, int Q, int C, int n, int d, LshPlan& p) {
  const DeviceInfo dev = device_info();
  const int64_t fill = std::max(1, kLshBlocksPerSm * dev.sms / std::max(Q, 1));
  const int64_t splits = std::min<int64_t>(
      std::max<int64_t>({fill, ceil_div(n, kLshMaxWidth), 1}), std::max(n, 1));
  p.width = std::max(1, static_cast<int>(ceil_div(n, static_cast<int>(splits))));
  p.splits = std::max(1, ceil_div(n, p.width));
  const uintptr_t al = reinterpret_cast<uintptr_t>(x);
  p.vec = (d % 4 == 0 && al % 16 == 0) ? 4 : (d % 2 == 0 && al % 8 == 0) ? 2 : 1;
  const int rounds = ceil_div(d / p.vec, kLshWords / p.vec);   // kLshPieces a lane
  p.group = 1;
  while (p.group < 32 && p.group < rounds) p.group *= 2;
  // 1 KB a block reserved, and the static scan scratch
  const int budget = std::min(dev.optin, dev.per_sm / kLshBlocksPerSm - 1024)
                     - 4 * kLshWarps;
  const int fixed = 8 * round_up(ceil_div(p.width, 32), 4) + 4 * round_up(d, 4);
  const int room = (budget - fixed) / 12 / 4 * 4;
  p.dcap = std::min({p.width, C, room});
  if (p.dcap < 1 || Q > 65535) return static_cast<int>(cudaErrorInvalidValue);
  p.smem = fixed + 12 * round_up(p.dcap, 4);
  return 0;
}

template <int METRIC, int VEC>
int run_lsh(const LshArgs& a, const LshPlan& p, cudaStream_t s) {
  auto kernel = lsh_scan_kernel<METRIC, VEC>;
  // The dynamic part may take what the block's static scan arrays leave;
  // the largest carveout lets kLshBlocksPerSm blocks share an SM.
  static const int max_dynamic = [&] {
    cudaFuncAttributes fa{};
    if (cudaFuncGetAttributes(&fa, kernel) != cudaSuccess) return -1;
    const int bytes = device_info().optin - static_cast<int>(fa.sharedSizeBytes);
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared) != cudaSuccess)
      return -1;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                bytes) == cudaSuccess ? bytes : -1;
  }();
  if (max_dynamic < 0) return static_cast<int>(cudaErrorInvalidDeviceFunction);
  if (p.smem > max_dynamic) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<dim3(p.splits, a.Q), kLshThreads, p.smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int METRIC>
int run_lsh_metric(const LshArgs& a, const LshPlan& p, cudaStream_t s) {
  switch (p.vec) {
    case 4: return run_lsh<METRIC, 4>(a, p, s);
    case 2: return run_lsh<METRIC, 2>(a, p, s);
    default: return run_lsh<METRIC, 1>(a, p, s);
  }
}

}  // namespace

// q: (Q, d), x: (N, d), qn: (Q,), xn: (N,) float32, contiguous rows (qn,
// xn are read only for mode 0 = l2; mode 1 = cosine; any 4-byte aligned
// base).  Outputs dist (Q, N) f32, mask (Q, N) u8, ids (Q, N) i32.
extern "C" int linear_scan_dot(const void* q, const void* x, const void* qn,
                               const void* xn, float thresh, int mode,
                               void* dist, void* mask, void* ids, int Q, int N,
                               int d, void* stream) {
  if (Q <= 0 || N <= 0) return 0;
  DotArgs a{static_cast<const float*>(q), static_cast<const float*>(x),
            static_cast<const float*>(qn), static_cast<const float*>(xn),
            thresh, mode, static_cast<float*>(dist),
            static_cast<uint8_t*>(mask), static_cast<int32_t*>(ids), Q, N, d};
  DotPlan p{};
  return dot_tile(a, p, static_cast<cudaStream_t>(stream), true);
}

// q: (Q, d), x: (N, d), qn: (Q,), xn: (N,) float32, contiguous rows (qn,
// xn are read only for mode 0 = l2; mode 1 = cosine).  Output dist (Q, N) f32.
extern "C" int pairwise_dot(const void* q, const void* x, const void* qn,
                            const void* xn, int mode, void* dist, int Q, int N,
                            int d, void* stream) {
  if (Q <= 0 || N <= 0) return 0;
  DotArgs a{static_cast<const float*>(q), static_cast<const float*>(x),
            static_cast<const float*>(qn), static_cast<const float*>(xn),
            0.f, mode, static_cast<float*>(dist), nullptr, nullptr, Q, N, d};
  DotPlan p{};
  return dot_tile(a, p, static_cast<cudaStream_t>(stream), true);
}

// The layout linear_scan_dot / pairwise_dot launch for these pointers and
// this shape, without launching: out[0..11] = copy width (floats),
// n-fragments a warp, row warps a block, queries a group, groups, row
// tiles, d-columns of the queries staged at once, ring stages, dynamic
// shared memory (bytes), resident blocks an SM, blocks a group, warps to
// a row slice.  Returns a cudaError_t.
extern "C" int dot_tile_plan(const void* q, const void* x, int Q, int N,
                             int d, int* out) {
  if (Q <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  DotArgs a{static_cast<const float*>(q), static_cast<const float*>(x),
            nullptr, nullptr, 0.f, kDotCosine, nullptr, nullptr, nullptr,
            Q, N, d};
  DotPlan p{};
  const int err = dot_tile(a, p, nullptr, false);
  const int v[12] = {p.vec, p.nf, p.warps, p.group, p.groups, p.tiles,
                     p.panel, p.stages, p.smem, p.occupancy, p.grid_x, p.ks};
  std::copy(v, v + 12, out);
  return err;
}

// q: (Q, d), x: (N, d) float32, contiguous rows (any 4-byte aligned base).
// Outputs dist (Q, N) f32, mask (Q, N) u8, ids (Q, N) i32.
extern "C" int linear_scan_l1(const void* q, const void* x, float thresh,
                              void* dist, void* mask, void* ids, int Q, int N,
                              int d, void* stream) {
  if (Q <= 0 || N <= 0) return 0;
  L1Args a{static_cast<const float*>(q), static_cast<const float*>(x), thresh,
           static_cast<float*>(dist), static_cast<uint8_t*>(mask),
           static_cast<int32_t*>(ids), Q, N, d};
  L1Plan p{};
  return l1_tile(a, p, static_cast<cudaStream_t>(stream), true);
}

// q: (Q, d), x: (N, d) float32, contiguous rows.  Output dist (Q, N) f32.
extern "C" int pairwise_l1(const void* q, const void* x, void* dist, int Q,
                           int N, int d, void* stream) {
  if (Q <= 0 || N <= 0) return 0;
  L1Args a{static_cast<const float*>(q), static_cast<const float*>(x), 0.f,
           static_cast<float*>(dist), nullptr, nullptr, Q, N, d};
  L1Plan p{};
  return l1_tile(a, p, static_cast<cudaStream_t>(stream), true);
}

// The layout linear_scan_l1 / pairwise_l1 launch for these pointers and this
// shape, without launching: out[0..8] = copy width (floats), d-columns of the
// queries staged at once, ring stages, dynamic shared memory (bytes), query
// groups, row tiles, resident blocks an SM, blocks walking a group's tiles,
// 8-query sets a group (the first ones one more).  Returns a cudaError_t.
extern "C" int l1_tile_plan(const void* q, const void* x, int Q, int N, int d,
                            int* out) {
  if (Q <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  L1Args a{static_cast<const float*>(q), static_cast<const float*>(x), 0.f,
           nullptr, nullptr, nullptr, Q, N, d};
  L1Plan p{};
  const int err = l1_tile(a, p, nullptr, false);
  const int v[9] = {p.vec, p.panel, p.stages, p.smem, p.groups, p.tiles,
                    p.occupancy, p.walkers, p.sets};
  std::copy(v, v + 9, out);
  return err;
}

// The Hamming scan of a group of segments (K5): a points to HamArgs in host
// memory, copied into the launch's parameters (tile0 and tiles are set
// here).  q: (Q, W) and each segment's x: (n, W) packed 32-bit codes (int32
// bit views read as unsigned), contiguous, W >= 1; dist (Q, ld) f32, mask
// (Q, ld) u8, ids (Q, ld) i32, segment s in columns [col, col + n).
extern "C" int grouped_hamming_scan(const void* a, void* stream) {
  return hamming_scan(*static_cast<const HamArgs*>(a),
                      static_cast<cudaStream_t>(stream));
}

// What kernels/fused_scan.py's ctypes mirror of HamArgs is checked against.
extern "C" int grouped_hamming_args_bytes() { return sizeof(HamArgs); }

// The Hamming matrix (K8): q (Q, W), x (N, W) packed 32-bit codes (int32
// bit views read as unsigned), contiguous, W >= 1.  Output out (Q, N) int32.
extern "C" int hamming(const void* q, const void* x, void* out, int Q, int N,
                       int W, void* stream) {
  HamArgs a{};
  a.q = static_cast<const uint32_t*>(q);
  a.dist = out;
  a.ld = N;
  a.Q = Q;
  a.W = W;
  a.nseg = 1;
  a.seg[0].x = static_cast<const uint32_t*>(x);
  a.seg[0].n = N;
  return hamming_scan(a, static_cast<cudaStream_t>(stream));
}

// metric: 0 l2, 1 l1, 2 cosine on unit corpus rows (x, q float32), 3
// hamming (x, q int32 bit views of packed uint32 codes).  x: (n, d), q:
// (Q, d), cands: (Q, C) int32 in [0, n] (n the sentinel), any order,
// contiguous.  Outputs ids (Q, C)
// int32 (cands sorted), dist (Q, C) f32, mask (Q, C) u8.
extern "C" int lsh_scan(int metric, const void* x, const void* q,
                        const void* cands, float thresh, void* ids, void* dist,
                        void* mask, int Q, int C, int n, int d, void* stream) {
  if (Q <= 0 || C <= 0) return 0;
  if (n < 0 || d < 0) return static_cast<int>(cudaErrorInvalidValue);
  LshPlan p{};
  const int err = lsh_plan(x, Q, C, n, d, p);
  if (err) return err;
  const LshArgs a{x, q, static_cast<const int32_t*>(cands), thresh,
                  static_cast<int32_t*>(ids), static_cast<float*>(dist),
                  static_cast<uint8_t*>(mask), Q, C, n, d, p.width, p.dcap,
                  p.group};
  auto s = static_cast<cudaStream_t>(stream);
  switch (metric) {
    case kL2: return run_lsh_metric<kL2>(a, p, s);
    case kL1: return run_lsh_metric<kL1>(a, p, s);
    case kCosineUnit: return run_lsh_metric<kCosineUnit>(a, p, s);
    case kHamming: return run_lsh_metric<kHamming>(a, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The layout lsh_scan launches for this x and shape, without launching:
// out[0..5] = blocks a query (splits), ids a block owns (width), distinct
// ids a block holds at once, copy width of the gather (elements), lanes a
// row, dynamic shared memory (bytes).  Returns a cudaError_t.
extern "C" int lsh_scan_plan(const void* x, int Q, int C, int n, int d,
                             int* out) {
  LshPlan p{};
  const int err = lsh_plan(x, Q, C, n, d, p);
  const int v[6] = {p.splits, p.width, p.dcap, p.vec, p.group, p.smem};
  std::copy(v, v + 6, out);
  return err;
}
