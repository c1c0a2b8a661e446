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
//  * The corpus streams through a cp.async ring of 32-column chunks (rows
//    padded by 4 words), 3 or 4 stages as shared memory allows, so the
//    next chunks' loads overlap this chunk's MMAs.  The copy width is
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
//    epilogue.  Small problems take fewer warps a block (down to 2), then
//    smaller groups (down to 8 queries), until there are at least as many
//    blocks as SMs (calibrate's 64 x 4,096: 128 tiles of 32 rows x 2
//    groups of 32 queries).
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
// Bound on an H100 SXM: device memory for one chunk at the CoverType shape
// (Q = 32 queries, N = 524,288, d = 54: x read once, 113.2 MB, and 9 B a
// pair written, 151.0 MB: 0.079 ms at 3.35 TB/s, against 2.7 G operations,
// a subtract, an absolute value and an add per term, 0.041 ms at
// 67 TFLOP/s); operations for pairwise_l1 at Q = 100 (N = 580,912:
// 9.41 G operations, 0.140 ms, against 358 MB).  The sum has no matmul
// form, so it runs on the CUDA cores.
// Design: a block owns 32 queries x 128 corpus rows; q and x go through
// shared memory in d-chunks of 32 (rows padded by one word so neither the
// transposing stores nor the reads conflict on banks); each of the 256
// threads keeps a 4 x 4 register tile of sums.  A d that is not a multiple
// of the chunk (54, 37) is masked on load: the tail loads zeros on both
// sides, which add |0 - 0| = 0.  The blocks of one row tile are numbered
// consecutively (query block fastest), so they run together and the corpus
// tile they share is read from device memory about once.
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
#include <algorithm>
#include <cstdint>
#include <mutex>
#include <cuda_runtime.h>

namespace {

// ---- the dot-form tile (linear_scan_dot, pairwise_dot) --------------------

constexpr int kDotBK = 32;              // d-columns of a ring stage
constexpr int kDotXS = kDotBK + 4;      // words per corpus row in a stage
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
  int tiles;             // row tiles of 16 rows a warp
  int stages;            // depth of the ring
};

// How a call is laid out on the card (dot_plan, run_dot).
struct DotPlan {
  int vec, nf, warps, group, groups, tiles, panel, stages, smem, occupancy,
      grid_x;
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
// a warp computes: the group's 8 NF queries, the rows past Q zeros.  Grid:
// (walkers, groups); block: 2-8 warps of 16 rows.
template <int VEC, int NF>
__global__ void __launch_bounds__(256, NF <= 4 ? 2 : 1)
dot_tile_kernel(const DotArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;          // fragment row, query within 8
  const int t = tid & 3;                  // fragment k within 4
  const int bm = blockDim.x / 2;          // 16 rows a warp
  const int q0 = blockIdx.y * a.group;
  const int nq = min(a.group, a.Q - q0);  // real queries of the group
  const int chunks = ceil_div(max(a.d, 1), kDotBK);   // ring steps a tile
  const int per_panel = a.panel / kDotBK;
  const int qstride = a.panel + 4;
  float* qs = smem;                                   // [8 NF][qstride]
  float* ring = qs + 8 * NF * qstride;                // [stages][bm][kDotXS]
  float* epi = ring + a.stages * bm * kDotXS;        // [min(8 NF, 32)][bm + 4]
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
      const int k0 = (s % chunks) * kDotBK;
      float* dst = ring + (s % a.stages) * bm * kDotXS;
      constexpr int per_row = kDotBK / VEC;
#pragma unroll
      for (int j = 0; j < kDotBK / (2 * VEC); ++j) {   // bm per_row / blockDim
        const int i = tid + j * blockDim.x;
        const int r = i / per_row;
        const int k = (i % per_row) * VEC;
        const bool ok = n0 + r < a.N && k0 + k < a.d;
        cp_async<VEC>(dst + r * kDotXS + k,
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

    const float* xa = ring + (s % a.stages) * bm * kDotXS
                      + (warp * 16 + g) * kDotXS + t;     // fragment row g
    const float* xb = xa + 8 * kDotXS;                     // and g + 8
    const float* qb = qs + g * qstride + (c % per_panel) * kDotBK + t;
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

    // The tile's epilogue, 32 queries at a time through epi.  A thread
    // finishes the same 4 rows (gn..gn+3) in every pass, 8 queries apart.
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
        float* e = epi + (8 * (f - f0) + 2 * t) * (bm + 4) + warp * 16 + g;
        e[0] = acc[f][0];                 // (row g,     query 2t)
        e[bm + 4] = acc[f][1];            // (row g,     query 2t + 1)
        e[8] = acc[f][2];                 // (row g + 8, query 2t)
        e[bm + 4 + 8] = acc[f][3];        // (row g + 8, query 2t + 1)
      }
      __syncthreads();
      const int eq = min(kDotEpiQ, nq - 8 * f0);
      for (int ql = tid / quads; in[0] && ql < eq; ql += 8) {
        const int gq = q0 + 8 * f0 + ql;
        const float4 e4 = *reinterpret_cast<const float4*>(epi + ql * (bm + 4) + gn - n0);
        float v[4] = {e4.x, e4.y, e4.z, e4.w};
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
  int sms = 0, optin = 0;
};

DeviceInfo read_device_info(int dev) {
  DeviceInfo info;
  cudaDeviceGetAttribute(&info.sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&info.optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
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
// that gives at least a block per SM, else fewer warps (down to 2), then
// smaller groups (down to 8 queries); the queries' d-panel as wide as the
// block's shared memory allows with a 3-stage ring, and a fourth stage where
// the rest allows.  Returns a cudaError_t.
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
  for (;;) {
    const int bm = 16 * p.warps;
    const int stage = 4 * bm * kDotXS;
    const int epi = 4 * std::min(8 * p.nf, kDotEpiQ) * (bm + 4);
    const int cols = (optin - epi - kDotMinStages * stage) / (32 * p.nf) - 4;
    p.panel = std::min(dp, cols / kDotBK * kDotBK);
    if (p.panel >= kDotBK) {            // the rest of shared memory: the ring
      const int qs = 32 * p.nf * (p.panel + 4);
      p.stages = std::min(kDotMaxStages, (optin - epi - qs) / stage);
      p.smem = qs + epi + p.stages * stage;
      break;
    }
    if (p.nf == 1) return static_cast<int>(cudaErrorInvalidValue);
    p.nf /= 2;
  }
  p.group = 8 * p.nf;
  p.groups = ceil_div(Q, p.group);
  p.tiles = ceil_div(N, 16 * p.warps);
  return p.groups > 65535 ? static_cast<int>(cudaErrorInvalidValue) : 0;
}

// The grid: blocks a group = min(tiles, SMs x resident blocks an SM /
// groups).  Launches if `launch`; fills p.occupancy and p.grid_x either way.
// The resident-block count of the last (warps, shared memory) is kept.
template <int VEC, int NF>
int run_dot(const DotArgs& a, DotPlan& p, cudaStream_t s, bool launch) {
  auto kernel = dot_tile_kernel<VEC, NF>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, device_info().optin);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  static std::mutex mu;
  static int last_warps = 0, last_smem = 0, last_occupancy = 0;
  {
    std::lock_guard<std::mutex> lock(mu);
    if (p.warps != last_warps || p.smem != last_smem) {
      const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &last_occupancy, kernel, 32 * p.warps, p.smem);
      if (e != cudaSuccess) return static_cast<int>(e);
      last_warps = p.warps;
      last_smem = p.smem;
    }
    p.occupancy = last_occupancy;
  }
  if (p.occupancy < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int walkers = device_info().sms * p.occupancy / p.groups;
  p.grid_x = std::min(p.tiles, std::max(1, walkers));
  if (!launch) return 0;
  kernel<<<dim3(p.grid_x, p.groups), 32 * p.warps, p.smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int VEC>
int run_dot_vec(const DotArgs& a, DotPlan& p, cudaStream_t s, bool launch) {
  switch (p.nf) {
    case 1: return run_dot<VEC, 1>(a, p, s, launch);
    case 2: return run_dot<VEC, 2>(a, p, s, launch);
    case 4: return run_dot<VEC, 4>(a, p, s, launch);
    case 8: return run_dot<VEC, 8>(a, p, s, launch);
    default: return run_dot<VEC, 16>(a, p, s, launch);
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

constexpr int kBQ = 32;    // queries per block
constexpr int kBN = 128;   // corpus rows per block
constexpr int kBK = 32;    // d-chunk staged per step
constexpr int kThreads = 256;

// Blocks of the L1 tile kernel for a (Q, N) output: one per 32 queries x 128
// rows, on a 1-D grid.  0 if the count does not fit a launch.
unsigned tile_blocks(int Q, int N) {
  const int64_t b = static_cast<int64_t>((N + kBN - 1) / kBN) * ((Q + kBQ - 1) / kBQ);
  return b > 0x7fffffff ? 0u : static_cast<unsigned>(b);
}

// DIST_ONLY: write the distances only (pairwise_l1); mask and ids are
// then null and unwritten.
template <bool DIST_ONLY>
__global__ void __launch_bounds__(kThreads)
l1_tile_kernel(const float* __restrict__ q, const float* __restrict__ x,
               float thresh, float* __restrict__ dist,
               uint8_t* __restrict__ mask, int32_t* __restrict__ ids, int Q,
               int N, int d) {
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
        for (int j = 0; j < 4; ++j) acc[i][j] += fabsf(a[i] - b[j]);
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
      const float v = acc[i][j];
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
// this shape, without launching: out[0..10] = copy width (floats),
// n-fragments a warp, warps a block, queries a group, groups, row tiles,
// d-columns of the queries staged at once, ring stages, dynamic shared
// memory (bytes), resident blocks an SM, blocks a group.  Returns a
// cudaError_t.
extern "C" int dot_tile_plan(const void* q, const void* x, int Q, int N,
                             int d, int* out) {
  if (Q <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  DotArgs a{static_cast<const float*>(q), static_cast<const float*>(x),
            nullptr, nullptr, 0.f, kDotCosine, nullptr, nullptr, nullptr,
            Q, N, d};
  DotPlan p{};
  const int err = dot_tile(a, p, nullptr, false);
  const int v[11] = {p.vec, p.nf, p.warps, p.group, p.groups, p.tiles,
                     p.panel, p.stages, p.smem, p.occupancy, p.grid_x};
  std::copy(v, v + 11, out);
  return err;
}

// q: (Q, d), x: (N, d) float32, contiguous.  Outputs dist (Q, N) f32,
// mask (Q, N) u8, ids (Q, N) i32.
extern "C" int linear_scan_l1(const void* q, const void* x, float thresh,
                              void* dist, void* mask, void* ids, int Q, int N,
                              int d, void* stream) {
  if (Q <= 0 || N <= 0) return 0;
  const unsigned grid = tile_blocks(Q, N);
  if (grid == 0) return static_cast<int>(cudaErrorInvalidValue);
  l1_tile_kernel<false><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(x), thresh,
      static_cast<float*>(dist), static_cast<uint8_t*>(mask),
      static_cast<int32_t*>(ids), Q, N, d);
  return static_cast<int>(cudaGetLastError());
}

// q: (Q, d), x: (N, d) float32, contiguous.  Output dist (Q, N) f32.
extern "C" int pairwise_l1(const void* q, const void* x, void* dist, int Q,
                           int N, int d, void* stream) {
  if (Q <= 0 || N <= 0) return 0;
  const unsigned grid = tile_blocks(Q, N);
  if (grid == 0) return static_cast<int>(cudaErrorInvalidValue);
  l1_tile_kernel<true><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(x), 0.f,
      static_cast<float*>(dist), nullptr, nullptr, Q, N, d);
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
