// The delta's collision test: per query, over the rows the delta holds, which
// rows share a bucket with the query in at least one probed column, in one
// launch.
//
// Replaces no Pallas kernel.  The reference's delta (repro/streaming/delta.py
// collision_stats :141, search :158) compares the query buckets with every row
// of the fixed-capacity delta as a jnp chain, which XLA fused into one TPU
// kernel.  Run eagerly by PyTorch, the chain materialises a (Q, C + 1, V)
// bool tensor (168 MB at Q = 1,024, C = 8,192, V = 20) and reduces it three
// times; slots at or after the delta's count are never live, so that work
// reports nothing.  This kernel reads only the first n = count rows.
//
// For query q and row j < n, over the V probed columns v (column v probes
// table t_v = tidx[v], or v without multi-probe):
//   hit[q, j] = live[j] ? sum_v (qb[q, v] == rb[j, t_v]) : 0,
// and, chosen by the mode:
//   counts: collisions[q] = sum_j hit[q, j], distinct[q] = #{j : hit[q, j] > 0}
//           (int32, exact: repro_torch/streaming/delta.py collision_stats);
//   mask:   mask[q, j] = hit[q, j] > 0 (bool, (Q, n): the LSH route's
//           "collides in at least one probed column", live rows only).
//
// Bound on an H100: Q * n * V integer compares (168 M at 1,024 x 8,192 x 20)
// over Q * V + n * (L + 1) words read (0.7 MB), so the compares: about 0.01
// ms at two integer instructions a compare on the 132 SMs, against 0.0002 ms
// of bytes.  The design keeps every operand of a compare in shared memory:
// a block takes kQTile queries and kRowsPerBlock rows (grid: query tiles x
// row chunks, 1,024 blocks at that shape); its query buckets sit column-major
// ([V][kQTile]) so a column's kQTile buckets are two 16-byte broadcast loads;
// a tile of 256 rows is read coalesced and stored transposed ([L][257]), so
// thread t's bucket of any table is a conflict-free load whatever tidx maps
// it to.  A block sums its rows' counts with warp shuffles and shared
// memory; a single row chunk stores them, more add them with integer
// atomicAdd into zeroed outputs: exact, in any order.  Measured (PERF.md
// §6, DC): 0.056 ms on the card for the counts at that shape (0.121 ms at
// V = 80), against 2.85 ms for the chain over all 8,193 slots.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;          // a row tile: one row a thread
constexpr int kWarps = kThreads / 32;
constexpr int kQTile = 8;              // queries a block
constexpr int kRowsPerBlock = 1024;    // rows a block: 4 row tiles
constexpr int kStride = kThreads + 1;  // a table's column of the row tile

enum Mode { kCounts = 0, kMask = 1 };
static_assert(kQTile == 8, "the compare loop unrolls eight queries");

// qb: (Q, V) int32; rb: (n, L) int32; live: (n,); tidx: (V,) or null.
// counts: coll, dist (Q,) int32, zeroed when gridDim.y > 1; mask: (Q, n).
template <int M>
__global__ void __launch_bounds__(kThreads)
delta_collide_kernel(const int32_t* __restrict__ qb,
                     const int32_t* __restrict__ rb,
                     const bool* __restrict__ live,
                     const int32_t* __restrict__ tidx, int Q, int n, int V,
                     int L, int32_t* __restrict__ coll,
                     int32_t* __restrict__ dist, bool* __restrict__ mask) {
  extern __shared__ int4 smem4[];
  int32_t* qs = reinterpret_cast<int32_t*>(smem4);  // [V][kQTile]
  int32_t* ts = qs + V * kQTile;                    // [V] column -> table
  int32_t* rs = ts + V;                             // [L][kStride] row tile
  const int t = threadIdx.x;
  const int q0 = blockIdx.x * kQTile;
  const int nq = min(kQTile, Q - q0);
  for (int i = t; i < V * kQTile; i += kThreads) {
    const int v = i / kQTile, k = i % kQTile;
    qs[i] = k < nq ? qb[static_cast<int64_t>(q0 + k) * V + v] : 0;
  }
  for (int v = t; v < V; v += kThreads) ts[v] = tidx ? tidx[v] : v;
  // thread t's first (row, table) of a tile's coalesced load, and how far
  // kThreads elements move it: no division inside the loop
  const int row0 = t / L, l0 = t % L;
  const int drow = kThreads / L, dl = kThreads % L;

  int c_acc[kQTile] = {}, d_acc[kQTile] = {};
  const int r0 = blockIdx.y * kRowsPerBlock;
  const int r1 = min(n, r0 + kRowsPerBlock);
  for (int j0 = r0; j0 < r1; j0 += kThreads) {
    const int rows = min(kThreads, r1 - j0);
    __syncthreads();   // qs and ts written; the last tile read
    const int32_t* src = rb + static_cast<int64_t>(j0) * L;
    for (int i = t, r = row0, l = l0; i < rows * L; i += kThreads) {
      rs[l * kStride + r] = src[i];
      r += drow;
      l += dl;
      if (l >= L) {
        l -= L;
        ++r;
      }
    }
    __syncthreads();
    int hit[kQTile] = {};
    if (t < rows && live[j0 + t]) {
      for (int v = 0; v < V; ++v) {
        const int32_t b = rs[ts[v] * kStride + t];
        const int4 lo = reinterpret_cast<const int4*>(qs)[2 * v];
        const int4 hi = reinterpret_cast<const int4*>(qs)[2 * v + 1];
        hit[0] += lo.x == b; hit[1] += lo.y == b;
        hit[2] += lo.z == b; hit[3] += lo.w == b;
        hit[4] += hi.x == b; hit[5] += hi.y == b;
        hit[6] += hi.z == b; hit[7] += hi.w == b;
      }
    }
    if constexpr (M == kMask) {
      if (t < rows) {
#pragma unroll
        for (int k = 0; k < kQTile; ++k)
          if (k < nq) mask[static_cast<int64_t>(q0 + k) * n + j0 + t] = hit[k] > 0;
      }
    } else {
#pragma unroll
      for (int k = 0; k < kQTile; ++k) {
        c_acc[k] += hit[k];
        d_acc[k] += hit[k] > 0;
      }
    }
  }
  if constexpr (M == kCounts) {
    __shared__ int part[2][kQTile][kWarps];
    const int lane = t % 32, warp = t / 32;
#pragma unroll
    for (int k = 0; k < kQTile; ++k) {
      int c = c_acc[k], d = d_acc[k];
      for (int off = 16; off > 0; off /= 2) {
        c += __shfl_down_sync(0xffffffffu, c, off);
        d += __shfl_down_sync(0xffffffffu, d, off);
      }
      if (lane == 0) {
        part[0][k][warp] = c;
        part[1][k][warp] = d;
      }
    }
    __syncthreads();
    if (t < 2 * kQTile) {
      const int which = t / kQTile, k = t % kQTile;
      if (k < nq) {
        int sum = 0;
        for (int w = 0; w < kWarps; ++w) sum += part[which][k][w];
        int32_t* out = (which == 0 ? coll : dist) + q0 + k;
        if (gridDim.y == 1) *out = sum;
        else if (sum) atomicAdd(out, sum);
      }
    }
  }
}

// Launch mode M, asking for more than 48 KB of shared memory where it needs it.
template <int M>
cudaError_t run(dim3 grid, size_t smem, cudaStream_t s, const int32_t* qb,
                const int32_t* rb, const bool* live, const int32_t* tidx, int Q,
                int n, int V, int L, int32_t* coll, int32_t* dist, bool* mask) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        delta_collide_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  delta_collide_kernel<M><<<grid, kThreads, smem, s>>>(
      qb, rb, live, tidx, Q, n, V, L, coll, dist, mask);
  return cudaGetLastError();
}

}  // namespace

// mode: 0 counts (coll, dist), 1 mask.  qb (Q, V), rb (n, L), live (n,),
// tidx (V,) or null.  With more than kRowsPerBlock rows, the counts add into
// coll and dist, which the caller zeroes.
extern "C" int delta_collide(int mode, const void* qb, const void* rb,
                             const void* live, const void* tidx, int Q, int n,
                             int V, int L, void* coll, void* dist, void* mask,
                             void* stream) {
  if (Q <= 0 || n <= 0) return 0;
  if (V <= 0 || L <= 0 || (n + kRowsPerBlock - 1) / kRowsPerBlock > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(int32_t) *
      (static_cast<size_t>(V) * (kQTile + 1) + static_cast<size_t>(L) * kStride);
  const dim3 grid((Q + kQTile - 1) / kQTile,
                  (n + kRowsPerBlock - 1) / kRowsPerBlock);
  if (mode != kCounts && mode != kMask)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* run_mode = mode == kCounts ? run<kCounts> : run<kMask>;
  return static_cast<int>(run_mode(
      grid, smem, static_cast<cudaStream_t>(stream),
      static_cast<const int32_t*>(qb), static_cast<const int32_t*>(rb),
      static_cast<const bool*>(live), static_cast<const int32_t*>(tidx), Q, n,
      V, L, static_cast<int32_t*>(coll), static_cast<int32_t*>(dist),
      static_cast<bool*>(mask)));
}
