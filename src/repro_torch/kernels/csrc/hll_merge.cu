// The route estimate: per query and per frozen segment, the exact bucket
// collisions and the HLL candSize estimate, summed over the segments in one
// launch (one block per query).
//
// Replaces: repro/kernels/hll_merge.py, hll_merge_estimate_pallas (:43,
// body _kernel): per query, max-merge the uint8 registers of the hit
// buckets, then the HLL estimator with the small-range (linear counting)
// and large-range (2^32) corrections, in float32.  The reference runs it
// once per segment, beside the bucket-size gathers, the tombstone gathers
// and the sums of repro/core/engine.py (TableSegment.estimate_terms,
// finalize_route); this kernel does all of that for every frozen segment
// of a batch at once, and never materialises the (Q, V, m) gathered
// registers.
//
// Per query q and segment s, over the V probed columns j (column j probes
// table t_j = tidx[j], or j; bucket b_j = qb[q, j]):
//   collisions_s = sum_j (starts[t_j, b_j + 1] - starts[t_j, b_j]) - dead_s,
//   dead_s       = sum_j tomb[t_j, b_j]                 (0 without tombstones)
//   est_s        = HLL estimate of max_j registers[t_j, b_j, :]
//   est_s        = max(est_s - dead_s, 0)               (with tombstones only)
// and cand = ((0 + est_0) + est_1) + ... in segment order, so the float32 sum
// is bit for bit what finalize_route adds one segment at a time.  The
// estimate of one segment is the expression of the per-segment kernel this
// one replaced: thread t of the segment's group of max(32, m) threads owns
// register t and takes its max over the columns, the group reduces
// sum(2^-R) and the zero count with warp shuffles and then its warps'
// partials in order, and its thread 0 applies the estimator as
// repro/core/hll.py estimate_cardinality does.
//
// ops.hll_merge_estimate(regs) is the one-segment case: (Q, L, m) registers
// as a table whose row stride is m and whose bucket stride is L * m, with
// bucket = query and no collisions.
//
// The terms mode (route_estimate_kernel<true>, ops.route_terms) stops before
// the estimate: it writes, for each segment k of the launch, collisions_k and
// dead_k (int32, (K, Q)) and the merged registers max_j registers[t_j, b_j, :]
// (uint8, (K, Q, m)).  A row-sharded index (repro_torch/core/distributed.py,
// repro_torch/streaming/sharded.py) sums the counts and max-merges the
// registers of each level across its shards before it estimates, as the
// reference's psum / pmax of TableSegment.estimate_terms and merge_registers
// do (repro/streaming/sharded.py:1044-1056, repro/core/distributed.py:118-125).
// Everything else is the estimate mode's: the gathers, the loads in flight,
// the groups and the segment table.  Its bytes add the outputs, Q * K * (m + 8).
//
// Bound on an H100: the bytes are Q * S * V * (m + 12) (the registers, two
// starts and a dead count per column; 100 x 4 x 20 x 76 B = 608 KB on the
// churned MNIST index), about 0.2 us at 3.35 TB/s, so launch latency
// bounds it, and then the latency of the dependent loads: V random
// buckets a segment, cold in L2.  The design is therefore about launches
// and latency: the segment table travels by value in the kernel's
// parameters (__grid_constant__, no copy to the device per batch); the
// segments of a query run side by side in groups of warps, each thread
// with 16 of its V register loads in flight; a stack of more than kRouteMaxSegs
// segments takes more launches of this kernel, each continuing the sums of
// the one before (accumulate).  Measured (PERF.md): 0.010-0.016 ms on the
// card for 100 queries over 4 segments, against 0.019 with the segments
// one after another and 0.018 with one load in flight.
#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxWarps = 32;       // m <= 1024
constexpr int kRouteMaxSegs = 64;   // segments a launch; 3 KB of parameters

struct RouteSeg {
  const int32_t* starts;   // (L, B + 1) CSR bucket offsets, or null: no collisions
  const uint8_t* regs;     // register t of bucket b in table l at l * tstride + b * bstride + t
  const int32_t* tomb;     // (L, B) dead counts, or null (a static segment)
  int64_t tstride;
  int64_t bstride;
  int B;
};

struct RouteArgs {
  const int32_t* qb;       // (Q, V) probed buckets, or null: bucket = query
  const int32_t* tidx;     // (V,) column -> table, or null: column j is table j
  int32_t* coll;           // (Q,) out, or null; terms mode: (K, Q) out
  float* cand;             // (Q,) out; unused in terms mode
  int32_t* dead;           // terms mode: (K, Q) out, the dead counts
  uint8_t* regs;           // terms mode: (K, Q, m) out, the merged registers
  int Q, V, m, nseg;
  float coef;              // float32(alpha(m) * m * m)
  int accumulate;          // continue the sums already in coll / cand
  RouteSeg seg[kRouteMaxSegs];
};

// Per block (one query): the probed columns' buckets and tables staged in
// shared memory once; then groups of G = max(32, m) threads, one segment a
// group at a time (S / groups rounds), each thread of a group the max of
// register t over the V columns (loaded kRouteBatch at a time, all in
// flight together) and a share of the columns' bucket sizes and
// dead counts; the group's sums as the per-segment kernel took them (warp
// shuffles, then its warps' partials in order); the estimates and
// collisions kept in shared memory and added in segment order at the end.
constexpr int kRouteBatch = 16;   // register loads a thread has in flight

// TERMS: write each segment's collisions, dead counts and merged registers
// and stop there (see the head of this file).
template <bool TERMS>
__global__ void __launch_bounds__(1024)
route_estimate_kernel(const __grid_constant__ RouteArgs a) {
  extern __shared__ int32_t cols[];   // (2, V): bucket, table of each column
  __shared__ float ss[kMaxWarps];
  __shared__ float zs[kMaxWarps];
  __shared__ int cs[kMaxWarps];
  __shared__ int ds[kMaxWarps];
  __shared__ float est_s[kRouteMaxSegs];
  __shared__ int coll_s[kRouteMaxSegs];
  const int q = blockIdx.x;
  const int t = threadIdx.x;
  const int G = a.m < 32 ? 32 : a.m;    // threads a group
  const int groups = blockDim.x / G;
  const int grp = t / G;
  const int lt = t - grp * G;            // thread within the group
  const int warp = t >> 5;
  const int lane = t & 31;
  int32_t* cb = cols;
  int32_t* cl = cols + a.V;
  for (int j = t; j < a.V; j += blockDim.x) {
    cb[j] = a.qb ? a.qb[static_cast<int64_t>(q) * a.V + j] : q;
    cl[j] = a.tidx ? a.tidx[j] : j;
  }
  __syncthreads();
  for (int s0 = 0; s0 < a.nseg; s0 += groups) {
    const int si = s0 + grp;
    const bool on = si < a.nseg;
    const RouteSeg& g = a.seg[on ? si : 0];
    int c = 0;
    int d = 0;
    if (on && g.starts) {
      for (int j = lt; j < a.V; j += G) {
        const int32_t* st = g.starts + static_cast<int64_t>(cl[j]) * (g.B + 1) + cb[j];
        c += st[1] - st[0];
        if (g.tomb) d += g.tomb[static_cast<int64_t>(cl[j]) * g.B + cb[j]];
      }
    }
    float s = 0.f;
    float z = 0.f;
    if (on && lt < a.m) {
      const uint8_t* base = g.regs + lt;
      int r = 0;
      for (int j0 = 0; j0 < a.V; j0 += kRouteBatch) {
        uint8_t v[kRouteBatch];
#pragma unroll
        for (int u = 0; u < kRouteBatch; ++u) {
          const int j = j0 + u;
          v[u] = j < a.V ? base[cl[j] * g.tstride +
                                static_cast<int64_t>(cb[j]) * g.bstride] : 0;
        }
#pragma unroll
        for (int u = 0; u < kRouteBatch; ++u) r = max(r, static_cast<int>(v[u]));
      }
      if constexpr (TERMS) {
        a.regs[(static_cast<int64_t>(si) * a.Q + q) * a.m + lt] = static_cast<uint8_t>(r);
      } else {
        s = ldexpf(1.f, -r);        // exact 2^-r
        z = (r == 0) ? 1.f : 0.f;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      if constexpr (!TERMS) {
        s += __shfl_xor_sync(0xffffffffu, s, off);
        z += __shfl_xor_sync(0xffffffffu, z, off);
      }
      c += __shfl_xor_sync(0xffffffffu, c, off);
      d += __shfl_xor_sync(0xffffffffu, d, off);
    }
    if (lane == 0) {
      ss[warp] = s;
      zs[warp] = z;
      cs[warp] = c;
      ds[warp] = d;
    }
    __syncthreads();
    if (on && lt == 0) {
      float sum = 0.f;
      float zeros = 0.f;
      int hits = 0;
      int dead = 0;
      for (int w = warp; w < warp + (G >> 5); ++w) {
        sum += ss[w];
        zeros += zs[w];
        hits += cs[w];
        dead += ds[w];
      }
      if constexpr (TERMS) {
        const int64_t o = static_cast<int64_t>(si) * a.Q + q;
        a.coll[o] = hits - dead;
        a.dead[o] = dead;
      } else {
        const float mf = static_cast<float>(a.m);
        const float raw = a.coef / sum;                   // alpha * m^2 / sum
        float est = raw;
        if (raw <= 2.5f * mf && zeros > 0.f) {
          est = mf * logf(mf / fmaxf(zeros, 1e-9f));     // linear counting
        }
        const float two32 = 4294967296.f;
        if (est > two32 / 30.f) est = -two32 * log1pf(-est / two32);
        if (g.tomb) est = fmaxf(est - static_cast<float>(dead), 0.f);
        est_s[si] = est;
        coll_s[si] = hits - dead;
      }
    }
    __syncthreads();   // the next round reuses the warps' partials
  }
  if (!TERMS && t == 0) {
    float cand = 0.f;
    int coll = 0;
    if (a.accumulate) {
      cand = a.cand[q];
      if (a.coll) coll = a.coll[q];
    }
    for (int si = 0; si < a.nseg; ++si) {
      cand += est_s[si];
      coll += coll_s[si];
    }
    a.cand[q] = cand;
    if (a.coll) a.coll[q] = coll;
  }
}

template <bool TERMS>
int launch(const RouteArgs& a, cudaStream_t s) {
  if (a.Q <= 0 || a.nseg <= 0) return 0;
  if (a.nseg > kRouteMaxSegs || a.m <= 0 || a.m > 1024 || (a.m & (a.m - 1)) ||
      a.V < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int group = a.m < 32 ? 32 : a.m;
  const int threads = group * std::min(a.nseg, 1024 / group);
  const size_t smem = 2 * sizeof(int32_t) * static_cast<size_t>(a.V);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  route_estimate_kernel<TERMS><<<a.Q, threads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// What kernels/hll_merge.py's ctypes mirror of RouteArgs is checked against.
extern "C" int route_estimate_args_bytes() { return sizeof(RouteArgs); }

// a: the arguments in host memory, copied into the launch's parameters.
extern "C" int route_estimate(const void* a, void* stream) {
  return launch<false>(*static_cast<const RouteArgs*>(a),
                       static_cast<cudaStream_t>(stream));
}

// The terms mode: a as route_estimate's, with coll, dead and regs the
// (K, Q), (K, Q) and (K, Q, m) outputs of the launch's K = nseg segments.
extern "C" int route_terms(const void* a, void* stream) {
  return launch<true>(*static_cast<const RouteArgs*>(a),
                      static_cast<cudaStream_t>(stream));
}

// regs: (Q, L, m) uint8, contiguous; out: (Q,) float32.  m is a power of
// two <= 1024; coef = float32(alpha(m) * m * m).
extern "C" int hll_merge_estimate(const void* regs, void* out, int Q, int L,
                                  int m, float coef, void* stream) {
  RouteArgs a{};
  a.cand = static_cast<float*>(out);
  a.Q = Q;
  a.V = L;
  a.m = m;
  a.nseg = 1;
  a.coef = coef;
  a.seg[0].regs = static_cast<const uint8_t*>(regs);
  a.seg[0].tstride = m;
  a.seg[0].bstride = static_cast<int64_t>(L) * m;
  return launch<false>(a, static_cast<cudaStream_t>(stream));
}
