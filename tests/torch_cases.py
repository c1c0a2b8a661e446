"""Inputs shared by the port's kernel tests (numpy and torch only, so the
GPU tests run where JAX is not installed)."""
import numpy as np
import torch

RADII = {"l2": 7.0, "l1": 55.0, "cosine": 0.9, "hamming": 300.0}
TOL = dict(rtol=3e-4, atol=3e-4)   # distances: sums in different orders


def pair(metric, q, n, rng):
    """numpy (queries, corpus): float32 rows, or uint32 packed codes."""
    if metric == "hamming":
        return (rng.integers(0, 2**32, (q, 3), dtype=np.uint32),
                rng.integers(0, 2**32, (n, 3), dtype=np.uint32))
    return (rng.normal(size=(q, 37)).astype(np.float32),
            rng.normal(size=(n, 37)).astype(np.float32))


def as_tensor(a):
    """numpy -> CPU tensor (uint32 codes as int64 holding the values)."""
    return torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32 else a)


def handcrafted_ids(n):
    """Sorted candidates: duplicate runs, a sentinel tail, an empty row."""
    sent = n
    ids = np.array([
        [0, 0, 0, 1, 2, 2, 5, sent],
        [3, 7, 7, 9, sent, sent, sent, sent],
        [sent] * 8,
    ], np.int32)
    return np.sort(ids, axis=-1)


def hll_regs(q, L, m, kind, rng):
    """uint8 registers: random, small-range (mostly empty) or large-range
    (the 2^32 correction)."""
    if kind == "random":
        return rng.integers(0, 25, (q, L, m)).astype(np.uint8)
    if kind == "small":
        r = np.zeros((q, L, m), np.uint8)
        r[:, 0, : m // 8] = 2
        return r
    lo = 29 - int(np.log2(m))
    return rng.integers(lo, lo + 2, (q, L, m)).astype(np.uint8)


def simhash_flips(a, b, x, r_padded):
    """Count the bits where the packed fingerprints ``a`` and ``b``
    ((N, L, words)) differ; raise unless every such bit's float64
    projection lies near 0 (``ref.simhash_bits_differing``)."""
    from repro_torch.kernels.ref import simhash_bits_differing
    differ, far = simhash_bits_differing(a, b, x, r_padded)
    assert far == 0, f"{far} bits differ away from 0"
    return differ


# (Q, N, d, view) for the dot-form tile (K1, K6): Q across n-fragments and
# query groups, N = 1 and ragged row tiles, d through each copy width (4 B:
# 1, 3, 37; 8 B: 54, 254; 16 B: 32, 256) and a ragged d-chunk, queries
# staged in two d-panels (65 x 16,897 x 384: 128 query rows of 388 words
# do not fit beside the ring), the corpus as x[1:] of an odd-d corpus
# ("rows") or 4 bytes into its buffer ("flat").
DOT_CASES = [(1, 1, 1, None), (8, 100, 37, None), (25, 129, 3, None),
             (32, 1000, 32, None), (33, 257, 256, None), (100, 333, 54, None),
             (129, 515, 254, None), (1, 300, 254, None), (100, 1, 32, None),
             (7, 300, 1, None), (129, 64, 3, None), (32, 4097, 254, None),
             (65, 16897, 384, None), (33, 257, 37, "rows"),
             (32, 300, 32, "flat"), (25, 129, 54, "flat"),
             # 4 row warps a block on an H100, split 2 ways along d
             (32, 12000, 254, None),
             # the retrieval service's width (Yi-6B's d_model), and odd:
             # 2 row warps split 4 ways, the queries staged in d-panels
             (64, 8192, 4096, None), (64, 8192, 4095, None)]
THRESH_EPS = 1e-5      # reported sets may differ within this of t (relative)


def dot_inputs(metric, q, n, d, rng):
    """float32 (q, d) queries and (n, d) rows: query 0 and the last row
    all zero (where there are two), rows 0-7 placed within 1e-4 of the
    threshold t of the last query.  Returns (queries, rows, t); t is the
    raw threshold (r for cosine, r^2 for l2)."""
    qa = rng.normal(size=(q, d)).astype(np.float32)
    xa = rng.normal(size=(n, d)).astype(np.float32)
    t = 0.9 if metric == "cosine" else 2.0 * d
    if q > 1:
        qa[0] = 0.0
    xa[-1] = 0.0
    u = qa[-1].astype(np.float64)
    for i in range(min(8, n - 1) if metric == "l2" or d > 1 else 0):
        w = rng.normal(size=d)
        dt = rng.uniform(-1e-4, 1e-4)
        if metric == "cosine":      # at angle arccos(1 - t - dt) from u
            un = u / np.linalg.norm(u)
            w -= (w @ un) * un
            c = 1.0 - t - dt
            xa[i] = (c * un + np.sqrt(1 - c * c) * w / np.linalg.norm(w)) \
                * rng.uniform(0.5, 2.0)
        else:                       # at distance sqrt(t + dt) from u
            xa[i] = u + np.sqrt(t + dt) * w / np.linalg.norm(w)
    return qa, xa, t


def unit_rows_np(a):
    """float32 rows scaled to unit norm (norms clamped at 1e-12)."""
    return (a / np.maximum(np.linalg.norm(a, axis=1, keepdims=True),
                           1e-12)).astype(np.float32)


def on_device(a, view, device):
    """numpy ``a`` on ``device``: as it is, as x[1:] of one more row
    ("rows"), or starting 4 bytes into its buffer ("flat")."""
    if view == "rows":
        a = np.concatenate([np.zeros((1, a.shape[1]), np.float32), a])
        return torch.from_numpy(a).to(device)[1:]
    if view == "flat":
        buf = np.zeros(a.size + 1, np.float32)
        buf[1:] = a.ravel()
        return torch.from_numpy(buf).to(device)[1:].view(a.shape)
    return torch.from_numpy(a).to(device)


def dist64(metric, q, x):
    """(Q, N) float64 distances: squared l2, l1, cosine (norms clamped),
    or Hamming of uint32 codes."""
    if metric == "hamming":
        xor = (q[:, None, :] ^ x[None, :, :]).astype(np.uint32)
        return np.unpackbits(xor.view(np.uint8), axis=-1).sum(-1).astype(np.float64)
    q, x = q.astype(np.float64), x.astype(np.float64)
    if metric == "l1":
        return np.abs(q[:, None, :] - x[None, :, :]).sum(-1)
    if metric == "l2":
        return np.maximum((q * q).sum(1)[:, None] + (x * x).sum(1)[None, :]
                          - 2.0 * q @ x.T, 0.0)
    qn = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
    xn = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
    return 1.0 - qn @ xn.T


def masks_outside_band_agree(mask, mask_plain, d64, t):
    """Report masks may differ from the plain version's, and from the
    float64 distance's, only within THRESH_EPS * max(1, |t|) of t."""
    near = np.abs(d64 - t) <= THRESH_EPS * max(1.0, abs(t))
    assert not ((mask != mask_plain) & ~near).any(), "masks differ off t"
    assert not ((mask != (d64 <= t)) & ~near).any(), "masks wrong off t"


# The L1 tile (K4 linear_scan_l1, K7 pairwise_l1): (Q, N, d, view).  Q across
# warps and query groups (a last group of 1, 4 or 8 queries), ragged row
# tiles (N = 129, 257, 333, 515, 4,097), d = 1, 37, 54, 64, 65 (ragged and
# whole 32-column chunks, d % 4 = 1, 2, 0) and 400 (queries staged in
# panels), copy widths 16 / 8 / 4 B and the corpus as x[1:] ("rows") or 4
# bytes into its buffer ("flat").
L1_CASES = [(1, 1, 1, None), (8, 129, 37, None), (33, 257, 54, None),
            (100, 333, 64, None), (129, 515, 65, None), (32, 4097, 54, None),
            (65, 333, 54, "flat"), (33, 257, 64, "rows"), (7, 515, 1, "flat"),
            (40, 300, 400, None), (32, 129, 54, "rows")]


def l1_inputs(q, n, d, rng):
    """float32 (q, d) queries and (n, d) rows, and a threshold at the
    median L1 distance (an attained value)."""
    qa = rng.normal(size=(q, d)).astype(np.float32)
    xa = rng.normal(size=(n, d)).astype(np.float32)
    return qa, xa, float(np.median(dist64("l1", qa, xa)))


# The fused LSH verification (K2): (metric, d or W words, n, Q, C, kind),
# every (n, Q, C, kind) of LSH_SHAPES with every dimension of LSH_DIMS
# (rows of 512 B and more, d = 160 and 254 and W = 129, go through the
# kernel's cp.async.bulk ring, at 16, 8 and 4-byte alignment),
# and two cases whose one split holds more distinct ids than a block's
# shared memory (80,000 rows, 32 queries, 60,001 ids each in one split of
# 10,000: the block walks its distinct ids in two passes).  Kinds
# (lsh_ids): ids at every split boundary (s w - 1, s w) with duplicates,
# every id inside one split, a row of one repeated id, random ids; every
# case shuffled, with sentinels, and a last row of sentinels only where
# Q > 1.  n = 1 and 40 (a split of one id), 5,000 and 20,000 (splits of
# many); C = 1, 33, 5,121 and 60,001 (the ids alone past one block's
# 227 KB of shared memory).
LSH_SHAPES = [(1, 3, 1, "random"), (40, 3, 33, "boundary"),
              (40, 5, 5121, "one_id"), (20000, 2, 5121, "boundary"),
              (20000, 3, 33, "one_split"), (5000, 2, 60001, "random"),
              (20000, 7, 5121, "random")]
LSH_DIMS = [("l2", 1), ("l2", 2), ("l2", 32), ("l1", 37), ("l1", 54),
            ("l1", 160), ("cosine", 254), ("cosine", 32), ("hamming", 1),
            ("hamming", 2), ("hamming", 9), ("hamming", 129)]
LSH_CASES = ([(m, d, *shape) for shape in LSH_SHAPES for m, d in LSH_DIMS]
             + [("l2", 2, 80000, 32, 60001, "one_split"),
                ("hamming", 2, 80000, 32, 60001, "one_split")]
             # the retrieval service's shape: d = Yi-6B's d_model (and odd),
             # 64 queries of cap 128 x L 20 candidates over 8,192 rows
             + [("cosine", 4096, 8192, 64, 2560, "random"),
                ("cosine", 4095, 8192, 64, 2560, "boundary"),
                ("l2", 4096, 8192, 64, 2560, "random")])


def lsh_ids(kind, n, q, c, width, rng):
    """(q, c) int32 unsorted candidate ids in [0, n], n the sentinel;
    ``width`` is the kernel's split (ids a block owns)."""
    if kind == "boundary":
        pool = sorted({v for s in range(0, n + width, width)
                       for v in (s - 1, s) if 0 <= v < n})
        ids = rng.choice(np.array(pool + [n]), size=(q, c))
    elif kind == "one_split":
        lo = (n // width // 2) * width
        ids = rng.integers(lo, min(lo + width, n), (q, c))
    else:
        ids = rng.integers(0, n + 1, (q, c))
    if kind == "one_id":
        ids[0] = n // 2
    ids[:, : c // 5] = n                  # a sentinel share
    if q > 1:
        ids[-1] = n
    return rng.permuted(ids, axis=1).astype(np.int32)


def lsh_inputs(metric, d, n, q, c, kind, width, rng):
    """(queries, corpus, unsorted ids, t, r): float32 rows (uint32 codes
    for hamming), t at the median distance of the distinct real candidates
    (an attained value; r^2 for l2), r the radius to pass."""
    if metric == "hamming":
        qa = rng.integers(0, 2**32, (q, d), dtype=np.uint32)
        xa = rng.integers(0, 2**32, (n, d), dtype=np.uint32)
    else:
        qa = rng.normal(size=(q, d)).astype(np.float32)
        xa = rng.normal(size=(n, d)).astype(np.float32)
    ids = lsh_ids(kind, n, q, c, width, rng)
    d64 = lsh_dist64(metric, qa, xa, np.sort(ids, axis=1))
    real = d64[np.isfinite(d64)]
    t = float(np.median(real)) if real.size else 1.0
    return qa, xa, ids, t, (float(np.sqrt(t)) if metric == "l2" else t)


def lsh_dist64(metric, qa, xa, ids_sorted):
    """(Q, C) float64 distance of each run's first slot of sorted ids to
    its query; +inf on duplicates and sentinels."""
    n = xa.shape[0]
    prev = np.concatenate([np.full((len(ids_sorted), 1), -1), ids_sorted[:, :-1]], 1)
    first = (ids_sorted != prev) & (ids_sorted < n)
    out = np.full(ids_sorted.shape, np.inf)
    for i in range(len(ids_sorted)):
        rows = ids_sorted[i][first[i]]
        out[i, first[i]] = dist64(metric, qa[i:i + 1], xa[rows])[0]
    return out


# The route estimate (K3, ops.route_estimate): (Q, L, T, m, S, kind).  V = L
# (T = 1) and V = L T probed columns (T > 1, a column -> table map); m = 16
# to 1,024 (threads a block); S = 1 to 65 segments (65: past the 64 of one
# launch's parameter struct, two launches); kinds (route_tables): "static"
# (no tombstones), "churned" (tombstones in every segment), "dead" (the
# second segment's rows all dead: its estimate clamps to 0).
ROUTE_CASES = [(1, 4, 1, 16, 1, "static"), (33, 20, 1, 64, 5, "churned"),
               (100, 20, 1, 64, 4, "churned"), (100, 20, 1, 64, 1, "static"),
               (100, 6, 4, 32, 3, "churned"), (33, 5, 2, 1024, 2, "dead"),
               (7, 2, 1, 128, 65, "churned"), (5, 3, 1, 256, 2, "static"),
               (33, 4, 2, 512, 6, "dead"), (257, 8, 2, 128, 3, "churned")]


def route_tables(q, L, T, m, S, kind, rng):
    """numpy inputs of a route estimate: (Q, L T) int32 buckets, the
    (L T,) int32 column -> table map (None where T = 1), and S segments of
    (starts (L, B + 1) int32, registers (L, B, m) uint8, tomb_counts
    (L, B) int32 or None), B = 64 buckets of 0-40 rows.  The registers
    of one segment are sparse (most merged estimates take the small-range
    correction), those of the next dense."""
    B = 64
    segs = []
    for s in range(S):
        sizes = rng.integers(0, 41, (L, B))
        starts = np.concatenate([np.zeros((L, 1), np.int64),
                                 np.cumsum(sizes, axis=1)], 1).astype(np.int32)
        # ranks 1 + geometric, in 10 % of the registers of even segments
        # (the merge leaves zeros: linear counting) and in all of odd ones
        regs = np.minimum(rng.geometric(0.5, (L, B, m)), 31)
        regs *= rng.random((L, B, m)) < (0.1 if s % 2 == 0 else 1.0)
        regs = regs.astype(np.uint8)
        tomb = None
        if kind != "static":
            tomb = rng.integers(0, sizes + 1).astype(np.int32)
            if kind == "dead" and s == 1:
                tomb = sizes.astype(np.int32)
        segs.append((starts, regs, tomb))
    qb = rng.integers(0, B, (q, L * T)).astype(np.int32)
    tidx = None if T == 1 else np.repeat(np.arange(L), T).astype(np.int32)
    return qb, tidx, segs


# The grouped Hamming scan (K5, ops.grouped_linear_scan): (Q, W, rows of
# each segment, kind).  Q = 1, 5, 7, 33, 100 (a last block of 1-32
# queries); W = 1, 2, 4 (codes held in registers), 3, 8, 9, 16; odd sums of
# rows (a delta of C + 1 rows last), frozen segments padded to powers of
# two, 71 segments (past the 64 of one launch: two launches); kinds
# (grouped_parts): "static" (no live, no external ids: ids are row
# indices), "stream" (live and external ids on every segment), "dead"
# (stream, the first segment's rows all dead: sentinel ids, mask 0).
GROUPED_CASES = [(1, 2, (1,), "static"), (33, 1, (8, 16, 129), "stream"),
                 (100, 2, (8192, 4096, 4096, 2048, 4097), "stream"),
                 (33, 3, (64, 8, 257), "stream"), (100, 8, (512, 513), "dead"),
                 (7, 9, (16, 31), "stream"), (33, 16, (100,), "static"),
                 (5, 4, (8,) * 70 + (9,), "stream"),
                 (100, 2, (59900,), "static"), (1, 4, (1024, 3), "dead")]


def grouped_parts(q, w, sizes, kind, rng):
    """numpy inputs of a grouped scan: (Q, W) uint32 query codes, one
    (x (n, W) uint32, live (n + 1,) bool or None, ext (n,) int32 or None)
    per segment, and a threshold at an attained distance (the median of
    the first segment's distances to query 0)."""
    qa = rng.integers(0, 2**32, (q, w), dtype=np.uint32)
    parts, base = [], 0
    for s, n in enumerate(sizes):
        x = rng.integers(0, 2**32, (n, w), dtype=np.uint32)
        x[: n // 7] ^= qa[0] & 0xFF00FF00         # near rows: both masks
        live = ext = None
        if kind != "static":
            live = rng.random(n + 1) < 0.8
            live[n] = False
            if kind == "dead" and s == 0:
                live[:] = False
            ext = (base + 1000 + rng.permutation(n)).astype(np.int32)
        base += n
        parts.append((x, live, ext))
    t = float(np.median(dist64("hamming", qa[:1], parts[0][0])))
    return qa, parts, t


def route_estimate_per_segment(qb, tables, tidx, merge):
    """The route estimate composed one segment at a time, as the engine
    composed it before ``ops.route_estimate``: each segment's (Q, V, m)
    registers gathered and estimated by ``merge`` ((Q, V, m) uint8 ->
    (Q,) float32), its dead counts subtracted and clamped at 0, the
    estimates added in segment order from 0.  Returns (collisions, cand)."""
    lidx = (torch.arange(qb.shape[1], device=qb.device) if tidx is None
            else tidx.to(torch.int64))[None, :]
    b = qb.to(torch.int64)
    coll = torch.zeros(qb.shape[0], dtype=torch.int32, device=qb.device)
    cand = torch.zeros(qb.shape[0], dtype=torch.float32, device=qb.device)
    for starts, regs, tomb in tables:
        counts = starts[lidx, b + 1] - starts[lidx, b]
        est = merge(regs[lidx, b].contiguous())
        if tomb is not None:
            dead = tomb[lidx, b]
            counts = counts - dead
            est = torch.clamp(est - torch.sum(dead, dim=-1, dtype=torch.int32)
                              .to(torch.float32), min=0.0)
        coll = coll + torch.sum(counts, dim=-1, dtype=torch.int32)
        cand = cand + est
    return coll, cand


# (n, d, L, k, view, rows set to +Inf, the loader simhash.plan picks on an
# H100) for K9 beyond test_cuda_simhash_matches_plain's grid: x 4 bytes
# into its buffer ("flat": every tile's span off 16 B, its last floats
# loaded apart) or x[1:] ("rows"), with both loaders; d = 1, 3, 7 (one
# partial k step); d = 1,000 (R in d-panels), with 5 column groups at
# k = 21; N one row past 5 tiles; rows of +Inf, whose neighbours (the
# previous row's last k step reads them) must still match.
SIMHASH_CASES = [(1000, 254, 20, 4, "flat", (), "bulk"),
                 (999, 254, 20, 21, "flat", (), "chunk"),
                 (333, 254, 20, 4, "rows", (), "bulk"),
                 (513, 1, 20, 4, None, (), "bulk"),
                 (300, 3, 3, 8, None, (), "bulk"),
                 (129, 7, 7, 1, None, (), "bulk"),
                 (300, 1000, 20, 21, None, (), "chunk"),
                 (200, 1000, 20, 4, None, (), "chunk"),
                 (321, 254, 20, 4, None, (), "bulk"),
                 (300, 254, 20, 4, None, (37, 63, 64, 299), "bulk"),
                 (300, 254, 20, 21, None, (37, 64), "chunk"),
                 (300, 37, 3, 8, None, (5,), "bulk")]


def simhash_inputs(n, d, L, k, view, inf_rows, rng, device):
    """float32 (n, d) points on ``device`` (``on_device``'s view) with
    row 0 zero and ``inf_rows`` +Inf, and a (d, L k) projection."""
    xa = rng.normal(size=(n, d)).astype(np.float32)
    xa[0] = 0.0
    xa[list(inf_rows)] = np.inf
    r = torch.from_numpy(rng.normal(size=(d, L * k)).astype(np.float32))
    return on_device(xa, view, device), r.to(device)


def simhash_packed_as_kernel(x, rc, L, k):
    """What ``csrc/simhash.cu`` packs, in plain PyTorch: the signs of x
    against each compact column of ``rc`` ((groups, 16 nfw, d)), read
    back as its epilogue reads its ballots (slot s = 2 f + e of a warp
    half is nibble s % npw of the half's word s // npw, lane t its bit
    t).  (N, L, words) int64."""
    from repro_torch.kernels.simhash import layout
    lay = layout(L, k)
    n = x.shape[0]
    out = torch.zeros((n, lay.tw), dtype=torch.int64)
    for y in range(lay.groups):
        bits = ((x.to(torch.float32) @ rc[y].T) > 0).to(torch.int64)
        for half in range(2):
            for w in range(lay.wh):
                local = half * lay.wh + w
                if local >= min(lay.wg, lay.tw - y * lay.wg):
                    continue
                word = torch.zeros(n, dtype=torch.int64)
                for j in range(lay.npw):
                    s = w * lay.npw + j
                    for t in range(4):
                        col = half * 8 * lay.nfw + 8 * (s // 2) + 2 * t + s % 2
                        word |= bits[:, col] << (4 * j + t)
                out[:, y * lay.wg + local] = word
    return out.reshape(n, L, lay.tw // L)


# The train step on the card against the CPU, float32 with TF32 off:
# (arch, remat, microbatch) on a reduced config (``reduced_arch``), one
# case a layer kind beyond the dense ones.
TRAIN_CASES = [("yi-6b", "block", 1), ("yi-6b", "none", 2),
               ("mistral-nemo-12b", "block", 1), ("nemotron-4-15b", "none", 1),
               ("gemma3-27b", "block", 1), ("granite-moe-1b-a400m", "none", 1),
               ("falcon-mamba-7b", "block", 1), ("zamba2-1.2b", "none", 2),
               ("llama-3.2-vision-11b", "block", 1),
               ("whisper-small", "none", 1)]
TRAIN_RTOL = 1e-4
# Every config that is not dense: float32 prefill and decode on the card
# against the CPU, within SERVE_TOL.
SERVE_ARCHS = ("gemma3-27b", "granite-moe-1b-a400m",
               "llama4-maverick-400b-a17b", "falcon-mamba-7b", "zamba2-1.2b",
               "llama-3.2-vision-11b", "whisper-small")
SERVE_TOL = dict(rtol=1e-4, atol=1e-4)
# The SSM scans at full width, 1 x 2,048 steps: (scan, x's trailing
# shape, d_state, chunk) of Falcon-Mamba 7B and Zamba2 1.2B.
SCAN_CASES = [("mamba1", (8192,), 16, 64), ("ssd", (64, 64), 64, 64)]


def reduced_arch(arch, dtype="float32"):
    """``reduced_config(arch)`` in ``dtype``: one repeat of the block
    pattern and the tail, two repeats where the pattern is one layer and
    there is no tail."""
    import dataclasses
    from repro_torch.configs import get_config, reduced_config
    cfg = reduced_config(get_config(arch))
    if len(cfg.pattern) == 1 and not cfg.tail:
        cfg = dataclasses.replace(cfg, n_layers=2, repeats=2)
    return dataclasses.replace(cfg, dtype=dtype)


def serve_device_vs_cpu(arch, device, prompt=8, new=4, mesh=None,
                        **par_kw):
    """Float32 ``prefill`` of ``prompt`` tokens (with the config's stub
    frames or image embeddings) and ``new`` ``decode_step`` s of
    ``reduced_arch(arch)`` on ``device`` and on the CPU, the same weights
    (seed 0 drawn on the CPU), TF32 off; with ``mesh`` (a shape over
    ("data", "model")), each on a debug mesh of its device with the
    ``ParallelConfig`` fields ``par_kw``.  Asserts each h and every cache
    leaf within SERVE_TOL; returns the largest deviation over the h's."""
    import copy
    from repro_torch.data import lm_batch
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import (ParallelConfig, decode_step, init_params,
                                    prefill)
    cfg = reduced_arch(arch)

    def par_on(d):
        return ParallelConfig(
            mesh=None if mesh is None else make_debug_mesh(mesh, device=d),
            attn_chunk_q=4, attn_chunk_k=4, **par_kw)

    par, par_dev = par_on("cpu"), par_on(device)
    cpu = init_params(cfg, 0, device="cpu")
    dev = copy.deepcopy(cpu).to(device)
    full = lm_batch(7, 0, batch=2, seq=prompt + new, vocab=cfg.vocab,
                    cfg=cfg, device="cpu")
    full.pop("labels")
    batch = dict(full, tokens=full["tokens"][:, :prompt])
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    worst = 0.0
    try:
        with torch.no_grad():
            hc, cc, lc = prefill(cpu, batch, cfg, par, prompt + new)
            hd, cd, ld = prefill(dev, {k: v.to(device) for k, v in
                                       batch.items()}, cfg, par_dev,
                                 prompt + new)
            pairs = [(hd, hc)]
            for t in range(prompt, prompt + new):
                tok = full["tokens"][:, t]
                hc, cc = decode_step(cpu, cc, tok, lc, cfg, par)
                hd, cd = decode_step(dev, cd, tok.to(device), ld, cfg,
                                     par_dev)
                lc, ld = lc + 1, ld + 1
                pairs.append((hd, hc))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    for a, c in pairs:
        torch.testing.assert_close(a.cpu(), c, **SERVE_TOL)
        worst = max(worst, float((a.cpu() - c).abs().max()))
    for a, c in zip(cd["blocks"], cc["blocks"]):
        for k in c:
            torch.testing.assert_close(a[k].cpu(), c[k], **SERVE_TOL)
    return worst


def scan_device_vs_cpu(scan, tail, n, chunk, device, s=2048):
    """``ssm.mamba1_scan`` or ``ssd_scan`` on (1, s, *tail) inputs
    (dt at the blocks' softplus(-4.6) scale, A from the blocks' A_log
    range, a random carried state) on ``device`` and on the CPU; asserts
    y and the final state within rtol 1e-4 and an atol of 1e-4 x the
    largest entry; returns their largest relative deviations."""
    from repro_torch.models import ssm
    g = torch.Generator().manual_seed(0)
    x = torch.randn((1, s) + tail, generator=g)
    dt = torch.rand((1, s) + tail[:1], generator=g) * 0.02
    bm = torch.randn((1, s, n), generator=g)
    cm = torch.randn((1, s, n), generator=g)
    if scan == "mamba1":
        dt = torch.rand((1, s) + tail, generator=g) * 0.02
        a = -torch.arange(1, n + 1, dtype=torch.float32).repeat(tail[0], 1)
        h0 = torch.randn((1, tail[0], n), generator=g)
        fn = ssm.mamba1_scan
    else:
        a = -torch.rand(tail[:1], generator=g) - 0.5
        h0 = torch.randn((1,) + tail + (n,), generator=g)
        fn = ssm.ssd_scan
    args = (x, dt, bm, cm, a, h0)
    yc, hc = fn(*args, chunk=chunk)
    yd, hd = fn(*(t.to(device) for t in args), chunk=chunk)
    out = []
    for d_, c in ((yd, yc), (hd, hc)):
        scale = float(c.abs().max())
        torch.testing.assert_close(d_.cpu(), c, rtol=1e-4, atol=1e-4 * scale)
        out.append(float((d_.cpu() - c).abs().max()) / scale)
    return out


def train_device_vs_cpu(arch, remat, microbatch, device, steps=3,
                        mesh=None, **par_kw):
    """``steps`` steps of ``make_train_step`` on a float32
    ``reduced_arch(arch)`` on ``device`` and on the CPU, from the same
    weights (seed 0 drawn on the CPU, carried over by ``state_tree``) on
    the same batches.  Asserts loss, grad norm and lr within TRAIN_RTOL
    (relative) each step, and each final weight leaf within TRAIN_RTOL
    in norm: ||a - c|| <= TRAIN_RTOL ||c||.  Not element by element:
    AdamW moves every entry whose grad is above eps by about lr whatever
    the grad's size, so an entry whose grad the two devices round to
    opposite signs near 0 ends up to 2 lr x steps apart.  Returns (the
    largest relative deviation of the metrics, the largest leaf's
    relative norm deviation, the largest entry's deviation over
    lr x steps).  With ``mesh`` (a shape over ("data", "model")), each
    device trains on a debug mesh of its own with the ``ParallelConfig``
    fields ``par_kw``."""
    from repro_torch.data import lm_batch
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import ParallelConfig
    from repro_torch.train import (TrainConfig, init_state, load_state_tree,
                                   make_jitted_train_step, state_tree)
    cfg = reduced_arch(arch)

    def par_on(d):
        return ParallelConfig(
            mesh=None if mesh is None else make_debug_mesh(mesh, device=d),
            remat=remat, attn_chunk_q=16, attn_chunk_k=16, logits_chunk=16,
            **par_kw)

    tcfg = TrainConfig(peak_lr=1e-3, warmup_steps=1, total_steps=steps,
                       microbatch=microbatch)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cpu = init_state(cfg, 0, tcfg, device="cpu")
        dev = load_state_tree(init_state(cfg, 1, tcfg, device=device),
                              state_tree(cpu, cfg), cfg)
        f_cpu = make_jitted_train_step(cfg, par_on("cpu"), tcfg)
        f_dev = make_jitted_train_step(cfg, par_on(device), tcfg)
        dev_metrics = 0.0
        for i in range(steps):
            b = lm_batch(5, i, batch=4, seq=32, vocab=cfg.vocab, cfg=cfg,
                         device="cpu")
            cpu, mc = f_cpu(cpu, b)
            dev, md = f_dev(dev, {k: v.to(device) for k, v in b.items()})
            for k in ("loss", "grad_norm", "lr"):
                a, c = float(md[k]), float(mc[k])
                dev_metrics = max(dev_metrics,
                                  abs(a - c) / max(abs(c), 1e-30))
                assert abs(a - c) <= TRAIN_RTOL * abs(c), (i, k, a, c)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    ref = dict(cpu["params"].named_parameters())
    dev_norm = dev_entry = 0.0
    for name, p in dev["params"].named_parameters():
        a, c = p.detach().cpu(), ref[name].detach()
        # a leaf of zeros (a shared layer's marker) must stay zeros
        rel = float(torch.linalg.norm(a - c)
                    / torch.clamp(torch.linalg.norm(c), min=1e-30))
        assert rel <= TRAIN_RTOL, (name, rel)
        dev_norm = max(dev_norm, rel)
        dev_entry = max(dev_entry, float((a - c).abs().max())
                        / (tcfg.peak_lr * steps))
    return dev_metrics, dev_norm, dev_entry


# The mesh's per-shard sites on the card against the CPU, float32: the
# train step and serving of a reduced config on a debug mesh of each
# device (``train_device_vs_cpu`` / ``serve_device_vs_cpu`` with
# ``mesh``), and each site alone (``mesh_site_device_vs_cpu``).
MESH_TRAIN_CASES = [("yi-6b", (4, 2), {}),
                    ("granite-moe-1b-a400m", (4, 2),
                     {"moe_local_dispatch": True})]
MESH_SERVE_CASES = [("yi-6b", (2, 4), {"decode_seq_shard": ("model",)}),
                    ("yi-6b", (2, 2), {"batch_axes": (),
                                       "decode_seq_shard": ("data", "model")}),
                    ("yi-6b", (2, 1), {"decode_kv_head_shard": True}),
                    ("granite-moe-1b-a400m", (2, 2),
                     {"moe_local_dispatch": True})]
MESH_SITES = ("embed", "softmax_xent", "greedy_sample", "flash_decode",
              "moe_local", "apply_ef", "gpipe")


def mesh_site_device_vs_cpu(site, device):
    """One per-shard site on random float32 inputs (seed 0), on a debug
    mesh of ``device`` and of the CPU, TF32 off.  Asserts the outputs
    within SERVE_TOL (ids and int8-derived sums exactly where the inputs
    leave no tie); returns the largest deviation."""
    from repro_torch.distributed import gpipe
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import ParallelConfig
    from repro_torch.models import attention, embedding, moe
    from repro_torch.optim import compression
    g = torch.Generator().manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g) * scale

    def run(dev):
        def par(shape=(4, 2), axes=("data", "model"), **kw):
            return ParallelConfig(mesh=make_debug_mesh(shape, axes,
                                                       device=dev), **kw)

        def on(*ts):
            return [t.to(dev) for t in ts]

        if site == "embed":
            tab, ids = on(randn(64, 32), torch.randint(0, 64, (8, 6),
                                                       generator=g))
            return [embedding.embed(tab, ids, par())]
        if site == "softmax_xent":
            head, h = (t.requires_grad_() for t in on(randn(64, 32),
                                                       randn(8, 12, 32)))
            lab, = on(torch.randint(-1, 64, (8, 12), generator=g))
            loss = embedding.softmax_xent(head, h, lab, par(), chunk=4)
            return [loss.detach(), *torch.autograd.grad(loss, [head, h])]
        if site == "greedy_sample":
            head, hl = on(randn(64, 32), randn(8, 32))
            return [embedding.greedy_sample(head, hl, par())]
        if site == "flash_decode":
            q, k, v, ln = on(randn(4, 8, 16), randn(4, 64, 2, 16),
                             randn(4, 64, 2, 16),
                             torch.tensor([64, 50, 33, 7]))
            p = par((2, 4), decode_seq_shard=("model",))
            return [attention.flash_decode(q, k, v, ln, p,
                                           seq_axes=("model",))]
        if site == "moe_local":
            r, wi, wg, wo, x = on(randn(32, 8), randn(8, 32, 64, scale=0.2),
                                  randn(8, 32, 64, scale=0.2),
                                  randn(8, 64, 32, scale=0.2),
                                  randn(8, 16, 32))
            return list(moe.moe_apply(
                {"router": r, "wi": wi, "wg": wg, "wo": wo}, x, top_k=2,
                capacity_factor=1.25, par=par(moe_local_dispatch=True)))
        if site == "apply_ef":
            mesh = make_debug_mesh((8,), ("pod",), device=dev)
            grads = [{"w": t} for t in on(*randn(8, 1000, scale=0.01))]
            ef = [compression.init_ef(gr) for gr in grads]
            red, ef = compression.apply_ef(grads, ef, mesh, "pod", 8)
            return [red[0]["w"], torch.stack([e["w"] for e in ef])]
        w, b, xs = on(randn(4, 16, 16, scale=0.3), randn(4, 16, scale=0.1),
                      randn(8, 4, 16))
        return [gpipe(lambda p, h: torch.tanh(h @ p["w"] + p["b"]),
                      {"w": w, "b": b}, xs,
                      mesh=make_debug_mesh((4, 2), ("stage", "model"),
                                           device=dev), axis="stage")]

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        state = g.get_state()
        want = run("cpu")
        g.set_state(state)
        got = run(device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    worst = 0.0
    for a, c in zip(got, want):
        if c.dtype in (torch.int32, torch.int64):
            assert torch.equal(a.cpu(), c), site
            continue
        torch.testing.assert_close(a.cpu(), c, **SERVE_TOL)
        worst = max(worst, float((a.cpu() - c).abs().max()))
    return worst



# -- the bucket hash (``families.bucket_ids``, ``csrc/bucket_hash.cu``) -----
# An independent numpy uint32 version of the ids: numpy's uint32 multiply
# wraps, so fmix32 is written as murmur3 states it.  The projection (a
# matmul) is the caller's: the spec starts after it.
_FMIX = (0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35)   # golden ratio, C1, C2


def np_fmix32(x, seed):
    golden, c1, c2 = _FMIX
    with np.errstate(over="ignore"):
        h = x + np.uint32((seed * golden) & 0xFFFFFFFF)
        h = h ^ (h >> np.uint32(16))
        h = h * np.uint32(c1)
        h = h ^ (h >> np.uint32(13))
        h = h * np.uint32(c2)
        return h ^ (h >> np.uint32(16))


def np_mix_words(words, num_buckets, seed=17):
    """(..., W) uint32 words -> (...) int32 bucket ids."""
    acc = np.full(words.shape[:-1], seed, np.uint32)
    for j in range(words.shape[-1]):
        acc = np_fmix32(acc ^ words[..., j], seed + j)
    return (acc & np.uint32(num_buckets - 1)).astype(np.int32)


def np_pack(bits):
    """(..., k) bool -> (..., ceil(k / 32)) uint32, LSB first, zero-padded."""
    k = bits.shape[-1]
    w = -(-k // 32)
    padded = np.zeros(bits.shape[:-1] + (w * 32,), np.uint32)
    padded[..., :k] = bits
    padded = padded.reshape(bits.shape[:-1] + (w, 32))
    return (padded << np.arange(32, dtype=np.uint32)).sum(
        -1, dtype=np.uint64).astype(np.uint32)


def np_floor_words(proj, b, w):
    """float32 floor((proj + b) / w), true division, wrapped to uint32."""
    v = (proj + b).astype(np.float32) / np.float32(w)
    return np.floor(v).astype(np.int64).astype(np.uint32)


def np_bucket_ids(fam, params, x, num_buckets):
    """What ``fam.bucket_ids(params, x, num_buckets)`` must return,
    (n, L) int32, from torch's projection of x on x's device."""
    name = type(fam).__name__
    n = x.shape[0]
    if name == "BitSampling":
        xa = x.cpu().numpy().astype(np.int64).astype(np.uint32)
        pos = params["pos"].cpu().numpy().astype(np.int64)
        bits = (xa[:, pos // 32] >> (pos % 32).astype(np.uint32)) & 1
        words = np_pack(bits.reshape(n, fam.L, fam.k).astype(bool))
    elif name == "SimHash":
        proj = (x.to(torch.float32) @ params["R"]).cpu().numpy()
        words = np_pack((proj > 0).reshape(n, fam.L, fam.k))
    else:
        proj = (x.to(torch.float32) @ params["a"]).cpu().numpy()
        words = np_floor_words(proj, params["b"].cpu().numpy(),
                               fam.w).reshape(n, fam.L, fam.k)
    return np_mix_words(words, num_buckets)


def reciprocal_misses(w, lo=-4096, hi=4096):
    """Multiples v = j * w (float32) where floor(v / w) and floor(v *
    (1 / w)) differ: a reciprocal multiply would move these across floors."""
    v = (np.arange(lo, hi, dtype=np.float32) * np.float32(w)).astype(
        np.float32)
    recip = np.float32(1.0) / np.float32(w)
    return v[np.floor(v / np.float32(w)) != np.floor(v * recip)]


# name -> (rows, d, L, k): SimHash at k across word edges and at the
# Webspam cell's shape (d = 254, L = 20, 1,024 queries); p-stable L1 at the
# CoverType cell's (d = 54, L = 20, k = 8), L1 with Cauchy draws at a tiny w
# (floors of both signs past 2^31), L2, and on exact multiples of w
# ("multiples": b = 0 and w with reciprocal misses; "offsets": b and x
# multiples of a dyadic w); bit sampling across one and two words.
BUCKET_HASH_CASES = {
    "simhash-k1": (257, 16, 3, 1), "simhash-k31": (257, 16, 3, 31),
    "simhash-k32": (257, 16, 3, 32), "simhash-k33": (257, 16, 3, 33),
    "simhash-k70": (257, 16, 3, 70), "simhash-webspam": (1024, 254, 20, 12),
    "l1-covertype": (1024, 54, 20, 8), "l1-wide-floors": (1024, 54, 20, 8),
    "l2-random": (300, 32, 5, 7), "pstable-multiples": (0, 1, 2, 3),
    "pstable-offsets": (512, 1, 4, 5), "bitsampling-k12": (300, 64, 20, 12),
    "bitsampling-k40": (300, 64, 6, 40)}
# (d, L, k, probes): multi-probe's perturbed codes, one and three words
MULTIPROBE_CASES = [(254, 20, 12, 4), (16, 3, 70, 6)]
BUCKET_HASH_B = 65536


def bucket_hash_case(name, device, seed=0):
    """(family, params, rows) of a ``BUCKET_HASH_CASES`` entry on
    ``device``."""
    from repro_torch.core.lsh import families as F
    rng = np.random.default_rng(seed)
    n, d, L, k = BUCKET_HASH_CASES[name]
    gen = torch.Generator().manual_seed(seed)
    if name.startswith("simhash"):
        fam = F.SimHash(d=d, L=L, k=k)
        xa = rng.normal(size=(n, d)).astype(np.float32)
        xa[0] = 0.0                 # every projection 0: every bit 0
    elif name.startswith("bitsampling"):
        fam = F.BitSampling(dim_bits=d, L=L, k=k)
        x = torch.from_numpy(rng.integers(0, 2**32, (n, d // 32),
                                          dtype=np.int64))
        return fam, fam.init(gen, device=device), x.to(device)
    elif name == "l2-random":
        fam = F.PStableL2(d=d, L=L, k=k, w=0.7)
        xa = (2.0 * rng.normal(size=(n, d))).astype(np.float32)
    elif name in ("l1-covertype", "l1-wide-floors"):
        wide = name == "l1-wide-floors"
        fam = F.PStableL1(d=d, L=L, k=k, w=1e-3 if wide else 2.2)
        xa = (rng.random((n, d)) * (4000.0 if wide else 1.0)).astype(
            np.float32)
        xa[1] *= -1.0
    elif name == "pstable-multiples":
        w = 0.7
        v = reciprocal_misses(w)
        fam = F.PStableL2(d=d, L=L, k=k, w=w)
        xa = np.concatenate([v, -v, [0.0, np.float32(w)]]).astype(
            np.float32)[:, None]
        params = {"a": torch.ones((1, L * k)), "b": torch.zeros(L * k)}
        return fam, {p: t.to(device) for p, t in params.items()}, \
            torch.from_numpy(xa).to(device)
    else:                           # pstable-offsets: w = 0.75, b = j / 4
        fam = F.PStableL1(d=d, L=L, k=k, w=0.75)
        b = (np.arange(L * k) % 3 * 0.25).astype(np.float32)
        j = rng.integers(-2000, 2000, (n,))
        xa = (j * 0.75 - 0.25 * rng.integers(0, 3, (n,))).astype(
            np.float32)[:, None]
        params = {"a": torch.ones((1, L * k)), "b": torch.from_numpy(b)}
        return fam, {p: t.to(device) for p, t in params.items()}, \
            torch.from_numpy(xa).to(device)
    return fam, fam.init(gen, device=device), torch.from_numpy(xa).to(device)


# The delta's collision test (``ops.delta_collide``) and scan: a delta of
# capacity DELTA_C filled to each count (across a warp's 32 rows, half and
# all of it), about a fifth of its rows tombstoned; DELTA_PROBES probes a
# table (1: no column -> table map).  DELTA_FULL is the CoverType cell's
# batch against a full delta, L = 20.
DELTA_C = 128
DELTA_COUNTS = (0, 1, 31, 32, 33, DELTA_C // 2, DELTA_C)
DELTA_PROBES = (1, 3)
DELTA_FULL = dict(C=8192, L=20, nq=1024, buckets=64)


def delta_case(count, probes, device, seed=0, *, C=DELTA_C, L=6, nq=37,
               buckets=6, metric="l1", d=5):
    """(delta, query rows, (Q, L * probes) query buckets, tidx or None):
    a ``make_delta`` of capacity ``C`` on ``device`` with ``count`` rows
    inserted (``metric``'s rows, bucket ids from [0, ``buckets``), so that
    queries collide often) and about a fifth of them killed."""
    from repro_torch.core.index import as_rows
    from repro_torch.streaming import delta as delta_lib
    rng = np.random.default_rng(seed)

    def rows(n):
        if metric == "hamming":
            return as_rows(rng.integers(0, 2**32, (n, 2), dtype=np.uint32),
                           metric, device)
        return as_rows(rng.normal(size=(n, d)).astype(np.float32), metric,
                       device)
    x = rows(count)
    delta = delta_lib.make_delta(C, x.shape[1], L, dtype=x.dtype,
                                 device=device)
    if count:
        bids = torch.from_numpy(rng.integers(0, buckets, (count, L),
                                             dtype=np.int32)).to(device)
        ext = torch.from_numpy(rng.permutation(10 * C)[:count].astype(
            np.int32)).to(device)
        delta_lib.insert(delta, x, bids, ext,
                         torch.ones(count, dtype=torch.bool, device=device))
        dead = np.nonzero(rng.random(count) < 0.2)[0]
        if len(dead):
            delta_lib.kill(delta, torch.from_numpy(dead).to(device),
                           torch.ones(len(dead), dtype=torch.bool,
                                      device=device))
    qb = torch.from_numpy(rng.integers(0, buckets, (nq, L * probes),
                                       dtype=np.int32)).to(device)
    tidx = None if probes == 1 else torch.repeat_interleave(
        torch.arange(L, dtype=torch.int32, device=device), probes)
    return delta, rows(nq), qb, tidx


def delta_full_chain(delta, qb, tidx, mode):
    """The delta's collision test as the port ran it before it knew its
    count: the (Q, C + 1, V) hit tensor over every slot, trash row
    included -> (collisions, distinct) or the (Q, C + 1) mask."""
    rb = delta.bucket_ids if tidx is None else \
        delta.bucket_ids[:, tidx.to(torch.int64)]
    hit = qb[:, None, :].to(torch.int32) == rb[None, :, :]
    if mode == "mask":
        return torch.any(hit, dim=-1) & delta.live[None, :]
    hit = hit & delta.live[None, :, None]
    return (torch.sum(hit, dim=(1, 2), dtype=torch.int32),
            torch.sum(torch.any(hit, dim=-1), dim=1, dtype=torch.int32))
