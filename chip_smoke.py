#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one GPU.

  python3 chip_smoke.py          # from the repository root, on a CUDA machine

Phases (each raises on failure, so any failure exits non-zero):
  1. card, torch and CUDA versions; build the CUDA kernels from
     ``src/repro_torch/kernels/csrc`` (one nvcc per source, in parallel)
     and log each kernel's registers, static shared memory and spills;
  2. each kernel (K1-K9) against its plain PyTorch version on hand-made
     edge cases (K1 and K2 also at the retrieval service's d = 4,096) (the dot-form tile of K1 and K6, the fused K2, the L1
     tile of K4 and K7, the route estimate K3, the grouped Hamming
     scan K5 and the SimHash kernel K9 on the GPU tests' cases,
     ``tests/torch_cases.py`` ``DOT_CASES``, ``LSH_SHAPES`` x
     ``LSH_DIMS``, ``L1_CASES``, ``ROUTE_CASES``, ``GROUPED_CASES`` and
     ``SIMHASH_CASES``);
  2b. the bucket hash kernel (``phase_bucket_hash``) beside the families'
     plain chain at the cells' query shapes (1,024 queries, L = 20:
     SimHash at d = 254, k = 8, 40, 70; p-stable L1 at d = 54, k = 8):
     bit-equal ids, one launch a call, its ms, device ms and bound, and
     ``bucket_ids``' ms, host ms and device ops on both paths;
  2c. the delta's collision test kernel (``phase_delta_collide``) beside
     its plain chain and the full-capacity chain at the CoverType batch
     against a delta of 8,192 slots holding 0, 1,024 and 8,192 rows, one
     and four probes a table: counts and masks bit-equal, launches, ms,
     device ms and bound;
  3. ``calibrate`` on the card for cosine (d = 254), l2 (d = 32) and l1
     (d = 54): beta/alpha beside the paper's presets, the distance
     kernel's launches inside each call (K6 or K7, a warm-up and 5);
  4. the static index at full scale on the Webspam analogue (N = 349,900,
     d = 254, cosine, L = 20), built and queried through the kernels at
     four radii with force None / "lsh" / "linear", and again through the
     plain versions: neighbor sets, route containment, each path's own
     kernel launch counts (set to 0 before the path, read after it),
     query and kernel times; the route mix of the calibrated cost model
     at each radius beside the preset's, and one radius driven again
     through an index built with the calibrated model; K6 (cosine) on the
     100 queries x the corpus and K9 on the corpus with the index's own
     SimHash projections, held against the bucket codes too;
  5. the same in l2 on the Corel analogue (the preset at one radius, the
     calibrated model's mixes and query; K6 in l2); then the CoverType
     analogue as a static index on all 580,912 rows (L1: the calibrated
     model's mixes and query, K7);
  5c. the row-sharded static index (``core.distributed``) on the Webspam
     analogue at full size, 4 shards of 87,475 rows on the card, at each
     radius (cap raised where a shard's report would not fit the L * cap
     buffer), under both policies: collisions and estimates against a
     plain single-host index, every forced route held to it, launches
     per path (``check_sharded_launches``: K3's terms mode once a shard);
  6. the streaming ``DynamicHybridIndex`` at full scale on the CoverType
     analogue (N = 580,912, d = 54, L1): built on 524,288 rows, 56,624
     rows inserted in batches of 4,096 through an 8,192-row delta (six
     level-0 freezes, a level merge staged by the ``CompactionDriver``
     worker while the control thread queries), 1 % of the ids deleted,
     then queried through the kernels and the plain versions, held
     against a fresh static index on the surviving rows; then its
     durability: the churned state checkpointed (``state_dict()``, a full
     save, incremental step 1 inside the driver's consistent cut with the
     worker running, one more batch and 16 deletes, step 2 reusing the
     frozen levels' chunks, step 3 killed at ``pre_commit`` and swept by
     a restarted manager) and restored to a fresh index on the card,
     held against the live index (digests, counts, sets and kernel
     launches on every path), timed; then fully compacted and checked
     again;
  6b. the row-sharded streaming index (``ShardedDynamicHybridIndex``) on
     the CoverType analogue at full size, 4 shards on the card: built on
     524,288 rows, the rest inserted in batches of 4,096 with deletes
     between them and merges staged by a ``CompactionDriver``, ticked to
     the end; every path under both routings held to a plain single-host
     index on the survivors; timed beside the single-host index; K3's
     terms mode timed beside its estimate mode; checkpointed and restored
     onto 4 and 2 shards; a skewed stream of 65,536 rows near the
     queries pinned to shard 0 under ``keep_local``, then
     ``load_balance``;
  7. the MNIST analogue (59,900 64-bit codes, Hamming): the static index
     at its mixing radius, K8 on the 100 queries x the codes, and a
     churned streaming index, saved and restored once the same way.  On
     both churned streaming indexes (CoverType, MNIST) K3 over all frozen
     segments, and on MNIST K5 over all segments, against their plain
     versions and bit for bit against the engine's per-segment
     composition (each segment's terms or one-part scan, then a sum or
     a concatenation), timed beside it.  Then three MNIST tenants
     (``serve.CollectionManager``: one family, engine and compaction
     driver, a ``ShapeBucketScheduler`` with quota weights 1 / 2 / 4 and
     a ``ResultCache``): churned, served in forced batches (sets held
     against each tenant's whole batch and a plain index), a repeat pass
     from the cache, a version bump that misses, the collection tree
     saved incrementally and restored into a fresh manager, one tenant
     dropped and re-created;
  8. the retrieval encoder and ``RetrievalService`` at Yi-6B's full width
     and depth (12.12 GB of bf16 weights drawn on the card from seed 0;
     ``drive_retrieval``): two documents' bf16 embeddings against float32
     ones from the same weights, radii at the 0.005 and 0.03 quantiles of
     random-pair cosine distances, 8,192 documents of 32 tokens indexed
     (d = 4,096), 64 queries at each radius on every path against a plain
     index of the same state (launches asserted), 100 requests of 1-4
     rows through ``submit`` / ``drain_batches`` and again from the
     cache, 1,024 documents added and 256 removed, the service
     checkpointed and restored into a fresh one (equal sets and launches),
     then the same service on a 4-shard mesh of the card (the same
     parameters, documents and churn; every path and routing held to the
     single-host service's index), then ``generate`` (4 x 16 tokens) held
     against a prefill's argmax; a
     ``[retrieval]`` JSON line with the embed, index, prefill and decode
     times, tokens/s and memory;
  8b. training on the dense path (``drive_train``): Yi-6B at full
     width and, where the card holds its 72.73 GB training state, full
     depth (bf16 weights and grads, float32 AdamW moments; the depth is
     cut otherwise, and logged), 2 + 5 steps of 1 x 2,048 tokens timed
     (step ms, tokens/s, the bf16 peak share, peak memory, the losses),
     one more traced; the card's float32 steps against the CPU's on a
     reduced config; the fault-tolerant loop's crash / resume and
     straggler checks and two ``launch.train`` subprocesses, the second
     resuming the first; a ``[train]`` JSON line;
  8c. the other layer kinds, last (``drive_archs``), on the card the
     earlier phases left empty (under 1 GB asserted), each model freed
     before the next: Gemma-3 27B (sliding window), Granite-MoE and
     Llama-4 Maverick (MoE), Falcon-Mamba 7B (Mamba-1), Zamba2 1.2B
     (Mamba-2 and the shared block), Llama-3.2-Vision 11B (cross
     attention to image tokens) and Whisper-small (the encoder) served at
     full width and depth (Maverick: the most layers whose weights,
     caches and a prefill fit, counted on the meta device; 2 of 48):
     weights drawn on the card from seed 0, one ``forward_embed`` of 64 x
     32 tokens, a prefill of 4 x 2,048 tokens (stub frames or image
     embeddings where the config has them) and 32 decode steps timed
     (Gemma-3's 1,024-slot rings wrap), one more decode step traced
     (kernels a token), greedy tokens held to a prefill's argmax (the MoE
     configs at a capacity factor of E / top_k, where no token is
     dropped); six of them trained at full width on one repeat of the
     pattern and the tail (1 + 3 steps of 1 x 2,048 tokens: finite
     losses and grad norms, MoE aux loss above 0, the step-0 ce_loss
     within 1.0 of ln V; Maverick's one-layer state is 219 GB); then
     ``RetrievalService`` behind Zamba2 at full size (8,192 documents,
     64 queries at two radii on every path against a plain index, K1,
     K2 and K3 launched); an ``[archs]`` JSON line;
  8d. model parallelism on the single-controller ``ShardMesh``, last
     (``drive_mesh``), each model freed before the next: a. Yi-6B at
     full width on 4 layers, one train step on a (4, 2) debug mesh
     against one with mesh=None from the same seed-0 state (the loss
     within 1e-3 relative, the first moments within 0.05 of each leaf's
     largest entry, past it with a planted fault: the first model
     shard's table rows given no gradient; the weights within
     test_distributed's 0.05);
     b. Yi-6B at full width and depth (the depth counted as ``drive_train``
     counts it) trained on that mesh, 1 + 3 steps of 1 x 2,048 tokens,
     beside the same steps with mesh=None; c. Yi-6B served (4 x 2,048,
     32 tokens) with mesh=None, the sequence-sharded decode over 'model'
     and over every axis, the greedy rule against
     a mesh=None prefill; d. Granite-MoE at full width and depth with the
     per-shard MoE dispatch on a (4, 2) mesh, prefill timed against the
     global dispatch, each data shard held to the global dispatch of its
     own tokens (one MoE layer in bf16, the model in float32); e. ``gpipe``
     over Yi-6B's 32 layers in 4 stages of 8, 8 micro-batches of 1 x 512,
     held to the sequential stack and timed beside it; f. ``apply_ef``
     over 8 shards of one Yi-6B layer's gradient-shaped leaves (5.54 GB
     of float32), against the plain mean and over 50 steps; g.
     ``launch.train --reduced --devices 8`` in a subprocess; a ``[mesh]``
     JSON line;
  8e. the launch tail, last (``drive_launch``): a. ``python -m
     repro_torch.launch.dryrun`` for Yi-6B ``train_4k`` on 16 x 16 and
     2 x 16 x 16, Yi-6B ``decode_32k``, Granite-MoE ``train_4k`` and
     Falcon-Mamba ``long_500k`` on 16 x 16, and b. ``python -m
     repro_torch.launch.dryrun_retrieval`` at its defaults, each a
     subprocess on the meta device (all started at once, each record
     ``ok``: seconds, per-chip FLOPs, bytes and wire bytes, the dominant
     term, the roofline fraction, input bytes a device), beside c. one
     1 x 2,048 Yi-6B train step at full width and ``drive_train``'s depth
     counted by ``hlo_analysis.analyze_step`` on the card and on the meta
     device (FLOPs equal, asserted; the bytes' ratio; the counted bound
     against the step's ms; the counted peak live bytes against
     ``max_memory_allocated``); a ``[launch]`` JSON line;
  9. a ``[sharded]`` JSON line (batch ms global / per_shard / single-host,
     routes, churn, merges, checkpoint, skew and padded rows, peak
     memory) and a ``[durability]`` JSON line with the checkpoint and restore times
     and bytes of both churned indexes and the tenants, beside the card's
     name and power limit; a ``{"kernels": [...]}`` JSON line with each
     kernel's launches, times,
     plain and library times and bound (for K1, K6 and K9 the larger of
     the bytes and three TF32 passes on the tensor cores, both terms and
     the CUDA-core term beside it, and the launch layout; for K4 and K7 two
     FP32 instructions a term; K2 from the unsorted candidates, its
     library time ``torch.sort`` of them alone, and over the whole batch
     in one launch beside its 32-query slices; for K2, K4 and K7 also the
     device time of a CUDA graph replay, ``device_ms``); then the last
     line ``{"ok": true, "device": {...}}``.

Each query path's kernel launches are asserted exactly where the path
fixes them: K3 once a batch on every path of every index (over all
frozen segments), K2 once a frozen segment of an LSH group (a shard's
segment on the sharded paths), K5 once a linear group and once for the
delta of an LSH group on a Hamming index, no kernel off its path.  Each hybrid
query's ``torch.profiler`` trace also logs its sort kernels per batch
(the LSH route sorts its candidates inside K2, so none is
``lsh_search``'s) and its kernels per batch (all, ``cat``, index /
gather, ``where``), and a trace of ``estimate()`` its kernels and device
ms per call.

Neighbor sets may differ only in rows whose float64 distance lies within
1e-5 * max(1, |t|) of the threshold t: the kernel and the plain version
round float32 sums in different orders, and the absolute size of that
rounding follows the magnitude of the terms (about 1), not of t.  SimHash
bits may differ only where the float64 projection lies within
1e-5 * sum_i |x_i r_i| of 0, for the same reason.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

# The H100's published peaks (memory bytes/s, fp32 FLOP/s on the CUDA
# cores, TF32 and bf16 FLOP/s on the tensor cores; SXM unless the card
# names itself PCIe): the port's hardware model, one source for both.
from repro_torch.launch.roofline import PEAKS  # noqa: E402

THRESH_EPS = 1e-5
TOL = dict(rtol=3e-4, atol=3e-4)      # distances, kernel vs plain
HLL_RTOL = 1e-5


def log(*a):
    print(*a, flush=True)


def pick_radii(x, metric, n_radii=4, seed=0):
    """Radii at increasing output-size quantiles of the pairwise distance
    distribution (the benchmarks' rule)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    a = x[rng.integers(0, len(x), 2000)]
    b = x[rng.integers(0, len(x), 2000)]
    if metric == "l2":
        d = np.linalg.norm(a - b, axis=1)
    elif metric == "l1":
        d = np.abs(a - b).sum(1)
    elif metric == "hamming":
        d = np.unpackbits((a ^ b).view(np.uint8), axis=1).sum(1)
    else:
        d = 1.0 - (a * b).sum(1) / np.maximum(
            np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1), 1e-9)
    qs = np.quantile(d, [0.0005, 0.005, 0.03, 0.12][:n_radii])
    return [float(q) for q in qs]


class Smoke:
    def __init__(self):
        import numpy as np
        import torch
        from repro_torch.kernels import (bucket_hash, delta_collide,
                                         distances, fused_scan, hamming,
                                         hll_merge, simhash)
        self.np, self.torch = np, torch
        self.dev = torch.device("cuda")
        self.counters = {"linear_scan_dot": fused_scan.linear_scan_dot,
                         "linear_scan_l1": fused_scan.linear_scan_l1,
                         "linear_scan_hamming": fused_scan.linear_scan_hamming,
                         "lsh_scan": fused_scan.lsh_scan,
                         "route_estimate": hll_merge.route_estimate,
                         "route_terms": hll_merge.route_terms,
                         "hll_merge_estimate": hll_merge.hll_merge_estimate,
                         "pairwise_dot": distances.pairwise_dot,
                         "pairwise_l1": distances.pairwise_l1,
                         "hamming": hamming.hamming,
                         "simhash": simhash.simhash,
                         "bucket_hash": bucket_hash.bucket_hash,
                         "delta_collide": delta_collide.delta_collide}
        name = torch.cuda.get_device_name(0)
        self.bw, self.fp32, self.tf32, self.bf16 = PEAKS[
            "pcie" if "PCIe" in name else "sxm"]
        self.flush_buf = torch.empty(64 << 20, dtype=torch.uint8,
                                     device=self.dev)

    # -- counters -----------------------------------------------------
    def reset(self):
        for fn in self.counters.values():
            fn.launches = 0

    def read(self):
        return {k: fn.launches for k, fn in self.counters.items()}

    def path(self, fn):
        """Run ``fn()`` with every count set to 0 just before it; returns
        its result and the counts read just after it."""
        self.reset()
        out = fn()
        self.torch.cuda.synchronize()
        return out, self.read()

    # -- timing -------------------------------------------------------
    def cuda_ms(self, fn, iters=10):
        """Median device ms of ``fn``, L2 flushed before each launch."""
        from dot_tile_ab import cuda_ms
        return cuda_ms(fn, self.flush_buf, iters)

    def graph_ms(self, fn, iters=10):
        """Median device ms of ``fn`` replayed from a CUDA graph, L2
        flushed before each replay (``tools/dot_tile_ab.py``)."""
        from dot_tile_ab import graph_ms
        return graph_ms(fn, self.flush_buf, iters)

    def bound_ms(self, nbytes, flops, rate=None):
        """The larger of ``nbytes`` at the memory rate and ``flops`` at
        ``rate`` (default: the fp32 FLOP/s of the CUDA cores)."""
        tb = nbytes / self.bw * 1e3
        tf = flops / (rate or self.fp32) * 1e3
        return max(tb, tf), ("bytes" if tb >= tf else "operations")

    def bound_l1_ms(self, nbytes, nq, n, d):
        """The L1 tile's bound: acc += |q - x| is two FP32 instructions
        (FADD, then FADD with |.|) a term, issued at half the FMA-counted
        fp32 FLOP/s: 2 Q N d instructions at fp32 / 2 a second."""
        return self.bound_ms(nbytes, 2.0 * nq * n * d, rate=self.fp32 / 2)

    def bound_dot_ms(self, nbytes, nq, n, d):
        """The bound of the dot-form tile (K1, K6; K9 with its L k columns
        as the queries): the larger of the bytes and its 3 x 2 Q N d TF32
        tensor-core operations (three passes make the fp32-exact
        product), with both terms and the CUDA-core term (2 Q N d at the
        fp32 rate) for the record."""
        tb = nbytes / self.bw * 1e3
        tt = 3 * 2.0 * nq * n * d / self.tf32 * 1e3
        return (max(tb, tt), "bytes" if tb >= tt else "operations",
                dict(bound_bytes_ms=tb, bound_tf32_ms=tt,
                     bound_cuda_cores_ms=2.0 * nq * n * d / self.fp32 * 1e3))

    # -- comparisons ----------------------------------------------------
    def masks_agree(self, mk, mp, dist_plain, thresh, what):
        """Kernel and plain report masks may differ only where the plain
        distance is within the distance tolerance of the threshold."""
        off = mk != mp
        if bool(off.any()):
            gap = (dist_plain[off] - thresh).abs()
            lim = TOL["atol"] + TOL["rtol"] * abs(thresh)
            assert bool((gap <= lim).all()), f"{what}: masks differ off the threshold"
            log(f"[{what}] {int(off.sum())} mask entries differ within "
                f"{lim:.1e} of the threshold")

    def dist64(self, metric, q, rows):
        np = self.np
        if metric == "hamming":
            return np.unpackbits((rows ^ q[None, :]).view(np.uint8),
                                 axis=1).sum(1).astype(np.float64)
        q = q.astype(np.float64)
        rows = rows.astype(np.float64)
        if metric == "l2":
            return ((rows - q) ** 2).sum(1)
        if metric == "l1":
            return np.abs(rows - q).sum(1)
        qn = q / max(np.linalg.norm(q), 1e-12)
        rn = rows / np.maximum(np.linalg.norm(rows, axis=1, keepdims=True),
                               1e-12)
        return 1.0 - rn @ qn

    def simhash_flips(self, a, b, x, r_padded, what):
        """Count the bits where packed fingerprints ``a`` and ``b``
        ((N, L, words)) differ; fail unless each such bit's float64
        projection lies within ref.SIMHASH_EPS * sum_i |x_i r_i| of 0."""
        from repro_torch.kernels.ref import simhash_bits_differing
        differ, far = simhash_bits_differing(a, b, x, r_padded)
        assert far == 0, f"{what}: {far} bits differ away from 0"
        return differ

    def off_threshold(self, ids, metric, xq, x, r):
        """Count of ``ids`` away from the threshold (must be 0)."""
        np = self.np
        if not ids:
            return 0
        t = r * r if metric == "l2" else r
        d = self.dist64(metric, xq, x[np.fromiter(ids, np.int64)])
        return int((np.abs(d - t) > THRESH_EPS * max(1.0, abs(t))).sum())

    def compare_sets(self, a, b, metric, q, x, r, what, subset=False):
        """a == b (or a <= b) up to near-threshold rows; returns the
        number of near-threshold exceptions used."""
        near = 0
        for i in a:
            extra = a[i] - b[i]
            missing = set() if subset else b[i] - a[i]
            bad = self.off_threshold(extra | missing, metric, q[i], x, r)
            if bad:
                raise AssertionError(f"{what}: query {i} differs in {bad} "
                                     f"rows away from the threshold")
            near += len(extra | missing)
        return near


# ---------------------------------------------------------------------------
SOURCES = ("hll_merge", "fused_scan", "simhash", "bucket_hash",
           "delta_collide")


def phase_build(s: Smoke):
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    built = _build.build(SOURCES)
    log(f"[build] nvcc wall {time.perf_counter() - t0:.1f} s, per source "
        + ", ".join(f"{k} {sec:.1f} s" for k, (sec, _) in built.items()))
    for name, (_, text) in built.items():
        for kernel, regs, smem, spills in ptxas_table(text):
            log(f"[build] {name} {kernel}: {regs} registers, {smem} B static "
                f"shared memory, {spills} B spilled (stores/loads)")
    for name in SOURCES:
        _build.load(name)


def demangled_kernel(mangled):
    """``name<template args>`` of a mangled kernel: the identifier ending in
    ``_kernel`` whose length prefix fits (Itanium ABI), and the integer
    template arguments."""
    import re
    for m in re.finditer(r"\d+", mangled):
        for i in range(m.start(), m.end()):
            ident = mangled[m.end():m.end() + int(mangled[i:m.end()])]
            if ident.endswith("_kernel") and re.fullmatch(r"[A-Za-z_]\w*", ident):
                args = re.findall(r"L[ib](\d+)E", mangled)
                return ident + (f"<{','.join(args)}>" if args else "")
    return mangled


def ptxas_table(text):
    """(kernel, registers, static shared bytes, spill stores/loads) per
    entry function of nvcc's -Xptxas -v output."""
    import re
    rows, name, spills = [], None, "?"
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = demangled_kernel(m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = f"{m.group(1)}/{m.group(2)}"
            continue
        m = re.search(r"Used (\d+) registers.*?(?:(\d+) bytes smem)?$", line)
        if m and name:
            rows.append((name, int(m.group(1)), int(m.group(2) or 0), spills))
            name, spills = None, "?"
    return rows


def phase_edge_cases(s: Smoke):
    """Kernels vs plain versions on hand-made cases (small, odd shapes)."""
    np, torch, dev = s.np, s.torch, s.dev
    from repro_torch.kernels import ops, ref
    rng = np.random.default_rng(0)
    radii = {"l2": 7.0, "l1": 55.0, "cosine": 0.9, "hamming": 300.0}

    def pair(metric, q, n, d=37):
        if metric == "hamming":
            return (torch.from_numpy(rng.integers(-2**31, 2**31, (q, 3),
                                                  dtype=np.int64)
                                     .astype(np.int32)).to(dev),
                    torch.from_numpy(rng.integers(-2**31, 2**31, (n, 3),
                                                  dtype=np.int64)
                                     .astype(np.int32)).to(dev))
        return (torch.from_numpy(rng.normal(size=(q, d)).astype(np.float32)).to(dev),
                torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(dev))

    dot_flips = dot_edge_cases(s, rng)
    lsh_flips = lsh_edge_cases(s, rng)
    l1_flips = l1_edge_cases(s, rng)
    route_edge_cases(s, rng)
    grouped_edge_cases(s, rng)
    sent = 40
    hand = torch.tensor(np.sort(np.array([
        [0, 0, 0, 1, 2, 2, 5, sent], [3, 7, 7, 9, sent, sent, sent, sent],
        [sent] * 8], np.int32), axis=-1), device=dev)
    for metric in ("l2", "l1", "cosine", "hamming"):
        qa, xa = pair(metric, 3, sent, 254 if metric != "hamming" else 37)
        a = ops.fused_lsh_scan(xa, hand, qa, radii[metric], metric, impl="cuda")
        b = ops.fused_lsh_scan(xa, hand, qa, radii[metric], metric, impl="ref")
        assert torch.equal(a[2], b[2]), metric
        assert not bool(a[2][2].any())
        torch.testing.assert_close(a[1][a[2]], b[1][b[2]], **TOL)
        # odd Q and sentinel tails on random sorted candidates
        qa, xa = pair(metric, 7, 500, 254 if metric != "hamming" else 37)
        ids = torch.sort(torch.from_numpy(rng.integers(0, 560, (7, 300))
                                          .astype(np.int32)).to(dev)).values
        ids = torch.clamp(ids, max=500)
        a = ops.fused_lsh_scan(xa, ids, qa, radii[metric], metric, impl="cuda")
        b = ops.fused_lsh_scan(xa, ids, qa, radii[metric], metric, impl="ref")
        assert torch.equal(a[2], b[2]), metric
        torch.testing.assert_close(a[1][a[2]], b[1][b[2]], **TOL)
    for q, L, m, lo, hi in ((8, 3, 32, 0, 25), (100, 20, 64, 0, 20),
                            (7, 4, 64, 0, 2), (6, 2, 64, 23, 25),
                            (5, 1, 16, 0, 9), (3, 2, 1024, 0, 30)):
        regs = torch.from_numpy(rng.integers(lo, hi, (q, L, m))
                                .astype(np.uint8)).to(dev)
        if hi == 2:                          # small range: mostly zeros
            regs[:, :, m // 8:] = 0
        a = ops.hll_merge_estimate(regs, impl="cuda")
        b = ops.hll_merge_estimate(regs, impl="ref")
        torch.testing.assert_close(a, b, rtol=HLL_RTOL, atol=0)
    # K5: W = 1, 2, 3, 8, 9, 16 words, all-zero codes, odd Q and N, and a
    # threshold equal to an attained distance (equality must report)
    for q, n, w in ((1, 1, 2), (33, 257, 1), (33, 257, 2), (33, 257, 3),
                    (65, 1000, 2), (7, 300, 8), (33, 257, 9), (5, 129, 16)):
        qa = torch.from_numpy(rng.integers(-2**31, 2**31, (q, w),
                                           dtype=np.int64).astype(np.int32)).to(dev)
        xa = torch.from_numpy(rng.integers(-2**31, 2**31, (n, w),
                                           dtype=np.int64).astype(np.int32)).to(dev)
        qa[0] = 0
        xa[0] = 0
        tie = int(ops.fused_linear_scan(qa, xa, 0.0, "hamming",
                                        impl="ref")[1][-1, n // 2])
        a = ops.fused_linear_scan(qa, xa, float(tie), "hamming", impl="cuda")
        b = ops.fused_linear_scan(qa, xa, float(tie), "hamming", impl="ref")
        for u, v in zip(a, b):
            assert torch.equal(u, v.contiguous()), ("K5", q, n, w)
        assert bool(a[2][-1, n // 2]) and float(a[1][0, 0]) == 0.0
    # K6 / K7: Q or N = 1, d = 37 and 254, an all-zero row on each side
    # (cosine's 1e-12 norm clamp), f16 inputs (cast to float32 first)
    for metric in ("l2", "cosine", "l1"):
        for q, n, d, dt in ((1, 129, 37, np.float32), (65, 1, 254, np.float32),
                            (33, 257, 254, np.float32),
                            (100, 1000, 37, np.float32),
                            (16, 64, 32, np.float16)):
            qa = torch.from_numpy(rng.normal(size=(q, d)).astype(dt)).to(dev)
            xa = torch.from_numpy(rng.normal(size=(n, d)).astype(dt)).to(dev)
            qa[0] = 0
            xa[-1] = 0
            a = ops.pairwise_dist(qa, xa, metric, impl="cuda")
            b = ops.pairwise_dist(qa, xa, metric, impl="ref")
            assert a.dtype == torch.float32 and a.shape == (q, n)
            torch.testing.assert_close(a, b, **TOL)
    # K8: W = 1, 2, 3, 8, 9, 16 words (chunks of 8 and a partial chunk),
    # Q or N = 1, a pair of equal codes
    for q, n, w in ((1, 1, 1), (33, 257, 2), (7, 300, 3), (65, 1000, 8),
                    (100, 513, 9), (3, 129, 16), (1, 700, 16)):
        qa = torch.from_numpy(rng.integers(-2**31, 2**31, (q, w),
                                           dtype=np.int64).astype(np.int32)).to(dev)
        xa = torch.from_numpy(rng.integers(-2**31, 2**31, (n, w),
                                           dtype=np.int64).astype(np.int32)).to(dev)
        xa[0] = qa[0]
        a = ops.hamming_dist(qa, xa, impl="cuda")
        b = ops.hamming_dist(qa, xa, impl="ref")
        assert a.dtype == torch.int32 and torch.equal(a, b), ("K8", q, n, w)
        assert int(a[0, 0]) == 0
    # K9: k = 1, 4, 8, 16 (1, 4, 8, 16 lane columns a word), 21, 31, 32,
    # 40, 64 (padded and whole words, two words), d = 37 and 254, N = 1, a
    # zero row (every projection 0.0: bit 0)
    flips = 0
    for n, d, L, k in ((1, 37, 3, 8), (130, 37, 5, 31), (257, 254, 2, 32),
                       (1000, 254, 4, 40), (65, 48, 1, 64), (999, 254, 20, 21),
                       (97, 37, 7, 1), (1000, 254, 20, 4), (64, 37, 3, 16)):
        xa = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(dev)
        ra = torch.from_numpy(rng.normal(size=(d, L * k)).astype(np.float32)).to(dev)
        xa[0] = 0
        a = ops.simhash_fingerprint(xa, ra, L, k, impl="cuda")
        b = ops.simhash_fingerprint(xa, ra, L, k, impl="ref")
        assert a.dtype == torch.int64 and a.shape == (n, L, (k + 31) // 32)
        assert not bool(a[0].any())
        flips += s.simhash_flips(a, b, xa, ops.pad_projection(ra, L, k),
                                 f"K9 n={n} d={d} L={L} k={k}")
    flips += simhash_edge_cases(s, rng)
    torch.cuda.synchronize()
    log(f"[edge] K1 / K6 (the dot-form tile, l2 and cosine: Q = 1-129, N = 1 "
        f"and ragged tiles, d = 1, 3, 32, 37, 54, 254, 256, 4,095, 4,096 "
        f"(Q = 64, N = 8,192: the retrieval service's), x[1:] and 4-byte "
        f"offset views, zero rows, rows within 1e-4 of the threshold; "
        f"{dot_flips} masks differ from the plain version, all within "
        f"{THRESH_EPS:g} of the threshold)")
    log(f"[edge] K2 fused (sort, dedup, gather, verify from unsorted ids: "
        f"ids at split boundaries, one split, one repeated id, C = 1-60,001, "
        f"n = 1-80,000, d = 1-254 and 4,095-4,096 (Q = 64, C = 2,560, "
        f"n = 8,192), W = 1-129, cosine on x and on unit rows): "
        f"ids equal torch.sort's; "
        f"{lsh_flips} masks differ, all within {THRESH_EPS:g} of the "
        f"threshold")
    log("[edge] K3 route estimate (ROUTE_CASES: S = 1-65 segments, two "
        "launches past 64, V = L and L T, m = 16-1,024, Q = 1-257, no "
        "tombstones, a segment of dead rows): collisions exact, estimates "
        f"within {HLL_RTOL:g} of the plain version and bit for bit the "
        "per-segment composition of its one-segment case; its terms mode "
        "(route_terms) on the same cases: collisions, dead counts and "
        "merged registers bit for bit the plain version's")
    log("[edge] K5 grouped Hamming scan (GROUPED_CASES: S = 1-71 segments, "
        "Q = 1-100, W = 1, 2, 3, 4, 8, 9, 16, odd sums of rows, a segment of "
        "dead rows, static and streaming epilogues): ids, distances and "
        "masks equal the plain version's")
    log(f"[edge] K4 / K7 (the L1 tile: Q = 1-129, N = 1-4,097, d = 1, 37, 54, "
        f"64, 65, 400, x[1:] and 4-byte offset views): {l1_flips} masks "
        f"differ, all within {THRESH_EPS:g} of the threshold")
    log("[edge] K1 (l2, cosine), K2 (sorted ids, l2, l1, cosine, hamming), "
        "K3, K5 (W = 1, 2, 3, 8, 9, 16; ties; zero codes), K6 / K7 "
        "(Q or N = 1, d = 37 and 254, zero rows, f16), K8 (W = 1, 2, 3, 8, "
        "9, 16) and K9 (k = 1, 4, 8, 16, 21, 31, 32, 40, 64; SIMHASH_CASES: "
        "both loaders, 4-byte offset and x[1:] views, d = 1, 3, 7, 1,000, "
        "ragged tiles, rows beside +Inf rows) match their plain versions on "
        f"the hand-made cases; K9 bits within {ref.SIMHASH_EPS:g} of 0 that "
        f"differ: {flips}")


# The bucket hash at the cells' query shapes: 1,024 queries, L = 20;
# Webspam's SimHash (d = 254) at k across one, two and three words, and
# CoverType's p-stable L1 (d = 54, k = 8, w = 2.2).
BUCKET_HASH_SHAPES = {"webspam d=254 k=8": ("cosine", 254, 8),
                      "webspam d=254 k=40": ("cosine", 254, 40),
                      "webspam d=254 k=70": ("cosine", 254, 70),
                      "covertype d=54 k=8": ("l1", 54, 8)}


def device_launches(s: Smoke, fn, reps=5, kernel=None):
    """Device kernels and copies a call of ``fn`` runs, by the profiler,
    and the device ms a call of the kernels whose name holds ``kernel``."""
    torch = s.torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    own = sum(e.self_device_time_total for e in dev
              if kernel is not None and kernel in e.key) / reps / 1e3
    return sum(e.count for e in dev) / reps, own


def host_ms(s: Smoke, fn, reps=200):
    """Host ms a call of ``fn`` takes to return, the queue kept short by a
    synchronise every 10 calls (the index hashes one batch at a time)."""
    torch = s.torch
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for i in range(reps):
        t0 = time.perf_counter()
        fn()
        total += time.perf_counter() - t0
        if i % 10 == 9:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return total / reps * 1e3


def phase_bucket_hash(s: Smoke):
    """The bucket hash kernel (``csrc/bucket_hash.cu``) beside its plain
    version at the cells' query shapes (``BUCKET_HASH_SHAPES``): the ids
    of ``bucket_ids`` on the kernel path equal to ``impl="ref"``'s bit for
    bit, and to the plain chain on one projection; the kernel launches a
    call of each path makes (``Smoke.path``: one on the kernel path, none
    on the plain one); the kernel's ms (events), device ms (graph replay)
    beside its bound (bytes: the projection read, the ids written);
    ``bucket_ids``' ms and host ms on both paths, and the device kernels
    and copies a call runs on each, and the kernel's own device ms by the
    profiler.  Logs a ``[bucket_hash]`` JSON line; returns the rows by
    shape (the kernel table's row is the CoverType one: the main path's
    front end, ``main``)."""
    np, torch, dev = s.np, s.torch, s.dev
    from repro_torch.core.lsh import families as F
    from repro_torch.kernels import bucket_hash as bh
    rng = np.random.default_rng(28)
    n, L, B = 1024, 20, 65536
    rows = {}
    for tag, (metric, d, k) in BUCKET_HASH_SHAPES.items():
        if metric == "cosine":
            fam = F.SimHash(d=d, L=L, k=k)
            x = rng.normal(size=(n, d))
        else:
            fam = F.PStableL1(d=d, L=L, k=k, w=2.2)
            x = rng.random((n, d)) * 4.0
        x = torch.from_numpy(x.astype(np.float32)).to(dev)
        params = fam.init(torch.Generator().manual_seed(28), device=dev)
        got, launches = s.path(lambda: fam.bucket_ids(params, x, B))
        assert launches == {c: int(c == "bucket_hash") for c in launches}, (
            tag, launches)
        want, plain_launches = s.path(
            lambda: fam.bucket_ids(params, x, B, impl="ref"))
        assert not any(plain_launches.values()), (tag, plain_launches)
        assert torch.equal(got, want), f"{tag}: bucket ids differ"
        proj = x @ params["R" if metric == "cosine" else "a"]
        if metric == "cosine":
            def kernel():
                return bh.bucket_hash(proj, B, "sign", k=k)
            words = F._pack_bits((proj > 0).reshape(n, L, k))
        else:
            def kernel():
                return bh.bucket_hash(proj, B, "floor", k=k, b=params["b"],
                                      w=fam.w)
            words = fam._floors(proj, params)
        assert torch.equal(kernel(), F._mix_words_to_bucket(words, B)), tag
        nbytes = proj.numel() * 4 + n * L * 4 + (
            0 if metric == "cosine" else L * k * 4)
        bound, by = s.bound_ms(nbytes, 0.0)
        path = lambda: fam.bucket_ids(params, x, B)            # noqa: E731
        plain = lambda: fam.bucket_ids(params, x, B, impl="ref")  # noqa: E731
        rows[tag] = {
            "ms": s.cuda_ms(kernel), "device_ms": s.graph_ms(kernel),
            "bound_ms": bound, "bound_by": by, "bytes": nbytes,
            "max_abs_err": int((got != want).sum()),
            "max_abs_err_unit": "bucket ids that differ from the plain path",
            "library_ms": None,
            "bucket_ids_ms": s.cuda_ms(path), "plain_ms": s.cuda_ms(plain),
            "bucket_ids_host_ms": host_ms(s, path),
            "plain_host_ms": host_ms(s, plain),
            "launches_a_call": launches["bucket_hash"],
            "plain_device_ops_a_call": device_launches(s, plain)[0],
            "shape": f"{n} x {d} -> ({n}, {L}), k = {k}"}
        r = rows[tag]
        r["device_ops_a_call"], r["profiled_ms"] = device_launches(
            s, path, kernel="bucket_hash_kernel")
        log(f"[bucket_hash] {tag}: kernel {r['ms']:.4f} ms (device "
            f"{r['device_ms']:.4f}, profiled {r['profiled_ms']:.4f}), bound "
            f"{bound:.2g} ({by}); bucket_ids "
            f"{r['bucket_ids_ms']:.4f} ms, host {r['bucket_ids_host_ms']:.4f}"
            f" ms, {r['device_ops_a_call']:g} device ops; plain "
            f"{r['plain_ms']:.4f} ms, host {r['plain_host_ms']:.4f} ms, "
            f"{r['plain_device_ops_a_call']:g} device ops")
    log("[bucket_hash] " + json.dumps(rows))
    return rows


# the delta's collision test at the CoverType batch against a delta of
# 8,192 slots: probes a table (1: p-stable, V = 20; 4: SimHash's
# multi-probe, V = 80) by the rows the delta holds
DELTA_COLLIDE_PROBES = {"single probe": 1, "multi-probe T=4": 4}
DELTA_COLLIDE_COUNTS = (0, 1024, 8192)


def phase_delta_collide(s: Smoke):
    """The delta's collision test kernel (``csrc/delta_collide.cu``)
    beside its plain chain at the CoverType cell's batch (1,024 queries,
    L = 20, ``torch_cases.DELTA_FULL``'s delta of 8,192 slots, bucket ids
    from 64 values so that queries collide) holding 0, 1,024 and 8,192
    rows, single-probe and with 4 probes a table: both modes bit-equal to
    the plain chain over the rows held and to the full-capacity chain
    (every slot: what the port ran before the kernel); one launch a call
    with rows, none without (``Smoke.path``); the kernel's ms (events)
    and device ms (graph replay), L2 flushed, beside its bound (the
    compares, one integer instruction each at the CUDA cores' 33.5 T a
    second, or the bytes: buckets, live flags and outputs once); the
    plain chain's and the full-capacity chain's ms.  Logs a
    ``[delta_collide]`` JSON line; returns the rows by shape (the kernel
    table's row: single probe, 8,192 rows, counts)."""
    torch, dev = s.torch, s.dev
    from repro_torch.kernels import ops
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_cases import DELTA_FULL, delta_case, delta_full_chain
    C, L, nq = DELTA_FULL["C"], DELTA_FULL["L"], DELTA_FULL["nq"]
    rows = {}
    for ptag, probes in DELTA_COLLIDE_PROBES.items():
        for n in DELTA_COLLIDE_COUNTS:
            delta, _, qb, tidx = delta_case(n, probes, dev, seed=n,
                                            **DELTA_FULL)
            rb, live = delta.bucket_ids[:n], delta.live[:n]
            v = qb.shape[1]
            for mode in ("counts", "mask"):
                def kernel(mode=mode):
                    return ops.delta_collide(qb, rb, live, tidx, mode)

                def plain(mode=mode):
                    return ops.delta_collide(qb, rb, live, tidx, mode,
                                             impl="ref")

                def full(mode=mode):
                    return delta_full_chain(delta, qb, tidx, mode)
                tag = f"{ptag} n={n} {mode}"
                got, launches = s.path(kernel)
                assert launches == {c: int(c == "delta_collide" and n > 0)
                                    for c in launches}, (tag, launches)
                want, was = plain(), full()
                if mode == "mask":
                    assert torch.equal(got, want), tag
                    assert torch.equal(got, was[:, :n]), tag
                else:
                    for a, b, c in zip(got, want, was):
                        assert torch.equal(a, b) and torch.equal(a, c), tag
                nbytes = (4 * nq * v + 4 * n * L + n
                          + (0 if tidx is None else 4 * v)
                          + (nq * n if mode == "mask" else 8 * nq))
                bound, by = s.bound_ms(nbytes, nq * n * v, rate=s.fp32 / 2)
                rows[tag] = {
                    "ms": s.cuda_ms(kernel),
                    "device_ms": s.graph_ms(kernel) if n else None,
                    "bound_ms": bound, "bound_by": by, "bytes": nbytes,
                    "compares": nq * n * v, "max_abs_err": 0,
                    "max_abs_err_unit": "counts or mask entries that "
                                        "differ from the plain chain",
                    "plain_ms": s.cuda_ms(plain),
                    "full_capacity_ms": s.cuda_ms(full), "library_ms": None,
                    "launches_a_call": launches["delta_collide"],
                    "hits": int(got.sum() if mode == "mask"
                                else got[0].sum()),
                    "shape": f"Q={nq} n={n} of C={C} V={v} L={L} {mode}"}
                r = rows[tag]
                log(f"[delta_collide] {tag}: kernel {r['ms']:.4f} ms "
                    f"(device {r['device_ms']}), bound {bound:.2g} ({by}); "
                    f"plain {r['plain_ms']:.4f} ms over the rows held, "
                    f"{r['full_capacity_ms']:.4f} ms over all {C + 1} slots")
                del got, want, was
            del delta, qb, rb, live
            torch.cuda.empty_cache()
    log("[delta_collide] " + json.dumps(rows))
    return rows


def simhash_edge_cases(s, rng):
    """K9 on the GPU tests' ``SIMHASH_CASES`` (``tests/torch_cases.py``):
    the loader the plan picks, one launch, bits within the band of the
    plain version's on every row but the +Inf rows.  Returns the number
    of bits that differ."""
    torch = s.torch
    from repro_torch.kernels import ops, simhash
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_cases import SIMHASH_CASES, simhash_inputs
    flips = 0
    for n, d, L, k, view, inf_rows, mode in SIMHASH_CASES:
        what = f"K9 n={n} d={d} L={L} k={k} {view} inf={inf_rows}"
        x, r = simhash_inputs(n, d, L, k, view, inf_rows, rng, s.dev)
        got = simhash.plan(x, L, k)["mode"]
        assert got == mode, f"{what}: loader {got}, want {mode}"
        a, launches = s.path(lambda: ops.simhash_fingerprint(x, r, L, k,
                                                             impl="cuda"))
        assert launches == {c: int(c == "simhash") for c in launches}, what
        b = ops.simhash_fingerprint(x, r, L, k, impl="ref")
        assert not bool(a[0].any()), what
        keep = torch.ones(n, dtype=torch.bool, device=s.dev)
        keep[list(inf_rows)] = False
        flips += s.simhash_flips(a[keep], b[keep], x[keep],
                                 ops.pad_projection(r, L, k), what)
    return flips


def dot_edge_cases(s, rng):
    """K1 through ``ops.fused_linear_scan`` and K6 (``pairwise_dot``) in
    l2 and cosine on the GPU tests' cases (``tests/torch_cases.py``
    DOT_CASES: zero rows, rows within 1e-4 of the threshold, corpus
    views): one launch each, exact ids, distances within TOL, and report
    masks that differ from the plain version's, or from the float64
    distance's, only within THRESH_EPS * max(1, |t|) of the threshold t.
    Returns the number of masks that differ."""
    np, torch = s.np, s.torch
    from repro_torch.kernels import distances, fused_scan, ops, ref
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_cases import (DOT_CASES, dist64, dot_inputs,
                             masks_outside_band_agree, on_device, unit_rows_np)
    flips = 0
    for q, n, d, view in DOT_CASES:
        for metric in ("l2", "cosine"):
            qa, xa, t = dot_inputs(metric, q, n, d, rng)
            r = t if metric == "cosine" else float(np.sqrt(t))
            qt, xt = torch.from_numpy(qa).to(s.dev), on_device(xa, view, s.dev)
            xu = (on_device(unit_rows_np(xa), view, s.dev)
                  if metric == "cosine" else None)
            what = f"K1 {metric} Q={q} N={n} d={d} {view}"
            before = fused_scan.linear_scan_dot.launches
            a = ops.fused_linear_scan(qt, xt, r, metric, impl="cuda", x_unit=xu)
            assert fused_scan.linear_scan_dot.launches == before + 1, what
            b = ops.fused_linear_scan(qt, xt, r, metric, impl="ref")
            assert torch.equal(a[0], b[0].contiguous()), what
            torch.testing.assert_close(a[1], b[1], **TOL)
            mk, mp = a[2].cpu().numpy(), b[2].cpu().numpy()
            masks_outside_band_agree(mk, mp, dist64(metric, qa, xa), t)
            flips += int((mk != mp).sum())
            before = distances.pairwise_dot.launches
            if metric == "cosine":
                c = distances.pairwise_dot(ref.unit_rows(qt).contiguous(), xu,
                                           None, None, mode="cosine")
            else:
                c = ops.pairwise_dist(qt, xt, "l2", impl="cuda")
            assert distances.pairwise_dot.launches == before + 1, what
            torch.testing.assert_close(
                c, ops.pairwise_dist(qt, xt, metric, impl="ref"), **TOL)
    return flips


def route_edge_cases(s, rng):
    """K3 (``ops.route_estimate``) on the GPU tests' cases
    (``tests/torch_cases.py`` ROUTE_CASES): one launch per 64 segments,
    collisions equal to the plain version's, estimates within HLL_RTOL of
    it and bit for bit the per-segment composition of the kernel's
    one-segment case (the engine's estimate before the kernel took all
    segments); K3's terms mode (``ops.route_terms``) on the same cases
    (m = 16 to 1,024, 1 to 65 segments, with and without tombstones,
    multi-probe, Q = 1 to 257): one launch per 64 segments, every output
    bit for bit the plain version's."""
    torch = s.torch
    from repro_torch.kernels import hll_merge, ops
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_cases import (ROUTE_CASES, route_estimate_per_segment,
                             route_tables)

    def on(a):
        return None if a is None else torch.from_numpy(a).to(s.dev)

    for case in ROUTE_CASES:
        qb, tidx, segs = route_tables(*case, rng)
        qb, tidx = on(qb), on(tidx)
        tables = [ops.TableTerms(*(on(a) for a in seg)) for seg in segs]
        before = hll_merge.route_estimate.launches
        coll, cand = ops.route_estimate(qb, tables, tidx, impl="cuda")
        assert hll_merge.route_estimate.launches == before + -(-len(segs) // 64), case
        pc, pe = ops.route_estimate(qb, tables, tidx, impl="ref")
        assert torch.equal(coll, pc), ("K3", case)
        torch.testing.assert_close(cand, pe, rtol=HLL_RTOL, atol=0)
        wc, we = route_estimate_per_segment(
            qb, tables, tidx, lambda r: ops.hll_merge_estimate(r, impl="cuda"))
        assert torch.equal(coll, wc) and torch.equal(cand, we), ("K3", case)
        before = hll_merge.route_terms.launches
        got = ops.route_terms(qb, tables, tidx, impl="cuda")
        assert hll_merge.route_terms.launches == before + -(-len(segs) // 64), case
        for a, b in zip(got, ops.route_terms(qb, tables, tidx, impl="ref")):
            assert a.dtype == b.dtype and torch.equal(a, b), ("K3 terms", case)


def grouped_edge_cases(s, rng):
    """K5 (``ops.grouped_linear_scan``, Hamming) on the GPU tests' cases
    (``tests/torch_cases.py`` GROUPED_CASES): one launch per 64 segments,
    ids, distances and masks equal to the plain version's."""
    np, torch = s.np, s.torch
    from repro_torch.kernels import fused_scan, ops
    from repro_torch.kernels.ref import EXT_SENTINEL
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_cases import GROUPED_CASES, grouped_parts

    def on(a):
        return None if a is None else torch.from_numpy(a).to(s.dev)

    for q, w, sizes, kind in GROUPED_CASES:
        qa, parts, t = grouped_parts(q, w, sizes, kind, rng)
        qt = on(qa.view(np.int32))
        tparts = [ops.ScanPart(on(x.view(np.int32)), on(live), on(ext))
                  for x, live, ext in parts]
        what = ("K5", q, w, len(sizes), kind)
        before = fused_scan.linear_scan_hamming.launches
        a = ops.grouped_linear_scan(qt, tparts, t, "hamming", impl="cuda")
        assert fused_scan.linear_scan_hamming.launches == \
            before + -(-len(sizes) // 64), what
        b = ops.grouped_linear_scan(qt, tparts, t, "hamming", impl="ref")
        for u, v in zip(a, b):
            assert u.dtype == v.dtype and torch.equal(u, v), what
        if kind == "dead":
            assert not bool(a[2][:, :sizes[0]].any()), what
            assert bool((a[0][:, :sizes[0]] == EXT_SENTINEL).all()), what


def lsh_edge_cases(s, rng):
    """The fused K2 through ``ops.fused_lsh_scan_unsorted`` on the GPU
    tests' cases (``tests/torch_cases.py`` LSH_CASES): one launch each,
    ids equal to ``torch.sort``'s, masks equal to the plain version's off
    the THRESH_EPS band, distances within TOL under both masks.  Returns
    the number of masks that differ."""
    torch = s.torch
    from repro_torch.kernels import fused_scan, ops, ref
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_cases import (LSH_CASES, as_tensor, lsh_dist64, lsh_inputs,
                             masks_outside_band_agree)
    flips = 0
    for metric, d, n, q, c, kind in LSH_CASES:
        dtype = torch.int32 if metric == "hamming" else torch.float32
        width = fused_scan.lsh_scan_plan(
            torch.empty((n, d), dtype=dtype, device=s.dev), q, c)["width"]
        qa, xa, ids, t, r = lsh_inputs(metric, d, n, q, c, kind, width, rng)
        args = (as_tensor(xa).to(s.dev), torch.from_numpy(ids).to(s.dev),
                as_tensor(qa).to(s.dev), r, metric)
        what = f"K2 {metric} n={n} Q={q} C={c} d={d} {kind}"
        b = ops.fused_lsh_scan_unsorted(*args, impl="ref")
        d64 = lsh_dist64(metric, qa, xa, b[0].cpu().numpy())
        # cosine on x (ops scales the rows) and on the unit rows the indexes keep
        for x_unit in ([None, ref.unit_rows(args[0]).contiguous()]
                       if metric == "cosine" else [None]):
            before = fused_scan.lsh_scan.launches
            a = ops.fused_lsh_scan_unsorted(*args, impl="cuda", x_unit=x_unit)
            assert fused_scan.lsh_scan.launches == before + 1, what
            assert torch.equal(a[0], b[0]), what
            mk, mp = a[2].cpu().numpy(), b[2].cpu().numpy()
            masks_outside_band_agree(mk, mp, d64, t)
            flips += int((mk != mp).sum())
            both = a[2] & b[2]
            torch.testing.assert_close(a[1][both], b[1][both], **TOL)
    return flips


def l1_edge_cases(s, rng):
    """K4 (``ops.fused_linear_scan``) and K7 (``ops.pairwise_dist``) on the
    GPU tests' L1 cases (``tests/torch_cases.py`` L1_CASES): one launch
    each, exact ids, distances within TOL, masks equal to the plain
    version's off the THRESH_EPS band.  Returns the masks that differ."""
    torch = s.torch
    from repro_torch.kernels import distances, fused_scan, ops
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_cases import (L1_CASES, dist64, l1_inputs,
                             masks_outside_band_agree, on_device)
    flips = 0
    for q, n, d, view in L1_CASES:
        qa, xa, t = l1_inputs(q, n, d, rng)
        qt, xt = torch.from_numpy(qa).to(s.dev), on_device(xa, view, s.dev)
        what = f"K4 Q={q} N={n} d={d} {view}"
        before = fused_scan.linear_scan_l1.launches
        a = ops.fused_linear_scan(qt, xt, t, "l1", impl="cuda")
        assert fused_scan.linear_scan_l1.launches == before + 1, what
        b = ops.fused_linear_scan(qt, xt, t, "l1", impl="ref")
        assert torch.equal(a[0], b[0].contiguous()), what
        torch.testing.assert_close(a[1], b[1], **TOL)
        mk, mp = a[2].cpu().numpy(), b[2].cpu().numpy()
        masks_outside_band_agree(mk, mp, dist64("l1", qa, xa), t)
        flips += int((mk != mp).sum())
        before = distances.pairwise_l1.launches
        c = ops.pairwise_dist(qt, xt, "l1", impl="cuda")
        assert distances.pairwise_l1.launches == before + 1, what
        torch.testing.assert_close(c, b[1], **TOL)
    return flips


CALIBRATE = (("cosine", 254, "webspam"), ("l2", 32, "corel"),
             ("l1", 54, "covertype"))


def phase_calibrate(s: Smoke, by_path):
    """``calibrate`` on the card for each metric's dimension: beta/alpha
    beside the paper's preset, and the distance kernel launched a warm-up
    and 5 times inside each call (counts set to 0 just before it and read
    just after).  Then the kernel against its plain version, timed, at
    the shape calibrate gives it.  Returns the calibrated models and the
    kernel times at that shape."""
    torch = s.torch
    from repro_torch.core import PAPER_PRESETS, calibrate
    models, at_probe = {}, {}
    for metric, d, data in CALIBRATE:
        kernel = "pairwise_l1" if metric == "l1" else "pairwise_dot"
        t0 = time.perf_counter()
        cm, launches = s.path(lambda: calibrate(d, metric))
        sec = time.perf_counter() - t0
        want = {k: 6 if k == kernel else 0 for k in launches}
        assert launches == want, f"calibrate {metric}: launches {launches}"
        by_path[f"calibrate {metric}"] = {"calibrate": launches}
        models[data] = cm
        preset = PAPER_PRESETS[data]
        log(f"[calibrate] {metric} d={d}: beta/alpha {cm.beta / cm.alpha:.6g} "
            f"(the paper's {data} preset {preset.beta / preset.alpha:g}); "
            f"{kernel} launches {launches[kernel]}; {sec:.3f} s")
        gen = torch.Generator(device=s.dev).manual_seed(1)
        q = torch.randn((64, d), generator=gen, device=s.dev)
        x = torch.randn((4096, d), generator=gen, device=s.dev)
        at_probe[metric] = pairwise_times(s, q, x, metric)
    log_kernel_times("calibrate", {f"{m} at calibrate's shape": v
                                   for m, v in at_probe.items()})
    return models, at_probe


PATHS = {None: "hybrid", "lsh": "lsh", "linear": "linear"}
LINEAR_KERNEL = {"l2": "linear_scan_dot", "cosine": "linear_scan_dot",
                 "l1": "linear_scan_l1", "hamming": "linear_scan_hamming"}


def check_path_launches(launches, n_lsh, n_linear, metric, what,
                        delta_rows=0, traced=0, segments=1):
    """Each kernel launches on a path exactly when that path has work for
    it: K3 (``route_estimate``, over all segments) and the bucket hash
    (the query batch's ids) exactly once a batch; K2 once for each of the
    index's ``segments`` frozen segments when queries go to LSH (the whole
    LSH group in one launch); the metric's linear scan when queries go to the linear scan or,
    on a streaming index whose delta holds rows (``delta_rows``), on
    every path (the delta scan) -- for Hamming (K5, over all segments)
    exactly once a linear group and once for the delta of an LSH group;
    with delta rows, the delta's collision test once for its counts, once
    for an LSH group's mask and once more in a ``traced`` batch (its
    candidate count); no other kernel ever (an empty delta launches
    nothing)."""
    lin = LINEAR_KERNEL[metric]
    held = delta_rows > 0
    want = {k: 0 for k in launches}       # None: at least one launch
    want.update({"route_estimate": 1, "bucket_hash": 1,
                 "lsh_scan": segments if n_lsh else 0,
                 "delta_collide": int(held) * (1 + int(n_lsh > 0) + traced)})
    if metric == "hamming":
        want[lin] = int(n_linear > 0) + int(held and n_lsh > 0)
    else:
        want[lin] = None if n_linear > 0 or held else 0
    for k, w in want.items():
        got = launches[k]
        assert (got > 0) if w is None else got == w, (
            f"{what}: kernel {k} launched {got} times with {n_lsh} queries "
            f"routed to LSH, {n_linear} to the linear scan and {delta_rows} "
            f"rows in the delta")


def traced_batches(idx):
    """Query batches the index's tracer has traced (a traced batch counts
    its candidates, the delta's collision test once more)."""
    tracer = idx._engine.tracer
    return 0 if tracer is None else tracer.summary()["batches_traced"]


def query_paths(s: Smoke, idx, q_np, r, metric, tag, delta=False):
    """Query force None / "lsh" / "linear" through the kernels, the
    launch counts set to 0 just before each path and read just after
    it (``delta``: a streaming index, whose delta's rows count).
    Returns the results and the per-path launch counts, those of the
    delta's collision test as an untraced batch makes them (a batch the
    index's tracer samples runs it once more, for its candidate count)."""
    torch = s.torch
    nq = len(q_np)
    rows = idx.delta.count if delta else 0
    segments = idx.index_stats()["segments"] if delta else 1
    res, launches, traced = {}, {}, {}
    for f, path in PATHS.items():
        t0 = traced_batches(idx)
        s.reset()
        res[f] = idx.query(q_np, r, force=f)
        torch.cuda.synchronize()
        launches[path] = s.read()
        traced[path] = traced_batches(idx) - t0
    n_lsh = len(res[None].lsh_idx)
    check_path_launches(launches["hybrid"], n_lsh, nq - n_lsh, metric,
                        f"{tag} hybrid", rows, traced["hybrid"], segments)
    check_path_launches(launches["lsh"], nq, 0, metric, f"{tag} lsh", rows,
                        traced["lsh"], segments)
    check_path_launches(launches["linear"], 0, nq, metric, f"{tag} linear",
                        rows, traced["linear"], segments)
    for path, n in traced.items():       # as an untraced batch launches
        launches[path]["delta_collide"] -= n * int(rows > 0)
    return res, launches


def check_results(s: Smoke, res, ref_res, x_np, q_np, metric, r, tag):
    """Kernel sets == plain sets per path (the hybrid where both routed
    a query the same way: routes may differ only at a cost tie), LSH
    sets within linear sets, each hybrid result == its route's, finite
    reported distances.  Returns the near-threshold exception counts."""
    np, torch = s.np, s.torch
    sets = {f: v.neighbor_sets() for f, v in res.items()}
    ref_sets = {f: v.neighbor_sets() for f, v in ref_res.items()}
    kr, pr = res[None].route, ref_res[None].route
    split = (kr.use_lsh != pr.use_lsh).cpu().numpy()
    tie = ((pr.lsh_cost - pr.linear_cost).abs()
           <= 1e-5 * pr.linear_cost).cpu().numpy()
    assert not (split & ~tie).any(), f"{tag}: routes differ off a cost tie"
    same = [i for i in range(len(split)) if not split[i]]
    near = {"route ties": int(split.sum())}
    for f in (None, "lsh", "linear"):
        a, b = sets[f], ref_sets[f]
        if f is None:
            a, b = {i: a[i] for i in same}, {i: b[i] for i in same}
        near[f"kernel=plain {f}"] = s.compare_sets(
            a, b, metric, q_np, x_np, r, f"{tag} force={f}")
    near["lsh<=linear"] = s.compare_sets(sets["lsh"], sets["linear"], metric,
                                         q_np, x_np, r, f"{tag} lsh<=linear",
                                         subset=True)
    use = res[None].route.use_lsh.cpu().numpy()
    routed = {i: sets["lsh"][i] if use[i] else sets["linear"][i]
              for i in range(len(use))}
    near["hybrid=route"] = s.compare_sets(sets[None], routed, metric, q_np,
                                          x_np, r, f"{tag} hybrid=route")
    for f, v in res.items():
        for out in (v.lsh_out, v.lin_out):
            if out is not None:
                assert bool(torch.isfinite(out[1][out[2]]).all()), (tag, f)
    return sets, near


def time_hybrid(s: Smoke, idx, q_np, r, reps=5):
    """Median host-clock ms of a synchronised hybrid query."""
    return time_query(s, lambda: idx.query(q_np, r), reps)


def time_query(s: Smoke, fn, reps=5):
    """Median host-clock ms of ``fn()`` between two synchronisations."""
    torch = s.torch
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def profile_hybrid(s: Smoke, idx, q_np, r, tag, ms, reps=3):
    """Trace ``reps`` synchronised hybrid queries with ``torch.profiler``:
    the device's busy time per query (the sum of its kernels' own times;
    one stream, so they do not overlap), its share of the untraced
    host-clock time ``ms`` (the profiler slows the host, not the
    device), and the kernels that took most of it; on the host, the
    device-to-host scalar reads (each a synchronisation) and the ops
    with the most self time."""
    torch = s.torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            idx.query(q_np, r)
        torch.cuda.synchronize()
        traced = (time.perf_counter() - t0) / reps * 1e3
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev) / reps / 1e3
    if busy == 0.0:
        log(f"[{tag} profile] the profiler saw no device time; device busy "
            f"share not measured")
        return
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:6]
    sorts = [e for e in dev if "sort" in e.key.lower()]
    from phase_profile import census
    log(f"[{tag} profile] kernels per query: {census(dev, reps)}")
    log(f"[{tag} profile] sort kernels per query: "
        f"{sum(e.count for e in sorts) / reps:g}"
        + "".join(f"; {e.key[:48]} x{e.count / reps:g} "
                  f"{e.self_device_time_total / reps / 1e3:.3f} ms"
                  for e in sorts))
    log(f"[{tag} profile] device busy {busy:.3f} ms per query: "
        f"{busy / ms:.1%} of the untraced {ms:.2f} ms, idle share "
        f"{1 - busy / ms:.1%} (traced host clock {traced:.2f} ms); top "
        f"device time per query: " + "; ".join(
            f"{e.key[:48]} x{e.count // reps} "
            f"{e.self_device_time_total / reps / 1e3:.3f} ms" for e in top))
    host = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CPU]
    syncs = sum(e.count for e in host if e.key == "aten::_local_scalar_dense")
    log(f"[{tag} profile] host: {syncs / reps:g} device-to-host scalar reads "
        f"per query; top self host time per query (traced): " + "; ".join(
            f"{e.key[:40]} x{e.count / reps:g} "
            f"{e.self_cpu_time_total / reps / 1e3:.3f} ms"
            for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:8]))


def profile_estimate(s: Smoke, idx, q_np, tag, reps=3):
    """``torch.profiler`` trace of ``reps`` ``estimate()`` calls (the
    queries' buckets and Algorithm 2 lines 1-4): device kernels and
    device ms per call."""
    torch = s.torch
    from phase_profile import census
    from torch.profiler import ProfilerActivity, profile
    idx.estimate(q_np)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            idx.estimate(q_np)
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev) / reps / 1e3
    log(f"[{tag} profile] estimate(): device {busy:.4f} ms per call; kernels "
        f"per call {census(dev, reps)}")


def drive(s: Smoke, x_np, q_np, metric, fam, idx_kw, r, tag):
    """Build one static index, query it on every path through the kernels
    and through the plain versions, check the results and time the
    hybrid query.  Returns the index, the per-path launch counts and the
    hybrid route mix."""
    np, torch = s.np, s.torch
    from repro_torch.core import HybridLSHIndex
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx = HybridLSHIndex(fam, seed=0, **idx_kw).build(x_np)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    plain = HybridLSHIndex(fam, params=idx.params, impl="ref", **idx_kw)
    plain.x, plain.tables = idx.x, idx.tables

    nq = len(q_np)
    res, launches = query_paths(s, idx, q_np, r, metric, tag)
    n_lsh = len(res[None].lsh_idx)
    ref_res = {f: plain.query(q_np, r, force=f) for f in PATHS}
    sets, near = check_results(s, res, ref_res, x_np, q_np, metric, r, tag)
    use = res[None].route.use_lsh.cpu().numpy()
    sizes = [len(v) for v in sets[None].values()]
    ms = time_hybrid(s, idx, q_np, r)
    log(f"[{tag}] r={r:.6g} k={fam.k} build {t_build:.3f} s; route mix "
        f"{int(use.sum())} lsh / {len(use) - int(use.sum())} linear; "
        f"output size mean {np.mean(sizes):.1f} max {max(sizes)}; "
        f"hybrid query median of 5 {ms:.2f} ms (host clock, "
        f"synchronised); launches {launches}; near-threshold exceptions "
        f"{near}")
    profile_hybrid(s, idx, q_np, r, tag, ms)
    profile_estimate(s, idx, q_np, tag)
    return idx, launches, (n_lsh, nq - n_lsh)


def kernel_times(s: Smoke, idx, q_np, r, metric):
    """Per-kernel ms, plain ms, library ms and bound at the main path's
    shapes: one 32-query chunk for the scans (K2 also over the whole
    batch, as the LSH route launches it), the whole batch for K3."""
    np, torch = s.np, s.torch
    from repro_torch.core.lsh.tables import gather_candidates, gather_registers
    from repro_torch.core.search import dedupe_sorted
    from repro_torch.kernels import fused_scan, hll_merge, ops, ref
    x = idx.x
    n, d = x.shape
    q_all = torch.from_numpy(q_np).to(s.dev)
    qc = q_all[:32].contiguous()
    thresh = ops.metric_radius_transform(metric, r)
    out = {}

    # K1: linear scan on the (pre-normalised for cosine) chunk and corpus
    if metric == "cosine":
        qk, xk = ref.unit_rows(qc).contiguous(), ref.unit_rows(x).contiguous()
        qn, xn = qk.new_empty(32), xk.new_empty(n)
        lib_in = torch.ones((1, 1), device=s.dev)
        lib = lambda: torch.addmm(lib_in, qk, xk.T, alpha=-1)  # noqa: E731
        in_bytes = 4 * (qk.numel() + xk.numel())
    else:
        qk, xk = qc, x
        qn, xn = (qk * qk).sum(-1), (xk * xk).sum(-1)
        lib_in = qn[:, None] + xn[None, :]
        lib = lambda: torch.addmm(lib_in, qk, xk.T, alpha=-2)  # noqa: E731
        in_bytes = 4 * (qk.numel() + xk.numel() + 32 + n)
    kern = lambda: fused_scan.linear_scan_dot(thresh, qk, xk, qn, xn,  # noqa: E731
                                              mode=metric)
    plain = lambda: ref.fused_linear_scan(qk, xk, thresh, metric)  # noqa: E731
    a, b = kern(), plain()              # (dist, mask, ids) / (ids, dist, mask)
    err = float((a[0] - b[1]).abs().max())
    assert torch.equal(a[2], b[0].contiguous())
    torch.testing.assert_close(a[0], b[1], **TOL)
    s.masks_agree(a[1], b[2], b[1], thresh, "linear_scan_dot")
    bound, by, terms = s.bound_dot_ms(in_bytes + 9 * 32 * n, 32, n, d)
    x_unit = xk if metric == "cosine" else None    # as the index keeps it
    ops_ms = s.cuda_ms(lambda: ops.fused_linear_scan(qc, x, r, metric,
                                                     impl="cuda",
                                                     x_unit=x_unit))
    out["linear_scan_dot"] = dict(
        ms=s.cuda_ms(kern), plain_ms=s.cuda_ms(plain), library_ms=s.cuda_ms(lib),
        bound_ms=bound, bound_by=by, max_abs_err=err,
        shape=f"Q=32 N={n} d={d} {metric}", ops_ms=ops_ms,
        plan=fused_scan.dot_tile_plan(qk, xk), **terms)

    # K2: the fused sort + verification on the first chunk's real
    # candidates as the gather leaves them (unsorted); the library call is
    # torch.sort of them alone, the plain version torch.sort + the plain
    # verification
    qb = idx.bucket_ids(qc)
    cands = gather_candidates(idx.tables, qb, idx.cap, n).contiguous()
    c = cands.shape[1]
    if metric == "cosine":              # the unit rows, as the index runs it
        xk, qk, mk = ref.unit_rows(x).contiguous(), qc, "cosine_unit"
    else:
        xk, qk, mk = x, qc, metric
    kern = lambda: fused_scan.lsh_scan(thresh, xk, qk, cands,  # noqa: E731
                                       metric=mk)
    plain = lambda: ops.fused_lsh_scan_unsorted(x, cands, qc, r,  # noqa: E731
                                                metric, impl="ref")
    a, b = kern(), plain()              # (ids, dist, mask) both
    assert torch.equal(a[0], b[0]), "lsh_scan: ids differ from torch.sort's"
    s.masks_agree(a[2], b[2], b[1], thresh, "lsh_scan")
    both = a[2] & b[2]
    err = float((a[1][both] - b[1][both]).abs().max()) if bool(both.any()) else 0.0
    distinct = int(dedupe_sorted(b[0], n)[1].sum())
    rows_read = int(torch.unique(cands[cands < n]).numel())
    flops_per = 2 if metric == "cosine" else 3     # x.q on unit rows: one FMA
    # ids in, each row the chunk needs read once (queries that share a row
    # share its read), the query rows, 9 B a slot out; a distance for each
    # distinct (query, row) pair
    bound, by = s.bound_ms(4 * 32 * c + rows_read * d * 4 + 4 * 32 * d
                           + 9 * 32 * c, flops_per * distinct * d)
    lib = lambda: torch.sort(cands, dim=-1)  # noqa: E731
    out["lsh_scan"] = dict(
        ms=s.cuda_ms(kern), plain_ms=s.cuda_ms(plain), library_ms=s.cuda_ms(lib),
        device_ms=s.graph_ms(kern), library_device_ms=s.graph_ms(lib),
        library_call="torch.sort of the candidates alone",
        bound_ms=bound, bound_by=by, max_abs_err=err,
        plan=fused_scan.lsh_scan_plan(xk, 32, c),
        shape=f"Q=32 C={c} distinct={distinct} rows={rows_read} d={d} "
              f"{metric}")
    # the whole batch as the LSH route verifies it (one launch), beside the
    # 32-query slices it took before: the same outputs bit for bit
    nq = len(q_all)
    cands_all = gather_candidates(idx.tables, idx.bucket_ids(q_all), idx.cap,
                                  n).contiguous()
    x_unit = xk if metric == "cosine" else None
    verify = lambda a_: ops.fused_lsh_scan_unsorted(  # noqa: E731
        x, a_[0], a_[1], r, metric, impl="cuda", x_unit=x_unit)
    group = lambda: verify((cands_all, q_all))  # noqa: E731
    sliced = lambda: ops.chunked(verify, (cands_all, q_all), (n, 0))  # noqa: E731
    assert all(torch.equal(u, v) for u, v in zip(group(), sliced())), \
        "lsh_scan: the whole group differs from its 32-query slices"
    out["lsh_scan"].update(
        group_q=nq, group_ms=s.cuda_ms(group), group_device_ms=s.graph_ms(group),
        sliced_ms=s.cuda_ms(sliced), sliced_device_ms=s.graph_ms(sliced),
        group_plan=fused_scan.lsh_scan_plan(xk, nq, c))

    # K3: HLL merge + estimate over the whole batch's registers
    regs = gather_registers(idx.tables, idx.bucket_ids(q_all)).contiguous()
    kern = lambda: hll_merge.hll_merge_estimate(regs)  # noqa: E731
    plain = lambda: ref.hll_merge_estimate(regs)  # noqa: E731
    a, b = kern(), plain()
    torch.testing.assert_close(a, b, rtol=HLL_RTOL, atol=0)
    q, L, m = regs.shape
    bound, by = s.bound_ms(q * L * m + 4 * q, q * L * m + 3 * q * m)
    out["hll_merge_estimate"] = dict(
        ms=s.cuda_ms(kern), plain_ms=s.cuda_ms(plain), library_ms=None,
        bound_ms=bound, bound_by=by, max_abs_err=float((a - b).abs().max()),
        shape=f"Q={q} L={L} m={m}")
    return out


def linear_kernel_times(s: Smoke, x, q_np, r, metric):
    """K4 / K5 ms, plain ms, library ms and bound for one 32-query chunk
    against the rows ``x`` (on the card) the main path scans."""
    torch = s.torch
    from repro_torch.kernels import fused_scan, ops, ref
    from repro_torch.u32 import as_i32
    n, d = x.shape
    qc = torch.from_numpy(q_np[:32].view(s.np.int32) if metric == "hamming"
                          else q_np[:32]).to(s.dev).contiguous()
    thresh = ops.metric_radius_transform(metric, r)
    if metric == "l1":
        name = "linear_scan_l1"
        kern = lambda: fused_scan.linear_scan_l1(thresh, qc, x)  # noqa: E731
        lib = lambda: torch.cdist(qc, x, p=1.0)  # noqa: E731
        in_bytes = 4 * (qc.numel() + x.numel())
    else:
        name = "linear_scan_hamming"
        qc, x = as_i32(qc).contiguous(), as_i32(x).contiguous()
        part = [ops.ScanPart(x)]        # one segment, no epilogue
        kern = lambda: fused_scan.linear_scan_hamming(thresh, qc, part)  # noqa: E731
        lib = None                  # torch has no popcount
        in_bytes = 4 * (qc.numel() + x.numel())
        nops = 3 * 32 * n * d       # xor, popcount, add per word
    plain = lambda: ref.fused_linear_scan(qc, x, thresh, metric)  # noqa: E731
    a, b = kern(), plain()          # (dist, mask, ids) / (ids, dist, mask)
    assert torch.equal(a[2], b[0].contiguous())
    torch.testing.assert_close(a[0], b[1], **TOL)
    s.masks_agree(a[1], b[2], b[1], thresh, name)
    extra = {}
    if metric == "l1":
        bound, by = s.bound_l1_ms(in_bytes + 9 * 32 * n, 32, n, d)
        extra["plan"] = fused_scan.l1_tile_plan(qc, x)
    else:   # the int ops of K5 are counted at the fp32 CUDA-core rate
        bound, by = s.bound_ms(in_bytes + 9 * 32 * n, nops)
    if metric == "l1":
        extra["device_ms"] = s.graph_ms(kern)
    return name, dict(
        ms=s.cuda_ms(kern), plain_ms=s.cuda_ms(plain),
        library_ms=None if lib is None else s.cuda_ms(lib),
        bound_ms=bound, bound_by=by,
        max_abs_err=float((a[0] - b[1]).abs().max()),
        shape=f"Q=32 N={n} {'W' if metric == 'hamming' else 'd'}={d} {metric}",
        **extra)


def route_scan_times(s: Smoke, idx, q_np, r, metric, tag):
    """K3 over all frozen segments of a streaming index, and for Hamming
    K5 over all its segments, at the shapes its query batch gives them:
    each against its plain version, and the engine's estimate and linear
    group against the parent's composition one segment at a time
    (``torch_cases.route_estimate_per_segment``, one K3 a segment on
    its gathered registers, then ``finalize_route``; a one-part
    ``ops.grouped_linear_scan`` a segment and a concatenation), which
    they must equal bit for bit.  Times: events around the call (``ms``)
    and a CUDA graph replay (``device_ms``), L2 flushed, for the kernel,
    the engine's whole phase and the per-segment composition; bounds from
    the segment sizes of this run."""
    np, torch = s.np, s.torch
    from repro_torch.core.engine import (SegmentEstimate, TableSegment,
                                         concat_columns, finalize_route)
    from repro_torch.kernels import fused_scan, hll_merge, ops, ref
    from repro_torch.u32 import as_i32
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_cases import route_estimate_per_segment
    q = idx._rows(q_np)
    qb, tidx = idx._qbuckets(q, 1)
    segs = idx._segments(tidx)
    eng = idx._engine
    frozen = [g for g in segs if isinstance(g, TableSegment)]
    tables = [g.table_terms() for g in frozen]
    qb32 = qb.to(torch.int32).contiguous()
    nq, v = qb32.shape
    m = tables[0].registers.shape[2]
    out = {}

    kern = lambda: hll_merge.route_estimate(qb32, tables)  # noqa: E731
    plain = lambda: ref.route_estimate(qb32, tables)  # noqa: E731
    whole = lambda: eng.estimate(segs, qb)  # noqa: E731
    sizes = [g.sizes() for g in frozen]

    def per_seg():
        coll, cand = route_estimate_per_segment(
            qb, tables, tidx, lambda r: ops.hll_merge_estimate(r, impl="cuda"))
        return finalize_route(
            [SegmentEstimate(coll, cand_est=cand,
                             n_live=sum(n for n, _ in sizes),
                             n_scan=sum(n for _, n in sizes))]
            + [g.estimate_terms(qb) for g in segs
               if not isinstance(g, TableSegment)], eng.cost_model)
    (kc, ke), (pc, pe) = kern(), plain()
    assert torch.equal(kc, pc), f"{tag}: K3 collisions differ"
    torch.testing.assert_close(ke, pe, rtol=HLL_RTOL, atol=0)
    a, b = whole(), per_seg()
    for f in ("collisions", "cand_est", "lsh_cost", "use_lsh"):
        assert torch.equal(getattr(a, f), getattr(b, f)), \
            f"{tag}: estimate {f} differs from the per-segment composition"
    S = len(tables)
    # the registers, two starts and a dead count per column and segment,
    # the buckets in, the two sums out
    bound, by = s.bound_ms(nq * S * v * (m + 12) + 4 * nq * v + 8 * nq,
                           nq * S * v * m)
    out["route_estimate"] = dict(
        ms=s.cuda_ms(kern), device_ms=s.graph_ms(kern),
        plain_ms=s.cuda_ms(plain), library_ms=None, bound_ms=bound,
        bound_by=by, max_abs_err=float((ke - pe).abs().max()),
        estimate_ms=s.cuda_ms(whole), estimate_device_ms=s.graph_ms(whole),
        per_segment_ms=s.cuda_ms(per_seg),
        per_segment_device_ms=s.graph_ms(per_seg),
        shape=f"Q={nq} V={v} m={m} S={S} frozen segments "
              f"(rows {[g.tables.n for g in frozen]})")

    if metric == "hamming":
        parts = [g.scan_part() for g in segs]
        qi = as_i32(q).contiguous()
        thresh = ops.metric_radius_transform(metric, r)
        kern = lambda: fused_scan.linear_scan_hamming(thresh, qi, parts)  # noqa: E731
        plain = lambda: ref.grouped_linear_scan(qi, parts, thresh, metric)  # noqa: E731
        whole = lambda: eng.search_group(segs, qb, q, float(r),  # noqa: E731
                                         lsh_route=False)
        per_seg = lambda: concat_columns([  # noqa: E731
            ops.grouped_linear_scan(q, [p], float(r), metric) for p in parts])
        (kd, km, ki), b, c = kern(), plain(), per_seg()
        for u, v_, w in zip((ki, kd, km), b, c):
            assert torch.equal(u, v_) and torch.equal(u, w), \
                f"{tag}: K5 differs from the plain / per-segment scan"
        rows = [p.x.shape[0] for p in parts]
        n, w = sum(rows), qi.shape[1]
        # codes, live and ids read once, 9 B a (query, row) out; the xor,
        # popcount and add of each word at the fp32 CUDA-core rate
        bound, by = s.bound_ms(4 * (nq + n) * w + 5 * n + 9 * nq * n,
                               3 * nq * n * w)
        out["linear_scan_hamming"] = dict(
            ms=s.cuda_ms(kern), device_ms=s.graph_ms(kern),
            plain_ms=s.cuda_ms(plain), library_ms=None, bound_ms=bound,
            bound_by=by, max_abs_err=float((kd - b[1]).abs().max()),
            group_ms=s.cuda_ms(whole), group_device_ms=s.graph_ms(whole),
            per_segment_ms=s.cuda_ms(per_seg),
            per_segment_device_ms=s.graph_ms(per_seg),
            shape=f"Q={nq} W={w} rows {rows} (sum {n}) hamming")
        # the delta alone, as the LSH route of the batch scans it
        xd = parts[-1].x
        dk = lambda: fused_scan.linear_scan_hamming(  # noqa: E731
            thresh, qi, [ops.ScanPart(xd)])
        a, b = dk(), ref.fused_linear_scan(qi, xd, thresh, metric)
        assert all(torch.equal(u, v) for u, v in zip(a, b[1:] + b[:1])), \
            f"{tag}: K5 on the delta differs from the plain scan"
        nd = xd.shape[0]
        bound, by = s.bound_ms(4 * (nq + nd) * w + 9 * nq * nd,
                               3 * nq * nd * w)
        out["linear_scan_hamming"]["delta_lsh"] = dict(
            ms=s.cuda_ms(dk), device_ms=s.graph_ms(dk), bound_ms=bound,
            bound_by=by, shape=f"Q={nq} W={w} N={nd} (the delta) hamming")
    for k, t in out.items():
        log(f"[{tag}] {k} over all segments: kernel {t['ms']:.4f} ms, "
            f"device {t['device_ms']:.4f}; bound {t['bound_ms']:.3g} "
            f"({t['bound_by']}); plain {t['plain_ms']:.4f}; the engine's "
            f"phase " + (f"{t['estimate_ms']:.4f} / device "
                         f"{t['estimate_device_ms']:.4f}"
                         if k == "route_estimate" else
                         f"{t['group_ms']:.4f} / device "
                         f"{t['group_device_ms']:.4f}")
            + f" against the per-segment composition {t['per_segment_ms']:.4f}"
            f" / device {t['per_segment_device_ms']:.4f} ms; {t['shape']}")
        if "delta_lsh" in t:
            dl = t["delta_lsh"]
            log(f"[{tag}] {k} on the delta alone (the LSH route's scan): "
                f"{dl['ms']:.4f} ms, device {dl['device_ms']:.4f}; bound "
                f"{dl['bound_ms']:.3g}; {dl['shape']}")
    return out


def pairwise_times(s: Smoke, q, x, metric):
    """K6 (l2, cosine) / K7 (l1) ms, ms through ``ops``, plain ms, library
    ms and bound for the queries ``q`` against the rows ``x`` (both on
    the card), a shape a caller of ``ops.pairwise_dist`` gives them."""
    torch = s.torch
    from repro_torch.kernels import distances, fused_scan, ops, ref
    n, d = x.shape
    nq = q.shape[0]
    if metric == "cosine":          # the kernel alone, on normalised rows
        qk, xk = ref.unit_rows(q).contiguous(), ref.unit_rows(x).contiguous()
        kern = lambda: distances.pairwise_dot(qk, xk, None, None,  # noqa: E731
                                              mode="cosine")
        lib_in = torch.ones((1, 1), device=s.dev)
        lib = lambda: torch.addmm(lib_in, qk, xk.T, alpha=-1)  # noqa: E731
        in_bytes = 4 * (qk.numel() + xk.numel())
    elif metric == "l2":
        qn, xn = (q * q).sum(-1), (x * x).sum(-1)
        kern = lambda: distances.pairwise_dot(q, x, qn, xn, mode="l2")  # noqa: E731
        lib_in = qn[:, None] + xn[None, :]
        lib = lambda: torch.addmm(lib_in, q, x.T, alpha=-2)  # noqa: E731
        in_bytes = 4 * (q.numel() + x.numel() + nq + n)
    else:
        kern = lambda: distances.pairwise_l1(q, x)  # noqa: E731
        lib = lambda: torch.cdist(q, x, p=1.0)  # noqa: E731
        in_bytes = 4 * (q.numel() + x.numel())
    through_ops = lambda: ops.pairwise_dist(q, x, metric, impl="cuda")  # noqa: E731
    plain = lambda: ops.pairwise_dist(q, x, metric, impl="ref")  # noqa: E731
    a, b, c = kern(), through_ops(), plain()
    torch.testing.assert_close(a, c, **TOL)
    torch.testing.assert_close(b, c, **TOL)
    extra = {}
    if metric == "l1":
        bound, by = s.bound_l1_ms(in_bytes + 4 * nq * n, nq, n, d)
        extra["plan"] = fused_scan.l1_tile_plan(q, x)
        extra["device_ms"] = s.graph_ms(kern)
    else:
        bound, by, extra = s.bound_dot_ms(in_bytes + 4 * nq * n, nq, n, d)
        extra["plan"] = fused_scan.dot_tile_plan(q, x)
    out = dict(ms=s.cuda_ms(kern), ops_ms=s.cuda_ms(through_ops),
               plain_ms=s.cuda_ms(plain), library_ms=s.cuda_ms(lib),
               bound_ms=bound, bound_by=by,
               max_abs_err=float((b - c).abs().max()),
               shape=f"Q={nq} N={n} d={d} {metric}", **extra)
    del a, b, c
    return out


def hamming_times(s: Smoke, q_np, x_np, by_path, tag):
    """K8 on all the queries' codes against the corpus codes through
    ``ops.hamming_dist`` (its own path: counts set to 0 just before it,
    read just after), exact against its plain version; ms, plain ms and
    bound."""
    np, torch = s.np, s.torch
    from repro_torch.kernels import hamming, ops
    q = torch.from_numpy(np.ascontiguousarray(q_np).view(np.int32)).to(s.dev)
    x = torch.from_numpy(np.ascontiguousarray(x_np).view(np.int32)).to(s.dev)
    (nq, w), n = q.shape, x.shape[0]
    a, launches = s.path(lambda: ops.hamming_dist(q, x))
    assert launches == {k: int(k == "hamming") for k in launches}, launches
    by_path[tag] = {"ops": launches}
    b = ops.hamming_dist(q, x, impl="ref")
    assert a.dtype == torch.int32 and torch.equal(a, b), tag
    # the int ops (xor, popcount, add per word) at the fp32 CUDA-core rate
    bound, by = s.bound_ms(4 * (q.numel() + x.numel()) + 4 * nq * n,
                           3 * nq * n * w)
    return dict(ms=s.cuda_ms(lambda: hamming.hamming(q, x)),
                device_ms=s.graph_ms(lambda: hamming.hamming(q, x)),
                plain_ms=s.cuda_ms(lambda: ops.hamming_dist(q, x, impl="ref")),
                library_ms=None, bound_ms=bound, bound_by=by,
                max_abs_err=float((a - b).abs().max()),
                shape=f"Q={nq} N={n} W={w} hamming")


def simhash_times(s: Smoke, idx, by_path, tag):
    """K9 on the index's corpus with the index's own SimHash projections
    through ``ops.simhash_fingerprint`` (its own path), held against its
    plain version and against the index's bucket codes
    (``family.codes``) bit for bit, up to near-zero projections; ms,
    plain ms, the projection's matmul alone and the bound."""
    torch = s.torch
    from repro_torch.kernels import ops, ref, simhash
    fam, x, R = idx.family, idx.x, idx.params["R"]
    n, d = x.shape
    L, k = fam.L, fam.k
    words = (k + 31) // 32
    rp = ops.pad_projection(R, L, k).contiguous()
    a, launches = s.path(lambda: ops.simhash_fingerprint(x, R, L, k))
    assert launches == {c: int(c == "simhash") for c in launches}, launches
    by_path[tag] = {"ops": launches}
    flips = s.simhash_flips(a, ops.simhash_fingerprint(x, R, L, k, impl="ref"),
                            x, rp, f"{tag} K9=plain")
    flips_codes = s.simhash_flips(a, fam.codes(idx.params, x), x, rp,
                                  f"{tag} K9=family.codes")
    del a
    # the least time for the work of the family's L k real columns: x, R
    # and the words moved once, against 3 x 2 N d L k TF32 operations on
    # the tensor cores (three passes make the fp32-exact product)
    bound, by, terms = s.bound_dot_ms(4 * (n * d + d * L * k + n * L * words),
                                      L * k, n, d)
    R = R.contiguous()
    rc = simhash.compact_projection(rp, L, k)
    out = dict(ms=s.cuda_ms(lambda: simhash.simhash(x, rp, L, k, rc=rc)),
               device_ms=s.graph_ms(lambda: simhash.simhash(x, rp, L, k,
                                                            rc=rc)),
               layout_ms=s.cuda_ms(lambda: simhash.compact_projection(rp, L,
                                                                      k)),
               ops_ms=s.cuda_ms(lambda: ops.simhash_fingerprint(x, R, L, k)),
               plain_ms=s.cuda_ms(lambda: ops.simhash_fingerprint(
                   x, R, L, k, impl="ref")),
               library_ms=None,
               matmul_ms=s.cuda_ms(lambda: torch.matmul(x, R)),
               matmul_padded_ms=s.cuda_ms(lambda: torch.matmul(x, rp)),
               bound_ms=bound, bound_by=by, **terms, max_abs_err=flips,
               max_abs_err_unit="bits that differ from the plain version",
               bits_differing_from_codes=flips_codes,
               compact_columns=int(rc.shape[0] * rc.shape[1]),
               plan=simhash.plan(x, L, k),
               shape=f"N={n} d={d} L={L} k={k} words={words}")
    log(f"[{tag}] K9 bits within {ref.SIMHASH_EPS:g} of 0 that differ: "
        f"{flips} from the plain version, {flips_codes} from the index's "
        f"bucket codes; {out['compact_columns']} compact columns, plan "
        f"{out['plan']}; K9 {out['ms']:.4f} ms (device {out['device_ms']:.4f})"
        f", compact_projection {out['layout_ms']:.4f}, ops {out['ops_ms']:.4f}"
        f"; the projection only: torch.matmul(x, R) {out['matmul_ms']:.4f} "
        f"ms, torch.matmul(x, r_padded) {out['matmul_padded_ms']:.4f} ms")
    return out


def route_mixes(s: Smoke, idx, q_np, r, models, tag):
    """Queries routed to LSH under each cost model, from the index's
    ``estimate()`` and ``CostModel.use_lsh`` (Algorithm 2 line 4 with each
    model's beta/alpha).  The index itself is built with ``models['preset']``."""
    torch = s.torch
    est = idx.estimate(q_np)
    coll = est.collisions.to(torch.float32)
    mix = {name: int(cm.use_lsh(coll, est.cand_est, idx.n).sum())
           for name, cm in models.items()}
    assert mix["preset"] == int(est.use_lsh.sum()), (tag, mix)
    nq = len(q_np)
    log(f"[{tag}] r={r:.6g} route mix lsh / linear: " + "; ".join(
        f"{name} (beta/alpha {cm.beta / cm.alpha:.6g}) {mix[name]} / "
        f"{nq - mix[name]}" for name, cm in models.items()))
    return mix


def drive_calibrated(s: Smoke, x_np, q_np, metric, make_fam, kw, radii, mixes,
                     cm, tag, by_path):
    """Drive one radius through an index built with the calibrated cost
    model: the largest radius where that model mixes routes, else q3."""
    nq = len(q_np)
    mixed = [i for i, m in enumerate(mixes) if 0 < m["calibrated"] < nq]
    i = mixed[-1] if mixed else len(radii) - 1
    if not mixed:
        log(f"[{tag}] the calibrated model mixes routes at no radius: "
            f"driving q{i}")
    r = radii[i]
    idx, launches, (n_lsh, _) = drive(s, x_np, q_np, metric, make_fam(r),
                                      dict(kw, cost_model=cm), r,
                                      f"{tag} calibrated q{i}")
    assert n_lsh == mixes[i]["calibrated"], (tag, n_lsh, mixes[i])
    by_path[f"{tag} calibrated q{i}"] = launches
    return idx


def log_memory(s: Smoke, idx, tag):
    """Per-segment device bytes of a streaming index, and the total."""
    parts = []
    for f in idx.stack.segments:
        t = f.seg.tables
        parts.append(f"L{f.level} rows {f.n_rows} pad {f.n_pad}: rows "
                     f"{f.seg.x.numel() * 4 / 1e6:.1f} MB, registers "
                     f"{t.registers.numel() / 1e6:.1f} MB, perm "
                     f"{t.perm.numel() * 4 / 1e6:.1f} MB, tombstone counts "
                     f"{f.tomb.counts.numel() * 4 / 1e6:.1f} MB")
    dl = idx.delta
    log(f"[{tag}] device memory: " + "; ".join(parts)
        + f"; delta {dl.x.numel() * 4 / 1e6:.2f} MB ({dl.count} of "
        f"{dl.capacity} slots); allocated "
        f"{s.torch.cuda.memory_allocated() / 1e9:.2f} GB, peak "
        f"{s.torch.cuda.max_memory_allocated() / 1e9:.2f} GB")


def pick_streaming_radius(s: Smoke, x_np, q_np, metric, radii, make_idx,
                          tag):
    """Build the streaming index at each radius and read ``estimate()``:
    the largest radius whose hybrid mixes routes, else the largest."""
    np = s.np
    chosen = None
    for i, r in enumerate(radii):
        idx = make_idx(r)
        use = idx.estimate(q_np).use_lsh.cpu().numpy()
        n_lsh = int(use.sum())
        log(f"[{tag}] estimate at q{i} r={r:.6g}: {n_lsh} lsh / "
            f"{len(use) - n_lsh} linear")
        if 0 < n_lsh < len(use) or (i == len(radii) - 1 and chosen is None):
            chosen = (i, r, idx, 0 < n_lsh < len(use))
        del idx
    i, r, idx, mixed = chosen
    if not mixed:
        log(f"[{tag}] the hybrid mixes routes at no radius: using q{i}")
    return i, r, idx


def drive_streaming(s: Smoke, idx, x_np, q_np, metric, r, *, n_build, batch,
                    tag, seed=0, durability=None):
    """Churn a built streaming index and check it on every path.

    Inserts rows ``n_build:`` in batches of ``batch`` while a
    ``CompactionDriver`` worker stages the merges and the control thread
    queries between batches; deletes 1 % of the ids (spread over the
    built segment, the frozen level segments and the delta); then, on
    the churned state and again after a full ``compact()``: every path
    through the kernels against a plain index loaded from the kernel
    index's ``state_dict()`` (``check_results``), no deleted id reported,
    and the linear sets equal to those of a fresh static index built on
    the surviving rows (external ids mapped).  ``durability`` ("steps"
    or "once") runs ``drive_durability`` on the churned state, before
    the compaction.  Returns the per-path launch counts of both states,
    the hybrid route mixes and the hybrid query times (and the
    durability numbers)."""
    np, torch = s.np, s.torch
    from repro_torch.core import HybridLSHIndex
    from repro_torch.streaming import CompactionDriver, DynamicHybridIndex
    n = len(x_np)
    kw = dict(num_buckets=idx.num_buckets, m=idx.m, cap=idx.cap,
              delta_capacity=idx.delta_capacity, cost_model=idx.cost_model,
              policy=idx.policy, device=s.dev)
    drv = CompactionDriver(idx, budget_rows=idx.policy.step_rows).start()
    t0 = time.perf_counter()
    for lo in range(n_build, n, batch):
        idx.insert(x_np[lo:lo + batch])
        drv.notify()
        idx.query(q_np, r)          # the control thread serves meanwhile
        drv.drain()
    t_churn = time.perf_counter() - t0
    drv.stop(flush=True)
    st = drv.stats()
    assert st["worker_errors"] == 0, st
    assert st["applied"] >= 1 and st["stage_calls"] >= 1, st
    stats = idx.index_stats()
    log(f"[{tag}] inserted {n - n_build} rows in batches of {batch} in "
        f"{t_churn:.2f} s (a hybrid query after each batch); driver: "
        f"{st['stage_calls']} worker gathers, {st['prepares']} worker "
        f"pre-builds, {st['applied']} merges applied; index: freezes "
        f"{stats['freezes']}, merges per level {stats['merges_per_level']}, "
        f"levels {stats['levels']}, delta {stats['delta_count']} rows")
    assert stats["freezes"] >= 1 and sum(stats["merges_per_level"].values()) >= 1

    rng = np.random.default_rng(seed)
    dead = rng.choice(n, n // 100, replace=False)
    where = {}
    for e in dead.tolist():
        loc = idx._loc[e]
        key = "delta" if loc[0] == "d" else (
            "built" if loc[1] == idx.stack.segments[0].uid else "levels")
        where[key] = where.get(key, 0) + 1
    assert set(where) == {"built", "levels", "delta"}, where
    assert idx.delete(dead.tolist()) == len(dead)
    live = np.setdiff1d(np.arange(n), dead)
    dead_set = set(dead.tolist())
    log(f"[{tag}] deleted {len(dead)} ids: {where}")

    out = {}
    for state in ("churned", "compacted"):
        if state == "compacted":
            t0 = time.perf_counter()
            idx.compact()
            torch.cuda.synchronize()
            log(f"[{tag}] compact(): {time.perf_counter() - t0:.2f} s, "
                f"{idx.stack.segments[0].n_rows} live rows padded to "
                f"{idx.stack.segments[0].n_pad}")
        log_memory(s, idx, f"{tag} {state}")
        res, launches = query_paths(s, idx, q_np, r, metric,
                                    f"{tag} {state}", delta=True)
        plain = DynamicHybridIndex(idx.family, params=idx.params,
                                   impl="ref", **kw)
        plain.load_state_dict(idx.state_dict())
        ref_res = {f: plain.query(q_np, r, force=f) for f in PATHS}
        del plain
        sets, near = check_results(s, res, ref_res, x_np, q_np, metric, r,
                                   f"{tag} {state}")
        for f, v in sets.items():
            assert not set().union(*v.values()) & dead_set, \
                f"{tag} {state} force={f}: a deleted id was reported"
        fresh = HybridLSHIndex(idx.family, params=idx.params,
                               num_buckets=idx.num_buckets, m=idx.m,
                               cap=idx.cap, device=s.dev).build(x_np[live])
        want = fresh.query(q_np, r, force="linear").neighbor_sets()
        del fresh
        want = {i: {int(live[j]) for j in v} for i, v in want.items()}
        near["linear=fresh static"] = s.compare_sets(
            sets["linear"], want, metric, q_np, x_np, r,
            f"{tag} {state} linear=fresh")
        use = res[None].route.use_lsh.cpu().numpy()
        sizes = [len(v) for v in sets[None].values()]
        ms = time_hybrid(s, idx, q_np, r)
        log(f"[{tag} {state}] r={r:.6g} route mix {int(use.sum())} lsh / "
            f"{len(use) - int(use.sum())} linear; output size mean "
            f"{np.mean(sizes):.1f} max {max(sizes)}; hybrid query median of "
            f"5 {ms:.2f} ms (host clock, synchronised); {len(idx.stack.segments)} "
            f"segments; launches {launches}; near-threshold exceptions {near}")
        profile_hybrid(s, idx, q_np, r, f"{tag} {state}", ms)
        profile_estimate(s, idx, q_np, f"{tag} {state}")
        out[state] = dict(launches=launches, mix=(int(use.sum()),
                                                  len(use) - int(use.sum())),
                          ms=ms)
        if state == "churned":
            out[state]["kernel_times"] = route_scan_times(
                s, idx, q_np, r, metric, f"{tag} {state}")
        del res, ref_res
        torch.cuda.empty_cache()
        if state == "churned" and durability is not None:
            out["durability"], gone = drive_durability(
                s, idx, x_np, q_np, metric, r, kw, dead, f"{tag} durability",
                steps=durability == "steps", batch=batch, seed=seed)
            dead = np.union1d(dead, gone)
            live = np.setdiff1d(np.arange(n), dead)
            dead_set |= set(gone)
            torch.cuda.empty_cache()
    return out


class InjectedCrash(RuntimeError):
    """The fault the durability phase injects into a save."""


def crash_at_pre_commit(point, **info):
    """A ``CheckpointManager`` fault hook: the process dies just before
    the COMMITTED marker of a save."""
    if point == "pre_commit":
        raise InjectedCrash(f"injected crash at {point} {info}")


def snapshot(s: Smoke, mgr, drv, idx, step):
    """``save_index(step, idx, incremental=True, blocking=False)`` inside
    the driver's consistent cut (the host copy and the digest hints on
    this thread, the worker excluded), then the writer joined.  Returns
    the cut's seconds (what the serving thread pays), the writer's, the
    whole save's, and the chunks and bytes written and reused."""
    before = mgr.stats()
    t0 = time.perf_counter()
    drv.consistent_cut(lambda: mgr.save_index(step, idx, incremental=True,
                                              blocking=False))
    cut = time.perf_counter() - t0
    mgr.wait()
    total = time.perf_counter() - t0
    after = mgr.stats()
    out = {k: after[k] - before[k] for k in ("chunks_written", "chunks_reused",
                                             "bytes_written", "bytes_reused")}
    return dict(out, cut_s=cut, write_s=after["last_save_seconds"],
                total_s=total)


INDEX_COUNTS = ("n_live", "n_main", "n_main_dead", "delta_count",
                "delta_live", "segments", "levels")


def restore_and_check(s: Smoke, mgr, live, kw, q_np, r, metric, tag):
    """Restore the newest committed step into a fresh index on the card
    (drawn from another seed: the params come from the checkpoint) and
    hold it against the live index: equal ``state_digests()`` and
    counts, and on every path exactly the live index's sets and kernel
    launches (``check_path_launches`` on both).  Returns the restored
    index and its seconds: the restore (read + load to the card), the
    read alone, and the first hybrid query after it."""
    torch = s.torch
    from repro_torch.streaming import DynamicHybridIndex
    live_res, live_launches = query_paths(s, live, q_np, r, metric,
                                          f"{tag} live", delta=True)
    fresh = DynamicHybridIndex(live.family, seed=1, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step = mgr.restore_index(fresh)
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    t0 = time.perf_counter()
    first = fresh.query(q_np, r)
    for o in (first.lsh_out, first.lin_out):
        if o is not None:
            o[2].sum().item()
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    assert step == mgr.latest_step(), (tag, step)
    assert fresh.params[next(iter(fresh.params))].device.type == s.dev.type
    assert fresh.state_digests() == live.state_digests(), tag
    a, b = live.index_stats(), fresh.index_stats()
    for k in INDEX_COUNTS:
        assert a[k] == b[k], (tag, k, a[k], b[k])
    res, launches = query_paths(s, fresh, q_np, r, metric, f"{tag} restored",
                                delta=True)
    for f, path in PATHS.items():
        assert res[f].neighbor_sets() == live_res[f].neighbor_sets(), (tag, f)
        assert launches[path] == live_launches[path], (tag, path)
    log(f"[{tag}] restored step {step}: digests, counts, sets and kernel "
        f"launches on every path equal the live index's; launches {launches}")
    return fresh, dict(restore_s=t_restore,
                       read_s=mgr.stats()["last_restore_seconds"],
                       first_hybrid_ms=t_first * 1e3, launches=launches)


def drive_durability(s: Smoke, idx, x_np, q_np, metric, r, kw, dead, tag, *,
                     steps, batch, seed):
    """Checkpoint the churned streaming index and restore it to the card.

    Always: ``state_dict()`` timed (the device-to-host copy), a full
    ``save_index`` timed, step 1 saved incrementally inside the
    ``CompactionDriver``'s consistent cut with the worker running, and
    restored into a fresh index (``restore_and_check``).  With
    ``steps``: before the restore, one more batch inserted (rows of
    deleted ids, under new ids) and 16 ids deleted, step 2 saved the
    same way (it must write well under step 1's bytes and reuse at least
    the leaves of the frozen segments both steps hold), and step 3 saved
    by a manager whose fault hook kills it at ``pre_commit``: a new
    manager on the directory sweeps the torn step and serves step 2.
    Afterwards the inserted batch is deleted again.  Writes into a
    temporary directory and removes it.  Returns the numbers and the
    corpus ids deleted here."""
    import shutil
    import tempfile
    np, torch = s.np, s.torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.streaming import CompactionDriver
    t_phase = time.perf_counter()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    drv = CompactionDriver(idx, budget_rows=idx.policy.step_rows)
    gone, nums = [], {}
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = idx.state_dict()
        nums["state_dict_s"] = time.perf_counter() - t0
        nums["state_bytes"] = tree_nbytes(state)
        del state
        full = CheckpointManager(str(root / "full"))
        t0 = time.perf_counter()
        full.save_index(1, idx, blocking=True)
        nums["full_save_s"] = time.perf_counter() - t0
        shutil.rmtree(root / "full")

        mgr = CheckpointManager(str(root / "inc"))
        drv.start()
        nums["step1"] = snapshot(s, mgr, drv, idx, 1)
        uids1 = {f.uid for f in idx.stack.segments}
        if steps:
            rng = np.random.default_rng(seed + 100)
            added = idx.insert(x_np[dead[:batch]])
            drv.notify()
            live = np.setdiff1d(np.arange(len(x_np)), dead)
            gone = rng.choice(live, 16, replace=False).tolist()
            assert idx.delete(gone) == len(gone)
            nums["step2"] = snapshot(s, mgr, drv, idx, 2)
            kept = uids1 & {f.uid for f in idx.stack.segments}
            st1, st2 = nums["step1"], nums["step2"]
            assert st2["bytes_written"] < st1["bytes_written"] / 3, nums
            assert st2["chunks_reused"] >= 6 * len(kept), (nums, kept)
            try:
                CheckpointManager(str(root / "inc"),
                                  fault_hook=crash_at_pre_commit).save_index(
                    3, idx, incremental=True, blocking=True)
                raise AssertionError(f"{tag}: the injected crash never fired")
            except InjectedCrash:
                pass
            mgr = CheckpointManager(str(root / "inc"))      # the restart
            nums["litter_swept"] = mgr.stats()["litter_swept"]
            assert nums["litter_swept"] >= 1 and mgr.latest_step() == 2, nums
        drv.stop()
        restored, nums["restore"] = restore_and_check(s, mgr, idx, kw, q_np, r,
                                                      metric, tag)
        del restored
        if steps:
            assert idx.delete(added.tolist()) == len(added)
    finally:
        drv.stop()
        shutil.rmtree(root, ignore_errors=True)
    st1 = nums["step1"]
    rs = nums["restore"]
    nums["phase_s"] = time.perf_counter() - t_phase
    log(f"[{tag}] {idx.index_stats()['segments']} segments; state_dict() "
        f"{nums['state_dict_s']:.3f} s for {nums['state_bytes'] / 1e6:.1f} MB "
        f"(device to host); full save {nums['full_save_s']:.3f} s; "
        f"incremental step 1: cut {st1['cut_s']:.3f} s (host copy + digest "
        f"hints, worker excluded), writer {st1['write_s']:.3f} s, total "
        f"{st1['total_s']:.3f} s, {st1['bytes_written'] / 1e6:.1f} MB written "
        f"in {st1['chunks_written']} chunks")
    if steps:
        st2 = nums["step2"]
        log(f"[{tag}] step 2 (a batch of {batch} inserted, 16 ids deleted): "
            f"cut {st2['cut_s']:.3f} s, writer {st2['write_s']:.3f} s, total "
            f"{st2['total_s']:.3f} s, {st2['bytes_written'] / 1e6:.2f} MB "
            f"written in {st2['chunks_written']} chunks, "
            f"{st2['bytes_reused'] / 1e6:.1f} MB reused in "
            f"{st2['chunks_reused']} chunks; step 3 killed at pre_commit, "
            f"{nums['litter_swept']} torn item(s) swept, restart serves step 2")
    log(f"[{tag}] restore {rs['restore_s']:.3f} s (read {rs['read_s']:.3f} s, "
        f"the rest the load to the card); first hybrid query after restore "
        f"{rs['first_hybrid_ms']:.2f} ms (host clock, synchronised); the "
        f"phase took {nums['phase_s']:.1f} s")
    return nums, gone


def tree_nbytes(tree):
    """Bytes of the arrays in a nested dict (a ``state_dict()``)."""
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    return tree.nbytes


def serve_pass(mgr, sched, cache, q_np, r, assign):
    """Submit query ``i`` to collection ``assign[i]``; drain with
    ``next_batch(force=True)``; per batch and tenant, answer cache hits
    and query the tenant's index once on its misses (the results go
    into the cache, keyed by the index version).  Returns each query's
    reported set, the batches' per-tenant sizes and padded sizes, and
    the cache hits and misses of the pass."""
    before = cache.stats()
    for i, name in enumerate(assign):
        assert sched.submit(i, collection=name) is not None
    served, batches = {}, []
    while True:
        take, padded = sched.next_batch(force=True)
        if not take:
            break
        by = {}
        for req in take:
            by.setdefault(req.collection, []).append(req)
        batches.append(({k: len(v) for k, v in sorted(by.items())}, padded))
        for name, reqs in by.items():
            index = mgr.get(name).index
            cache.purge_stale(index.version, collection=name)
            todo = []
            for req in reqs:
                key = cache.key(index.version, r, q_np[req.payload][None],
                                collection=name)
                hit = cache.get(key)
                if hit is None:
                    todo.append((req.payload, key))
                else:
                    served[req.payload] = set(hit[0][0].tolist())
            if todo:
                res = index.query(q_np[[i for i, _ in todo]], r)
                for j, (i, key) in enumerate(todo):
                    ids, dists = res.reported(j)
                    cache.put(key, [ids], [dists])
                    served[i] = set(ids.tolist())
                mgr.note_query(name, len(todo), len(res.lin_idx))
    after = cache.stats()
    return (served, batches, after["hits"] - before["hits"],
            after["misses"] - before["misses"])


def drive_tenants(s: Smoke, x_np, q_np, fam, r, kw, tag, seed=3):
    """Three collections over one family, one ``QueryEngine`` and one
    ``CompactionDriver``; a ``ShapeBucketScheduler`` with quotas of
    weight 1 / 2 / 4 and a ``ResultCache``.

    The codes are split into three tenants; each is built on 3,000 rows
    and churned through its delta with the shared worker staging the
    merges (its fairness counters printed), and 1 % of each tenant's ids
    are deleted.  The queries, query i to tenant i mod 3, are submitted
    and served in forced batches; each tenant's sets equal those of its
    own whole batch on every path (launches asserted) and a plain
    (``impl="ref"``) index loaded from its ``state_dict()``
    (``check_results``).  A second pass is all cache hits; an insert into
    one tenant bumps its version, and the next pass misses its queries
    only.  The tree ``{"collections": mgr.state_dict()}`` is saved
    incrementally with the digest hints under ``collections/``;
    ``collection_names`` reads the tenants from the manifest, and a
    fresh ``CollectionManager`` loaded from the step reports equal sets
    and launches on every path.  Dropping one tenant purges its cache
    entries and queued requests, and a re-created namesake starts at
    version 0."""
    import shutil
    import tempfile
    np, torch = s.np, s.torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import QueryEngine
    from repro_torch.obs import Observability
    from repro_torch.serve import (CollectionManager, ResultCache,
                                   ShapeBucketScheduler, TenantQuota)
    from repro_torch.streaming import CompactionDriver, DynamicHybridIndex
    names, weights = ("a", "b", "c"), (1.0, 2.0, 4.0)
    metric = fam.metric
    obs = Observability.create(enabled=True)
    params = fam.init(torch.Generator().manual_seed(seed), device=s.dev)
    engine = QueryEngine(kw["cost_model"], tracer=obs.tracer)

    def factory(o):
        return DynamicHybridIndex(fam, params=params, engine=engine, obs=o,
                                  **kw)

    sched = ShapeBucketScheduler(max_batch=32, min_bucket=8)
    cache = ResultCache(max_bytes=1 << 26)
    drv = CompactionDriver(budget_rows=kw["policy"].step_rows, obs=obs)
    mgr = CollectionManager(factory, obs=obs, scheduler=sched, cache=cache,
                            driver=drv)
    rng = np.random.default_rng(seed)
    parts = dict(zip(names, np.array_split(rng.permutation(len(x_np)), 3)))
    rows = {k: x_np[v] for k, v in parts.items()}
    t_phase = time.perf_counter()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_tenants_"))
    try:
        for name, w in zip(names, weights):
            col = mgr.create(name, quota=TenantQuota(weight=w), attach=False)
            col.index.build(rows[name][:3000])
            mgr.attach_driver(name)
        drv.start()
        t0 = time.perf_counter()
        for lo in range(3000, max(len(v) for v in rows.values()), 2048):
            for name in names:
                if lo < len(rows[name]):
                    mgr.get(name).index.insert(rows[name][lo:lo + 2048])
                    drv.notify()
            drv.drain()
        deadline = time.perf_counter() + 60.0
        while (any(mgr.get(n).index.has_compaction_work for n in names)
               and time.perf_counter() < deadline):
            drv.drain()
            time.sleep(0.01)
        t_churn = time.perf_counter() - t0
        for name in names:
            n_t = len(rows[name])
            gone = rng.choice(n_t, n_t // 100, replace=False).tolist()
            assert mgr.get(name).index.delete(gone) == len(gone)
        drv.flush()
        dst = drv.stats()
        assert dst["worker_errors"] == 0 and dst["applied"] >= 3, dst
        assert all(dst["fairness"].get(n, 0) > 0 for n in names), dst
        mst = mgr.stats()
        log(f"[{tag}] {len(x_np)} codes split {[len(rows[n]) for n in names]}; "
            f"churned in {t_churn:.2f} s; shared driver: "
            f"{dst['stage_calls']} worker gathers, {dst['prepares']} "
            f"pre-builds, {dst['applied']} merges applied, fairness (worker "
            f"ops per tenant) {dst['fairness']}; tenants " + "; ".join(
                f"{n}: {c['n_live']} live, {c['segments']} segments, "
                f"version {c['version']}"
                for n, c in mst["collections"].items()))

        assign = [names[i % 3] for i in range(len(q_np))]
        served, batches, hits, misses = serve_pass(mgr, sched, cache, q_np, r,
                                                   assign)
        assert len(served) == len(q_np) and hits == 0, (hits, misses)
        first = batches[0][0]        # weighted-fair: slots follow the weights
        assert sum(first.values()) == 32 and \
            first["a"] < first["b"] < first["c"], batches
        for name in names:
            mine = [i for i, n in enumerate(assign) if n == name]
            idx = mgr.get(name).index
            res, _ = query_paths(s, idx, q_np[mine], r, metric,
                                 f"{tag} {name}", delta=True)
            whole = res[None].neighbor_sets()
            assert all(served[i] == whole[j] for j, i in enumerate(mine)), name
            plain = DynamicHybridIndex(fam, params=idx.params, impl="ref",
                                       **kw).load_state_dict(idx.state_dict())
            ref_res = {f: plain.query(q_np[mine], r, force=f) for f in PATHS}
            _, near = check_results(s, res, ref_res, rows[name], q_np[mine],
                                    metric, r, f"{tag} {name}")
            log(f"[{tag} {name}] {len(mine)} queries: served sets equal the "
                f"whole batch's; kernel = plain on every path "
                f"(near-threshold exceptions {near})")
        again, _, hits2, misses2 = serve_pass(mgr, sched, cache, q_np, r,
                                              assign)
        assert again == served and (hits2, misses2) == (len(q_np), 0), \
            (hits2, misses2)
        v0 = mgr.get("a").index.version
        mgr.get("a").index.insert(q_np[:16])
        assert mgr.get("a").index.version > v0
        _, _, hits3, misses3 = serve_pass(mgr, sched, cache, q_np, r,
                                          assign)
        n_a = assign.count("a")
        assert (hits3, misses3) == (len(q_np) - n_a, n_a), (hits3, misses3)
        waits = {n: (t["batched"], t["queue_wait_max_s"])
                 for n, t in sched.stats()["tenants"].items()}
        log(f"[{tag}] batches of the first pass (per tenant, padded): "
            f"{batches}; repeat pass {hits2} hits / {misses2} misses; after "
            f"an insert into a (version {v0} -> "
            f"{mgr.get('a').index.version}) {hits3} hits / {misses3} misses; "
            f"cache {cache.stats()}; scheduler (batched, max queue wait s) "
            f"per tenant {waits}")

        ck = CheckpointManager(str(root))
        hints = {f"collections/{k}": v
                 for k, v in mgr.state_digests().items()}
        t0 = time.perf_counter()
        drv.consistent_cut(lambda: ck.save_incremental(
            1, {"collections": mgr.state_dict()}, digests=hints,
            blocking=False))
        t_cut = time.perf_counter() - t0
        ck.wait()
        t_save = time.perf_counter() - t0
        assert ck.collection_names(1) == list(names), ck.collection_names(1)
        fresh = CollectionManager(factory)
        tree, _ = ck.restore_tree()
        fresh.load_state_dict(tree["collections"])
        assert fresh.names() == list(names)
        for name in names:
            a, b = mgr.get(name).index, fresh.get(name).index
            assert b.state_digests() == a.state_digests(), name
            ra, la = query_paths(s, a, q_np, r, metric, f"{tag} {name} live",
                                 delta=True)
            rb, lb = query_paths(s, b, q_np, r, metric,
                                 f"{tag} {name} restored", delta=True)
            for f, path in PATHS.items():
                assert rb[f].neighbor_sets() == ra[f].neighbor_sets(), (name, f)
                assert lb[path] == la[path], (name, path)
        cst = ck.stats()
        log(f"[{tag}] collection tree saved in {t_save:.3f} s (cut "
            f"{t_cut:.3f} s), {cst['bytes_written'] / 1e6:.1f} MB in "
            f"{cst['chunks_written']} chunks; collection_names "
            f"{ck.collection_names(1)}; a fresh manager restored in "
            f"{ck.stats()['last_restore_seconds']:.3f} s (read) reports "
            f"equal sets and launches on every path")
        del fresh, tree

        for i in range(5):
            sched.submit(i, collection="c")
        entries = cache.stats()["entries"]
        mgr.drop("c")
        ev = [e for e in obs.events.events()
              if e["kind"] == "collection_drop"][-1]
        assert ev["dropped_requests"] == 5 and ev["purged_cache_entries"] > 0, ev
        assert "c" not in sched.stats()["tenants"] and not sched.queue
        assert entries - cache.stats()["entries"] == ev["purged_cache_entries"]
        recreated = mgr.create("c")
        assert recreated.index.version == 0
        assert cache.get(cache.key(0, r, q_np[2][None], collection="c")) is None
        t_phase = time.perf_counter() - t_phase
        log(f"[{tag}] dropped c: {ev['dropped_requests']} queued requests and "
            f"{ev['purged_cache_entries']} cache entries purged; re-created c "
            f"at version {recreated.index.version}; the phase took "
            f"{t_phase:.1f} s")
        return dict(churn_s=t_churn, fairness=dst["fairness"],
                    tree_save_s=t_save, tree_bytes=cst["bytes_written"],
                    phase_s=t_phase)
    finally:
        drv.stop()
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# the retrieval encoder and RetrievalService at Yi-6B's full width and depth
# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
# The row-sharded indexes (core.distributed, streaming.sharded) on one card
# ---------------------------------------------------------------------------
SHARDS = 4


def check_sharded_launches(launches, used, metric, what, delta_rows,
                           segments=1):
    """A sharded path's launches, summed over the shards: K3's terms mode
    (``route_terms``) once a shard (one launch covers a shard's levels),
    K3's estimate mode never; K2 once for each of a shard's ``segments``
    frozen segments (levels) for each shard routed LSH; the metric's linear scan (K1 or K4) at least
    once for each shard routed linear and, on a streaming index, once
    more for each shard whose delta holds rows (``delta_rows``, a shard's
    rows, or None); the delta's collision test once for each such delta's
    counts and once more where its shard is routed LSH; the bucket hash
    once a device that holds a shard (the queries are hashed once a
    device: between 1 and S launches); no other kernel."""
    S, n_lsh = len(used), int(sum(used))
    held = [n > 0 for n in delta_rows or [0] * S]
    lin = LINEAR_KERNEL[metric]
    for k, got in launches.items():
        if k == "delta_collide":
            ok = got == sum(held) + sum(h and u for h, u in zip(held, used))
        elif k == "route_terms":
            ok = got == S
        elif k == "bucket_hash":
            ok = 1 <= got <= S
        elif k == "lsh_scan":
            ok = got == n_lsh * segments
        elif k == lin:
            need = (S - n_lsh) + sum(held)
            ok = got >= need and (got > 0) == (need > 0)
        else:
            ok = got == 0
        assert ok, (f"{what}: kernel {k} launched {got} times with the shards "
                    f"routed {['lsh' if u else 'linear' for u in used]} and "
                    f"delta rows {delta_rows}")


def sharded_paths(s: Smoke, idx, q, r, metric, tag, delta):
    """Query force None / "lsh" / "linear" through the kernels, the counts
    set to 0 just before each path and read just after it
    (``check_sharded_launches``; ``delta``: a streaming index, whose
    deltas' rows count).  Returns results and launches."""
    rows = idx.index_stats()["delta_per_shard"] if delta else None
    segments = idx.index_stats()["segments"] if delta else 1
    res, launches = {}, {}
    for f, path in PATHS.items():
        res[f], launches[path] = s.path(lambda: idx.query(q, r, force=f))
        check_sharded_launches(launches[path], res[f].used_lsh, metric,
                               f"{tag} {path}", rows, segments)
    return res, launches


class StaticSharded:
    """``make_query_fn``'s query as an index: ``query(q, r, force)`` ->
    ``ShardedQueryResult``."""

    def __init__(self, fn, state, params):
        self.fn, self.state, self.params = fn, state, params

    def query(self, q, r, force=None):
        from repro_torch.streaming import ShardedQueryResult
        d = self.fn(self.state, self.params, q, r, force=force)
        return ShardedQueryResult(
            ids=d["ids"], dists=d["dists"], mask=d["mask"],
            collisions=d["collisions"], cand_est=d["cand_est"],
            used_lsh=d["used_lsh"], n_queries=len(q))


def lsh_truncated(s: Smoke, segments, qb, cap):
    """(Q,) bool: some probed bucket of one of ``segments``' tables holds
    more than ``cap`` rows, so the LSH route's gather cuts it and which
    rows it keeps follows the segment's row order."""
    torch = s.torch
    from repro_torch.core.engine import TableSegment
    lidx = torch.arange(qb.shape[1], device=qb.device)[None, :]
    b = qb.to(torch.int64)
    out = torch.zeros(qb.shape[0], dtype=torch.bool, device=qb.device)
    for g in segments:
        if isinstance(g, TableSegment):
            st = g.tables.starts
            out |= ((st[lidx, b + 1] - st[lidx, b]) > cap).any(1)
    return out.cpu().numpy()


def check_sharded_sets(s: Smoke, res, truth, trunc, x, q, metric, r, tag,
                       dead=frozenset(), lsh_superset=False):
    """The sharded sets per forced route against a plain single-host
    index's (``truth``, force -> sets) over the same rows, up to rows
    within THRESH_EPS of the threshold: linear equal; LSH equal where no
    probed bucket of either index is cut at ``cap`` (``trunc`` False),
    elsewhere within the linear truth (and, for the static index, whose
    shards keep the global row order, a superset of the single-host LSH
    set: ``lsh_superset``); the hybrid between the sharded LSH and
    linear sets; no id in ``dead``; no shard's buffer full (a full one
    could have cut the report).  Returns the near-threshold counts."""
    np = s.np
    sets = {f: v.neighbor_sets() for f, v in res.items()}
    for f, v in res.items():
        counts = v.mask.sum(-1)
        full = int(counts.max())
        if full >= v.mask.shape[-1]:
            sh_i, qi = divmod(int(counts.argmax()), counts.shape[1])
            ids = v.ids[sh_i, qi][v.mask[sh_i, qi]].cpu().numpy()
            raise AssertionError(
                f"{tag} force={f}: shard {sh_i}'s buffer is full for query "
                f"{qi} ({full} of {v.mask.shape[-1]}; {len(set(ids.tolist()))}"
                f" distinct ids, {len(sets[f][qi])} reported over all shards, "
                f"{len(truth['linear'][qi])} in the linear truth)")
        assert not set().union(*sets[f].values()) & dead, \
            f"{tag} force={f}: a deleted id was reported"
    exact = [i for i in sets["lsh"] if not trunc[i]]
    near = {"linear": s.compare_sets(sets["linear"], truth["linear"], metric,
                                     q, x, r, f"{tag} linear"),
            "lsh exact": s.compare_sets({i: sets["lsh"][i] for i in exact},
                                        {i: truth["lsh"][i] for i in exact},
                                        metric, q, x, r, f"{tag} lsh"),
            "lsh<=linear": s.compare_sets(sets["lsh"], truth["linear"],
                                          metric, q, x, r,
                                          f"{tag} lsh<=linear", subset=True),
            "hybrid<=linear": s.compare_sets(sets[None], sets["linear"],
                                             metric, q, x, r,
                                             f"{tag} hybrid<=linear",
                                             subset=True),
            "lsh<=hybrid": s.compare_sets(sets["lsh"], sets[None], metric, q,
                                          x, r, f"{tag} lsh<=hybrid",
                                          subset=True)}
    if lsh_superset:
        near["single lsh<=lsh"] = s.compare_sets(
            truth["lsh"], sets["lsh"], metric, q, x, r,
            f"{tag} single lsh<=sharded lsh", subset=True)
    near["lsh compared exactly"] = len(exact)
    for v in res.values():
        assert bool(s.torch.isfinite(v.dists[v.mask]).all()), \
            f"{tag}: non-finite reported distance"
    return sets, near


def drive_sharded_static(s: Smoke, x, q, radii, make_fam, kw, by_path):
    """``build_sharded`` and ``make_query_fn`` on the Webspam analogue at
    full size, S = 4 shards of 87,475 rows on the card, at each radius of
    the static phase (cap raised where a shard's report would not fit
    the L * cap buffer):
    ``collisions`` equal and ``cand_est`` within 1e-6 of a plain
    single-host ``HybridLSHIndex`` of the same params, both policies and
    both forced routes held to it (``check_sharded_sets``: no row off the
    threshold band outside the brute-force linear set), launches per
    path.  Returns the record."""
    np, torch = s.np, s.torch
    from repro_torch.core import HybridLSHIndex
    from repro_torch.core.distributed import (build_sharded, make_mesh,
                                              make_query_fn)
    from repro_torch.core.index import as_rows
    mesh = make_mesh(SHARDS)
    metric = "cosine"
    n = len(x)
    rec = {}
    for i, r in enumerate(radii):
        fam = make_fam(r)
        tag = f"webspam sharded q{i}"
        plain = HybridLSHIndex(fam, seed=0, impl="ref", **kw).build(x)
        truth = {f: plain.query(q, r, force=f).neighbor_sets()
                 for f in ("lsh", "linear")}
        per_shard = max(int(np.bincount(
            np.fromiter(v, np.int64, len(v)) // (n // SHARDS),
            minlength=SHARDS).max()) for v in truth["linear"].values())
        # max_out is clamped to the LSH route's L * cap (both routes fill
        # one buffer): raise cap, in both indexes, until the buffer holds
        # the largest report of a shard
        cap = kw["cap"]
        while fam.L * cap <= per_shard:
            cap *= 2
        if cap != kw["cap"]:
            plain = HybridLSHIndex(fam, seed=0, impl="ref",
                                   **{**kw, "cap": cap}).build(x)
            truth = {f: plain.query(q, r, force=f).neighbor_sets()
                     for f in ("lsh", "linear")}
        width = min(n // SHARDS, fam.L * cap)
        log(f"[{tag}] r={r:.6g}: at most {per_shard} reported rows of one "
            f"shard; cap {cap} (a shard's buffer {width})")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = build_sharded(fam, plain.params, x, num_buckets=kw["num_buckets"],
                              m=kw["m"], mesh=mesh)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        est = plain.estimate(q)
        qb = plain.bucket_ids(as_rows(q, metric, s.dev))
        trunc = lsh_truncated(s, [plain._segment()], qb, cap)
        out = {"build_s": t_build}
        for policy in ("global", "per_shard"):
            fn = make_query_fn(fam, num_buckets=kw["num_buckets"], mesh=mesh,
                               n_total=n, cost_model=kw["cost_model"],
                               metric=metric, cap=cap, max_out=width,
                               policy=policy)
            idx = StaticSharded(fn, state, plain.params)
            res, launches = sharded_paths(s, idx, q, r, metric,
                                          f"{tag} {policy}", delta=False)
            by_path[f"{tag} {policy}"] = launches
            h = res[None]
            assert torch.equal(h.collisions, est.collisions), f"{tag}: collisions"
            torch.testing.assert_close(h.cand_est, est.cand_est, rtol=1e-6,
                                       atol=0)
            _, near = check_sharded_sets(s, res, truth, trunc, x, q, metric,
                                         r, f"{tag} {policy}",
                                         lsh_superset=True)
            ms = time_query(s, lambda: idx.query(q, r))
            out[policy] = dict(used_lsh=h.used_lsh.tolist(), ms=ms,
                               near=near, launches=launches["hybrid"])
            log(f"[{tag} {policy}] r={r:.6g} k={fam.k}: shards routed "
                f"{['lsh' if u else 'linear' for u in h.used_lsh]}; batch "
                f"{ms:.2f} ms (host clock, synchronised); collisions equal "
                f"the single-host estimate's, cand_est within 1e-6; "
                f"near-threshold exceptions {near}; launches {launches}")
        single = HybridLSHIndex(fam, params=plain.params,
                                **{**kw, "cap": cap}).build(x)
        out["single_host_ms"] = time_hybrid(s, single, q, r)
        log(f"[{tag}] build_sharded {t_build:.3f} s; the single-host index "
            f"on the same rows: {out['single_host_ms']:.2f} ms a batch")
        out["cap"] = cap
        rec[f"q{i}"] = out
        del state, plain, single
        torch.cuda.empty_cache()
    return rec


def route_terms_times(s: Smoke, idx, q_np, tag):
    """K3's terms mode over shard 0's levels of a sharded index, at its
    query batch: bit for bit its plain version, timed (events and CUDA
    graph) beside the plain version and beside K3's estimate mode on the
    same tables.  The bound reads each distinct (table, bucket) a level's
    queries probe once (its m register bytes, two starts, a dead count)
    and writes the (K, Q) counts and (K, Q, m) registers."""
    torch = s.torch
    from repro_torch.core.engine import TableSegment
    from repro_torch.kernels import hll_merge, ref
    q = idx._rows(q_np)
    qb = idx._bucket_fn(idx.params, q).to(torch.int32).contiguous()
    tables = [g.table_terms() for g in idx._segments(0)
              if isinstance(g, TableSegment)]
    nq, v = qb.shape
    K, m = len(tables), tables[0].registers.shape[2]
    kern = lambda: hll_merge.route_terms(qb, tables)  # noqa: E731
    plain = lambda: ref.route_terms(qb, tables)  # noqa: E731
    est = lambda: hll_merge.route_estimate(qb, tables)  # noqa: E731
    for a, b in zip(kern(), plain()):
        assert a.dtype == b.dtype and torch.equal(a, b), f"{tag}: route_terms != plain"
    B = tables[0].registers.shape[1]
    cols = torch.arange(v, device=qb.device)[None, :] * (B + 1)
    distinct = int(torch.unique(qb.to(torch.int64) + cols).numel())
    nbytes = K * distinct * (m + 12) + 4 * nq * v + K * nq * (m + 8)
    bound, by = s.bound_ms(nbytes, K * nq * v * m)
    t = dict(ms=s.cuda_ms(kern), device_ms=s.graph_ms(kern),
             plain_ms=s.cuda_ms(plain), library_ms=None, bound_ms=bound,
             bound_by=by, max_abs_err=0.0,
             route_estimate_ms=s.cuda_ms(est),
             route_estimate_device_ms=s.graph_ms(est),
             shape=f"Q={nq} V={v} m={m} K={K} levels of shard 0 "
                   f"({distinct} distinct probed buckets a level)")
    log(f"[{tag}] route_terms over shard 0's {K} levels: {t['ms']:.4f} ms, "
        f"device {t['device_ms']:.4f}; plain {t['plain_ms']:.4f}; "
        f"route_estimate on the same tables {t['route_estimate_ms']:.4f}, "
        f"device {t['route_estimate_device_ms']:.4f}; bound "
        f"{t['bound_ms']:.3g} ({t['bound_by']}); {t['shape']}")
    return t


def sharded_truth(s: Smoke, sh, x_all, live_ids, q, r):
    """A plain (``impl="ref"``) single-host streaming index on the card,
    built on the surviving rows with the sharded index's params: its
    forced sets (external ids) and, per query, whether it cuts a probed
    bucket at cap."""
    from repro_torch.streaming import CompactionPolicy, DynamicHybridIndex
    plain = DynamicHybridIndex(
        sh.family, params=sh.params, impl="ref", num_buckets=sh.num_buckets,
        m=sh.m, cap=sh.cap, cost_model=sh.cost_model,
        delta_capacity=sh.delta_capacity * sh.shards,
        policy=CompactionPolicy(delta_fill=2.0, tombstone_ratio=2.0),
        device=s.dev).build(x_all[live_ids], ids=live_ids)
    truth = {f: plain.query(q, r, force=f).neighbor_sets()
             for f in ("lsh", "linear")}
    qt = plain._rows(q)
    trunc = lsh_truncated(s, plain._segments(), plain._bucket_fn(
        plain.params, qt), sh.cap)
    del plain
    return truth, trunc


def sharded_trunc(s: Smoke, sh, q):
    """(Q,) bool: the sharded index cuts a probed bucket of some level of
    some shard at cap."""
    qt = sh._rows(q)
    qb = sh._bucket_fn(sh.params, qt)
    out = s.np.zeros(len(q), bool)
    for sh_i in range(sh.shards):
        out |= lsh_truncated(s, sh._segments(sh_i), qb, sh.cap)
    return out


def shard_cost_ratios(sh, q):
    """Per shard, the batch's summed Eq. (1) LSH cost over its Eq. (2)
    linear cost, from the shard's own terms: the per_shard vote (LSH
    below 1)."""
    from repro_torch.core.engine import finalize_route
    qb = sh._bucket_fn(sh.params, sh._rows(q))
    loads, n_pads = sh.shard_loads(), sum(l.n_pad for l in sh._levels)
    out = []
    for i in range(sh.shards):
        rt = finalize_route(sh._engine.segment_terms(sh._segments(i), qb),
                            sh.cost_model, n_live=int(loads[i]),
                            n_scan=int(sh._delta_count_s[i]) + n_pads)
        out.append(float(rt.lsh_cost.sum()) / (rt.linear_cost * len(q)))
    return out


def padded_rows(sh):
    """Rows each shard holds on the card (every level's common n_pad and
    the delta's slots) against its live rows."""
    st = sh.index_stats()
    return dict(padded=sum(st["level_n_pads"]) + sh.delta_capacity,
                live=[a + b for a, b in zip(st["live_per_shard"],
                                            st["delta_per_shard"])],
                skew=st["shard_skew"], rows_moved=st["rows_moved"],
                level_n_pads=st["level_n_pads"])


def sharded_check(s: Smoke, sh, x_all, live_ids, q, r, tag, by_path,
                  dead, routings=("global", "per_shard")):
    """Every path under each routing, held to a plain single-host index on
    the survivors; returns per routing the hybrid's shard routes, launches
    and near-threshold counts."""
    truth, trunc = sharded_truth(s, sh, x_all, live_ids, q, r)
    trunc = trunc | sharded_trunc(s, sh, q)
    out = {}
    for routing in routings:
        sh.routing = routing
        res, launches = sharded_paths(s, sh, q, r, "l1", f"{tag} {routing}",
                                      delta=True)
        by_path[f"{tag} {routing}"] = launches
        _, near = check_sharded_sets(s, res, truth, trunc, x_all, q, "l1", r,
                                     f"{tag} {routing}", dead=dead)
        out[routing] = dict(used_lsh=res[None].used_lsh.tolist(), near=near,
                            launches=launches)
        log(f"[{tag} {routing}] shards routed "
            f"{['lsh' if u else 'linear' for u in res[None].used_lsh]}; "
            f"every path held to a plain single-host index on "
            f"{len(live_ids)} rows (near-threshold / exact counts {near}); "
            f"launches {launches}")
    sh.routing = "per_shard"
    return out


def fitting_radius(s: Smoke, x, q, radii, metric, limit):
    """The largest of ``radii`` at which no query has more than ``limit``
    rows of ``x`` within the radius (plain distances on the card), so
    that a shard's (Q, max_out) buffer holds every report; else the
    smallest.  Returns (index, radius, the largest report)."""
    torch = s.torch
    from repro_torch.kernels import ops
    d = ops.pairwise_dist(torch.from_numpy(q).to(s.dev),
                          torch.from_numpy(x).to(s.dev), metric, impl="ref")
    best = None
    for i, r in enumerate(radii):
        t = r * r if metric == "l2" else r
        most = int((d <= t).sum(1).max())
        if most <= limit or best is None:
            best = (i, r, most)
    del d
    return best


def drive_sharded_streaming(s: Smoke, x, q, make_fam, radii, by_path,
                            n_build=524288,
                            batch=4096, seed=11, skew_rows=65536,
                            delta_rows=8192, max_out=16384):
    """The row-sharded streaming index on the CoverType analogue at full
    size, S = 4 shards on the card (one 4-shard deployment mapped onto
    one H100): built on ``n_build`` rows, the rest inserted in batches of
    ``batch`` with 64 deletes after each and a hybrid query between
    batches, merges staged by a ``CompactionDriver`` worker and applied
    by its ``drain`` between batches, then ticked to the end with a query
    between ticks (``validate_locations`` after each merge); checked under
    both routings on every path (``sharded_check``), timed beside the
    single-host index on the same rows, K3's terms mode timed; then
    checkpointed and restored onto 4 and, elastically, 2 shards; then a
    skewed stream of ``skew_rows`` rows near the queries (each query's
    nearest rows, in L1) pinned to shard 0, under
    ``keep_local`` and again under ``load_balance``.  Returns the
    ``[sharded]`` record and the terms mode's times."""
    import shutil
    import tempfile
    np, torch = s.np, s.torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import PAPER_PRESETS
    from repro_torch.core.distributed import make_mesh
    from repro_torch.kernels import ops
    from repro_torch.streaming import (CompactionDriver, CompactionPolicy,
                                       DynamicHybridIndex,
                                       ShardedDynamicHybridIndex,
                                       make_placement_policy)
    tag = "covertype sharded"
    t_phase = time.perf_counter()
    i_r, r, most = fitting_radius(s, x, q, radii, "l1", max_out // 8)
    fam = make_fam(r)
    log(f"[{tag}] radius q{i_r} r={r:.6g}: the largest of {radii} at which "
        f"no query has more than {max_out // 8} rows of the corpus within it "
        f"({most}), so that a shard's buffer of max_out = {max_out} holds "
        f"every report through the churn and the skewed streams")
    mesh = make_mesh(SHARDS)
    kw = dict(num_buckets=65536, m=64, cap=256,
              delta_capacity=delta_rows // SHARDS,
              cost_model=PAPER_PRESETS["covertype"],
              policy=CompactionPolicy(step_rows=delta_rows))
    rec = {"shards": SHARDS, "devices": [str(d) for d in mesh.devices],
           "radius": r, "radius_index": i_r}
    torch.cuda.reset_peak_memory_stats()
    sh = ShardedDynamicHybridIndex(fam, mesh=mesh, seed=0, max_out=max_out,
                                   routing="per_shard", **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sh.build(x[:n_build])
    torch.cuda.synchronize()
    rec["build_s"] = time.perf_counter() - t0
    n = len(x)
    rng = np.random.default_rng(seed)
    dead = set()
    drv = CompactionDriver(sh, budget_rows=sh.policy.step_rows).start()
    merges = 0
    t0 = time.perf_counter()
    for lo in range(n_build, n, batch):
        sh.insert(x[lo:lo + batch])
        drv.notify()
        gone = [int(e) for e in rng.choice(min(lo + batch, n), 64,
                                           replace=False)
                if int(e) not in dead]
        assert sh.delete(gone) == len(gone)
        dead.update(gone)
        sh.query(q, r)                       # the control thread serves
        if drv.drain():
            merges += 1
            sh.validate_locations()
    rec["churn_s"] = time.perf_counter() - t0
    rec["churn_docs_per_s"] = (n - n_build) / rec["churn_s"]
    ticks, tick_s = 0, []
    t_end = time.perf_counter() + 300
    while sh.has_compaction_work:
        assert time.perf_counter() < t_end, f"{tag}: merges never drained"
        sh.query(q, r)
        t0 = time.perf_counter()
        applied = drv.drain()
        tick_s.append(time.perf_counter() - t0)
        ticks += 1
        if applied:
            merges += 1
            sh.validate_locations()
        else:
            time.sleep(0.002)
    drv.stop(flush=True)
    st, ds = sh.index_stats(), drv.stats()
    assert ds["worker_errors"] == 0 and ds["applied"] >= 1, ds
    work = st["work_seconds"]
    rec["merges"] = dict(applied=ds["applied"], worker_gathers=ds["stage_calls"],
                         ticks_after_churn=ticks, drain_ms_median=(
                             statistics.median(tick_s) * 1e3 if tick_s else None),
                         stage_s=work["stage"], apply_s=work["apply"],
                         apply_s_per_merge=work["apply"] / max(ds["applied"], 1),
                         stage_s_per_gather=work["stage"] / max(ds["stage_calls"], 1),
                         merges_per_level=st["merges_per_level"],
                         levels=st["levels"], level_n_pads=st["level_n_pads"])
    log(f"[{tag}] {SHARDS} shards on {rec['devices']}: built on {n_build} rows "
        f"in {rec['build_s']:.2f} s; inserted {n - n_build} rows in batches of "
        f"{batch} with {len(dead)} deletes in {rec['churn_s']:.2f} s "
        f"({rec['churn_docs_per_s']:.0f} docs/s, a hybrid query after each "
        f"batch); merges {rec['merges']}; validate_locations after each of "
        f"{merges} merges applied")
    live_ids = np.setdiff1d(np.arange(n), np.fromiter(dead, np.int64))
    assert sh.n == len(live_ids)
    rec["churned"] = sharded_check(s, sh, x, live_ids, q, r, f"{tag} churned",
                                   by_path, dead)
    # times: global against per_shard, beside the single-host index
    single = DynamicHybridIndex(fam, params=sh.params, device=s.dev,
                                **{**kw, "delta_capacity": delta_rows}).build(
                                    x[live_ids], ids=live_ids)
    ms = {}
    for routing in ("global", "per_shard"):
        sh.routing = routing
        ms[routing] = time_query(s, lambda: sh.query(q, r))
    ms["single_host"] = time_hybrid(s, single, q, r)
    del single
    sh.routing = "per_shard"
    rec["batch_ms"] = ms
    log(f"[{tag} churned] a 100-query hybrid batch (host clock, "
        f"synchronised, median of 5): global {ms['global']:.2f} ms, per_shard "
        f"{ms['per_shard']:.2f} ms; the single-host index on the same rows "
        f"{ms['single_host']:.2f} ms")
    profile_hybrid(s, sh, q, r, f"{tag} churned per_shard", ms["per_shard"])
    terms = route_terms_times(s, sh, q, f"{tag} churned")
    rec["route_terms"] = {k: v for k, v in terms.items() if k != "shape"}

    # -- durability: restore onto 4 and, elastically, 2 shards ----------
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_sharded_"))
    try:
        mgr = CheckpointManager(str(root))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.save_index(1, sh)
        rec["save_s"] = time.perf_counter() - t0
        rec["checkpoint_bytes"] = sum(f.stat().st_size for f in root.rglob("*")
                                      if f.is_file())
        live_res, live_l = sharded_paths(s, sh, q, r, "l1", f"{tag} live",
                                         delta=True)
        for shards in (SHARDS, 2):
            back = ShardedDynamicHybridIndex(fam, mesh=make_mesh(shards),
                                             max_out=max_out,
                                             routing="per_shard", **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            assert mgr.restore_index(back) == 1
            torch.cuda.synchronize()
            rec[f"restore_s_{shards}"] = time.perf_counter() - t0
            assert back.validate_locations() == sh.n
            res, launches = sharded_paths(s, back, q, r, "l1",
                                          f"{tag} restored S={shards}",
                                          delta=True)
            by_path[f"{tag} restored S={shards}"] = launches
            if shards == SHARDS:
                for f, path in PATHS.items():
                    assert (res[f].neighbor_sets()
                            == live_res[f].neighbor_sets()), (shards, f)
                    assert launches[path] == live_l[path], (shards, path)
                what = "every path's sets and launches equal the live index's"
            else:
                # the re-dealt levels order each bucket's rows otherwise,
                # so LSH sets are compared where no bucket is cut at cap
                trunc = sharded_trunc(s, sh, q) | sharded_trunc(s, back, q)
                a = {f: v.neighbor_sets() for f, v in res.items()}
                b = {f: v.neighbor_sets() for f, v in live_res.items()}
                assert a["linear"] == b["linear"], (shards, "linear")
                exact = [i for i in a["lsh"] if not trunc[i]]
                assert all(a["lsh"][i] == b["lsh"][i] for i in exact), \
                    (shards, "lsh")
                assert all(a["lsh"][i] <= a["linear"][i] for i in a["lsh"])
                what = (f"elastic: linear sets equal the live index's, LSH "
                        f"sets on the {len(exact)} queries no bucket cut")
            log(f"[{tag}] restored onto {shards} shards in "
                f"{rec[f'restore_s_{shards}']:.2f} s: {what}; launches "
                f"{launches}")
            del back
            torch.cuda.empty_cache()
        log(f"[{tag}] checkpoint: {rec['checkpoint_bytes'] / 1e6:.1f} MB "
            f"saved in {rec['save_s']:.2f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # -- a skewed stream near the queries, pinned to shard 0 -------------
    per_query = -(-skew_rows // len(q))
    near = torch.topk(ops.pairwise_dist(torch.from_numpy(q).to(s.dev),
                                        torch.from_numpy(x).to(s.dev), "l1",
                                        impl="ref"), per_query, dim=1,
                      largest=False).indices.reshape(-1)[:skew_rows]
    near = near.cpu().numpy()
    x_all = np.concatenate([x, x[near], x[near]])
    rec["skew"] = {}
    for k, placement in enumerate(("keep_local", "load_balance")):
        sh.placement = make_placement_policy(placement)
        ids0 = n + k * len(near)
        drv = CompactionDriver(sh, budget_rows=sh.policy.step_rows).start()
        t0 = time.perf_counter()
        for lo in range(0, len(near), batch):
            sh.insert(x[near[lo:lo + batch]],
                      ids=np.arange(ids0 + lo, ids0 + lo + batch), shard=0)
            drv.notify()
            drv.drain()
        drv.stop(flush=True)
        sh.validate_locations()
        t_skew = time.perf_counter() - t0
        live_ids = np.concatenate([live_ids, np.arange(ids0, ids0 + len(near))])
        rows = padded_rows(sh)
        chk = sharded_check(s, sh, x_all, live_ids, q, r,
                            f"{tag} skewed {placement}", by_path, dead,
                            routings=("per_shard",))
        rec["skew"][placement] = dict(rows, seconds=t_skew,
                                      used_lsh=chk["per_shard"]["used_lsh"],
                                      cost_ratio=shard_cost_ratios(sh, q),
                                      ms=time_query(s, lambda: sh.query(q, r)))
        log(f"[{tag} skewed {placement}] +{len(near)} rows near the queries "
            f"pinned to shard 0 in {t_skew:.2f} s: shard_skew "
            f"{rows['skew']:.3f}, rows_moved {rows['rows_moved']}, live rows a "
            f"shard {rows['live']}, rows a shard holds on the card (levels' "
            f"n_pad {rows['level_n_pads']} + the delta) {rows['padded']}; "
            f"per_shard routes {chk['per_shard']['used_lsh']} (each shard's "
            f"LSH / linear cost {rec['skew'][placement]['cost_ratio']}); "
            f"batch {rec['skew'][placement]['ms']:.2f} ms")
    splits = [name for name, v in list(rec["churned"].items())
              + [(f"skewed {p}", v) for p, v in rec["skew"].items()]
              if name != "global" and 0 < sum(v["used_lsh"]) < SHARDS]
    rec["per_shard_splits"] = splits
    if splits:
        log(f"[{tag}] per_shard split the shards between routes in: {splits}")
    else:
        worst = max(v["cost_ratio"][0] for v in rec["skew"].values())
        log(f"[{tag}] per_shard never split the shards between routes at "
            f"q{i_r} r={r:.6g}: every shard's summed Eq. (1) cost stayed below "
            f"its Eq. (2) cost in every batch checked; dense shard 0 came "
            f"closest at {worst:.3g} of it under the skew (the paper's "
            f"CoverType preset sends all 100 queries to LSH at every radius "
            f"on the single-host index too)")
    rec["peak_bytes"] = torch.cuda.max_memory_allocated()
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"[{tag}] peak device memory {rec['peak_bytes'] / 1e9:.2f} GB; the "
        f"phase took {rec['phase_s']:.1f} s")
    del sh
    torch.cuda.empty_cache()
    return rec, terms


def sharded_retrieval(s: Smoke, svc, cfg, par, params, rcfg, corpus, extra,
                      gone, qb, radii, rows, by_path):
    """A second ``RetrievalService`` on a 4-shard mesh of the card, sharing
    the first's encoder parameters (no second copy), fed the same
    documents, additions and removals.  Its cap is raised to the largest
    bucket of the corpus, so that no bucket is cut.  Per radius and
    routing, every path (launches asserted) is held to the single-host
    service's index on the embeddings it computed: the linear sets to its
    forced linear sets, the LSH sets to what its LSH route reports when
    no bucket is cut (the live rows within r that share a bucket with the
    query in some table); the hybrid between them, no removed id."""
    import dataclasses
    np, torch = s.np, s.torch
    from repro_torch.core.distributed import make_mesh
    from repro_torch.kernels import ops
    from repro_torch.serve import RetrievalService
    idx = svc.index
    live = np.setdiff1d(np.arange(len(rows)), np.fromiter(gone, np.int64))
    x_live = torch.from_numpy(rows[live]).to(s.dev)
    bx = idx._bucket_fn(idx.params, x_live)                  # (n, L)
    biggest = max(int(torch.bincount(bx[:, t].to(torch.int64)).max())
                  for t in range(bx.shape[1]))
    cap = 1 << (biggest - 1).bit_length()
    scfg = dataclasses.replace(rcfg, mesh=make_mesh(SHARDS), cap=cap,
                               shard_max_out=len(rows))
    svc2 = RetrievalService(cfg, par, params, scfg, device=s.dev)
    assert svc2.params is svc.params
    t0 = time.perf_counter()
    svc2.index_corpus(corpus)
    svc2.add_documents(extra)
    assert svc2.remove_documents(sorted(gone)) == len(gone)
    while svc2.compaction_tick():
        pass
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    assert svc2.index.n == idx.n == len(live)
    emb = svc.embed(qb)
    q_np = emb.cpu().numpy()
    d = ops.pairwise_dist(emb, x_live, "cosine", impl="ref")
    collide = (idx._bucket_fn(idx.params, emb)[:, None, :]
               == bx[None, :, :]).any(-1)
    out = {"build_s": t_build, "cap": cap, "largest_bucket": biggest}
    trunc = np.zeros(len(q_np), bool)
    for i, r in enumerate(radii):
        within = (d <= r).cpu().numpy()
        lsh = (collide & (d <= r)).cpu().numpy()
        truth = {"linear": {j: set(live[within[j]].tolist())
                            for j in range(len(q_np))},
                 "lsh": {j: set(live[lsh[j]].tolist())
                         for j in range(len(q_np))}}
        single = idx.query(emb, r, force="linear").neighbor_sets()
        n_near = s.compare_sets(single, truth["linear"], "cosine", q_np,
                                rows, r, f"retrieval sharded r{i} truth")
        for routing in ("global", "per_shard"):
            svc2.index.routing = routing
            tag = f"retrieval sharded r{i} {routing}"
            res, launches = sharded_paths(s, svc2.index, emb, r, "cosine", tag,
                                          delta=True)
            by_path[tag] = launches
            _, near = check_sharded_sets(s, res, truth, trunc, rows, q_np,
                                         "cosine", r, tag, dead=gone)
            near["single-host linear = truth"] = n_near
            ms = time_query(s, lambda: svc2.index.query(emb, r))
            out[f"r{i} {routing}"] = dict(used_lsh=res[None].used_lsh.tolist(),
                                          index_ms=ms, near=near)
            log(f"[{tag}] shards routed "
                f"{['lsh' if u else 'linear' for u in res[None].used_lsh]}; "
                f"index {ms:.2f} ms a batch of {len(q_np)}; sets equal the "
                f"single-host service's linear sets and its uncut LSH sets "
                f"(near-threshold / exact counts {near}); launches {launches}")
    st = svc2.stats
    out["live_per_shard"] = st["live_per_shard"]
    out["shard_skew"] = st["shard_skew"]
    log(f"[retrieval sharded] {SHARDS} shards, cap {cap} (the largest bucket "
        f"holds {biggest} rows): indexed, +1,024 / -{len(gone)} in "
        f"{t_build:.2f} s; live a shard {st['live_per_shard']}, skew "
        f"{st['shard_skew']:.3f}, placement {st['placement']}")
    svc2.shutdown()
    del svc2, d, collide, x_live
    torch.cuda.empty_cache()
    return out


RETRIEVAL_ARCH = "yi-6b"
RETRIEVAL_DOCS = 8192        # 128 batches of 64 documents of 32 tokens
RETRIEVAL_SEQ = 32
RETRIEVAL_BATCH = 64
EMBED_COS = 0.999            # bf16 embeddings vs float32 ones, a row
GREEDY_MARGIN = 1e-2         # of the logit range: greedy == prefill argmax


def rows_by_id(idx, rows):
    """Write each live or dead row of a streaming index into ``rows``
    (numpy, indexed by external id) from its ``state_dict()``."""
    import numpy as np
    st = idx.state_dict()
    parts = [(seg["x"][:int(seg["meta"]["n_rows"])],
              seg["ids"][:int(seg["meta"]["n_rows"])])
             for seg in st["segments"].values()]
    count = int(st["delta"]["count"])
    parts.append((st["delta"]["x"][:count], st["delta"]["ids"][:count]))
    for x, ids in parts:
        rows[np.asarray(ids, np.int64)] = x
    return rows


def served_sets(out, uids):
    """Each query row's reported id set, in submission order."""
    return [set(ids.tolist()) for u in uids for ids in out[u].ids]


def retrieval_queries(s: Smoke, svc, plain, emb, r, rows, gone, tag):
    """The service's index on every path (launches asserted) against the
    plain index on the same embeddings: sets equal off the threshold
    band, LSH within linear, no removed id.  Returns the results, the
    launches and the near-threshold counts."""
    q_np = emb.cpu().numpy()
    res, launches = query_paths(s, svc.index, emb, r, "cosine", tag,
                                delta=True)
    ref_res = {f: plain.query(emb, r, force=f) for f in PATHS}
    sets, near = check_results(s, res, ref_res, rows, q_np, "cosine", r, tag)
    for f, v in sets.items():
        for i, ids in v.items():
            assert not ids & gone, f"{tag} force={f}: query {i} reports a removed id"
    return res, launches, near


def drive_retrieval(s: Smoke, by_path):
    """``RetrievalService`` and ``generate`` on Yi-6B at its full width and
    depth (32 layers, d_model 4,096, 32 heads, GQA kv 4, d_ff 11,008,
    vocab 64,000, bf16; random weights from seed 0, drawn on the card).

    1. the model drawn leaf by leaf; its bytes, seconds and peak memory;
       the bf16 embeddings of two documents against float32 ones from the
       same weights (cosine >= EMBED_COS a row);
    2. two radii at the 0.005 and 0.03 quantiles of random-pair cosine
       distances of a 1,024-document sample;
    3. the service (``RetrievalConfig`` defaults: L 20, B 4,096, m 64,
       cap 128, beta/alpha 10, delta 4,096) indexes 8,192 documents of 32
       tokens;
    4. 64 queries at each radius on every path against a plain
       (``impl="ref"``) index of the same state; K1, K2 and K3 timed at
       d = 4,096 (``kernel_times`` on a static index of the corpus, the
       same family and draws); 100 requests of 1-4 rows
       through ``submit`` / ``drain_batches`` (each coalesced batch's sets
       against the plain index on the embeddings the service computed, its
       launches against its route split, the drain's equal to their sum),
       then the same requests again, all from the cache; 1,024 documents
       added, 256 removed, ``compaction_tick`` until False (the plain
       index fed the same rows and deletes); the queries again;
    5. the service checkpointed (the "cut" barrier) under TMPDIR and
       restored into a fresh service: equal sets and launches on every
       path;
    6. ``generate`` (batch 4, prompt 32, 16 new tokens), then a prefill of
       the prompt and the first 15 tokens: greedy tokens equal its argmax
       wherever its top-2 margin exceeds GREEDY_MARGIN of the logit range.
    Returns the ``[retrieval]`` record."""
    import copy
    import dataclasses
    import shutil
    import tempfile
    np, torch, dev = s.np, s.torch, s.dev
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.core import HybridLSHIndex
    from repro_torch.data import lm_batch
    from repro_torch.models import (ParallelConfig, forward_embed,
                                    hidden_states, init_params)
    from repro_torch.serve import (RetrievalConfig, RetrievalService,
                                   generate, make_serve_prefill,
                                   make_serve_step)
    from repro_torch.streaming import DynamicHybridIndex
    t_phase = time.perf_counter()
    cfg = get_config(RETRIEVAL_ARCH)
    par = ParallelConfig(attn_chunk_q=64, attn_chunk_k=64)
    rec = {"card": None, "arch": cfg.name, "layers": cfg.n_layers,
           "d_model": cfg.d_model}

    def batch(seed, step, b=RETRIEVAL_BATCH, seq=RETRIEVAL_SEQ):
        out = lm_batch(seed, step, batch=b, seq=seq, vocab=cfg.vocab,
                       device=dev)
        out.pop("labels")
        return out

    def synced(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # -- 1. the model ---------------------------------------------------
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    params, rec["init_s"] = synced(lambda: init_params(cfg, 0, device=dev))
    rec["param_bytes"] = params.nbytes()
    rec["init_peak_bytes"] = torch.cuda.max_memory_allocated() - base
    assert rec["param_bytes"] == 2 * cfg.num_params() + 2 * cfg.d_model * (
        2 * cfg.n_layers + 1), rec["param_bytes"]
    log(f"[retrieval] {cfg.name}: {cfg.num_params()} parameters, "
        f"{rec['param_bytes'] / 1e9:.3f} GB in bf16 (norms included), drawn "
        f"on the card in {rec['init_s']:.2f} s; peak "
        f"{rec['init_peak_bytes'] / 1e9:.3f} GB above the "
        f"{base / 1e9:.3f} GB already allocated")
    small = batch(7, 0, b=2)
    with torch.no_grad():
        e16 = forward_embed(params, small, cfg, par)
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        p32 = copy.deepcopy(params).float()
        e32 = forward_embed(p32, small, cfg32, par)
    del p32
    torch.cuda.empty_cache()
    assert e16.shape == (2, cfg.d_model) and bool(torch.isfinite(e16).all())
    cos = (e16 * e32).sum(1).cpu().numpy()
    assert cos.min() >= EMBED_COS, f"bf16 embeddings vs float32: cosine {cos}"
    rec["embed_cos_bf16_vs_f32"] = cos.tolist()
    log(f"[retrieval] the bf16 embeddings of 2 documents against float32 "
        f"ones from the same weights: cosine {cos.tolist()} (>= {EMBED_COS})")

    # -- 2. radii -------------------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        sample = torch.cat([forward_embed(params, batch(1, i), cfg, par)
                            for i in range(1024 // RETRIEVAL_BATCH)])
    radii = pick_radii(sample.cpu().numpy(), "cosine")[1:3]
    rec["radii"] = radii
    log(f"[retrieval] radii at the 0.005 and 0.03 quantiles of random-pair "
        f"cosine distances of 1,024 documents: {radii}")

    # -- 3. the service -------------------------------------------------
    rcfg = RetrievalConfig(radius=radii[1])
    svc = RetrievalService(cfg, par, params, rcfg, device=dev)
    n_batches = RETRIEVAL_DOCS // RETRIEVAL_BATCH
    corpus = [batch(1, i) for i in range(n_batches)]
    n, rec["index_corpus_s"] = synced(lambda: svc.index_corpus(corpus))
    assert n == RETRIEVAL_DOCS and svc.index.n == n
    times = []
    for b in corpus[:5]:
        _, t = synced(lambda: svc.embed(b))
        times.append(t)
    rec["embed_ms"] = statistics.median(times) * 1e3
    tokens = RETRIEVAL_BATCH * RETRIEVAL_SEQ
    rec["tokens_per_s"] = tokens / (rec["embed_ms"] / 1e3)
    flops = 2.0 * cfg.num_params() * tokens
    rec["bf16_peak_share"] = flops / (rec["embed_ms"] / 1e3) / s.bf16
    log(f"[retrieval] index_corpus: {n} documents ({n * RETRIEVAL_SEQ} "
        f"tokens) in {rec['index_corpus_s']:.2f} s; embed "
        f"{rec['embed_ms']:.2f} ms a {RETRIEVAL_BATCH} x {RETRIEVAL_SEQ} "
        f"batch (median of 5): {rec['tokens_per_s']:.0f} tokens/s, "
        f"{rec['bf16_peak_share']:.3f} of the bf16 dense peak "
        f"({s.bf16 / 1e12:.0f} TFLOP/s) at 2 x {cfg.num_params()} FLOP a "
        f"token; {svc.index.family}")
    kw = dict(num_buckets=rcfg.num_buckets, m=rcfg.hll_m, cap=rcfg.cap,
              delta_capacity=rcfg.delta_capacity, device=dev,
              cost_model=svc.index.cost_model, policy=svc.index.policy)
    plain = DynamicHybridIndex(svc.index.family, params=svc.index.params,
                               impl="ref", **kw).load_state_dict(
                                   svc.index.state_dict())
    rows = rows_by_id(svc.index, np.zeros(
        (RETRIEVAL_DOCS + 1024, cfg.d_model), np.float32))

    # -- 4. queries -----------------------------------------------------
    qb = batch(2, 0)
    mixes, near = {}, {}
    gone = set()
    routes = {"lsh": 0, "linear": 0}
    for i, r in enumerate(radii):
        (res, emb), _ = synced(lambda: svc.query(qb, radius=r))
        assert emb.shape == (RETRIEVAL_BATCH, cfg.d_model)
        _, launches, near[f"r{i}"] = retrieval_queries(
            s, svc, plain, emb, r, rows, gone, f"retrieval r{i}")
        by_path[f"retrieval r{i}"] = launches
        n_lsh = len(res.lsh_idx)
        routes["lsh"] += n_lsh
        routes["linear"] += len(res.lin_idx)
        _, t_embed = synced(lambda: svc.embed(qb))
        t_index = time_hybrid(s, svc.index, emb, r)
        mixes[f"r{i}"] = dict(radius=r, lsh=n_lsh, linear=len(res.lin_idx),
                              embed_ms=t_embed * 1e3, index_ms=t_index,
                              mean_reported=float(np.mean(
                                  [len(res.neighbors(j))
                                   for j in range(res.n_queries)])))
        log(f"[retrieval r{i}] r={r:.6g}: {n_lsh} lsh / {len(res.lin_idx)} "
            f"linear; mean {mixes[f'r{i}']['mean_reported']:.1f} reported; "
            f"a batch of 64 queries: embed {t_embed * 1e3:.2f} ms, index "
            f"{t_index:.2f} ms (hybrid, host clock, synchronised); kernel = "
            f"plain on every path (near-threshold exceptions {near[f'r{i}']}); "
            f"launches {launches}")
    # K1, K2 and K3 timed at the service's width (d = 4,096), on a static
    # index of the same corpus, family and draws
    static = HybridLSHIndex(svc.index.family, params=svc.index.params,
                            num_buckets=rcfg.num_buckets, m=rcfg.hll_m,
                            cap=rcfg.cap, device=dev).build(
                                rows[:RETRIEVAL_DOCS])
    rec["kernel_times"] = kernel_times(s, static, emb.cpu().numpy(),
                                       radii[1], "cosine")
    log_kernel_times("retrieval r1 (d = 4,096)", rec["kernel_times"])
    del static

    # 100 requests of 1-4 rows through the coalesced path
    rng = np.random.default_rng(5)
    sizes = rng.integers(1, 5, 100)
    req_toks = batch(3, 0, b=int(sizes.sum()))["tokens"].cpu().numpy()
    recorded = []
    embed = svc.embed

    def tap(b):                   # the embeddings the service computes
        e = embed(b)
        recorded.append((np.asarray(b["tokens"]), e))
        return e

    svc.embed = tap

    def drain_pass():
        off, uids = 0, []
        for k in sizes:
            uids.append(svc.submit(req_toks[off:off + k]))
            off += k
        out = svc.drain_batches(force=True)
        assert sorted(out) == sorted(uids)
        return out, uids

    t0 = traced_batches(svc.index)
    (out, uids), launches = s.path(drain_pass)
    held = int(svc.index.delta.count > 0)     # untraced, as below
    launches["delta_collide"] -= held * (traced_batches(svc.index) - t0)
    groups = len(recorded)
    by_path["retrieval drain"] = {"drain": launches}
    where = {}
    for g, (toks, _) in enumerate(recorded):
        for j, row in enumerate(toks):       # pad rows repeat the last
            where.setdefault(row.tobytes(), (g, j))
    got = served_sets(out, uids)
    # each coalesced batch queried again on its own: its launches checked
    # against its route split, and the drain's equal to their sum
    k_sets, p_sets, summed = [], [], dict.fromkeys(launches, 0)
    for g, (toks, e) in enumerate(recorded):
        t0 = traced_batches(svc.index)
        res, lg = s.path(lambda: svc.index.query(e, radii[1]))
        n_lsh = len(res.lsh_idx)
        traced = traced_batches(svc.index) - t0
        check_path_launches(lg, n_lsh, len(e) - n_lsh, "cosine",
                            f"retrieval drain batch {g}",
                            svc.index.delta.count, traced,
                            svc.index.index_stats()["segments"])
        lg["delta_collide"] -= held * traced
        summed = {k: v + lg[k] for k, v in summed.items()}
        k_sets.append(res.neighbor_sets())
        p_sets.append(plain.query(e, radii[1]).neighbor_sets())
    assert launches == summed, ("drain launches", launches, summed)
    n_near = 0
    for i, row in enumerate(req_toks):
        g, j = where[row.tobytes()]
        assert got[i] == k_sets[g][j], f"drained request row {i}"
        q = recorded[g][1][j].cpu().numpy()
        n_near += s.compare_sets({0: got[i]}, {0: p_sets[g][j]}, "cosine",
                                 q[None], rows, radii[1], "retrieval drain")
    (again, uids2), launches2 = s.path(drain_pass)
    del svc.embed
    assert all(again[u].cached for u in uids2), "repeat pass missed the cache"
    assert served_sets(again, uids2) == got
    assert launches2["route_estimate"] == 0, launches2
    st = svc.stats
    log(f"[retrieval] 100 requests ({int(sizes.sum())} rows) served in "
        f"{groups} coalesced batches, sets equal the plain index's on the "
        f"embeddings the service computed ({n_near} near-threshold "
        f"exceptions); the repeat pass: all {len(uids2)} from the cache; "
        f"cache {st['cache']}; drain launches {launches}")
    rec["drain"] = dict(requests=len(uids), rows=int(sizes.sum()),
                        batches=groups, cache_hits=st["cache"]["hits"])

    # churn: add 1,024, remove 256, compaction ticks
    extra = [batch(1, n_batches + i) for i in range(1024 // RETRIEVAL_BATCH)]
    new_ids = svc.add_documents(extra)
    assert len(new_ids) == 1024
    rows_by_id(svc.index, rows)
    d = svc.index.delta
    plain.insert(d.x[:d.count].clone(), ids=new_ids)
    gone = set(rng.choice(RETRIEVAL_DOCS + 1024, 256, replace=False).tolist())
    assert svc.remove_documents(sorted(gone)) == plain.delete(sorted(gone)) \
        == 256
    ticks = 0
    while svc.compaction_tick():
        ticks += 1
        assert ticks < 1000, "compaction_tick never drained"
    plain_state = plain.index_stats()
    for key in ("n_live", "n_main", "n_main_dead", "delta_count",
                "delta_live", "segments"):
        assert svc.stats[key] == plain_state[key], key
    assert svc.index.state_digests() == plain.state_digests()
    for i, r in enumerate(radii):
        (res, emb) = svc.query(qb, radius=r)
        _, launches, near[f"churned r{i}"] = retrieval_queries(
            s, svc, plain, emb, r, rows, gone, f"retrieval churned r{i}")
        by_path[f"retrieval churned r{i}"] = launches
        routes["lsh"] += len(res.lsh_idx)
        routes["linear"] += len(res.lin_idx)
    log(f"[retrieval] churned: +1,024 / -256 documents, {ticks} extra "
        f"compaction ticks, {svc.stats['segments']} segments, delta "
        f"{svc.stats['delta_count']}; kernel = plain on every path "
        f"(near-threshold exceptions {near})")

    # -- 5. durability --------------------------------------------------
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_retrieval_"))
    try:
        mgr = CheckpointManager(str(root))
        _, rec["checkpoint_s"] = synced(lambda: svc.checkpoint(mgr, 1))
        fresh = RetrievalService(cfg, par, params, rcfg, device=dev)
        step, rec["restore_s"] = synced(lambda: fresh.restore(mgr))
        assert step == 1
        assert fresh.index.state_digests() == svc.index.state_digests()
        emb = svc.embed(qb)
        for i, r in enumerate(radii):
            ra, la = query_paths(s, svc.index, emb, r, "cosine",
                                 f"retrieval live r{i}", delta=True)
            rb, lb = query_paths(s, fresh.index, emb, r, "cosine",
                                 f"retrieval restored r{i}", delta=True)
            for f, path in PATHS.items():
                assert rb[f].neighbor_sets() == ra[f].neighbor_sets(), (r, f)
                assert lb[path] == la[path], (r, path)
            by_path[f"retrieval restored r{i}"] = lb
        rec["checkpoint_bytes"] = mgr.stats()["bytes_written"]
        log(f"[retrieval] checkpoint (cut) {rec['checkpoint_s']:.3f} s, "
            f"{rec['checkpoint_bytes'] / 1e6:.1f} MB; restored into a fresh "
            f"service in {rec['restore_s']:.3f} s: equal sets and launches "
            f"on every path")
        del fresh
    finally:
        shutil.rmtree(root, ignore_errors=True)
    # -- 5b. the same service on a 4-shard mesh of the card -------------
    rec["sharded"] = sharded_retrieval(s, svc, cfg, par, params, rcfg, corpus,
                                       extra, gone, qb, radii, rows, by_path)
    if routes["lsh"] and routes["linear"]:
        log(f"[retrieval] both routes ran in the hybrid: {routes}")
    else:
        none = "lsh" if not routes["lsh"] else "linear"
        log(f"[retrieval] the hybrid never chose {none} ({routes}): at these "
            f"radii the family has k = {svc.index.family.k} bits a table, so "
            f"a table's buckets hold about 1/{2 ** svc.index.family.k} of the "
            f"corpus each and the estimated LSH cost is "
            + ("above" if none == "lsh" else "below")
            + f" the linear scan's; the forced {none} path ran its kernels")
    rec["routes"] = routes
    rec["mixes"] = mixes
    svc.shutdown()
    del svc, plain
    torch.cuda.empty_cache()

    # -- 6. generation --------------------------------------------------
    pb = batch(0, 0, b=4)
    new = 16
    toks, rec["generate_s"] = synced(lambda: generate(
        params, pb, cfg, par, cache_len=RETRIEVAL_SEQ + new,
        max_new_tokens=new, device=dev))
    assert toks.shape == (4, new) and toks.dtype == torch.int32
    pre = make_serve_prefill(cfg, par, RETRIEVAL_SEQ + new)
    step = make_serve_step(cfg, par)
    with torch.inference_mode():
        (tok, caches, lengths), t_pre = synced(lambda: pre(params, pb))
        t_steps = []
        for _ in range(new - 1):
            (tok, caches, lengths), t = synced(
                lambda: step(params, caches, tok, lengths))
            t_steps.append(t)
        full = torch.cat([pb["tokens"], toks[:, :new - 1]], dim=1)
        h = hidden_states(params, {"tokens": full}, cfg, par)
        logits = (h[:, RETRIEVAL_SEQ - 1:].float()
                  @ params.lm_head.float().T)           # (4, 16, V)
    top2 = logits.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    span = logits.amax(-1) - logits.amin(-1)
    clear = (margin > GREEDY_MARGIN * span).cpu().numpy()
    want = logits.argmax(-1).cpu().numpy()
    got = toks.cpu().numpy()
    assert (got[clear] == want[clear]).all(), "greedy tokens != the prefill's argmax"
    rec["generate"] = dict(
        batch=4, prompt=RETRIEVAL_SEQ, new=new,
        close_positions=int((~clear).sum()),
        agree_where_close=int((got[~clear] == want[~clear]).sum()),
        prefill_ms=t_pre * 1e3,
        decode_ms_per_token=statistics.median(t_steps) * 1e3,
        decode_bound_ms=rec["param_bytes"] / s.bw * 1e3)
    g = rec["generate"]
    log(f"[retrieval] generate 4 x {new} tokens in {rec['generate_s']:.2f} s; "
        f"greedy tokens equal the prefill's argmax at all "
        f"{int(clear.sum())} positions with a clear margin ({g['close_positions']} "
        f"close, {g['agree_where_close']} of them equal too); prefill "
        f"{g['prefill_ms']:.2f} ms, decode {g['decode_ms_per_token']:.2f} ms a "
        f"token (median of {new - 1}) against the weight-read bound "
        f"{g['decode_bound_ms']:.2f} ms ({rec['param_bytes'] / 1e9:.2f} GB at "
        f"{s.bw / 1e12:.2f} TB/s)")
    rec["peak_bytes"] = torch.cuda.max_memory_allocated()
    del params, caches
    torch.cuda.empty_cache()
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"[retrieval] peak device memory {rec['peak_bytes'] / 1e9:.3f} GB "
        f"after the model; the phase took {rec['phase_s']:.1f} s")
    return rec


TRAIN_ARCH = "yi-6b"
TRAIN_BATCH, TRAIN_SEQ = 1, 2048      # 2,048 tokens a step
TRAIN_CHUNK = 512                     # attention q / k and logits chunks
TRAIN_WARMUP, TRAIN_TIMED = 2, 5
TRAIN_PROBE_LAYERS = 2                # the depth of the memory probe step
TRAIN_SLACK = 2e9                     # bytes left free for fragmentation
TRAIN_LEFT = 1e9                      # bytes the earlier phases may leave
LOSS_AT_INIT = 0.5                    # |step-0 loss - ln V| limit


def train_state_bytes(cfg):
    """Bytes of a training state of ``cfg``, counted on the meta device:
    the weights and their grads in the parameter dtype, float32 m and v."""
    from repro_torch.train import init_state
    st = init_state(cfg, device="meta")
    w = sum(p.numel() * p.element_size() for p in st["params"].parameters())
    mv = sum(t.numel() * t.element_size() for k in ("m", "v")
             for t in st["opt"][k].values())
    return 2 * w + mv


def at_depth(cfg, repeats, pattern=None, tail=None):
    """``cfg`` with ``repeats`` repeats of its block pattern (or of
    ``pattern``) and its tail (or ``tail``)."""
    import dataclasses
    pattern = cfg.pattern if pattern is None else tuple(pattern)
    tail = cfg.tail if tail is None else tuple(tail)
    return dataclasses.replace(cfg, pattern=pattern, tail=tail,
                               repeats=repeats,
                               n_layers=len(pattern) * repeats + len(tail))


def train_steps(s, cfg, par, tcfg, batches):
    """A fresh state of ``cfg`` on the card (seed 0), trained one step a
    batch; returns (state, metrics a step as floats, step seconds, peak
    bytes above what was allocated before the state, the names of the
    matrices that did not change: the first 4 rows of each, the first
    batch's first 4 tokens' rows of the embedding; the norms' weights
    start at 1.0, where a bf16 ulp, 2 ** -7, outweighs an update of
    lr x (1 + weight decay))."""
    torch = s.torch
    from repro_torch.train import init_state, make_jitted_train_step
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    state = init_state(cfg, 0, tcfg, device=s.dev)
    rows = batches[0]["tokens"][0, :4].long()

    def watched():
        return {n: (p[rows] if n == "embed" else p[:4]).detach().clone()
                for n, p in state["params"].named_parameters()
                if p.ndim == 2}

    before = watched()
    step = make_jitted_train_step(cfg, par, tcfg)
    metrics, times = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
    unchanged = [n for n, v in watched().items() if torch.equal(v, before[n])]
    return (state, metrics, times,
            torch.cuda.max_memory_allocated() - base, unchanged)


def profile_train_step(s: Smoke, state, cfg, par, tcfg, batch, ms):
    """``torch.profiler`` trace of one more train step: the device's busy
    ms (its kernels' own times; one stream), its share of the untraced
    median ``ms``, the kernels launched, and the kernels that took most
    of the time."""
    torch = s.torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.train import make_train_step
    step = make_train_step(cfg, par, tcfg)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(state, batch)
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev) / 1e3
    if busy == 0.0:
        log("[train profile] the profiler saw no device time; device busy "
            "share not measured")
        return None
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:12]
    out = {"busy_ms": busy, "busy_share": busy / ms,
           "kernels": sum(e.count for e in dev),
           "top": [(e.key[:80], e.count, e.self_device_time_total / 1e3)
                   for e in top]}
    log(f"[train profile] one step: device busy {busy:.1f} ms, "
        f"{busy / ms:.1%} of the untraced {ms:.1f} ms; {out['kernels']} "
        f"kernels; top device time: " + "; ".join(
            f"{k} x{n} {t:.1f} ms" for k, n, t in out["top"]))
    return out


def drive_train(s: Smoke, smi):
    """Training on the dense path (``repro_torch.train``), last, on a
    card the earlier phases left (less than TRAIN_LEFT bytes allocated).

    1. Yi-6B at full width (d_model 4,096, 32 heads, GQA kv 4, d_ff
       11,008, vocab 64,000; bf16 weights and grads, float32 m and v,
       random weights from seed 0): the state's bytes on the meta device,
       one step at TRAIN_PROBE_LAYERS layers to measure the step's memory
       above its state, then the depth: all 32 layers unless the state,
       that overhead, a saved layer input a further layer and
       TRAIN_SLACK pass the card's free memory.  TRAIN_WARMUP + TRAIN_TIMED
       steps of TRAIN_BATCH x TRAIN_SEQ tokens (remat "block", chunks of
       TRAIN_CHUNK): step ms, tokens/s, peak memory, the loss each step
       and the share of the bf16 peak (``roofline.model_flops`` at the
       depth run); every loss and grad norm finite, the step-0 loss within
       LOSS_AT_INIT of ln 64,000, the weights changed; one more step
       traced by ``torch.profiler`` (busy share, top kernels).
    2. A reduced float32 Yi-6B (2 layers), the same weights on the card
       and the CPU, 3 steps of ``make_train_step`` on the same batches
       with TF32 off (``tests/torch_cases.py`` ``train_device_vs_cpu``):
       loss, grad norm and lr, and each final weight leaf in norm, within
       TRAIN_RTOL; the largest entry's deviation logged.
    3. The loop's fault tolerance at ``reduced_config(yi-6b)`` (the
       reference test's config): a crash at step 7 and a relaunch end at
       the uninterrupted run's final loss (rtol 1e-4); a 0.35 s delay at
       step 8 logged as a straggler; ``python -m repro_torch.launch.train
       --reduced --steps 12`` in a subprocess, then ``--steps 16``
       resuming at step 12.
    Returns the ``[train]`` record."""
    import dataclasses
    import gc
    import math
    import os
    import shutil
    import tempfile
    torch, dev = s.torch, s.dev
    from repro_torch.configs import SHAPES, get_config, reduced_config
    from repro_torch.data import lm_batch
    from repro_torch.launch import roofline
    from repro_torch.models import ParallelConfig
    from repro_torch.train import LoopConfig, TrainConfig, train_loop
    t_phase = time.perf_counter()
    # the retrieval phase's service, indexes and model sit in reference
    # cycles: collect them before the card's free memory is read
    gc.collect()
    torch.cuda.empty_cache()
    assert torch.cuda.memory_allocated() < TRAIN_LEFT, \
        f"{torch.cuda.memory_allocated()} bytes left on the card"
    cfg = get_config(TRAIN_ARCH)
    par = ParallelConfig(remat="block", attn_chunk_q=TRAIN_CHUNK,
                         attn_chunk_k=TRAIN_CHUNK, logits_chunk=TRAIN_CHUNK)
    rec = {"card": smi, "arch": cfg.name, "d_model": cfg.d_model,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "left_on_card_bytes": torch.cuda.memory_allocated()}
    free, total = torch.cuda.mem_get_info()
    rec.update(free_bytes=free, total_bytes=total)

    def batches(n, seed=0, b=TRAIN_BATCH, seq=TRAIN_SEQ, vocab=cfg.vocab):
        return [lm_batch(seed, i, batch=b, seq=seq, vocab=vocab, device=dev)
                for i in range(n)]

    # -- 1. full width ------------------------------------------------------
    tcfg = TrainConfig(peak_lr=1e-3, warmup_steps=1,
                       total_steps=TRAIN_WARMUP + TRAIN_TIMED)
    probe = at_depth(cfg, TRAIN_PROBE_LAYERS)
    state, _, _, probe_peak, _ = train_steps(s, probe, par, tcfg,
                                             batches(1))
    del state
    overhead = probe_peak - train_state_bytes(probe)
    per_layer = TRAIN_BATCH * TRAIN_SEQ * cfg.d_model * 2   # a saved input

    def need(layers):
        return (train_state_bytes(at_depth(cfg, layers)) + overhead
                + (layers - TRAIN_PROBE_LAYERS) * per_layer + TRAIN_SLACK)

    layers = cfg.n_layers
    while layers > TRAIN_PROBE_LAYERS and need(layers) > free:
        layers -= 1
    run = at_depth(cfg, layers)
    rec.update(layers=layers, full_layers=cfg.n_layers,
               state_bytes=train_state_bytes(run),
               full_state_bytes=train_state_bytes(cfg),
               probe_overhead_bytes=overhead, need_bytes=need(layers),
               num_params=run.num_params())
    log(f"[train] {cfg.name}: {cfg.num_params()} parameters, a training "
        f"state of {rec['full_state_bytes'] / 1e9:.2f} GB at all "
        f"{cfg.n_layers} layers (meta device: bf16 weights and grads, "
        f"float32 m and v); a {TRAIN_PROBE_LAYERS}-layer step needs "
        f"{overhead / 1e9:.2f} GB above its state; {free / 1e9:.2f} GB "
        f"free of {total / 1e9:.2f} GB: running {layers} of "
        f"{cfg.n_layers} layers ({rec['state_bytes'] / 1e9:.2f} GB state)")
    steps = batches(TRAIN_WARMUP + TRAIN_TIMED)
    state, metrics, times, peak, unchanged = train_steps(s, run, par, tcfg,
                                                         steps)
    timed = times[TRAIN_WARMUP:]
    step_s = statistics.median(timed)
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=TRAIN_SEQ,
                                global_batch=TRAIN_BATCH)
    flops = roofline.model_flops(run, shape)
    rec.update(step_ms=step_s * 1e3, step_ms_min=min(timed) * 1e3,
               step_ms_max=max(timed) * 1e3,
               step_ms_all=[t * 1e3 for t in times],
               tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / step_s,
               model_flops=flops,
               bf16_peak_share=flops / step_s / s.bf16, peak_bytes=peak,
               loss=[m["loss"] for m in metrics],
               grad_norm=[m["grad_norm"] for m in metrics],
               lr=[m["lr"] for m in metrics], weights_unchanged=unchanged)
    log(f"[train] {layers} layers x d_model {cfg.d_model}, {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} tokens a step: {rec['step_ms']:.1f} ms median of "
        f"{TRAIN_TIMED} (min {rec['step_ms_min']:.1f}, max "
        f"{rec['step_ms_max']:.1f}; warm-up {times[0] * 1e3:.1f}, "
        f"{times[1] * 1e3:.1f}), {rec['tokens_per_s']:.0f} tokens/s, "
        f"{rec['bf16_peak_share']:.4f} of the bf16 dense peak "
        f"({s.bf16 / 1e12:.0f} TFLOP/s) at 6 x {run.num_params()} FLOP a "
        f"token; peak {peak / 1e9:.2f} GB; losses {rec['loss']}; grad "
        f"norms {rec['grad_norm']}; {smi}")
    assert all(math.isfinite(x) for x in rec["loss"] + rec["grad_norm"])
    assert abs(rec["loss"][0] - math.log(cfg.vocab)) < LOSS_AT_INIT, \
        rec["loss"][0]
    assert not unchanged, f"matrices that did not change: {unchanged}"
    rec["profile"] = profile_train_step(s, state, run, par, tcfg, steps[-1],
                                        step_s * 1e3)
    del state
    torch.cuda.empty_cache()

    # -- 2. the card against the CPU, float32 ---------------------------
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_cases import TRAIN_RTOL, train_device_vs_cpu
    dev_metric, dev_norm, dev_entry = train_device_vs_cpu(
        TRAIN_ARCH, "block", 1, dev)
    rec["f32_vs_cpu"] = {"max_rel_dev_metrics": dev_metric,
                         "max_rel_norm_dev_weights": dev_norm,
                         "max_entry_dev_over_lr_steps": dev_entry}
    log(f"[train] float32 card vs CPU, 3 steps of a 2-layer reduced "
        f"{cfg.name}: loss / grad norm / lr within {dev_metric:.3g} "
        f"relative, each weight leaf within {dev_norm:.3g} in norm (limit "
        f"{TRAIN_RTOL} both); the largest entry's deviation "
        f"{dev_entry:.3g} x lr x steps")

    # -- 3. the loop's fault tolerance, and the launcher ----------------
    rcfg = reduced_config(cfg)
    lpar = ParallelConfig(mesh=None, attn_chunk_q=16, attn_chunk_k=16,
                          logits_chunk=16, remat="none")
    ltcfg = TrainConfig(peak_lr=1e-3, warmup_steps=2, total_steps=12)

    def loop(ckpt_dir, steps=12, **kw):
        return train_loop(rcfg, lpar, batch=2, seq=16, tcfg=ltcfg,
                          lcfg=LoopConfig(steps=steps, ckpt_every=4,
                                          log_every=1, ckpt_dir=ckpt_dir),
                          device=dev, **kw)

    def crash_at_7(step):
        if step == 7:
            raise RuntimeError("injected failure at step 7")

    tmp = tempfile.mkdtemp(prefix="train_smoke_")
    try:
        ref = loop(os.path.join(tmp, "a"))
        try:
            loop(os.path.join(tmp, "b"), failure_injector=crash_at_7)
            raise AssertionError("the injected failure did not raise")
        except RuntimeError as e:
            assert "injected" in str(e), e
        resumed = loop(os.path.join(tmp, "b"))
        assert resumed["step"] == list(range(4, 12)), resumed["step"]
        assert abs(resumed["loss"][-1] - ref["loss"][-1]) <= \
            1e-4 * abs(ref["loss"][-1]), (resumed["loss"], ref["loss"])
        slow = loop(None, steps=10,
                    step_delay_injector=lambda i: 0.35 if i == 8 else 0.0)
        assert any(e[0] == 8 for e in slow["stragglers"]), slow["stragglers"]
        rec["loop"] = {"final_loss": ref["loss"][-1],
                       "resumed_final_loss": resumed["loss"][-1],
                       "stragglers": slow["stragglers"]}
        log(f"[train] loop on the card ({rcfg.name} reduced): crash at step "
            f"7, resumed at 4, final loss {resumed['loss'][-1]:.6f} against "
            f"{ref['loss'][-1]:.6f} uninterrupted; stragglers "
            f"{slow['stragglers']}")
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        ck = os.path.join(tmp, "launch")
        launches = []
        for n in (12, 16):
            t0 = time.perf_counter()
            out = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.train", "--arch",
                 cfg.name, "--reduced", "--steps", str(n), "--ckpt-every",
                 "4", "--ckpt-dir", ck], capture_output=True, text=True,
                env=env, cwd=str(ROOT), timeout=300)
            assert out.returncode == 0, out.stderr[-3000:]
            final = [ln for ln in out.stdout.splitlines()
                     if ln.startswith("final loss:")]
            assert final and math.isfinite(float(final[-1].split()[-1])), \
                out.stdout
            launches.append({"steps": n, "s": time.perf_counter() - t0,
                             "final_loss": float(final[-1].split()[-1])})
        assert "restored checkpoint at step 12" in out.stderr, \
            out.stderr[-3000:]
        rec["launch"] = launches
        log(f"[train] launch.train in a subprocess: {launches}; the second "
            f"launch restored step 12")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"[train] the phase took {rec['phase_s']:.1f} s")
    return rec


ARCHS = ("gemma3-27b", "granite-moe-1b-a400m", "llama4-maverick-400b-a17b",
         "falcon-mamba-7b", "zamba2-1.2b", "llama-3.2-vision-11b",
         "whisper-small")
ARCH_NO_TRAIN = ("llama4-maverick-400b-a17b",)
ARCH_BATCH, ARCH_PROMPT, ARCH_NEW = 4, 2048, 32
ARCH_CHUNK = 512                      # attention q / k and logits chunks
ARCH_EMBED = (64, 32)                 # forward_embed's batch x tokens
ARCH_SLACK = 8e9                      # serving bytes beside weights, caches
ARCH_TRAIN_STEPS = (1, 3)             # warm-up, timed
ARCH_LOSS_AT_INIT = 1.0               # |step-0 ce_loss - ln V| limit
ARCH_TRAIN_SLACK = 4e9                # training bytes left for fragmentation
ARCH_LEFT = 1e9                       # bytes the earlier phases may leave
ARCH_RETRIEVAL = "zamba2-1.2b"
# configs whose greedy check runs on a float32 copy of their weights: over
# Falcon-Mamba's 64 random Mamba-1 layers, bf16 decode and prefill hidden
# states differ by up to 7 % of a row's largest entry on an H100, and a
# few tokens at positions past GREEDY_MARGIN differ; in float32, 3e-5
ARCH_F32_CHECK = ("falcon-mamba-7b",)


def synced(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def arch_batch(s: Smoke, cfg, seed, b, seq, step=0):
    """A token batch of ``cfg`` on the card, with its stub frames or image
    embeddings; no labels."""
    from repro_torch.data import lm_batch
    out = lm_batch(seed, step, batch=b, seq=seq, vocab=cfg.vocab, cfg=cfg,
                   device=s.dev)
    out.pop("labels")
    return out


def memory_len(cfg):
    return cfg.encoder_seq if cfg.encoder_layers else cfg.num_image_tokens


def serving_bytes(cfg, cache_len):
    """The weights' and the decode caches' bytes of ``cfg`` at ARCH_BATCH
    rows, counted on the meta device."""
    from repro_torch.models import init_caches, init_params
    caches = init_caches(cfg, ARCH_BATCH, cache_len, device="meta",
                         memory_len=memory_len(cfg))
    return (init_params(cfg, device="meta").nbytes(),
            sum(t.numel() * t.element_size() for c in caches["blocks"]
                for t in c.values()))


def no_drop(cfg):
    """``cfg`` with its MoE capacity factor raised to E / top_k: every
    expert can hold every token, so no (token, choice) pair is dropped."""
    import dataclasses
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))


def serve_tokens(s: Smoke, params, cfg, par, pb, new, cache_len):
    """Prefill ``pb`` then ``new`` decode steps, each synchronised and
    timed, greedy tokens throughout.  Returns (the (B, new + 1) tokens,
    their (B, new + 1, D) final hidden states, prefill s, decode s a
    step, the state after the last step for one more step: caches,
    token, lengths)."""
    torch = s.torch
    from repro_torch.models import decode_step, prefill
    from repro_torch.models.embedding import greedy_sample
    finite = torch.ones((), dtype=torch.bool, device=s.dev)
    with torch.inference_mode():
        (h, caches, lengths), t_pre = synced(
            torch, lambda: prefill(params, pb, cfg, par, cache_len))
        finite &= torch.isfinite(h).all()
        tok = greedy_sample(params.lm_head, h, par)
        out, hs, t_dec = [tok], [h], []
        for _ in range(new):
            (h, caches), t = synced(torch, lambda: decode_step(
                params, caches, tok, lengths, cfg, par))
            finite &= torch.isfinite(h).all()
            tok = greedy_sample(params.lm_head, h, par)
            lengths = lengths + 1
            out.append(tok)
            hs.append(h)
            t_dec.append(t)
    assert bool(finite), f"{cfg.name}: non-finite hidden states"
    return (torch.stack(out, dim=1), torch.stack(hs, dim=1), t_pre, t_dec,
            (caches, tok, lengths))


def greedy_check(s: Smoke, params, cfg, par, pb, toks, h_dec):
    """Greedy tokens against the argmax of a prefill of the prompt and
    the generated tokens but the last, where its top-2 margin exceeds
    GREEDY_MARGIN of the logit range ("clear" positions).  Returns the
    counts of clear positions, of clear ones whose tokens differ (0 is
    the hard limit, ``assert_greedy``), of close ones and of close ones
    that agree too, and the largest deviation of the decode's hidden
    states ``h_dec`` from the prefill's, over a row's largest entry."""
    torch = s.torch
    from repro_torch.models import hidden_states
    p = pb["tokens"].shape[1]
    full = dict(pb, tokens=torch.cat([pb["tokens"], toks[:, :-1]], dim=1))
    with torch.inference_mode():
        h = hidden_states(params, full, cfg, par)[:, p - 1:]
        assert bool(torch.isfinite(h).all()), f"{cfg.name}: check prefill"
        dev = float(((h_dec.float() - h.float()).abs().amax(-1)
                     / h.float().abs().amax(-1)).max())
        logits = h.float() @ params.lm_head.float().T      # (B, new + 1, V)
    top2 = logits.topk(2, dim=-1).values
    clear = ((top2[..., 0] - top2[..., 1])
             > GREEDY_MARGIN * (logits.amax(-1) - logits.amin(-1))
             ).cpu().numpy()
    want = logits.argmax(-1).cpu().numpy()
    got = toks.cpu().numpy()
    return dict(clear=int(clear.sum()), close=int((~clear).sum()),
                close_equal=int((got[~clear] == want[~clear]).sum()),
                clear_unequal=int((got[clear] != want[clear]).sum()),
                h_dev=dev)


def assert_greedy(cfg, g):
    assert g["clear_unequal"] == 0, (
        f"{cfg.name}: greedy tokens != the prefill's argmax at "
        f"{g['clear_unequal']} of {g['clear']} clear positions; decode's "
        f"hidden states off by {g['h_dev']:.4g} of a row's largest entry")


def profile_decode(s: Smoke, params, cfg, par, state):
    """``torch.profiler`` trace of one more decode step: its kernels and
    device busy ms, or None where the profiler sees no device time."""
    torch = s.torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import decode_step
    caches, tok, lengths = state
    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        decode_step(params, caches, tok, lengths, cfg, par)
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev) / 1e3
    if busy == 0.0:
        return None
    return {"kernels": sum(e.count for e in dev), "busy_ms": busy}


def free_card(s: Smoke):
    import gc
    gc.collect()
    s.torch.cuda.empty_cache()


def serve_arch(s: Smoke, name, smi):
    """One config served at full width: the depth (every layer unless its
    weights, ARCH_BATCH rows of caches and ARCH_SLACK pass the card's
    free memory, counted on the meta device), the weights drawn on the
    card, one ``forward_embed`` of ARCH_EMBED, a prefill of ARCH_BATCH x
    ARCH_PROMPT tokens and ARCH_NEW decode steps timed, one more decode
    step traced, and the greedy check (at a no-drop capacity factor for
    the MoE configs)."""
    import copy
    import dataclasses
    torch = s.torch
    from repro_torch.configs import get_config
    from repro_torch.models import ParallelConfig, forward_embed, init_params
    full = get_config(name)
    par = ParallelConfig(attn_chunk_q=ARCH_CHUNK, attn_chunk_k=ARCH_CHUNK)
    cache_len = ARCH_PROMPT + ARCH_NEW + 1
    free, _ = torch.cuda.mem_get_info()
    # weights and caches grow by the same bytes a repeat of the pattern:
    # count one and two repeats on the meta device
    one, two = (serving_bytes(at_depth(full, r), cache_len) for r in (1, 2))

    def counted(r):
        return tuple(a + (r - 1) * (b - a) for a, b in zip(one, two))

    repeats = full.n_repeats
    while repeats > 1 and sum(counted(repeats)) + ARCH_SLACK > free:
        repeats -= 1
    cfg = at_depth(full, repeats)
    w_bytes, c_bytes = counted(repeats)
    rec = {"arch": name, "layers": cfg.n_layers, "full_layers": full.n_layers,
           "d_model": cfg.d_model, "free_bytes": free,
           "cache_bytes": c_bytes, "num_params": cfg.num_params(),
           "num_active_params": cfg.num_active_params()}
    if cfg.n_layers < full.n_layers:
        log(f"[archs {name}] depth {cfg.n_layers} of {full.n_layers}: "
            f"{w_bytes / 1e9:.2f} GB of weights and {c_bytes / 1e9:.3f} GB "
            f"of caches at this depth (meta device) leave the {ARCH_SLACK / 1e9:.0f} "
            f"GB of activations and slack within {free / 1e9:.2f} GB free; "
            f"{at_depth(full, repeats + 1).n_layers} layers would need "
            f"{sum(counted(repeats + 1)) / 1e9:.2f} GB")
    torch.cuda.reset_peak_memory_stats()
    params, rec["init_s"] = synced(torch, lambda: init_params(cfg, 0,
                                                              device=s.dev))
    rec["weight_bytes"] = params.nbytes()
    assert rec["weight_bytes"] == w_bytes
    eb = arch_batch(s, cfg, 1, *ARCH_EMBED)
    with torch.inference_mode():
        emb, t0 = synced(torch, lambda: forward_embed(params, eb, cfg, par))
        emb, t = synced(torch, lambda: forward_embed(params, eb, cfg, par))
    assert emb.shape == (ARCH_EMBED[0], cfg.d_model)
    assert bool(torch.isfinite(emb).all())
    assert bool(((emb.norm(dim=-1) - 1).abs() < 1e-3).all())
    rec["embed_ms"], rec["embed_first_ms"] = t * 1e3, t0 * 1e3
    pb = arch_batch(s, cfg, 0, ARCH_BATCH, ARCH_PROMPT)
    toks, h_dec, t_pre, t_dec, state = serve_tokens(s, params, cfg, par, pb,
                                                    ARCH_NEW, cache_len)
    tokens = ARCH_BATCH * ARCH_PROMPT
    active = cfg.num_active_params()
    table = cfg.vocab * cfg.d_model * 2          # a decode reads B rows
    rec.update(prefill_ms=t_pre * 1e3, prefill_tokens_per_s=tokens / t_pre,
               prefill_bf16_peak_share=2.0 * active * tokens / t_pre / s.bf16,
               decode_ms=statistics.median(t_dec) * 1e3,
               decode_ms_min=min(t_dec) * 1e3,
               decode_bound_ms=(2 * active - table + c_bytes) / s.bw * 1e3)
    rec["decode_profile"] = profile_decode(s, params, cfg, par, state)
    del state
    t_check = time.perf_counter()
    check_cfg = no_drop(cfg)
    if check_cfg is not cfg:
        # at the config's 1.25, a decode step (T = B tokens) drops pairs
        # that the prefill of the whole sequence keeps: the reference's
        # capacity semantics, not a fault; the check runs where neither
        # drops any
        nd, h_dec, _, _, st = serve_tokens(s, params, check_cfg, par, pb,
                                           ARCH_NEW, cache_len)
        del st
        rec["tokens_equal_at_own_capacity"] = int((nd == toks).sum())
        toks = nd
    rec["greedy"] = greedy_check(s, params, check_cfg, par, pb, toks, h_dec)
    if name in ARCH_F32_CHECK:
        # bf16 rounding over the config's random layers moves decode's
        # logits from the prefill's by more than GREEDY_MARGIN of their
        # range: the hard limit holds a float32 copy of the same weights
        del h_dec
        free_card(s)
        rec["greedy_bf16"] = rec.pop("greedy")
        f32 = dataclasses.replace(check_cfg, dtype="float32")
        p32 = copy.deepcopy(params).float()
        t32, h32, _, _, st = serve_tokens(s, p32, f32, par, pb, ARCH_NEW,
                                          cache_len)
        del st
        rec["greedy"] = greedy_check(s, p32, f32, par, pb, t32, h32)
        rec["greedy"]["float32"] = True
        del p32, h32
        free_card(s)
    assert_greedy(cfg, rec["greedy"])
    rec["check_s"] = time.perf_counter() - t_check
    rec["peak_bytes"] = torch.cuda.max_memory_allocated()
    prof = rec["decode_profile"]
    kern = "not measured" if prof is None else prof["kernels"]
    g = rec["greedy"]
    bf16 = ""
    if "greedy_bf16" in rec:
        b = rec["greedy_bf16"]
        bf16 = (f"; in bf16 {b['clear_unequal']} of {b['clear']} clear "
                f"positions differ, the hidden states within "
                f"{b['h_dev']:.3g}")
    ring = ""
    if "swa" in cfg.pattern:
        w = min(cfg.sliding_window, cache_len)
        ring = (f"; its {w}-slot rings wrap: the prompt's last {w} tokens "
                f"fill them, decode writes slots {ARCH_PROMPT % w}.."
                f"{(ARCH_PROMPT + ARCH_NEW - 1) % w}")
    log(f"[archs {name}] {cfg.n_layers} of {full.n_layers} layers, d_model "
        f"{cfg.d_model}: weights {rec['weight_bytes'] / 1e9:.2f} GB (drawn in "
        f"{rec['init_s']:.1f} s), peak {rec['peak_bytes'] / 1e9:.2f} GB; "
        f"forward_embed {ARCH_EMBED[0]} x {ARCH_EMBED[1]} "
        f"{rec['embed_ms']:.1f} ms (first call {rec['embed_first_ms']:.1f}); "
        f"prefill {ARCH_BATCH} x {ARCH_PROMPT} {rec['prefill_ms']:.1f} ms "
        f"({rec['prefill_tokens_per_s']:.0f} tokens/s, "
        f"{rec['prefill_bf16_peak_share']:.4f} of the bf16 peak at 2 x "
        f"{active} FLOP a token); decode {rec['decode_ms']:.2f} ms a token "
        f"(median of {ARCH_NEW}) against a {rec['decode_bound_ms']:.3f} ms "
        f"bound (active weights but the token table, and {c_bytes / 1e9:.3f} "
        f"GB of caches, at {s.bw / 1e12:.2f} TB/s); {kern} kernels a decode "
        f"token; greedy == prefill argmax at {g['clear']} clear positions"
        f"{' in float32' if g.get('float32') else ''} ({g['close']} close, "
        f"{g['close_equal']} of them equal too; decode's hidden states "
        f"within {g['h_dev']:.3g} of a row's largest entry of the "
        f"prefill's)" + bf16 + ring + (
            f"; tokens equal at the config's own capacity factor "
            f"{rec['tokens_equal_at_own_capacity']} of "
            f"{ARCH_BATCH * (ARCH_NEW + 1)}"
            if "tokens_equal_at_own_capacity" in rec else "") + f"; {smi}")
    del params
    free_card(s)
    return rec


def train_depths(cfg):
    """Training depths of ``cfg`` to try, largest first: one repeat of the
    pattern and the tail (two repeats of a one-layer pattern without a
    tail), then the repeat alone, then shorter prefixes of the pattern,
    down to 2 layers."""
    first = at_depth(cfg, 2 if len(cfg.pattern) == 1 and not cfg.tail
                     else 1)
    out = [first]
    if cfg.tail:
        out.append(at_depth(cfg, 1, tail=()))
    out += [at_depth(cfg, 1, pattern=cfg.pattern[:k], tail=())
            for k in range(len(cfg.pattern) - 1, 1, -1)]
    return out


def train_arch(s: Smoke, name, smi):
    """One config trained at full width on one repeat (``train_depths``:
    the first whose state, a probe step's memory above its state, a
    saved layer input a further layer and ARCH_TRAIN_SLACK fit the card's
    free memory), ARCH_TRAIN_STEPS of TRAIN_BATCH x TRAIN_SEQ tokens."""
    import math
    torch = s.torch
    from repro_torch.configs import get_config
    from repro_torch.data import lm_batch
    from repro_torch.models import ParallelConfig
    from repro_torch.train import TrainConfig
    full = get_config(name)
    par = ParallelConfig(remat="block", attn_chunk_q=ARCH_CHUNK,
                         attn_chunk_k=ARCH_CHUNK, logits_chunk=ARCH_CHUNK)
    warm, timed_n = ARCH_TRAIN_STEPS
    tcfg = TrainConfig(peak_lr=1e-3, warmup_steps=1,
                       total_steps=warm + timed_n)

    def batches(cfg, n):
        return [lm_batch(0, i, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                         vocab=cfg.vocab, cfg=cfg, device=s.dev)
                for i in range(n)]

    cands = train_depths(full)
    free, _ = torch.cuda.mem_get_info()
    probe = at_depth(full, 1, pattern=full.pattern[:2], tail=()) \
        if len(full.pattern) >= 2 else at_depth(full, 2, tail=())
    state, _, _, probe_peak, _ = train_steps(s, probe, par, tcfg,
                                             batches(probe, 1))
    del state
    free_card(s)
    overhead = probe_peak - train_state_bytes(probe)
    per_layer = TRAIN_BATCH * TRAIN_SEQ * full.d_model * 2

    def need(c):
        return (train_state_bytes(c) + overhead
                + (c.n_layers - probe.n_layers) * per_layer
                + ARCH_TRAIN_SLACK)

    run = next((c for c in cands if need(c) <= free), None)
    assert run is not None, f"{name}: no training depth fits {free} bytes"
    rec = {"arch": name, "layers": run.n_layers, "pattern": list(run.pattern),
           "tail": list(run.tail), "state_bytes": train_state_bytes(run),
           "need_bytes": need(run), "free_bytes": free,
           "probe_overhead_bytes": overhead}
    if run is not cands[0]:
        log(f"[archs train {name}] cut to {run.n_layers} layers "
            f"({list(run.pattern)} + {list(run.tail)}): {cands[0].n_layers} "
            f"layers need {need(cands[0]) / 1e9:.2f} GB of {free / 1e9:.2f} "
            f"GB free (state {train_state_bytes(cands[0]) / 1e9:.2f} GB)")
    state, metrics, times, peak, unchanged = train_steps(
        s, run, par, tcfg, batches(run, warm + timed_n))
    del state
    free_card(s)
    timed = times[warm:]
    step_s = statistics.median(timed)
    rec.update(step_ms=step_s * 1e3, step_ms_all=[t * 1e3 for t in times],
               tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / step_s,
               bf16_peak_share=6.0 * run.num_active_params() * TRAIN_BATCH
               * TRAIN_SEQ / step_s / s.bf16,
               peak_bytes=peak, weights_unchanged=unchanged,
               **{k: [m[k] for m in metrics]
                  for k in ("loss", "ce_loss", "aux_loss", "grad_norm")})
    assert all(math.isfinite(x) for x in rec["loss"] + rec["grad_norm"])
    assert abs(rec["ce_loss"][0] - math.log(run.vocab)) < ARCH_LOSS_AT_INIT, \
        (name, rec["ce_loss"][0])
    if run.moe is not None:
        assert min(rec["aux_loss"]) > 0, rec["aux_loss"]
    log(f"[archs train {name}] {run.n_layers} layers x d_model "
        f"{run.d_model}, {TRAIN_BATCH} x {TRAIN_SEQ} tokens a step: "
        f"{rec['step_ms']:.1f} ms median of {timed_n} (all "
        f"{[round(t, 1) for t in rec['step_ms_all']]}), "
        f"{rec['tokens_per_s']:.0f} tokens/s, {rec['bf16_peak_share']:.4f} "
        f"of the bf16 peak; state {rec['state_bytes'] / 1e9:.2f} GB, peak "
        f"{peak / 1e9:.2f} GB; ce_loss {rec['ce_loss']}, aux_loss "
        f"{rec['aux_loss']}, grad norms {rec['grad_norm']}; unchanged "
        f"(first rows, bf16) {unchanged}; {smi}")
    return rec


def archs_retrieval(s: Smoke, by_path, smi):
    """``RetrievalService`` behind ARCH_RETRIEVAL at full width and depth:
    radii at the 0.005 and 0.03 quantiles of a 1,024-document sample's
    cosine distances, RETRIEVAL_DOCS documents of RETRIEVAL_SEQ tokens
    indexed, RETRIEVAL_BATCH queries at each radius on every path against
    a plain (``impl="ref"``) index of the same state, launches asserted
    (``retrieval_queries``); K1, K2 and K3 each launched."""
    np, torch = s.np, s.torch
    from repro_torch.configs import get_config
    from repro_torch.models import ParallelConfig, forward_embed, init_params
    from repro_torch.serve import RetrievalConfig, RetrievalService
    from repro_torch.streaming import DynamicHybridIndex
    cfg = get_config(ARCH_RETRIEVAL)
    par = ParallelConfig(attn_chunk_q=64, attn_chunk_k=64)
    params = init_params(cfg, 0, device=s.dev)
    rec = {"arch": cfg.name, "layers": cfg.n_layers,
           "weight_bytes": params.nbytes()}

    def batch(seed, i):
        return arch_batch(s, cfg, seed, RETRIEVAL_BATCH, RETRIEVAL_SEQ, i)

    with torch.no_grad():
        sample = torch.cat([forward_embed(params, batch(1, i), cfg, par)
                            for i in range(1024 // RETRIEVAL_BATCH)])
    radii = pick_radii(sample.cpu().numpy(), "cosine")[1:3]
    rcfg = RetrievalConfig(radius=radii[1])
    svc = RetrievalService(cfg, par, params, rcfg, device=s.dev)
    corpus = [batch(1, i) for i in range(RETRIEVAL_DOCS // RETRIEVAL_BATCH)]
    n, rec["index_corpus_s"] = synced(torch, lambda: svc.index_corpus(corpus))
    assert n == RETRIEVAL_DOCS
    plain = DynamicHybridIndex(
        svc.index.family, params=svc.index.params, impl="ref",
        num_buckets=rcfg.num_buckets, m=rcfg.hll_m, cap=rcfg.cap,
        delta_capacity=rcfg.delta_capacity, device=s.dev,
        cost_model=svc.index.cost_model,
        policy=svc.index.policy).load_state_dict(svc.index.state_dict())
    rows = rows_by_id(svc.index, np.zeros((RETRIEVAL_DOCS, cfg.d_model),
                                          np.float32))
    qb = batch(2, 0)
    total = {}
    rec["radii"], rec["near"], rec["routes"] = radii, {}, {}
    for i, r in enumerate(radii):
        res, emb = svc.query(qb, radius=r)
        _, launches, rec["near"][f"r{i}"] = retrieval_queries(
            s, svc, plain, emb, r, rows, set(), f"archs retrieval r{i}")
        by_path[f"archs retrieval r{i}"] = launches
        rec["routes"][f"r{i}"] = (len(res.lsh_idx), len(res.lin_idx))
        for path in launches.values():
            for k, v in path.items():
                total[k] = total.get(k, 0) + v
    for k in ("linear_scan_dot", "lsh_scan", "route_estimate"):
        assert total[k] > 0, f"archs retrieval: kernel {k} was not launched"
    rec["launches"] = {k: total[k] for k in
                       ("linear_scan_dot", "lsh_scan", "route_estimate")}
    log(f"[archs retrieval] {cfg.name} at full width and depth "
        f"({rec['weight_bytes'] / 1e9:.2f} GB): {n} documents of "
        f"{RETRIEVAL_SEQ} tokens indexed in {rec['index_corpus_s']:.1f} s; "
        f"radii {radii}; {RETRIEVAL_BATCH} queries a radius, sets equal "
        f"the plain index's on every path (near-threshold exceptions "
        f"{rec['near']}); routes (lsh, linear) {rec['routes']}; K1 / K2 / K3 "
        f"launches over the paths {rec['launches']}; {smi}")
    svc.shutdown()
    del svc, plain, params
    free_card(s)
    return rec


def drive_archs(s: Smoke, smi, by_path):
    """The other layer kinds, last, on a card the earlier phases left
    (less than ARCH_LEFT bytes allocated): each of ARCHS served at full
    width (``serve_arch``; full depth but where the weights do not fit,
    Llama-4 Maverick, whose depth is the most layers that fit), each but
    ARCH_NO_TRAIN trained at full width on one repeat of its pattern
    (``train_arch``; Maverick's one layer alone holds 16.1e9 expert
    weights, a 193 GB training state), then ``RetrievalService`` behind
    Zamba2 (``archs_retrieval``).  Returns the ``[archs]`` record."""
    torch = s.torch
    from repro_torch.configs import get_config
    t_phase = time.perf_counter()
    free_card(s)
    assert torch.cuda.memory_allocated() < ARCH_LEFT, \
        f"{torch.cuda.memory_allocated()} bytes left on the card"
    rec = {"card": smi, "serve": {}, "train": {}}
    for name in ARCHS:
        t0 = time.perf_counter()
        rec["serve"][name] = serve_arch(s, name, smi)
        rec["serve"][name]["s"] = time.perf_counter() - t0
    for name in ARCHS:
        if name in ARCH_NO_TRAIN:
            one = train_state_bytes(at_depth(get_config(name), 1))
            log(f"[archs train {name}] no train step: a one-layer training "
                f"state (bf16 weights and grads, float32 m and v; meta "
                f"device) is {one / 1e9:.0f} GB")
            rec["train"][name] = {"skipped": "state", "state_bytes": one}
            continue
        t0 = time.perf_counter()
        rec["train"][name] = train_arch(s, name, smi)
        rec["train"][name]["s"] = time.perf_counter() - t0
    rec["retrieval"] = archs_retrieval(s, by_path, smi)
    assert torch.cuda.memory_allocated() < ARCH_LEFT
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"[archs] the phase took {rec['phase_s']:.1f} s")
    return rec


MESH_ARCH = "yi-6b"
MESH_MOE = "granite-moe-1b-a400m"
MESH_SHAPE = (4, 2)                   # ("data", "model")
MESH_TRAIN_LAYERS = 4                 # a: the depth of the mesh check
MESH_TRAIN_BATCH = (4, 512)           # a: a batch row a data shard
MESH_LOSS_RTOL = 1e-3                 # a: mesh step vs mesh=None step
MESH_M_RTOL = 0.05                    # a: first moments, of a leaf's max
MESH_PARAM_ATOL = 0.05                # a: test_distributed's own bound
MESH_TRAIN_STEPS = (1, 3)             # b: warm-up, timed
# c: (name, mesh shape, ParallelConfig fields) of the sharded decodes
MESH_SERVE = (("seq_model", (2, 4), {"decode_seq_shard": ("model",)}),
              ("seq_all", (2, 4), {"batch_axes": (),
                                   "decode_seq_shard": ("data", "model")}))
MESH_CACHE = ARCH_PROMPT + ARCH_NEW   # 2,080 slots: a multiple of 8 shards
MESH_MOE_TOL = 2e-2                   # d: one MoE layer, bf16, of max |out|
MESH_MOE_ROW_TOL = 1e-3               # d: float32 model rows, of row max
MESH_MOE_ROW_SHARE = 1e-2             # d: share of rows past it allowed
MESH_PIPE = (4, 8, 512)               # e: stages, micro-batches, tokens
MESH_PIPE_TOL = 2e-2                  # e: of max |sequential|, bf16
MESH_EF_SHARDS, MESH_EF_STEPS = 8, 50  # f
MESH_EF_RELERR = 0.02                 # f: test_distributed's bound


def mesh_pars(s, shape, **kw):
    """A ``ParallelConfig`` on a debug mesh of ``shape`` on the card (a
    shape over ("data", "model")): ARCH_CHUNK attention chunks and the
    fields ``kw``."""
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import ParallelConfig
    return ParallelConfig(mesh=make_debug_mesh(shape, device=s.dev),
                          **dict(dict(attn_chunk_q=ARCH_CHUNK,
                                      attn_chunk_k=ARCH_CHUNK), **kw))


def moment_gap(ref, got):
    """The largest entry of |got - ref| over the largest |ref| of its
    leaf, over the leaves of two dicts of first moments: (gap, leaf)."""
    gap, leaf = 0.0, None
    for n, r in ref.items():
        g = float((got[n] - r).abs().max() / r.abs().max().clamp_min(1e-30))
        if leaf is None or g > gap:
            gap, leaf = g, n
    return gap, leaf


def vocab_shard_grad_dropped():
    """A planted fault for ``mesh_train_check``: while it is entered, the
    vocab-sharded ``embed`` and ``softmax_xent`` send no gradient into
    the first model shard's rows of their tables (the rows detached; the
    forward pass is unchanged)."""
    import contextlib
    from repro_torch.models import embedding
    sound = embedding._vocab_shards

    def faulty(table, par):
        mesh, shards = sound(table, par)
        return mesh, [(off, t.detach() if i == 0 else t)
                      for i, (off, t) in enumerate(shards)]

    @contextlib.contextmanager
    def planted():
        embedding._vocab_shards = faulty
        try:
            yield
        finally:
            embedding._vocab_shards = sound
    return planted()


def mesh_train_check(s: Smoke):
    """a. Yi-6B at full width on MESH_TRAIN_LAYERS layers: one step on the
    MESH_SHAPE mesh and one with mesh=None, from two states of seed 0, on
    one batch of MESH_TRAIN_BATCH, at the reference test's schedule (no
    warm-up).  The losses are held within MESH_LOSS_RTOL.  The backward
    pass is held by the first moments (0.1 x the clipped grads; one step
    moves a weight by about lr whatever its grad, so the weights cannot
    tell a wrong grad): within MESH_M_RTOL of each leaf's largest entry,
    and a third step on the mesh with a planted fault
    (``vocab_shard_grad_dropped``) must land past that limit."""
    import math
    torch = s.torch
    from repro_torch.configs import get_config
    from repro_torch.data import lm_batch
    from repro_torch.models import ParallelConfig
    from repro_torch.train import TrainConfig
    cfg = at_depth(get_config(MESH_ARCH), MESH_TRAIN_LAYERS)
    kw = dict(remat="block", attn_chunk_q=TRAIN_CHUNK,
              attn_chunk_k=TRAIN_CHUNK, logits_chunk=TRAIN_CHUNK)
    tcfg = TrainConfig(total_steps=10, warmup_steps=0)
    b, seq = MESH_TRAIN_BATCH
    batch = [lm_batch(0, 0, batch=b, seq=seq, vocab=cfg.vocab, device=s.dev)]
    par = mesh_pars(s, MESH_SHAPE, **kw)
    plain, m0, t0, _, _ = train_steps(s, cfg, ParallelConfig(**kw), tcfg,
                                      batch)
    mesh, m1, t1, peak, unchanged = train_steps(s, cfg, par, tcfg, batch)
    ref = dict(plain["params"].named_parameters())
    gap = max(float((p.detach().float() - ref[n].detach().float())
                    .abs().max())
              for n, p in mesh["params"].named_parameters())
    del ref
    m_gap, m_leaf = moment_gap(plain["opt"]["m"], mesh["opt"]["m"])
    del mesh
    free_card(s)
    with vocab_shard_grad_dropped():
        fault, m2, _, _, _ = train_steps(s, cfg, par, tcfg, batch)
    f_gap, f_leaf = moment_gap(plain["opt"]["m"], fault["opt"]["m"])
    del plain, fault
    l0, l1 = m0[0]["loss"], m1[0]["loss"]
    rec = {"layers": cfg.n_layers, "batch": [b, seq], "loss": l1,
           "loss_no_mesh": l0, "loss_rel_gap": abs(l1 - l0) / abs(l0),
           "m_rel_gap": m_gap, "m_rel_gap_leaf": m_leaf,
           "fault_m_rel_gap": f_gap, "fault_m_rel_gap_leaf": f_leaf,
           "fault_loss": m2[0]["loss"], "param_max_abs_gap": gap,
           "step_ms": t1[0] * 1e3, "step_ms_no_mesh": t0[0] * 1e3,
           "peak_bytes": peak, "lr": m1[0]["lr"],
           "weights_unchanged": unchanged}
    log(f"[mesh a] {MESH_ARCH} {cfg.n_layers} layers x d_model "
        f"{cfg.d_model}, {b} x {seq} tokens, a {MESH_SHAPE} mesh: loss "
        f"{l1:.6f} against {l0:.6f} without a mesh ({rec['loss_rel_gap']:.3g} "
        f"relative, limit {MESH_LOSS_RTOL}); first moments within "
        f"{m_gap:.4g} of a leaf's largest entry ({m_leaf}; limit "
        f"{MESH_M_RTOL}), with the first model shard's table rows given "
        f"no gradient {f_gap:.4g} ({f_leaf}; must pass the limit); "
        f"weights after one step at lr {m1[0]['lr']:.3g} within {gap:.4g} "
        f"(limit {MESH_PARAM_ATOL}); one step {t1[0] * 1e3:.1f} ms "
        f"(no mesh {t0[0] * 1e3:.1f}, each a first call); peak "
        f"{peak / 1e9:.2f} GB")
    assert math.isfinite(l1) and rec["loss_rel_gap"] <= MESH_LOSS_RTOL, rec
    assert m_gap <= MESH_M_RTOL < f_gap, rec
    assert gap <= MESH_PARAM_ATOL, rec
    assert m1[0]["lr"] > 0 and not unchanged, rec
    return rec


def mesh_train_full(s: Smoke, smi):
    """b. Yi-6B at full width and, where the state fits (the
    TRAIN_PROBE_LAYERS probe step's memory above its state, counted as
    ``drive_train`` counts it), full depth on the MESH_SHAPE mesh:
    MESH_TRAIN_STEPS steps of TRAIN_BATCH x TRAIN_SEQ tokens.  A batch of
    one row cannot split over the data shards (the reference's placement
    refuses it too): the batch is replicated (``batch_axes=()``).  The
    same steps with mesh=None first, in the same call."""
    import dataclasses
    import math
    import statistics
    torch = s.torch
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.data import lm_batch
    from repro_torch.launch import roofline
    from repro_torch.train import TrainConfig
    full = get_config(MESH_ARCH)
    par = mesh_pars(s, MESH_SHAPE, batch_axes=(), remat="block",
                    attn_chunk_q=TRAIN_CHUNK, attn_chunk_k=TRAIN_CHUNK,
                    logits_chunk=TRAIN_CHUNK)
    warm, timed_n = MESH_TRAIN_STEPS
    tcfg = TrainConfig(peak_lr=1e-3, warmup_steps=1,
                       total_steps=warm + timed_n)

    def batches(n):
        return [lm_batch(0, i, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                         vocab=full.vocab, device=s.dev) for i in range(n)]

    free, _ = torch.cuda.mem_get_info()
    probe = at_depth(full, TRAIN_PROBE_LAYERS)
    state, _, _, probe_peak, _ = train_steps(s, probe, par, tcfg, batches(1))
    del state
    free_card(s)
    overhead = probe_peak - train_state_bytes(probe)
    per_layer = TRAIN_BATCH * TRAIN_SEQ * full.d_model * 2

    def need(layers):
        return (train_state_bytes(at_depth(full, layers)) + overhead
                + (layers - TRAIN_PROBE_LAYERS) * per_layer + TRAIN_SLACK)

    layers = full.n_layers
    while layers > TRAIN_PROBE_LAYERS and need(layers) > free:
        layers -= 1
    run = at_depth(full, layers)
    # mesh=None first, then the mesh: two versions compare in one call
    state, _, plain_times, plain_peak, _ = train_steps(
        s, run, dataclasses.replace(par, mesh=None, batch_axes=None),
        tcfg, batches(warm + timed_n))
    del state
    free_card(s)
    state, metrics, times, peak, unchanged = train_steps(
        s, run, par, tcfg, batches(warm + timed_n))
    del state
    free_card(s)
    timed = times[warm:]
    step_s = statistics.median(timed)
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=TRAIN_SEQ,
                                global_batch=TRAIN_BATCH)
    flops = roofline.model_flops(run, shape)
    rec = {"layers": layers, "full_layers": full.n_layers,
           "state_bytes": train_state_bytes(run), "need_bytes": need(layers),
           "free_bytes": free, "probe_overhead_bytes": overhead,
           "step_ms": step_s * 1e3, "step_ms_all": [t * 1e3 for t in times],
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step_s,
           "bf16_peak_share": flops / step_s / s.bf16, "peak_bytes": peak,
           "loss": [m["loss"] for m in metrics],
           "grad_norm": [m["grad_norm"] for m in metrics],
           "weights_unchanged": unchanged,
           "no_mesh": {"step_ms": statistics.median(plain_times[warm:])
                       * 1e3, "step_ms_all": [t * 1e3 for t in plain_times],
                       "peak_bytes": plain_peak}}
    log(f"[mesh b] {MESH_ARCH} {layers} of {full.n_layers} layers on the "
        f"{MESH_SHAPE} mesh, {TRAIN_BATCH} x {TRAIN_SEQ} tokens a step: "
        f"{rec['step_ms']:.1f} ms median of {timed_n} (all "
        f"{[round(t, 1) for t in rec['step_ms_all']]}), "
        f"{rec['tokens_per_s']:.0f} tokens/s, {rec['bf16_peak_share']:.4f} "
        f"of the bf16 peak; peak {peak / 1e9:.2f} GB (state "
        f"{rec['state_bytes'] / 1e9:.2f} GB); losses {rec['loss']}; without "
        f"a mesh in this call {rec['no_mesh']['step_ms']:.1f} ms (all "
        f"{[round(t, 1) for t in rec['no_mesh']['step_ms_all']]}), peak "
        f"{plain_peak / 1e9:.2f} GB; {smi}")
    assert all(math.isfinite(x) for x in rec["loss"] + rec["grad_norm"])
    assert abs(rec["loss"][0] - math.log(full.vocab)) < LOSS_AT_INIT, rec
    assert not unchanged, unchanged
    return rec


def mesh_serve(s: Smoke, smi):
    """c. Yi-6B served at full width and depth: a prefill of ARCH_BATCH x
    ARCH_PROMPT tokens and ARCH_NEW decode steps with mesh=None, then on
    each of MESH_SERVE's meshes, its greedy tokens held to a mesh=None
    prefill's argmax at clear positions (``greedy_check``).  e. ``gpipe``
    over the same weights (``mesh_gpipe``)."""
    import statistics
    torch = s.torch
    from repro_torch.configs import get_config
    from repro_torch.models import ParallelConfig, init_params
    cfg = get_config(MESH_ARCH)
    params = init_params(cfg, 0, device=s.dev)
    par0 = ParallelConfig(attn_chunk_q=ARCH_CHUNK, attn_chunk_k=ARCH_CHUNK)
    pb = arch_batch(s, cfg, 0, ARCH_BATCH, ARCH_PROMPT)
    rec = {}
    toks0 = None
    for name, shape, kw in (("none", None, {}),) + MESH_SERVE:
        par = par0 if shape is None else mesh_pars(s, shape, **kw)
        toks, h, t_pre, t_dec, state = serve_tokens(s, params, cfg, par, pb,
                                                    ARCH_NEW, MESH_CACHE)
        del state
        r = {"prefill_ms": t_pre * 1e3,
             "decode_ms": statistics.median(t_dec) * 1e3,
             "decode_ms_min": min(t_dec) * 1e3}
        if toks0 is None:
            toks0 = toks
        else:
            r["mesh"] = {"shape": list(shape), **{k: list(v) if isinstance(
                v, tuple) else v for k, v in kw.items()}}
            r["tokens_equal_no_mesh"] = int((toks == toks0).sum())
            r["greedy"] = greedy_check(s, params, cfg, par0, pb, toks, h)
            assert_greedy(cfg, r["greedy"])
        del h
        rec[name] = r
        g = r.get("greedy")
        log(f"[mesh c] {MESH_ARCH} serving, {name}: prefill {ARCH_BATCH} x "
            f"{ARCH_PROMPT} {r['prefill_ms']:.1f} ms, decode "
            f"{r['decode_ms']:.2f} ms a token (median of {ARCH_NEW}; no mesh "
            f"{rec['none']['decode_ms']:.2f})" + (
                "" if g is None else
                f"; greedy == the mesh=None prefill's argmax at {g['clear']} "
                f"clear positions ({g['close']} close, {g['close_equal']} "
                f"equal too; hidden states within {g['h_dev']:.3g}); tokens "
                f"equal to the mesh=None decode's "
                f"{r['tokens_equal_no_mesh']} of {toks.numel()}") +
            f"; {smi}")
    pipe = mesh_gpipe(s, params, cfg, par0, smi)
    del params
    free_card(s)
    return rec, pipe


def mesh_gpipe(s: Smoke, params, cfg, par0, smi):
    """e. ``gpipe`` over the model's layers in MESH_PIPE[0] stages (the
    'stage' axis of a (stages, 2) mesh) on MESH_PIPE[1] micro-batches of
    1 x MESH_PIPE[2] embedded tokens, held to the sequential stack; each
    timed twice, sequential, pipe, pipe, sequential."""
    import statistics
    torch = s.torch
    from repro_torch.data import lm_batch
    from repro_torch.distributed import bubble_fraction, gpipe
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.transformer import _layers
    stages, n_micro, seq = MESH_PIPE
    per = cfg.n_layers // stages
    mesh = make_debug_mesh((stages, 2), ("stage", "model"), device=s.dev)
    pos = torch.arange(seq, dtype=torch.int32, device=s.dev).expand(1, seq)

    def stage_fn(layers, h):
        return _layers(layers, h, pos, cfg, par0, None, params.shared)[0]

    stage_params = [list(params.blocks[i * per:(i + 1) * per])
                    for i in range(stages)]
    toks = lm_batch(3, 0, batch=n_micro, seq=seq, vocab=cfg.vocab,
                    device=s.dev)["tokens"].long()
    times = {"pipe": [], "sequential": []}
    with torch.inference_mode():
        xs = params.embed[toks][:, None]             # (n_micro, 1, seq, D)
        stage_fn(stage_params[0], xs[0])            # warm-up
        for name in ("sequential", "pipe", "pipe", "sequential"):
            if name == "pipe":
                out, t = synced(torch, lambda: gpipe(
                    stage_fn, stage_params, xs, mesh=mesh, axis="stage"))
            else:
                ref, t = synced(torch, lambda: torch.stack(
                    [stage_fn(list(params.blocks[:stages * per]), x)
                     for x in xs]))
            times[name].append(t * 1e3)
        err = float((out.float() - ref.float()).abs().max()
                    / ref.float().abs().max())
    t_pipe = statistics.median(times["pipe"]) / 1e3
    t_seq = statistics.median(times["sequential"]) / 1e3
    rec = {"stages": stages, "micro_batches": n_micro, "tokens": seq,
           "layers_a_stage": per, "pipe_ms": t_pipe * 1e3,
           "sequential_ms": t_seq * 1e3, "ms_all": times,
           "ratio": t_pipe / t_seq,
           "bubble_fraction": bubble_fraction(n_micro, stages),
           "schedule_ratio": (n_micro + stages - 1) / n_micro,
           "max_rel_err": err}
    log(f"[mesh e] gpipe of {stages * per} layers in {stages} stages of "
        f"{per}, {n_micro} micro-batches of 1 x {seq} tokens: "
        f"{t_pipe * 1e3:.1f} ms against {t_seq * 1e3:.1f} ms sequential "
        f"(medians of {times}; x{rec['ratio']:.3f}; the schedule runs every stage each of "
        f"n_micro + n_stages - 1 steps: x{rec['schedule_ratio']:.3f}); "
        f"bubble fraction {rec['bubble_fraction']:.4f}; within {err:.3g} of "
        f"the sequential stack's largest entry (limit {MESH_PIPE_TOL}); {smi}")
    assert rec["bubble_fraction"] == 3 / 11 or MESH_PIPE[:2] != (4, 8)
    assert err <= MESH_PIPE_TOL, rec
    return rec


def mesh_moe(s: Smoke, smi):
    """d. Granite-MoE at full width and depth, ``moe_local_dispatch`` on
    the MESH_SHAPE mesh (one batch row a data shard): a prefill of
    ARCH_BATCH x ARCH_PROMPT tokens timed against the global dispatch
    (global, local, local, global after a warm-up).  The local dispatch
    is each shard's global dispatch on its own tokens: held on the first
    MoE layer's input (bf16, each row against ``moe_apply`` of that row
    alone, the same routing, within MESH_MOE_TOL of the largest entry)
    and on the whole model in float32 (each row's final hidden states
    against a mesh=None prefill of that row alone; rows within
    MESH_MOE_ROW_TOL of their largest entry but a MESH_MOE_ROW_SHARE
    share: a routing near-tie may flip on one side)."""
    import copy
    import dataclasses
    import statistics
    torch = s.torch
    from repro_torch.configs import get_config
    from repro_torch.models import (ParallelConfig, hidden_states,
                                    init_params, prefill)
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.common import rmsnorm
    cfg = get_config(MESH_MOE)
    params = init_params(cfg, 0, device=s.dev)
    par0 = ParallelConfig(attn_chunk_q=ARCH_CHUNK, attn_chunk_k=ARCH_CHUNK)
    parl = mesh_pars(s, MESH_SHAPE, moe_local_dispatch=True)
    pb = arch_batch(s, cfg, 0, ARCH_BATCH, ARCH_PROMPT)
    times = {"global": [], "local": []}
    with torch.inference_mode():
        prefill(params, pb, cfg, par0, ARCH_PROMPT)
        for name in ("global", "local", "local", "global"):
            _, t = synced(torch, lambda: prefill(
                params, pb, cfg, parl if name == "local" else par0,
                ARCH_PROMPT))
            times[name].append(t * 1e3)
        lp = next(lp for lp in params.blocks if lp.kind == "moe")
        x = rmsnorm(params.embed[pb["tokens"].long()], lp.norm2,
                    cfg.norm_eps)
        kw = dict(top_k=cfg.moe.top_k, capacity_factor=cfg.moe.capacity_factor,
                  act=cfg.mlp_act)
        local, _ = moe_lib.moe_apply(lp.moe, x, par=parl, **kw)
        rows = torch.cat([moe_lib.moe_apply(lp.moe, x[r:r + 1], **kw)[0]
                          for r in range(x.shape[0])])
        layer_err = float((local.float() - rows.float()).abs().max()
                          / rows.float().abs().max())
        glob, _ = moe_lib.moe_apply(lp.moe, x, **kw)
        global_gap = float((glob.float() - rows.float()).abs().max()
                           / rows.float().abs().max())
    del local, rows, glob, x
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = copy.deepcopy(params).float()
    del params
    free_card(s)
    with torch.inference_mode():
        h = hidden_states(p32, pb, cfg32, parl).float()
        dev = torch.cat([
            ((h[r:r + 1] - hidden_states(p32, {"tokens": pb["tokens"][
                r:r + 1]}, cfg32, par0).float()).abs().amax(-1)
             / h[r:r + 1].abs().amax(-1)) for r in range(h.shape[0])])
    share = float((dev > MESH_MOE_ROW_TOL).float().mean())
    rec = {"layers": cfg.n_layers, "batch": [ARCH_BATCH, ARCH_PROMPT],
           "prefill_ms": times, "prefill_ms_local": statistics.median(
               times["local"]),
           "prefill_ms_global": statistics.median(times["global"]),
           "layer_max_rel_err": layer_err,
           "layer_global_vs_rows_gap": global_gap,
           "f32_row_dev_max": float(dev.max()),
           "f32_row_dev_median": float(dev.median()),
           "f32_rows_past_tol_share": share}
    log(f"[mesh d] {MESH_MOE} {cfg.n_layers} layers x d_model {cfg.d_model} "
        f"({cfg.moe.num_experts} experts, top {cfg.moe.top_k}, capacity "
        f"factor {cfg.moe.capacity_factor}), {ARCH_BATCH} x {ARCH_PROMPT} "
        f"tokens on the {MESH_SHAPE} mesh: prefill local dispatch "
        f"{times['local']} ms, global {times['global']} ms; the first MoE "
        f"layer's local output within {layer_err:.3g} of each row's own "
        f"dispatch (limit {MESH_MOE_TOL}; the global dispatch of the batch "
        f"is {global_gap:.3g} away: the capacity binds); float32 model rows "
        f"within {rec['f32_row_dev_median']:.3g} median, "
        f"{rec['f32_row_dev_max']:.3g} max of their largest entry, "
        f"{share:.4%} past {MESH_MOE_ROW_TOL}; {smi}")
    assert layer_err <= MESH_MOE_TOL, rec
    assert share <= MESH_MOE_ROW_SHARE, rec
    del p32, h
    free_card(s)
    return rec


def mesh_ef(s: Smoke, smi):
    """f. ``apply_ef`` over MESH_EF_SHARDS shards of a 'pod' axis, each
    holding gradient-shaped leaves of one Yi-6B layer (N(0, 0.01), seed
    0): the first step's reduction against the plain mean (relative error
    below MESH_EF_RELERR, as test_distributed's), then MESH_EF_STEPS
    steps of the same grads: the applied sum within
    ``tests/test_optim.py``'s bound (0.01 x the largest entry of
    steps x the mean, + 1e-4), leaf by leaf."""
    import statistics
    torch = s.torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import init_params
    from repro_torch.optim import apply_ef, init_ef
    cfg = at_depth(get_config(MESH_ARCH), 1)
    shapes = {n: p.shape for n, p in
              init_params(cfg, device="meta").blocks[0].named_parameters()}
    n = MESH_EF_SHARDS
    mesh = make_debug_mesh((n,), ("pod",), device=s.dev)
    gen = torch.Generator(device=s.dev).manual_seed(0)
    grads = [{k: torch.randn(v, generator=gen, device=s.dev) * 0.01
              for k, v in shapes.items()} for _ in range(n)]
    ef = [init_ef(g) for g in grads]
    mean = {k: sum(g[k] for g in grads) / n for k in shapes}
    applied = {k: torch.zeros_like(v) for k, v in mean.items()}
    times, first = [], None
    for step in range(MESH_EF_STEPS):
        (red, ef), t = synced(torch, lambda: apply_ef(grads, ef, mesh, "pod",
                                                      n))
        times.append(t * 1e3)
        if first is None:
            first = max(float((red[0][k] - mean[k]).abs().max()
                              / mean[k].abs().max()) for k in shapes)
            assert all(torch.equal(r[k], red[0][k]) for r in red[1:]
                       for k in shapes)
        for k in shapes:
            applied[k] += red[0][k]
        del red
    errs = {}
    for k in shapes:
        want = MESH_EF_STEPS * mean[k]
        err = float((applied[k] - want).abs().max())
        bound = 0.01 * float(want.abs().max()) + 1e-4
        errs[k] = (err, bound)
        assert err < bound, (k, err, bound)
    entries = sum(v.numel() for v in mean.values())
    rec = {"shards": n, "entries_a_shard": entries,
           "bytes_float32_all_shards": 4 * n * entries,
           "first_step_rel_err": first, "steps": MESH_EF_STEPS,
           "step_ms_median": statistics.median(times),
           "step_ms_first": times[0],
           "applied_err_over_bound_max": max(e / b for e, b in errs.values())}
    log(f"[mesh f] apply_ef over {n} shards of {entries} entries each (one "
        f"{MESH_ARCH} layer's leaves, {4 * n * entries / 1e9:.2f} GB of "
        f"float32 grads): first step within {first:.4g} of the plain mean "
        f"(limit {MESH_EF_RELERR}); after {MESH_EF_STEPS} steps the applied "
        f"sum within {rec['applied_err_over_bound_max']:.3g} of its bound, "
        f"leaf by leaf; {rec['step_ms_median']:.1f} ms a step (median; first "
        f"{times[0]:.1f}); {smi}")
    assert first < MESH_EF_RELERR, rec
    del grads, ef, mean, applied
    free_card(s)
    return rec


def mesh_launch(s: Smoke):
    """g. ``python -m repro_torch.launch.train --reduced --devices 8
    --steps 4`` in a subprocess: the launcher's debug mesh on the card."""
    import math
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         MESH_ARCH, "--reduced", "--devices", "8", "--steps", "4"],
        capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    final = [ln for ln in out.stdout.splitlines()
             if ln.startswith("final loss:")]
    assert final and math.isfinite(float(final[-1].split()[-1])), out.stdout
    rec = {"s": time.perf_counter() - t0,
           "final_loss": float(final[-1].split()[-1])}
    log(f"[mesh g] launch.train --reduced --devices 8 --steps 4 in a "
        f"subprocess: final loss {rec['final_loss']:.6f}, {rec['s']:.1f} s")
    return rec


def drive_mesh(s: Smoke, smi):
    """Model parallelism on the ``ShardMesh`` (phase 8d), last, on a card
    the earlier phases left (less than ARCH_LEFT bytes allocated), each
    model freed before the next: a. ``mesh_train_check``, b.
    ``mesh_train_full``, c. and e. ``mesh_serve`` (with ``mesh_gpipe``),
    d. ``mesh_moe``, f. ``mesh_ef``, g. ``mesh_launch``.  Returns the
    ``[mesh]`` record."""
    torch = s.torch
    t_phase = time.perf_counter()
    free_card(s)
    assert torch.cuda.memory_allocated() < ARCH_LEFT, \
        f"{torch.cuda.memory_allocated()} bytes left on the card"
    rec = {"card": smi}
    rec["a_train_check"] = mesh_train_check(s)
    free_card(s)
    rec["b_train_full"] = mesh_train_full(s, smi)
    rec["c_serve"], rec["e_gpipe"] = mesh_serve(s, smi)
    rec["d_moe_local"] = mesh_moe(s, smi)
    rec["f_apply_ef"] = mesh_ef(s, smi)
    rec["g_launch"] = mesh_launch(s)
    assert torch.cuda.memory_allocated() < ARCH_LEFT
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"[mesh] the phase took {rec['phase_s']:.1f} s")
    return rec


# phase 8e: the dry-run cells, each a ``launch.dryrun`` subprocess
LAUNCH_CELLS = (("yi-6b", "train_4k", "single"),
                ("yi-6b", "train_4k", "multi"),
                ("yi-6b", "decode_32k", "single"),
                ("granite-moe-1b-a400m", "train_4k", "single"),
                ("falcon-mamba-7b", "long_500k", "single"))
LAUNCH_TAG = "chip_smoke"
LAUNCH_TIMEOUT = 600                  # seconds the dry-run subprocesses get


def launch_subprocesses():
    """Start ``python -m repro_torch.launch.dryrun`` for each of
    LAUNCH_CELLS and ``python -m repro_torch.launch.dryrun_retrieval``,
    all at once (meta-device work on the host's cores, beside the card's
    part of the phase); returns [(what, Popen, record path)]."""
    import os
    from repro_torch.launch import dryrun
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = []
    for arch, shape, mesh in LAUNCH_CELLS:
        name = "2x16x16" if mesh == "multi" else "16x16"
        path = dryrun.cell_path(arch, shape, name, LAUNCH_TAG)
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--mesh", mesh, "--force", "--tag",
               LAUNCH_TAG]
        procs.append((f"{arch} {shape} {name}", subprocess.Popen(
            cmd, env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), path))
    path = str(Path(dryrun.RESULTS_DIR) / "paper-index__retrieval__16x16.json")
    procs.append(("retrieval", subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun_retrieval"],
        env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True), path))
    return procs


def launch_records(procs, deadline):
    """Wait for ``launch_subprocesses``' processes (each killed at
    ``deadline``, a ``time.perf_counter()``), assert each exited 0 with an
    ``ok`` record, and return the records by cell."""
    out = {}
    try:
        for what, p, path in procs:
            text, _ = p.communicate(
                timeout=max(1.0, deadline - time.perf_counter()))
            assert p.returncode == 0, f"{what}: exit {p.returncode}\n" \
                + text[-3000:]
            with open(path) as f:
                out[what] = json.load(f)
            assert out[what]["status"] == "ok", out[what]
    finally:
        for _, p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def launch_tie(s: Smoke, layers, smi):
    """c. One TRAIN_BATCH x TRAIN_SEQ train step of Yi-6B at full width
    and ``layers`` layers (mesh=None, ``drive_train``'s knobs) counted by
    ``hlo_analysis.analyze_step`` on the card and on the meta device: the
    FLOPs equal (the model path launches no hand-written kernel), the
    bytes' ratio, the counted bound max(FLOPs / bf16 peak, bytes / HBM
    rate) against the step's measured ms, and the counter's peak live
    bytes against ``torch.cuda.max_memory_allocated()`` over the counted
    step."""
    torch = s.torch
    from repro_torch.configs import get_config
    from repro_torch.data import lm_batch
    from repro_torch.launch.hlo_analysis import analyze_step
    from repro_torch.models import ParallelConfig
    from repro_torch.train import TrainConfig, init_state, make_train_step
    cfg = at_depth(get_config(TRAIN_ARCH), layers)
    par = ParallelConfig(remat="block", attn_chunk_q=TRAIN_CHUNK,
                         attn_chunk_k=TRAIN_CHUNK, logits_chunk=TRAIN_CHUNK)
    tcfg = TrainConfig(peak_lr=1e-3, warmup_steps=1, total_steps=8)
    step = make_train_step(cfg, par, tcfg)
    t0 = time.perf_counter()
    meta_state = init_state(cfg, 0, tcfg, device="meta")
    meta_batch = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                  for k, v in lm_batch(0, 0, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                                       vocab=cfg.vocab, device="cpu").items()}
    meta = analyze_step(step, meta_state, meta_batch)
    meta_s = time.perf_counter() - t0
    del meta_state, meta_batch
    free_card(s)
    state = init_state(cfg, 0, tcfg, device=s.dev)
    batches = [lm_batch(0, i, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                        vocab=cfg.vocab, device=s.dev) for i in range(3)]
    step(state, batches[0])                      # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    card = analyze_step(step, state, batches[1])
    torch.cuda.synchronize()
    counted_s = time.perf_counter() - t0
    card_peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    step(state, batches[2])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    del state, batches
    free_card(s)
    bound_ms = max(card.flops / s.bf16, card.bytes / s.bw) * 1e3
    rec = {"arch": cfg.name, "layers": layers, "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "flops_card": card.flops,
           "flops_meta": meta.flops, "bytes_card": card.bytes,
           "bytes_meta": meta.bytes, "bytes_ratio": card.bytes / meta.bytes,
           "bound_ms": bound_ms,
           "bound_by": ("operations" if card.flops / s.bf16
                        >= card.bytes / s.bw else "bytes"),
           "step_ms": step_ms, "share_of_bound": bound_ms / step_ms,
           "peak_live_bytes": card.peak_live_bytes,
           "max_memory_allocated": card_peak,
           "live_ratio": card.peak_live_bytes / card_peak,
           "peak_live_bytes_meta": meta.peak_live_bytes,
           "meta_count_s": meta_s, "card_counted_step_s": counted_s}
    log(f"[launch c] {cfg.name} {layers} layers, {TRAIN_BATCH} x {TRAIN_SEQ} "
        f"tokens, one train step: FLOPs card {card.flops:.6g} meta "
        f"{meta.flops:.6g}; bytes card {card.bytes:.6g} meta "
        f"{meta.bytes:.6g} (ratio {rec['bytes_ratio']:.6f}); counted bound "
        f"{bound_ms:.2f} ms ({rec['bound_by']}) against the step's "
        f"{step_ms:.2f} ms: {rec['share_of_bound']:.4f} of its bound; peak "
        f"live {card.peak_live_bytes / 1e9:.3f} GB against "
        f"max_memory_allocated {card_peak / 1e9:.3f} GB (ratio "
        f"{rec['live_ratio']:.4f}); the meta count took {meta_s:.1f} s, the "
        f"counted card step {counted_s:.1f} s; {smi}")
    assert card.flops == meta.flops, (card.flops, meta.flops)
    assert card.flops > 0 and card.bytes > 0
    return rec


def drive_launch(s: Smoke, smi, layers):
    """The launch tail (phase 8e), last: a. the LAUNCH_CELLS dry runs
    (``python -m repro_torch.launch.dryrun``, the meta device, the
    production meshes) and b. ``python -m
    repro_torch.launch.dryrun_retrieval`` at its defaults, in
    subprocesses beside c. ``launch_tie`` on the card.  Returns the
    ``[launch]`` record."""
    t_phase = time.perf_counter()
    procs = launch_subprocesses()
    try:
        tie = launch_tie(s, layers, smi)
    except BaseException:
        for _, p, _ in procs:
            p.kill()
            p.wait()
        raise
    recs = launch_records(procs, t_phase + LAUNCH_TIMEOUT)
    rec = {"card": smi, "cells": {}, "tie": tie}
    for what, r in recs.items():
        if what == "retrieval":
            rec["retrieval"] = {k: r[k] for k in (
                "shape", "mesh", "chips", "shards", "run_s", "cost",
                "collectives", "terms", "estimate", "routes", "both_routes",
                "memory")}
            t = r["terms"]
            log(f"[launch b] dryrun_retrieval {r['shape']} on {r['mesh']} "
                f"({r['shards']} index shards): {r['run_s']} s; per chip "
                f"FLOPs {r['cost']['flops']:.6g}, bytes "
                f"{r['cost']['bytes accessed']:.6g}, wire "
                f"{sum(r['collectives'].values()):.6g}; both routes' FLOPs "
                f"{r['both_routes']['flops']:.6g} (lsh "
                f"{r['routes']['lsh']['flops']:.6g}, linear "
                f"{r['routes']['linear']['flops']:.6g}, estimate "
                f"{r['estimate']['flops']:.6g}); dominant {t['dominant']}, "
                f"roofline {t['roofline_fraction']:.6g}")
            continue
        t = r["terms"]
        cell = {"run_s": r["run_s"], "chips": r["chips"],
                "flops_per_chip": r["cost"]["flops"],
                "bytes_per_chip": r["cost"]["bytes accessed"],
                "wire_per_chip": sum(r["collectives"].values()),
                "dominant": t["dominant"],
                "roofline_fraction": t["roofline_fraction"],
                "input_bytes_per_device": r["input_bytes_per_device"],
                "peak_live_bytes_global":
                    r["memory"]["peak_live_bytes_global"]}
        rec["cells"][what] = cell
        log(f"[launch a] {what}: {cell['run_s']} s on the meta device; per "
            f"chip FLOPs {cell['flops_per_chip']:.6g}, bytes "
            f"{cell['bytes_per_chip']:.6g}, wire {cell['wire_per_chip']:.6g}; "
            f"dominant {cell['dominant']}, roofline "
            f"{cell['roofline_fraction']:.6g}; input bytes per device "
            f"{cell['input_bytes_per_device']}")
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"[launch] the phase took {rec['phase_s']:.1f} s")
    return rec


def log_kernel_times(tag, kt):
    for k, v in kt.items():
        lib = "none" if v["library_ms"] is None else f"{v['library_ms']:.4f}"
        if "library_call" in v:
            lib += f" ({v['library_call']})"
        log(f"[{tag}] {k}: {v['ms']:.4f} ms, plain {v['plain_ms']:.4f}, "
            f"library {lib}, bound {v['bound_ms']:.3g} ({v['bound_by']}), "
            f"max abs err {v['max_abs_err']:.3g}; {v['shape']}")
        if "device_ms" in v:
            log(f"[{tag}] {k} device ms (CUDA graph replay, no host work "
                f"between launches): {v['device_ms']:.4f}"
                + (f", library {v['library_device_ms']:.4f}"
                   if "library_device_ms" in v else ""))
        if "group_device_ms" in v:
            log(f"[{tag}] {k} over the whole {v['group_q']}-query group in "
                f"one launch: {v['group_ms']:.4f} ms (device "
                f"{v['group_device_ms']:.4f}), in 32-query slices "
                f"{v['sliced_ms']:.4f} ms (device {v['sliced_device_ms']:.4f}); "
                f"group launch layout {v['group_plan']}")
        if "ops_ms" in v:
            log(f"[{tag}] {k} through ops (the wrapper's own preparation "
                f"and the kernel): {v['ops_ms']:.4f} ms")
        if "bound_tf32_ms" in v:
            log(f"[{tag}] {k} bound terms: bytes {v['bound_bytes_ms']:.4f} ms, "
                f"TF32 x3 {v['bound_tf32_ms']:.4f} ms (the same products on "
                f"the CUDA cores {v['bound_cuda_cores_ms']:.4f} ms); launch "
                f"layout {v['plan']}")
        elif "plan" in v:
            log(f"[{tag}] {k} launch layout {v['plan']}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on a "
              "GPU", file=sys.stderr)
        return 1
    from repro_torch.core import PAPER_PRESETS, HybridLSHIndex
    from repro_torch.core.lsh import make_family
    from repro_torch.data import paper_dataset, query_split

    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    log(smi)
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    s = Smoke()
    phase_build(s)
    phase_edge_cases(s)
    bucket_hash_rows = phase_bucket_hash(s)
    delta_collide_rows = phase_delta_collide(s)
    by_path = {}
    calibrated, at_probe = phase_calibrate(s, by_path)

    def models(data):
        return {"preset": PAPER_PRESETS[data], "calibrated": calibrated[data]}

    # -- 4. Webspam analogue, full scale --------------------------------
    t0 = time.perf_counter()
    x, metric = paper_dataset("webspam", scale=1.0, seed=0)
    x, q = query_split(x, n_queries=100, seed=0)
    log(f"[webspam] N={x.shape[0]} d={x.shape[1]} {metric}, 100 queries "
        f"(data {time.perf_counter() - t0:.1f} s)")
    radii = pick_radii(x, metric)
    kw = dict(num_buckets=65536, m=64, cap=256,
              cost_model=PAPER_PRESETS["webspam"], device="cuda")

    def webspam_fam(r):
        return make_family("cosine", d=254, L=20, r=r, delta=0.1)

    mixed, mixes, main_idx = None, [], None
    for i, r in enumerate(radii):
        idx, launches, (n_lsh, n_lin) = drive(s, x, q, metric, webspam_fam(r),
                                              kw, r, f"webspam q{i}")
        by_path[f"webspam q{i}"] = launches
        mixes.append(route_mixes(s, idx, q, r, models("webspam"),
                                 f"webspam q{i}"))
        if i == 0:
            mem = idx.memory_stats()
            log(f"[webspam] device memory: corpus {idx.x.numel() * 4 / 1e6:.1f}"
                f" MB, registers {mem['hll_bytes'] / 1e6:.1f} MB, perm "
                f"{mem['perm_bytes'] / 1e6:.1f} MB, starts "
                f"{mem['starts_bytes'] / 1e6:.1f} MB")
        kt = kernel_times(s, idx, q, r, metric)
        log_kernel_times(f"webspam q{i}", kt)
        if n_lsh and n_lin:
            mixed, timings, main_idx = i, kt, idx
        del idx
        torch.cuda.empty_cache()
    assert mixed is not None, "webspam: the hybrid mixed routes at no radius"
    # the main path: the hybrid query at the radius where it mixes routes,
    # so that it runs all three kernels
    main_launches = by_path[f"webspam q{mixed}"]["hybrid"]
    for k in ("linear_scan_dot", "lsh_scan", "route_estimate", "bucket_hash"):
        assert main_launches[k] > 0, f"webspam q{mixed}: kernel {k} was not launched"
    timings["simhash"] = simhash_times(s, main_idx, by_path,
                                       f"webspam q{mixed} simhash_fingerprint")
    full_cosine = pairwise_times(s, torch.from_numpy(q).to(s.dev), main_idx.x,
                                 metric)
    log_kernel_times("webspam", {"pairwise_dot": full_cosine,
                                 "simhash": timings["simhash"]})
    del main_idx
    torch.cuda.empty_cache()
    idx = drive_calibrated(s, x, q, metric, webspam_fam, kw, radii, mixes,
                           calibrated["webspam"], "webspam", by_path)
    del idx
    torch.cuda.empty_cache()
    # -- 4b. the row-sharded static index (core.distributed), 4 shards ----
    sharded_static = drive_sharded_static(s, x, q, radii, webspam_fam, kw,
                                          by_path)
    del x
    torch.cuda.empty_cache()

    # -- 5a. Corel analogue, l2: the preset at q2, the calibrated model --
    x2, metric2 = paper_dataset("corel", scale=1.0, seed=0)
    x2, q2 = query_split(x2, n_queries=100, seed=0)
    radii2 = pick_radii(x2, metric2)
    kw2 = dict(num_buckets=32768, m=64, cap=256,
               cost_model=PAPER_PRESETS["corel"], device="cuda")

    def corel_fam(r):
        return make_family("l2", d=32, L=20, r=r, delta=0.1)

    mixes2 = []
    for i, r in enumerate(radii2):
        idx2 = HybridLSHIndex(corel_fam(r), seed=0, **kw2).build(x2)
        mixes2.append(route_mixes(s, idx2, q2, r, models("corel"),
                                  f"corel q{i}"))
        del idx2
    r2 = radii2[2]
    idx2, by_path["corel"], _ = drive(s, x2, q2, metric2, corel_fam(r2), kw2,
                                      r2, "corel")
    corel_kt = kernel_times(s, idx2, q2, r2, metric2)
    log_kernel_times("corel", corel_kt)
    timings["linear_scan_dot"]["corel"] = corel_kt["linear_scan_dot"]
    corel_l2 = pairwise_times(s, torch.from_numpy(q2).to(s.dev), idx2.x,
                              metric2)
    log_kernel_times("corel", {"pairwise_dot": corel_l2})
    del idx2
    idx2 = drive_calibrated(s, x2, q2, metric2, corel_fam, kw2, radii2, mixes2,
                            calibrated["corel"], "corel", by_path)
    del idx2
    torch.cuda.empty_cache()

    # -- 5b. CoverType analogue, static on all rows, the calibrated model --
    t0 = time.perf_counter()
    x3, metric3 = paper_dataset("covertype", scale=1.0, seed=0)
    x3, q3 = query_split(x3, n_queries=100, seed=0)
    log(f"[covertype] N={x3.shape[0]} d={x3.shape[1]} {metric3}, 100 "
        f"queries (data {time.perf_counter() - t0:.1f} s)")
    radii3 = pick_radii(x3, metric3)
    kw3s = dict(num_buckets=65536, m=64, cap=256,
                cost_model=PAPER_PRESETS["covertype"], device="cuda")

    def cover_fam(r):
        return make_family("l1", d=54, L=20, r=r, delta=0.1)

    mixes3 = []
    for i, r in enumerate(radii3):
        idx3 = HybridLSHIndex(cover_fam(r), seed=0, **kw3s).build(x3)
        mixes3.append(route_mixes(s, idx3, q3, r, models("covertype"),
                                  f"covertype static q{i}"))
        del idx3
    idx3 = drive_calibrated(s, x3, q3, metric3, cover_fam, kw3s, radii3,
                            mixes3, calibrated["covertype"],
                            "covertype static", by_path)
    full_l1 = pairwise_times(s, torch.from_numpy(q3).to(s.dev), idx3.x,
                             metric3)
    log_kernel_times("covertype static", {"pairwise_l1": full_l1})
    del idx3
    torch.cuda.empty_cache()

    # -- 6. CoverType analogue, streaming, full scale (K4's main path) ----
    from repro_torch.streaming import CompactionPolicy, DynamicHybridIndex
    n_build3 = 524288
    log(f"[covertype] streaming: build on {n_build3} rows, then insert "
        f"{x3.shape[0] - n_build3}")
    kw3 = dict(num_buckets=65536, m=64, cap=256, delta_capacity=8192,
               cost_model=PAPER_PRESETS["covertype"],
               policy=CompactionPolicy(step_rows=8192), device="cuda")

    def make_cover(r):
        return DynamicHybridIndex(cover_fam(r), seed=0, **kw3).build(
            x3[:n_build3])

    i3, r3, idx3 = pick_streaming_radius(s, x3, q3, metric3, radii3,
                                         make_cover, "covertype")
    name, k4 = linear_kernel_times(s, idx3.stack.segments[0].seg.x, q3, r3,
                                   metric3)
    timings[name] = k4
    log_kernel_times(f"covertype q{i3}", {name: k4})
    cover = drive_streaming(s, idx3, x3, q3, metric3, r3, n_build=n_build3,
                            batch=4096, tag=f"covertype q{i3}", seed=1,
                            durability="steps")
    for state in ("churned", "compacted"):
        by_path[f"covertype q{i3} {state}"] = cover[state]["launches"]
    by_path[f"covertype q{i3} restored"] = cover["durability"]["restore"][
        "launches"]
    del idx3
    torch.cuda.empty_cache()
    # -- 6b. the row-sharded streaming index, 4 shards on the card --------
    sharded, timings["route_terms"] = drive_sharded_streaming(
        s, x3, q3, cover_fam, radii3, by_path)

    # -- 7. MNIST analogue, Hamming: static, K8 and streaming (K5) --------
    x4, metric4 = paper_dataset("mnist", scale=1.0, seed=0)
    x4, q4 = query_split(x4, n_queries=100, seed=0)
    log(f"[mnist] N={x4.shape[0]} W={x4.shape[1]} {metric4}, 100 queries")
    kw4 = dict(num_buckets=16384, m=64, cap=256,
               cost_model=PAPER_PRESETS["mnist"], device="cuda")
    radii4 = pick_radii(x4, metric4)
    mixed4 = None
    for i, r in enumerate(radii4):
        fam = make_family("hamming", d=64, L=20, r=r, delta=0.1)
        idx4, launches, (n_lsh, n_lin) = drive(s, x4, q4, metric4, fam, kw4,
                                               r, f"mnist q{i}")
        by_path[f"mnist q{i}"] = launches
        if n_lsh and n_lin:
            mixed4 = i
        del idx4
    if mixed4 is None:
        log("[mnist] the static hybrid mixes routes at no radius: the "
            "streaming phase runs at q3")
    i4 = 3 if mixed4 is None else mixed4
    r4 = radii4[i4]
    fam4 = make_family("hamming", d=64, L=20, r=r4, delta=0.1)
    idx4 = HybridLSHIndex(fam4, seed=0, **kw4).build(x4)
    _, k5_static = linear_kernel_times(s, idx4.x, q4, r4, metric4)
    log_kernel_times(f"mnist q{i4} static, one 32-query chunk",
                     {"linear_scan_hamming": k5_static})
    del idx4
    timings["hamming"] = hamming_times(s, q4, x4, by_path,
                                       "mnist hamming_dist")
    log_kernel_times("mnist", {"hamming": timings["hamming"]})
    dyn4 = DynamicHybridIndex(fam4, seed=0, delta_capacity=4096,
                              policy=CompactionPolicy(step_rows=4096),
                              **kw4).build(x4[:32768])
    mnist = drive_streaming(s, dyn4, x4, q4, metric4, r4, n_build=32768,
                            batch=2048, tag=f"mnist q{i4} streaming", seed=2,
                            durability="once")
    for state in ("churned", "compacted"):
        by_path[f"mnist q{i4} streaming {state}"] = mnist[state]["launches"]
    by_path[f"mnist q{i4} streaming restored"] = mnist["durability"][
        "restore"]["launches"]
    del dyn4
    torch.cuda.empty_cache()
    # -- 7b. three MNIST tenants: shared engine, driver, scheduler, cache -
    tenants = drive_tenants(
        s, x4, q4, fam4, r4,
        dict(kw4, delta_capacity=4096,
             policy=CompactionPolicy(step_rows=4096)), f"mnist q{i4} tenants")
    log("[durability] " + json.dumps(
        {"card": smi, "covertype": cover["durability"],
         "mnist": mnist["durability"], "tenants": tenants}))
    # -- 7c. the retrieval encoder and service at Yi-6B's full size ------
    retrieval = drive_retrieval(s, by_path)
    retrieval["card"] = smi
    log("[retrieval] " + json.dumps(retrieval))
    log("[sharded] " + json.dumps(
        {"card": smi, "webspam_static": sharded_static,
         "covertype_streaming": sharded, "retrieval": retrieval["sharded"]}))
    # -- 7d. training on the dense path, on an empty card ---------------
    train = drive_train(s, smi)
    log("[train] " + json.dumps(train))
    # -- 7e. the other layer kinds, last, on an empty card ---------------
    archs = drive_archs(s, smi, by_path)
    log("[archs] " + json.dumps(archs))
    # -- 7f. model parallelism on the ShardMesh, on an empty card --------
    mesh = drive_mesh(s, smi)
    log("[mesh] " + json.dumps(mesh))
    # -- 7g. the launch tail: dry runs on the meta device, the card's tie -
    launch = drive_launch(s, smi, train["layers"])
    log("[launch] " + json.dumps(launch))
    rkt = retrieval.pop("kernel_times")
    for name in ("linear_scan_dot", "lsh_scan"):
        timings[name]["retrieval d=4096"] = rkt[name]
    # K3 and K5 at their main-path shape: churned MNIST over all segments
    mkt = mnist["churned"]["kernel_times"]
    timings["route_estimate"] = dict(
        mkt["route_estimate"],
        covertype_churned=cover["churned"]["kernel_times"]["route_estimate"],
        webspam_one_segment=timings.pop("hll_merge_estimate"))
    timings["linear_scan_hamming"] = dict(mkt["linear_scan_hamming"],
                                          static_one_chunk=k5_static)

    # -- 8. summary lines -----------------------------------------------
    # K6 and K7 run on the calibrate paths: their rows' times are at
    # calibrate's shape; the full-size times ride along under full_size
    timings["pairwise_dot"] = dict(
        at_probe["cosine"], calibrate_l2=at_probe["l2"],
        full_size={"webspam cosine": full_cosine, "corel l2": corel_l2})
    timings["pairwise_l1"] = dict(at_probe["l1"],
                                  full_size={"covertype l1": full_l1})
    # the bucket hash at CoverType's query shape (p-stable, the floor
    # front), the other shapes beside it
    timings["bucket_hash"] = dict(bucket_hash_rows["covertype d=54 k=8"],
                                  by_shape=bucket_hash_rows)
    # the delta's collision test: counts over a full delta, single probe
    timings["delta_collide"] = dict(
        delta_collide_rows["single probe n=8192 counts"],
        by_shape=delta_collide_rows)
    csrc = "src/repro_torch/kernels/csrc/"
    main_paths = {
        "linear_scan_dot": (f"webspam q{mixed}", "hybrid"),
        "lsh_scan": (f"webspam q{mixed}", "hybrid"),
        "route_estimate": (f"mnist q{i4} streaming churned", "hybrid"),
        "route_terms": ("covertype sharded churned per_shard", "hybrid"),
        "linear_scan_l1": (f"covertype q{i3} churned", "hybrid"),
        "linear_scan_hamming": (f"mnist q{i4} streaming churned", "hybrid"),
        "pairwise_dot": ("calibrate cosine", "calibrate"),
        "pairwise_l1": ("calibrate l1", "calibrate"),
        "hamming": ("mnist hamming_dist", "ops"),
        "simhash": (f"webspam q{mixed} simhash_fingerprint", "ops"),
        "bucket_hash": (f"covertype q{i3} churned", "hybrid"),
        "delta_collide": (f"covertype q{i3} churned", "hybrid"),
    }
    src = {"linear_scan_dot": (csrc + "fused_scan.cu",
                               "src/repro/kernels/fused_scan.py:145"),
           "lsh_scan": (csrc + "fused_scan.cu",
                        "src/repro/kernels/fused_scan.py:272"),
           "route_estimate": (csrc + "hll_merge.cu",
                              "src/repro/kernels/hll_merge.py:43"),
           "route_terms": (csrc + "hll_merge.cu",
                           "src/repro/kernels/hll_merge.py:43"),
           "linear_scan_l1": (csrc + "fused_scan.cu",
                              "src/repro/kernels/fused_scan.py:177"),
           "linear_scan_hamming": (csrc + "fused_scan.cu",
                                   "src/repro/kernels/fused_scan.py:202"),
           "pairwise_dot": (csrc + "fused_scan.cu",
                            "src/repro/kernels/distances.py:62"),
           "pairwise_l1": (csrc + "fused_scan.cu",
                           "src/repro/kernels/distances.py:93"),
           "hamming": (csrc + "fused_scan.cu",
                       "src/repro/kernels/hamming.py:33"),
           "simhash": (csrc + "simhash.cu", "src/repro/kernels/simhash.py:34"),
           "bucket_hash": (csrc + "bucket_hash.cu",
                           "none: XLA fused the jnp chain of "
                           "src/repro/core/lsh/families.py:65"),
           "delta_collide": (csrc + "delta_collide.cu",
                             "none: XLA fused the jnp chain of "
                             "src/repro/streaming/delta.py:141,158")}
    kernels = []
    for name, (source, replaces) in src.items():
        t = timings[name]
        cell, path = main_paths[name]
        launches = by_path[cell][path][name]
        assert launches > 0, f"{cell} {path}: kernel {name} was not launched"
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": launches,
               "max_abs_err": t["max_abs_err"], "ms": t["ms"],
               "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
               "bound_by": t["bound_by"], "library_ms": t["library_ms"],
               "main_path": f"{cell} {path}", "shape": t["shape"],
               "launches_by_path": {
                   c: {p: n[name] for p, n in paths.items()}
                   for c, paths in by_path.items()}}
        row.update({k: v for k, v in t.items() if k not in row})
        kernels.append(row)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": kernels, "not_ported": []}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
