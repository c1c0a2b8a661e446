#!/usr/bin/env python3
"""Where a forward of the port's dense transformer spends its time, on
the card.

  PYTHONPATH=src python3 tools/encoder_profile.py [--arch yi-6b]

Draws the model at full width and depth on the GPU (seed 0), then for
the retrieval embed (64 documents of 32 tokens), a generation prefill
(4 prompts of 32) and a decode step (4 rows against a 48-slot cache):
the untraced host-clock ms (synchronised, median of 5), and from a
``torch.profiler`` trace of 3 calls the device ms a call (the sum of the
kernels' self CUDA time), the kernel launches a call and the device busy
share (device ms over untraced ms); the top ops by device and by host
time.  Beside them, one bf16 product of the MLP's input weight at 4, 128
and 2,048 rows (``x @ W``, events).  One JSON line per item, after the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))


def synced_ms(torch, fn, reps=5):
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def traced(torch, fn, calls=3, top=8):
    """Device ms, launches and the top ops a call, from a trace."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ev = prof.key_averages()
    launches = sum(e.count for e in ev
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernelEx",
                                "cuLaunchKernel", "cudaLaunchKernelExC"))
    kernels = [e for e in ev if e.device_type.name == "CUDA"]
    device_us = sum(e.self_device_time_total for e in kernels)
    by_dev = sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]
    ops = [e for e in ev if e.device_type.name == "CPU"
           and e.key.startswith("aten::")]
    by_cpu = sorted(ops, key=lambda e: -e.self_cpu_time_total)[:top]
    return dict(
        device_ms=device_us / 1e3 / calls, launches=launches / calls,
        top_device=[(e.key[:60], e.self_device_time_total / 1e3 / calls,
                     e.count / calls) for e in by_dev],
        top_host=[(e.key, e.self_cpu_time_total / 1e3 / calls,
                   e.count / calls) for e in by_cpu])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("encoder_profile: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.data import lm_batch
    from repro_torch.models import ParallelConfig, forward_embed, init_params
    from repro_torch.serve import make_serve_prefill, make_serve_step
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    cfg = get_config(args.arch)
    par = ParallelConfig(attn_chunk_q=64, attn_chunk_k=64)
    params = init_params(cfg, 0, device="cuda")

    def batch(seed, b, s):
        return {"tokens": lm_batch(seed, 0, batch=b, seq=s, vocab=cfg.vocab,
                                   device="cuda")["tokens"]}

    w = params.blocks[0].mlp["wi"]
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for m in (4, 128, 2048):
        x = torch.randn(m, cfg.d_model, device="cuda", dtype=w.dtype)
        x @ w
        start.record()
        for _ in range(20):
            x @ w
        end.record()
        torch.cuda.synchronize()
        print(json.dumps({"item": f"x @ wi, {m} rows",
                          "shape": [m, *w.shape],
                          "ms": start.elapsed_time(end) / 20}), flush=True)

    docs = batch(1, 64, 32)
    prompts = batch(0, 4, 32)
    pre = make_serve_prefill(cfg, par, 48)
    step = make_serve_step(cfg, par)
    with torch.inference_mode():
        _, caches, lengths = pre(params, prompts)
        token = torch.zeros(4, dtype=torch.int32, device="cuda")
        items = {
            "embed 64 x 32": lambda: forward_embed(params, docs, cfg, par),
            "prefill 4 x 32": lambda: pre(params, prompts),
            # the same position each call: the caches are written in place
            "decode step, batch 4": lambda: step(params, caches, token,
                                                 lengths),
        }
        for name, fn in items.items():
            ms = synced_ms(torch, fn)
            tr = traced(torch, fn)
            tr.update(item=name, ms=ms, busy=tr["device_ms"] / ms)
            print(json.dumps(tr), flush=True)
    print(json.dumps({"item": "weights", "bytes": params.nbytes(),
                      "read_bound_ms": params.nbytes() / 3.35e12 * 1e3}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
