"""Training launcher.

  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --reduced \\
      --steps 100 --batch 8 --seq 256 --ckpt-dir CKPT

Trains on the GPU unless ``--device cpu`` asks for the CPU.  A restart
after a crash resumes from the latest committed checkpoint in
``--ckpt-dir``.  ``--devices N`` trains on the reference's debug mesh,
(N / 2, 2) over ("data", "model"), every shard on that one device.
``--coordinator`` (the reference's multi-host start) raises: the port
runs one controller, so there is no second host to start, and no machine
here has one to test it on.
"""
from __future__ import annotations

import argparse
import logging


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--coordinator", default=None,
                    help="host:port of a multi-host start (not supported)")
    ap.add_argument("--devices", type=int, default=0,
                    help="a debug mesh of N shards on the one device")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    if args.coordinator:
        raise NotImplementedError(
            "--coordinator: a multi-host start has no counterpart on the "
            "port's single controller (every shard of a mesh is driven "
            "from one process), and no machine here could test one")

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models.parallel import ParallelConfig
    from repro_torch.train import LoopConfig, TrainConfig, train_loop

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    mesh = None
    if args.devices:
        from repro_torch.launch.mesh import make_debug_mesh
        mesh = make_debug_mesh((args.devices // 2, 2), ("data", "model"),
                               device="cuda" if args.device is None
                               else args.device)
    par = ParallelConfig(mesh=mesh, attn_chunk_q=min(128, args.seq),
                         attn_chunk_k=min(128, args.seq),
                         logits_chunk=min(512, args.seq))
    hist = train_loop(
        cfg, par, batch=args.batch, seq=args.seq,
        tcfg=TrainConfig(peak_lr=args.lr, total_steps=args.steps,
                         warmup_steps=max(1, args.steps // 10),
                         microbatch=args.microbatch),
        lcfg=LoopConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                        ckpt_dir=args.ckpt_dir),
        device=args.device)
    print("final loss:", hist["loss"][-1] if hist["loss"] else None)
    return hist


if __name__ == "__main__":
    main()
