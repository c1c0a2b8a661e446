"""Serving launcher: generation or retrieval-augmented serving.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \\
      --mode generate --batch 4 --prompt-len 32 --max-new 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \\
      --mode retrieval --corpus 4096 --queries 64

Runs the architecture at its full width and depth on the GPU, with
random weights drawn on the card from seed 0; ``--reduced`` runs the
tiny same-family config, and ``--device cpu`` the plain PyTorch
versions on the CPU.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mode", choices=("generate", "retrieval"),
                    default="generate")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--corpus", type=int, default=4096)
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--radius", type=float, default=0.3)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core.index import resolve_device
    from repro_torch.data import lm_batch
    from repro_torch.models import init_params
    from repro_torch.models.parallel import ParallelConfig
    from repro_torch.serve import RetrievalConfig, RetrievalService, generate

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    par = ParallelConfig(mesh=None, attn_chunk_q=64, attn_chunk_k=64,
                         logits_chunk=128)
    params = init_params(cfg, 0, device=device)

    def batch(seed, step, b):
        out = lm_batch(seed, step, batch=b, seq=args.prompt_len,
                       vocab=cfg.vocab, cfg=cfg, device=device)
        out.pop("labels")
        return out

    if args.mode == "generate":
        toks = generate(params, batch(0, 0, args.batch), cfg, par,
                        cache_len=args.prompt_len + args.max_new,
                        max_new_tokens=args.max_new, device=device)
        print("generated:", tuple(toks.shape))
        print(toks[:2].cpu())
    else:
        svc = RetrievalService(cfg, par, params,
                               RetrievalConfig(radius=args.radius),
                               device=device)
        bs = 64
        n = svc.index_corpus(batch(1, i, bs)
                             for i in range(args.corpus // bs))
        res, _ = svc.query(batch(2, 0, args.queries))
        sizes = [len(res.neighbors(i)) for i in range(res.n_queries)]
        print(f"indexed {n} docs; {args.queries} queries; "
              f"mean output size {sum(sizes)/len(sizes):.1f}; "
              f"frac linear {res.frac_linear:.2f}")
        print("service stats:", svc.stats)
        svc.shutdown()


if __name__ == "__main__":
    main()
