"""Deterministic synthetic data.

Two generators:

  * LM token batches — a pure function of (seed, step), drawn from a
    ``torch.Generator`` seeded by the pair: restart-safe by construction
    (an iterator's state is its step counter).  Not the reference's
    draws: parity tests feed the reference's tokens as numpy.
  * Clustered vector datasets for the paper's r-NN experiments —
    Gaussian mixtures with a controllable "dense core", so query sets
    contain the hard queries of the paper's Fig. 1/Webspam discussion.
    numpy only, and a verbatim copy of ``repro.data.synthetic``'s vector
    generators, so both packages see the same corpora from the same seed.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch


# ------------------------------------------------------------------ LM
def lm_batch(seed: int, step: int, *, batch: int, seq: int, vocab: int,
             cfg=None, device=None) -> Dict[str, torch.Tensor]:
    """Deterministic token batch for (seed, step) on ``device`` (None:
    the GPU): int32 ``tokens`` (batch, seq) and their next tokens as
    ``labels``, drawn on the host so that every device sees the same.
    With an audio ``cfg`` (``encoder_layers``) the batch also carries
    stub ``frames`` (batch, encoder_seq, d_model), with a vision one
    (``num_image_tokens``) stub ``image_embeds`` (batch,
    num_image_tokens, d_model): standard normal in bf16, drawn after the
    tokens from the same generator."""
    from repro_torch.core.index import resolve_device
    device = resolve_device(device)
    state = np.random.SeedSequence([int(seed), int(step)]).generate_state(2)
    gen = torch.Generator().manual_seed(
        int(state[0]) << 32 | int(state[1]))
    toks = torch.randint(0, vocab, (batch, seq + 1), generator=gen,
                         dtype=torch.int32)
    toks = toks.to(device)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg is None:
        return out
    for key, n in (("frames", cfg.encoder_seq if cfg.encoder_layers else 0),
                   ("image_embeds", cfg.num_image_tokens)):
        if n:
            out[key] = torch.randn((batch, n, cfg.d_model), generator=gen
                                   ).to(torch.bfloat16).to(device)
    return out


@dataclasses.dataclass
class LMDataIterator:
    """Resumable iterator: ``state`` is just the step counter."""

    seed: int
    batch: int
    seq: int
    vocab: int
    step: int = 0
    cfg: Optional[object] = None
    device: Optional[object] = None

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        b = lm_batch(self.seed, self.step, batch=self.batch, seq=self.seq,
                     vocab=self.vocab, cfg=self.cfg, device=self.device)
        self.step += 1
        return b

    def state_dict(self):
        return {"step": self.step, "seed": self.seed}

    def load_state_dict(self, s):
        if s["seed"] != self.seed:
            raise ValueError("data seed changed across restart")
        self.step = int(s["step"])


# ------------------------------------------------- r-NN vector datasets
def clustered_dataset(n: int, d: int, *, n_clusters: int = 32,
                      dense_core_frac: float = 0.0,
                      core_scale: float = 0.05, cluster_scale: float = 0.25,
                      seed: int = 0, metric: str = "l2") -> np.ndarray:
    """Mixture-of-Gaussians points; optionally a tight "dense core".

    ``dense_core_frac`` > 0 reproduces the paper's Webspam regime: a
    fraction of the dataset sits in one tiny cluster, so queries landing
    there have near-n output sizes and LSH loses to linear search.
    """
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    n_core = int(n * dense_core_frac)
    n_rest = n - n_core
    assign = rng.integers(0, n_clusters, n_rest)
    pts = centers[assign] + cluster_scale * rng.normal(
        size=(n_rest, d)).astype(np.float32)
    if n_core:
        core = centers[0] + core_scale * rng.normal(
            size=(n_core, d)).astype(np.float32)
        pts = np.concatenate([pts, core], axis=0)
        rng.shuffle(pts, axis=0)
    if metric == "cosine":
        pts /= np.maximum(np.linalg.norm(pts, axis=1, keepdims=True), 1e-9)
    return pts.astype(np.float32)


def paper_dataset(name: str, scale: float = 1.0, seed: int = 0):
    """Synthetic analogues of the paper's four datasets.

    Matched (n, d, metric); density skew approximates each dataset's
    character (Webspam gets the dense core that makes hybrid win).
    Returns (points, metric).  ``scale`` shrinks n for CI-speed runs.
    """
    presets = {
        "corel": dict(n=68040, d=32, metric="l2", n_clusters=64,
                      dense_core_frac=0.02),
        "covertype": dict(n=581012, d=54, metric="l1", n_clusters=16,
                          dense_core_frac=0.05),
        "webspam": dict(n=350000, d=254, metric="cosine", n_clusters=32,
                        dense_core_frac=0.25, core_scale=0.02),
        "mnist": dict(n=60000, d=780, metric="hamming"),
    }
    p = dict(presets[name])
    metric = p.pop("metric")
    p["n"] = max(1024, int(p["n"] * scale))
    if metric == "hamming":
        # 64-bit SimHash fingerprints of clustered real vectors, as the
        # paper does for MNIST.
        base = clustered_dataset(p["n"], p["d"], n_clusters=10, seed=seed)
        rng = np.random.default_rng(seed + 1)
        proj = rng.normal(size=(p["d"], 64)).astype(np.float32)
        bits = (base @ proj > 0)
        words = np.zeros((p["n"], 2), np.uint32)
        for w in range(2):
            for j in range(32):
                words[:, w] |= bits[:, w * 32 + j].astype(
                    np.uint32) << np.uint32(j)
        return words, metric
    pts = clustered_dataset(seed=seed, metric=metric, **p)
    return pts, metric


def query_split(x: np.ndarray, n_queries: int = 100, seed: int = 0):
    """Paper protocol: randomly remove n_queries points as the query set."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(x.shape[0])
    q, rest = idx[:n_queries], idx[n_queries:]
    return x[rest], x[q]
