"""train_step factory: value and grad, microbatch accumulation, clip,
schedule and AdamW, in the reference's order.

``state`` = {"params": the ``Transformer``, whose weights require
grad, "opt": {"m", "v", "step"}}, with ``m`` and ``v`` float32 and keyed
like ``params.named_parameters()``.  The step updates the state in place
(the reference donates it to its jitted step) and returns it with 0-d
device metrics: no host read.

``state_tree`` / ``load_state_tree`` give the state in the reference's
layout — ``params["blocks"]`` as one ``(repeats, ...)`` leaf a pattern
position, the tail's layers, ``shared``, the encoder's blocks as
``(encoder_layers, ...)`` leaves, ``img_proj``; ``m`` and ``v`` alike —
so that either package's ``CheckpointManager`` restores the other's
training checkpoints.
``state_specs`` and ``batch_specs`` are the reference's spec trees of the
state and the batch; ``named_specs`` gives each of the port's tensors
its leaf's spec.  Under a mesh the state and each batch are checked
against them (``check_state``, ``check_batch``: every dim a multiple of
its axes' size, as a placed array needs) and the step is the same eager
step: its mesh sites are in the model code.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import forward_train, init_params, param_specs
from repro_torch.models.parallel import ParallelConfig
from repro_torch.models.transformer import check_ported
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               clip_by_global_norm_, warmup_cosine)

__all__ = ["TrainConfig", "init_state", "state_specs", "batch_specs",
           "named_specs", "check_state", "check_batch", "make_train_step",
           "make_jitted_train_step", "params_tree", "state_tree",
           "load_state_tree"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    clip_norm: float = 1.0
    microbatch: int = 1            # grad-accumulation steps
    adamw: AdamWConfig = AdamWConfig()


def init_state(cfg: ArchConfig, seed: int = 0,
               tcfg: TrainConfig = TrainConfig(), device=None
               ) -> Dict[str, Any]:
    """Random weights from ``seed`` on ``device`` (None: the GPU; raises
    without one), made trainable, and zero moments."""
    params = init_params(cfg, seed, device=device).requires_grad_(True)
    return {"params": params,
            "opt": adamw_init(dict(params.named_parameters()))}


def state_specs(cfg: ArchConfig, par: ParallelConfig,
                tcfg: TrainConfig = TrainConfig()):
    """The spec tree of the reference's state (the moments follow the
    params)."""
    ps = param_specs(cfg, par)
    return {"params": ps, "opt": {"m": ps, "v": ps, "step": ()}}


def batch_specs(cfg: ArchConfig, par: ParallelConfig):
    b = par.batch()
    out = {"tokens": (b, None), "labels": (b, None)}
    if cfg.encoder_layers:
        out["frames"] = (b, None, None)
    if cfg.num_image_tokens:
        out["image_embeds"] = (b, None, None)
    return out


def named_specs(tree, names, cfg: ArchConfig) -> Dict[str, tuple]:
    """The spec of each of the port's tensors ``names`` (keyed like
    ``named_parameters()``) in a spec tree of the reference's params
    layout: its leaf's, without the leading entry of a stacked leaf."""
    out = {}
    for name in names:
        path, rep = _ref_path(name, cfg)
        spec = tree
        for p in path:
            spec = spec[p]
        out[name] = spec[1:] if rep is not None else spec
    return out


def check_state(state, cfg: ArchConfig, par: ParallelConfig,
                tcfg: TrainConfig = TrainConfig()) -> None:
    """Raise ``ValueError`` unless the state lies on the mesh as
    ``state_specs`` lays it out: each weight and moment, and the step."""
    specs = state_specs(cfg, par, tcfg)
    weights = dict(state["params"].named_parameters())
    for tree, flat in ((specs["params"], weights),
                       (specs["opt"]["m"], state["opt"]["m"]),
                       (specs["opt"]["v"], state["opt"]["v"])):
        for name, spec in named_specs(tree, flat, cfg).items():
            par.check(flat[name], spec, even=True)
    par.check(state["opt"]["step"], specs["opt"]["step"], even=True)


def check_batch(batch, cfg: ArchConfig, par: ParallelConfig) -> None:
    """Raise ``ValueError`` unless ``batch`` lies on the mesh as
    ``batch_specs`` lays it out."""
    for k, spec in batch_specs(cfg, par).items():
        if k in batch:
            par.check(batch[k], spec, even=True)


def make_train_step(cfg: ArchConfig, par: ParallelConfig,
                    tcfg: TrainConfig = TrainConfig()) -> Callable:
    """``step(state, batch) -> (state, metrics)``: metrics ``loss``,
    ``grad_norm``, ``lr``, ``ce_loss`` and ``aux_loss``, float32 0-d
    tensors on the state's device.

    ``batch`` holds (B, S) ``tokens`` and ``labels``, numpy or tensors
    anywhere.  With ``tcfg.microbatch`` = nm > 1 it splits into nm slices
    of its rows; their grads are summed in float32 and divided by nm, and
    the loss and metrics are the slices' means."""
    check_ported(cfg)

    def grad_fn(params, names, mb):
        loss, metrics = forward_train(params, mb, cfg, par)
        # a leaf the loss does not read (a shared layer's marker) gets a
        # zero grad, as jax.grad gives it
        grads = torch.autograd.grad(loss, [p for _, p in names],
                                    allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for (_, p), g in zip(names, grads)]
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    def train_step(state, batch):
        params = state["params"]
        names = list(params.named_parameters())
        nm = tcfg.microbatch
        if nm > 1:
            rows = len(batch["tokens"]) // nm
            g_acc = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for _, p in names]
            loss, metrics = 0.0, {}
            for i in range(nm):
                mb = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
                l, m, g = grad_fn(params, names, mb)
                for a, b in zip(g_acc, g):
                    a.add_(b.float())
                del g
                loss = loss + l
                for k, v in m.items():
                    metrics[k] = metrics.get(k, 0.0) + v
            grads = [a.div_(nm) for a in g_acc]
            del g_acc
            loss = loss / nm
            metrics = {k: v / nm for k, v in metrics.items()}
        else:
            loss, metrics, grads = grad_fn(params, names, batch)
        # the dict holds the only reference to each grad, so that the
        # in-place clip frees each old grad as it scales the next
        grads = {n: g for (n, _), g in zip(names, grads)}
        grads, gnorm = clip_by_global_norm_(grads, tcfg.clip_norm)
        lr = warmup_cosine(state["opt"]["step"], peak_lr=tcfg.peak_lr,
                           warmup_steps=tcfg.warmup_steps,
                           total_steps=tcfg.total_steps)
        adamw_update(grads, state["opt"], dict(names), lr, tcfg.adamw)
        out = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        out.update(metrics)
        return state, out

    return train_step


def make_jitted_train_step(cfg: ArchConfig, par: ParallelConfig,
                           tcfg: TrainConfig = TrainConfig()) -> Callable:
    """The reference's launcher entry: the same eager step (its in-place
    update is the donation); under a mesh, the state and the batch are
    checked against ``state_specs`` and ``batch_specs`` (the reference's
    in_shardings) each step."""
    step = make_train_step(cfg, par, tcfg)
    if not par.active:
        return step

    def mesh_step(state, batch):
        check_state(state, cfg, par, tcfg)
        check_batch(batch, cfg, par)
        return step(state, batch)

    return mesh_step


# ------------------------------------------------ the reference's layout
def _ref_path(name: str, cfg: ArchConfig):
    """The path in the reference's params tree of the port's parameter
    ``name``, and its index on the stacked leaf's repeat axis (None for
    an unstacked leaf).  Layer i of the port is repeat i // len(pattern)
    of pattern position i % len(pattern), then the tail; encoder layer j
    is index j of the ``encoder.blocks`` leaves; ``shared.*`` and
    ``img_proj`` are unstacked."""
    parts = name.split(".")
    if parts[:2] == ["encoder", "blocks"]:
        return ("encoder", "blocks") + tuple(parts[3:]), int(parts[2])
    if parts[0] != "blocks":
        return tuple(parts), None
    i, rest, n = int(parts[1]), tuple(parts[2:]), len(cfg.pattern)
    if i >= n * cfg.n_repeats:
        return ("tail", i - n * cfg.n_repeats) + rest, None
    return ("blocks", i % n) + rest, i // n


def params_tree(flat: Dict[str, torch.Tensor], cfg: ArchConfig):
    """A dict keyed like ``named_parameters()`` (weights, moments or
    grads) as the reference's params tree of host (CPU) copies (meta
    tensors stay meta: a dry run's shapes)."""
    tree = {"blocks": [{} for _ in cfg.pattern],
            "tail": [{} for _ in cfg.tail]}
    for name, t in flat.items():         # layers in execution order
        path, rep = _ref_path(name, cfg)
        node = tree
        for p in path[:-1]:
            node = node[p] if isinstance(p, int) else node.setdefault(p, {})
        t = t.detach() if t.is_meta else t.detach().to("cpu", copy=True)
        if rep is None:
            node[path[-1]] = t
        else:
            node.setdefault(path[-1], []).append(t)

    def stack(node):
        if isinstance(node, dict):
            return {k: stack(v) for k, v in node.items()}
        return torch.stack(node) if isinstance(node, list) else node

    tree["blocks"] = tuple(stack(b) for b in tree["blocks"])
    tree["tail"] = tuple(tree["tail"])
    if "encoder" in tree:
        tree["encoder"] = stack(tree["encoder"])
    return tree


def _from_layout(flat: Dict[str, torch.Tensor], tree, cfg: ArchConfig):
    """Copy a reference-layout tree (numpy or tensor leaves) into the
    tensors of ``flat`` in place."""
    for name, t in flat.items():
        path, rep = _ref_path(name, cfg)
        src = tree
        for p in path:
            src = src[p]
        if rep is not None:
            src = src[rep]
        if not isinstance(src, torch.Tensor):
            src = torch.from_numpy(np.array(src))
        if tuple(src.shape) != tuple(t.shape):
            raise ValueError(f"{name}: saved shape {tuple(src.shape)}, "
                             f"state {tuple(t.shape)}")
        with torch.no_grad():
            t.copy_(src)


def state_tree(state: Dict[str, Any], cfg: ArchConfig) -> Dict[str, Any]:
    """A host copy of the training state in the reference's layout:
    {"params": tree, "opt": {"m": tree, "v": tree, "step"}}."""
    opt = state["opt"]
    step = opt["step"].detach()
    return {"params": params_tree(dict(state["params"].named_parameters()),
                                 cfg),
            "opt": {"m": params_tree(opt["m"], cfg),
                    "v": params_tree(opt["v"], cfg),
                    "step": step if step.is_meta
                    else step.to("cpu", copy=True)}}


def load_state_tree(state: Dict[str, Any], tree, cfg: ArchConfig
                    ) -> Dict[str, Any]:
    """Copy ``tree`` (the reference's layout: a ``state_tree``, a
    restored checkpoint of either package, or the reference's state as
    numpy) into ``state`` in place, cast to each tensor's dtype; returns
    ``state``."""
    _from_layout(dict(state["params"].named_parameters()), tree["params"],
                 cfg)
    _from_layout(state["opt"]["m"], tree["opt"]["m"], cfg)
    _from_layout(state["opt"]["v"], tree["opt"]["v"], cfg)
    step = tree["opt"]["step"]
    if not isinstance(step, torch.Tensor):
        step = torch.from_numpy(np.array(step))
    state["opt"]["step"].copy_(step)
    return state
