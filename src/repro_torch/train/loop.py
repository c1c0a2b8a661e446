"""Fault-tolerant training loop.

Responsibilities:
  * restore from the latest committed checkpoint on (re)start — a
    crashed run relaunches with the same command and resumes;
  * periodic async checkpointing (two-phase commit in CheckpointManager),
    in the reference's layout (``train.step.state_tree``), so that either
    package resumes the other's run;
  * deterministic data resume (the iterator's state is its step counter);
  * straggler watchdog: each step's wall time against the running median
    of the last 20 — slow steps are logged with the step index (on a
    cluster this feeds the controller that replaces the slow host; tests
    inject a delay);
  * failure injection hook for tests (raise at step N).  When a step
    raises, the loop joins the checkpoint writer before it re-raises, so
    that no save of the failed run is left half written behind it.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ArchConfig
from repro_torch.core.index import resolve_device
from repro_torch.data import LMDataIterator
from repro_torch.models.parallel import ParallelConfig
from repro_torch.train.step import (TrainConfig, init_state, load_state_tree,
                                    make_jitted_train_step, state_tree)

log = logging.getLogger("repro_torch.train")


@dataclasses.dataclass
class LoopConfig:
    steps: int = 100
    ckpt_every: int = 50
    log_every: int = 10
    ckpt_dir: Optional[str] = None
    data_seed: int = 0
    straggler_factor: float = 3.0


def train_loop(cfg: ArchConfig, par: ParallelConfig, *, batch: int, seq: int,
               tcfg: TrainConfig = TrainConfig(),
               lcfg: LoopConfig = LoopConfig(),
               failure_injector: Optional[Callable[[int], None]] = None,
               step_delay_injector: Optional[Callable[[int], float]] = None,
               device=None) -> Dict[str, list]:
    """Train on ``device`` (None: the GPU; raises without one).  Returns
    the history: the loss per logged step and the straggler events
    (step, seconds, median)."""
    device = resolve_device(device)
    step_fn = make_jitted_train_step(cfg, par, tcfg)
    data = LMDataIterator(seed=lcfg.data_seed, batch=batch, seq=seq,
                          vocab=cfg.vocab, cfg=cfg, device=device)
    mgr = CheckpointManager(lcfg.ckpt_dir) if lcfg.ckpt_dir else None
    state = init_state(cfg, 0, tcfg, device=device)
    start_step = 0
    if mgr is not None and mgr.latest_step() is not None:
        restored, start_step = mgr.restore(
            {"state": state_tree(state, cfg), "data": data.state_dict()},
            device="cpu")
        load_state_tree(state, restored["state"], cfg)
        data.load_state_dict(restored["data"])
        log.info("restored checkpoint at step %d", start_step)

    def checkpoint(step, blocking=False):
        mgr.save(step, {"state": state_tree(state, cfg),
                        "data": data.state_dict()}, blocking=blocking)

    history = {"loss": [], "step": [], "stragglers": []}
    times = []
    try:
        for step in range(start_step, lcfg.steps):
            if failure_injector is not None:
                failure_injector(step)
            batch_data = next(data)
            t0 = time.perf_counter()
            if step_delay_injector is not None:
                # inside the timed region: simulates a slow (straggler) step
                time.sleep(step_delay_injector(step))
            state, metrics = step_fn(state, batch_data)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0
            times.append(dt)
            med = float(np.median(times[-20:]))
            if len(times) > 5 and dt > lcfg.straggler_factor * med:
                history["stragglers"].append((step, dt, med))
                log.warning("straggler: step %d took %.3fs (median %.3fs)",
                            step, dt, med)
            if step % lcfg.log_every == 0 or step == lcfg.steps - 1:
                history["loss"].append(float(metrics["loss"]))
                history["step"].append(step)
                log.info("step %d loss %.4f grad_norm %.3f", step,
                         float(metrics["loss"]), float(metrics["grad_norm"]))
            if mgr is not None and (step + 1) % lcfg.ckpt_every == 0:
                checkpoint(step + 1)
        if mgr is not None:
            checkpoint(lcfg.steps, blocking=True)
    except BaseException:
        if mgr is not None:
            mgr.wait()
        raise
    return history
