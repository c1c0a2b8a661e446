"""Training: the train step and the fault-tolerant loop, on one device or
a single-controller mesh (``state_specs`` / ``batch_specs`` lay the state
and the batch out on it)."""
from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.train.step import (TrainConfig, batch_specs, init_state,
                                    load_state_tree, make_jitted_train_step,
                                    make_train_step, state_specs, state_tree)

__all__ = ["LoopConfig", "train_loop", "TrainConfig", "batch_specs",
           "init_state", "load_state_tree", "make_jitted_train_step",
           "make_train_step", "state_specs", "state_tree"]
