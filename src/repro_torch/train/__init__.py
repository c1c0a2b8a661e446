"""Training on the dense path (one device).  The reference's
``state_specs`` and ``batch_specs`` place a state on a mesh and come with
model parallelism (Slice F3)."""
from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.train.step import (TrainConfig, init_state, load_state_tree,
                                    make_jitted_train_step, make_train_step,
                                    state_tree)

__all__ = ["LoopConfig", "train_loop", "TrainConfig", "init_state",
           "load_state_tree", "make_jitted_train_step", "make_train_step",
           "state_tree"]
