"""Training: the optimizers, the train step and the trainer (the JAX
package's ``repro.train``)."""

from repro_torch.train.optimizer import (OptConfig, lr_schedule,
                                         init_opt_state, opt_update,
                                         opt_state_axes, abstract_opt_state,
                                         clip_by_global_norm, pick_optimizer)
from repro_torch.train.step import TrainConfig, make_train_step, \
    make_train_state_specs

__all__ = ["OptConfig", "lr_schedule", "init_opt_state", "opt_update",
           "opt_state_axes", "abstract_opt_state", "clip_by_global_norm",
           "pick_optimizer", "TrainConfig", "make_train_step",
           "make_train_state_specs"]
