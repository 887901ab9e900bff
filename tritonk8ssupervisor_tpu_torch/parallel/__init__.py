"""The training steps of the port, on one device."""

from tritonk8ssupervisor_tpu_torch.parallel.train import (
    TrainState,
    create_train_state,
    default_optimizer,
    lm_optimizer,
    make_lm_eval_step,
    make_lm_train_step,
    make_train_step,
)

__all__ = [
    "TrainState",
    "create_train_state",
    "default_optimizer",
    "lm_optimizer",
    "make_lm_eval_step",
    "make_lm_train_step",
    "make_train_step",
]
