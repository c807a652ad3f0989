"""The train step of the port (graspnerf_tpu/train/): losses, schedules,
`create_train_state`, `make_train_step` and `make_eval_step`."""
from . import losses
from .schedule import exp_decay_lr, warmup_exp_decay_lr
from .trainer import (TrainState, apply_gradients, compute_losses,
                      create_train_state, gradients, make_eval_step,
                      make_loss_fn, make_train_step)
