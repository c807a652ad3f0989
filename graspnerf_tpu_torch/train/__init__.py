"""Training in the port (graspnerf_tpu/train/): losses, schedules, the train
step (`create_train_state`, `make_train_step`, `make_eval_step`), the
scene-batched loss, checkpoints, metrics and the `Trainer` loop. The entry
script is `python3 -m graspnerf_tpu_torch.train.cli`."""
from . import losses, metrics
from ..tracing import trace
from .checkpoint import CheckpointManager, load_params
from .profiling import rays_per_step
from .schedule import exp_decay_lr, warmup_exp_decay_lr
from .trainer import (Trainer, TrainState, apply_gradients, check_trainable,
                      compute_losses, create_train_state, gradients,
                      make_batched_loss_fn, make_eval_step, make_loss_fn,
                      make_train_step, mesh_gradients, scene_generators)
