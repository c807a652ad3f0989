"""Training over a (data, space) mesh of ranks (graspnerf_tpu/parallel/):
scenes on `data`, a scene's rays and volume columns on `space`, one process
per rank on `torch.distributed`. `train.Trainer(..., mesh=make_mesh(...))`
and `python3 -m graspnerf_tpu_torch.train.cli --mesh DATA,SPACE` use it."""
from .distributed import all_mean, initialize, replicate, shutdown
from .mesh import (DATA_AXIS, SPACE_AXIS, Mesh, SpaceSplit, make_mesh,
                   scene_indices, shard_batch)
