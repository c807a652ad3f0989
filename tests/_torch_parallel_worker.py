"""One rank of the port's two-process gloo step (tests/test_torch_parallel.py).

argv: address world_size rank directory. Reads <directory>/inputs.pt (the
model's state dict, a two-scene global batch, the seed), then on the CPU:
- `make_mesh`'s defaults over the world;
- one training step at (2, 1): the rank's scene, the world-mean gradients,
  the finite guard, Adam;
- one at (1, 2) on the first scene: the rank's rays and volume columns,
  the fine pass at the one-process step's fine samples (inputs' "fine");
- the (2, 1) step again with NaN views in rank 1's scene;
- rank 0's trees (inputs' "trees") broadcast over the (1, 2) space group;
and writes each case's losses, gradients, parameters and update decision
to <directory>/rank<r>.pt. Imports nothing of JAX.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from graspnerf_tpu_torch.models import GraspNeRF
from graspnerf_tpu_torch.parallel import (initialize, make_mesh, replicate,
                                          scene_indices, shard_batch,
                                          shutdown)
from graspnerf_tpu_torch.tools.scene import pinned_fine_samples
from graspnerf_tpu_torch.train import (apply_gradients, create_train_state,
                                       make_batched_loss_fn, mesh_gradients,
                                       scene_generators)

addr, world_size, rank, out = (sys.argv[1], int(sys.argv[2]),
                               int(sys.argv[3]), sys.argv[4])
torch.set_num_threads(1)
inputs = torch.load(os.path.join(out, "inputs.pt"), weights_only=True)
assert initialize(addr, world_size, rank, "gloo", "cpu") == "gloo"


def scenes(batch, n):
    if isinstance(batch, dict):
        return {k: scenes(v, n) for k, v in batch.items()}
    return batch[:n]


def step(mesh, batch, poison=False):
    model = GraspNeRF(inputs["cfg"])
    model.load_state_dict(inputs["params"])
    state = create_train_state(model, device="cpu")
    model.nr_net.space = mesh.split
    replicate(model)
    local = shard_batch(mesh, batch)
    if poison:
        local["data"]["ref"]["imgs"] = torch.full_like(
            local["data"]["ref"]["imgs"], float("nan"))
    n_local = local["sdf_gt"].shape[0]
    metrics, grads = mesh_gradients(
        state, make_batched_loss_fn(model), local,
        scene_generators(inputs["seed"], 0, scene_indices(mesh, n_local),
                         "cpu"), mesh)
    finite = apply_gradients(state, grads)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": grads, "finite": finite, "updates": state.step,
            "params": [p.detach().clone() for p in model.parameters()]}


try:
    shapes = (make_mesh().shape, make_mesh(n_data=2).shape,
              make_mesh(n_space=2).shape)
    batch = inputs["batch"]
    result = {"shapes": shapes, "data": step(make_mesh(2, 1), batch)}
    result["space"], _ = pinned_fine_samples(
        lambda: step(make_mesh(1, 2), scenes(batch, 1)), inputs["fine"])
    result["nan"] = step(make_mesh(2, 1), batch, poison=rank == 1)
    split = make_mesh(1, 2).split
    result["broadcast"] = [split.broadcast(
        tree if rank == 0 else None, "cpu") for tree in inputs["trees"]]
    torch.save(result, os.path.join(out, f"rank{rank}.pt"))
finally:
    shutdown()
