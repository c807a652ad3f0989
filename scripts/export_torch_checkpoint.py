"""Export an Orbax checkpoint of the JAX package as a checkpoint file of the
PyTorch port.

Reads a trainer checkpoint (a `CheckpointManager` step directory or its
`latest` / `best` link: {"state": {"params", "opt_state"}, "step", "best"})
or a converted reference checkpoint (the same without opt_state) with the
JAX package, converts the params with `graspnerf_tpu_torch.convert.
flax_to_state_dict`, and writes {"model": state dict, "step", "best"} with
`torch.save`, which `graspnerf_tpu_torch.train.load_params` reads. The
optimizer state is not exported.

Usage:
  python scripts/export_torch_checkpoint.py data/train_r4_proof/ckpt/step_50 out.pt
"""
import argparse
import math
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def read_orbax(ckpt_dir: str):
    """(flax params as numpy, step, best) of an Orbax checkpoint, restored
    onto the first CPU device."""
    import jax
    import numpy as np
    import orbax.checkpoint as ocp
    path = os.path.realpath(ckpt_dir)
    ckptr = ocp.PyTreeCheckpointer()
    meta = ckptr.metadata(path).item_metadata.tree
    cpu = jax.sharding.SingleDeviceSharding(jax.devices("cpu")[0])

    def restore_arg(m):
        # arrays need a concrete sharding; numpy leaves restore as they are
        if isinstance(m, ocp.metadata.ArrayMetadata):
            return ocp.ArrayRestoreArgs(sharding=cpu)
        return ocp.RestoreArgs()

    restored = ckptr.restore(path, restore_args=jax.tree_util.tree_map(
        restore_arg, meta))
    state = restored.get("state", restored)
    params = jax.tree_util.tree_map(np.array, state["params"])   # writable
    return (params, int(restored.get("step", 0)),
            float(restored.get("best", math.inf)))


def write_torch(params, out: str, step: int = 0, best: float = math.inf):
    """Write flax `params` as the port's checkpoint file `out`."""
    import torch
    from graspnerf_tpu_torch.convert import flax_to_state_dict
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    torch.save({"model": flax_to_state_dict(params), "step": int(step),
                "best": float(best)}, out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("ckpt", help="Orbax checkpoint directory or link")
    p.add_argument("out", help="the .pt file to write")
    args = p.parse_args(argv)
    import jax
    jax.config.update("jax_platforms", "cpu")
    params, step, best = read_orbax(args.ckpt)
    write_torch(params, args.out, step, best)
    print(f"wrote {args.out}: step {step}, best {best}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
