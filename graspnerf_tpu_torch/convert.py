"""Weight conversion into the port's state dict.

1. Reference checkpoint -> port checkpoint (`convert_reference_state_dict`,
   `main`; the role of scripts/convert_checkpoint.py with
   graspnerf_tpu/models/convert.py::convert_state_dict). The upstream
   project's `model_best.pth` is `{"network_state_dict", "step", ...}` (ref
   trainer.py:199-218) with keys `nr_net.*` and `vgn_net.*` in torch
   layout; the port's modules carry the same keys and layouts, so nothing
   is transposed:

       python3 -m graspnerf_tpu_torch.convert model_best.pth out.pt

   writes `{"model", "step", "best": inf}`, which
   `train.checkpoint.load_params` and `sim.cli --ckpt` read as they read a
   trainer checkpoint.

2. Flax param pytree -> state dict (`flax_to_state_dict`), the inverse of
   graspnerf_tpu/models/convert.py: every flax submodule of the JAX
   package is named with the reference's torch state-dict prefix, so the
   torch key is the flax path joined with dots, and the leaf maps as

    kernel -> weight, transposed back to torch layout
              Linear [I,O] -> [O,I]
              Conv2d [kh,kw,I,O] -> [O,I,kh,kw]
              Conv3d [kd,kh,kw,I,O] -> [O,I,kd,kh,kw]
    scale  -> weight (norm affine)
    bias   -> bias
    other  -> its own name (e.g. deviation_network.variance)

The port's modules reproduce those keys, so the result loads with
`load_state_dict(strict=True)`.
"""
from __future__ import annotations

import argparse
import math
import sys
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

_KERNEL_PERM = {2: (1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}


def _to_torch(arr: np.ndarray, leaf: str) -> np.ndarray:
    a = np.asarray(arr, np.float32)
    if leaf == "kernel":
        if a.ndim not in _KERNEL_PERM:
            raise ValueError(f"kernel of rank {a.ndim} has no torch layout")
        a = a.transpose(_KERNEL_PERM[a.ndim])
    # not np.ascontiguousarray: it returns a 0-d leaf (the NeuS variance)
    # with a new axis of 1
    return np.array(a, order="C")


def flax_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """Nested mapping of numpy arrays (a flax param tree, e.g. from
    `jax.device_get(variables["params"])`) -> flat torch state dict."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, path + [str(k)])
            return
        leaf = path[-1]
        names = path[:-1] + ["weight"] if leaf in ("kernel", "scale") else path
        out[".".join(names)] = torch.from_numpy(_to_torch(node, leaf))

    walk(params, [])
    return out


def _port_shapes() -> Dict[str, torch.Size]:
    """The port's GraspNeRF state-dict keys and shapes, as
    scripts/convert_checkpoint.py builds GraspNeRF(renderer_cfg={}) (on the
    meta device: no weights are allocated)."""
    from .models import GraspNeRF
    with torch.device("meta"):
        model = GraspNeRF({})
    return {k: v.shape for k, v in model.state_dict().items()}


def convert_reference_state_dict(
        state_dict: Mapping) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """The reference's `network_state_dict` -> (the port's state dict in
    float32 on the CPU, the sorted keys it did not use), as
    `convert_state_dict(..., strict=True)` fills the JAX package's tree:
    a KeyError names a port key the checkpoint lacks, a ValueError a shape
    that differs; the unused keys are the reference's dead buffers."""
    out: Dict[str, torch.Tensor] = {}
    for key, shape in _port_shapes().items():
        if key not in state_dict:
            raise KeyError(f"missing torch key {key}")
        v = torch.as_tensor(state_dict[key]).detach()
        if v.shape != shape:
            raise ValueError(f"{key}: checkpoint {tuple(v.shape)} vs port "
                             f"{tuple(shape)}")
        out[key] = v.to(device="cpu", dtype=torch.float32).contiguous()
    return out, sorted(set(state_dict) - set(out))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python3 -m graspnerf_tpu_torch.convert",
        description="Convert the reference's model_best.pth into a "
                    "checkpoint of the port.")
    p.add_argument("pth", help="the reference checkpoint (model_best.pth)")
    p.add_argument("out", help="the port's checkpoint file to write")
    args = p.parse_args(argv)
    # tensors, dicts and numbers only: the reference saves nothing else
    ckpt = torch.load(args.pth, map_location="cpu", weights_only=True)
    sd, unused = convert_reference_state_dict(ckpt["network_state_dict"])
    if unused:
        print(f"[convert] {len(unused)} unused torch keys (expected: dead "
              f"buffers): {unused}")
    step = int(ckpt.get("step", 0))
    torch.save({"model": sd, "step": step, "best": math.inf}, args.out)
    print(f"[convert] saved {len(sd)} tensors to {args.out} (step {step})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
