"""Flax param pytree -> PyTorch state dict.

Inverts graspnerf_tpu/models/convert.py: every flax submodule of the JAX
package is named with the reference's torch state-dict prefix, so the torch
key is the flax path joined with dots, and the leaf maps as

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

from typing import Dict, Mapping

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
