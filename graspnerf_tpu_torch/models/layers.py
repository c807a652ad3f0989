"""Linear and convolution layers with a compute dtype, the flax modules'
`dtype` field (graspnerf_tpu/models/nn_blocks.py:25-57, grasp_head.py:19-58,
flax `Dense(dtype=...)`): the input, weight and bias are cast to it and the
result comes back in it. Parameters stay float32, so one state dict serves
every compute dtype; in float32 the casts are no-ops and the layers are
their torch.nn parents."""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """'float32' | 'bfloat16' -> the torch dtype."""
    if name not in DTYPES:
        raise ValueError(f"compute_dtype {name!r}: one of {sorted(DTYPES)}")
    return DTYPES[name]


def _cast(t, dtype):
    return None if t is None else t.to(dtype)


class Linear(nn.Linear):
    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias)
        self.compute_dtype = dtype

    def forward(self, x):
        d = self.compute_dtype
        return F.linear(x.to(d), self.weight.to(d), _cast(self.bias, d))


class Conv2d(nn.Conv2d):
    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = dtype

    def forward(self, x):
        d = self.compute_dtype
        return self._conv_forward(x.to(d), self.weight.to(d),
                                  _cast(self.bias, d))


class Conv3d(nn.Conv3d):
    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = dtype

    def forward(self, x):
        d = self.compute_dtype
        return self._conv_forward(x.to(d), self.weight.to(d),
                                  _cast(self.bias, d))
