"""Where the port's entry points run: the card unless the caller asks for
another device. Imports only torch, so both `ops` and `models` use it."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """`None` means the card. Without one this raises: the port never falls
    back to the CPU on its own; pass device="cpu" for that."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run on "
                               "the CPU")
        device = "cuda"
    return torch.device(device)
