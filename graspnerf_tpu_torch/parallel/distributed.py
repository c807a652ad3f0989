"""The process group and the collectives of a training step
(graspnerf_tpu/parallel/distributed.py), on `torch.distributed`.

One process per rank. The caller passes the address
(`tcp://127.0.0.1:<port>`), the world size and the rank: nothing comes from
a cluster. NCCL on the card (one card a rank), gloo on the CPU, or for
several ranks on one card, which NCCL refuses.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from ..device import resolve_device


def initialize(init_method: Optional[str] = None, world_size: int = 1,
               rank: int = 0, backend: Optional[str] = None,
               device=None) -> Optional[str]:
    """Join the process group; a no-op for world size 1 without an address
    (JAX's single process). backend: NCCL where `device` (the card when
    None, raising without one) is a card, else gloo. Returns the backend,
    or None when there is no group."""
    if world_size == 1 and init_method is None:
        return None
    if backend is None:
        backend = ("nccl" if resolve_device(device).type == "cuda"
                   else "gloo")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return backend


def shutdown() -> None:
    """Leave the process group, if this process is in one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def _flat(tensors: Sequence[torch.Tensor], fn) -> None:
    """fn on one flat buffer of each dtype's tensors, copied back in place."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        buf = torch.cat([t.reshape(-1) for t in group])
        fn(buf)
        for t, part in zip(group, buf.split([t.numel() for t in group])):
            t.copy_(part.view_as(t))


def all_mean(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """The mean of each tensor over every rank of the world, in place, as
    one all-reduce of a flat buffer (a sum, then a division by the world
    size, which every backend takes). A non-finite value on any rank makes
    that value non-finite on every rank."""
    if dist.is_available() and dist.is_initialized():
        def reduce(buf):
            dist.all_reduce(buf, op=dist.ReduceOp.SUM)
            buf.div_(dist.get_world_size())
        _flat(tensors, reduce)
    return tensors


@torch.no_grad()
def replicate(module: torch.nn.Module) -> torch.nn.Module:
    """Every parameter and buffer of `module` set to rank 0's (JAX's
    `replicate`): after the init and after a restore."""
    if dist.is_available() and dist.is_initialized():
        _flat(list(module.state_dict().values()),
              lambda buf: dist.broadcast(buf, 0))
    return module
