"""The (data, space) mesh of ranks and its sharding rules
(graspnerf_tpu/parallel/mesh.py), on `torch.distributed`.

  data  -- the scenes of a batch split across this axis;
  space -- a scene's rays (and the volume's z-columns) split across this
           axis: per-ray work is independent, the reduction over the 6
           views stays on the rank.

Rank r sits at (r // n_space, r % n_space). Parameters are replicated
(`distributed.replicate`); the gradients are averaged over the whole world
(`distributed.all_mean`). Where JAX lets XLA place the arrays and add the
collectives, here each rank computes its share and the renderer joins its
per-ray outputs back along dim 1 (`SpaceSplit.join`), so that the losses,
the composite and the grasp head run on the whole tensors, identically on
every rank of a space group.
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
SPACE_AXIS = "space"


def world() -> tuple:
    """(world size, rank): (1, 0) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def share(n: int, parts: int, index: int) -> slice:
    """Part `index` of range(n) cut into `parts` contiguous parts whose sizes
    differ by at most one: for n a multiple of parts, JAX's shard of a
    dimension split over a mesh axis."""
    return slice(index * n // parts, (index + 1) * n // parts)


class _Join(torch.autograd.Function):
    """Forward: the ranks' shares of dim 1 gathered over the space group,
    in rank order. Backward: the upstream summed over the group, then this
    rank's own rows. Every rank of the group computes the same loss from
    the joined tensor, so the sum, divided by the world in `all_mean`, is
    the one-process gradient."""

    @staticmethod
    def forward(ctx, x, split: "SpaceSplit", n: int):
        ctx.split, ctx.n = split, n
        lengths = [len(range(n)[share(n, split.size, i)])
                   for i in range(split.size)]
        x = x.contiguous()
        if x.shape[1] < max(lengths):          # shares differ by one row
            pad = list(x.shape)
            pad[1] = max(lengths) - x.shape[1]
            x = torch.cat([x, x.new_zeros(pad)], 1)
        parts = [torch.empty_like(x) for _ in range(split.size)]
        dist.all_gather(parts, x, group=split.group)
        return torch.cat([p[:, :m] for p, m in zip(parts, lengths)], 1)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.split.group)
        return grad[:, ctx.split.rows(ctx.n)], None, None


class SpaceSplit:
    """The space axis as the renderer sees it (JAX's `space_axis`): this
    rank's contiguous share of a dim of n rays or columns (`rows`), and the
    join of per-row outputs back to all n (`join`), over `group`; and the
    group's first rank's batches on every rank of it (`broadcast`)."""

    def __init__(self, group, size: int, index: int):
        self.group, self.size, self.index = group, size, index

    def rows(self, n: int) -> slice:
        if n < self.size:
            raise ValueError(f"{n} rays or columns cannot be split over "
                             f"{self.size} space ranks")
        return share(n, self.size, self.index)

    def join(self, x: torch.Tensor, n: int) -> torch.Tensor:
        """x [a, rows(n), ...] -> [a, n, ...], the same on every rank of the
        group; differentiable. Booleans join as bytes."""
        if x.dtype == torch.bool:
            with torch.no_grad():
                return _Join.apply(x.to(torch.uint8), self, n).bool()
        return _Join.apply(x, self, n)

    def broadcast(self, tree, device):
        """The group's first rank's `tree` (nested dicts and lists of
        tensors; None on the other ranks) on every rank of the group, its
        tensors on `device` there: one broadcast of its structure, one of
        its tensors' bytes. The first rank gets its own tree back."""
        leaves, specs = [], []

        def spec(x):
            if isinstance(x, dict):
                return {k: spec(v) for k, v in x.items()}
            if isinstance(x, list):
                return [spec(v) for v in x]
            leaves.append(x.detach().contiguous().reshape(-1)
                          .view(torch.uint8))
            specs.append((x.dtype, tuple(x.shape), leaves[-1].numel()))
            return len(specs) - 1
        meta = [(spec(tree), specs) if self.index == 0 else None]
        src = dist.get_rank() - self.index   # the group's ranks are in a row
        dist.broadcast_object_list(meta, src=src, group=self.group)
        structure, specs = meta[0]
        sizes = [n for _, _, n in specs]
        buf = (torch.cat(leaves).to(device) if leaves else
               torch.empty(sum(sizes), dtype=torch.uint8, device=device))
        if buf.numel():
            dist.broadcast(buf, src, group=self.group)
        if self.index == 0:
            return tree
        parts = buf.split(sizes)

        def build(m):
            if isinstance(m, dict):
                return {k: build(v) for k, v in m.items()}
            if isinstance(m, list):
                return [build(v) for v in m]
            dtype, shape, _ = specs[m]
            # a copy of its own, so that the dtype's view is aligned
            return parts[m].clone().view(dtype).reshape(shape)
        return build(structure)


class Mesh:
    """A (data, space) mesh over the world's ranks: `shape`, this rank's
    `data_index` and `space_index`, and `split`, the renderer's SpaceSplit
    (None when n_space is 1)."""

    def __init__(self, n_data: int, n_space: int, rank: int = 0,
                 split: Optional[SpaceSplit] = None):
        self.n_data, self.n_space, self.rank = n_data, n_space, rank
        self.data_index, self.space_index = divmod(rank, n_space)
        self.split = split

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.n_data, SPACE_AXIS: self.n_space}

    @property
    def size(self) -> int:
        return self.n_data * self.n_space


def make_mesh(n_data: Optional[int] = None,
              n_space: Optional[int] = None) -> Mesh:
    """The mesh over every rank of the process group (one rank without one).
    Default: every rank on `space` (single-scene training, as JAX's). Every
    rank must call it with the same shape: it creates the space groups."""
    n, rank = world()
    if n_data is None and n_space is None:
        n_data, n_space = 1, n
    elif n_data is None:
        n_data = n // n_space
    elif n_space is None:
        n_space = n // n_data
    assert n_data * n_space == n, (n_data, n_space, n)
    split = None
    if n_space > 1:
        # every rank creates every group, in the same order
        groups = [dist.new_group(list(range(d * n_space, (d + 1) * n_space)))
                  for d in range(n_data)]
        split = SpaceSplit(groups[rank // n_space], n_space, rank % n_space)
    return Mesh(n_data, n_space, rank, split)


def shard_batch(mesh: Mesh, batch, scene_axis: bool = True):
    """This rank's share of a global batch (a nested dict of arrays or
    tensors), the counterpart of `shard_batch` / `host_local_batch_to_global`:
    with scene_axis, its S / n_data scenes of every array with a leading
    scene axis, contiguous and in order; 0-d values replicated; a scene
    axis that does not divide raises. Without it, everything replicated.
    `coords` stays whole either way: the renderer takes the rank's rays
    (`SpaceSplit.rows`)."""
    def take(path: str, x):
        if isinstance(x, dict):
            return {k: take(f"{path}/{k}", v) for k, v in x.items()}
        if not scene_axis or x.ndim == 0:
            return x
        if x.shape[0] % mesh.n_data:
            raise ValueError(
                f"{path}: leading scene axis {x.shape[0]} is not divisible "
                f"by the data-axis size {mesh.n_data}")
        return x[share(x.shape[0], mesh.n_data, mesh.data_index)]
    return take("", batch)


def scene_indices(mesh: Mesh, n_local: int) -> List[int]:
    """The global batch indices of this rank's n_local scenes."""
    return list(range(mesh.data_index * n_local,
                      (mesh.data_index + 1) * n_local))
