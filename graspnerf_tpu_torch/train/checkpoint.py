"""Checkpoints with latest/best semantics (graspnerf_tpu/train/checkpoint.py;
ref: trainer.py:183-218), as `torch.save` files.

Crash-safe: every save writes a fresh step file (through a temporary name,
renamed into place), and only then are the `latest` / `best` symlinks
switched with an atomic `os.replace`, so a crash at any point leaves the
previous checkpoint intact.

Layout:
  <dir>/step_<n>.pt  {"model": state dict, "optimizer": Adam's state dict,
                      "step": n, "best": the best key metric so far}
  <dir>/latest       symlink to the newest step file
  <dir>/best         symlink to the step file with the best key metric
Step files that neither name points to are removed after each save.
"""
from __future__ import annotations

import math
import os
from typing import Any, Dict, Mapping, Optional

import torch


def _atomic_symlink(target: str, link: str):
    """Point `link` at `target` (a name in the same directory) atomically."""
    tmp = link + ".tmp"
    if os.path.lexists(tmp):
        os.remove(tmp)
    os.symlink(target, tmp)
    os.replace(tmp, link)


class CheckpointManager:
    def __init__(self, directory: str, prefer_lower: bool = True):
        self.dir = os.path.abspath(directory)
        self.prefer_lower = prefer_lower
        os.makedirs(self.dir, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.dir, name)

    def _gc(self):
        """Remove step files no longer named by latest/best, and the
        leftovers of interrupted writes."""
        keep = {os.path.basename(os.path.realpath(self._path(tag)))
                for tag in ("latest", "best")
                if os.path.lexists(self._path(tag))}
        for name in os.listdir(self.dir):
            if name.startswith("step_") and name not in keep:
                os.remove(self._path(name))

    def save(self, state: Mapping[str, Any], step: int,
             key_metric: Optional[float] = None,
             best: Optional[float] = None) -> float:
        """Save `state` ({"model", "optimizer"} state dicts) as step `step`;
        promote it to best when key_metric improves on `best`. Returns the
        updated best value."""
        best = math.inf if best is None else float(best)
        improved = False
        if key_metric is not None:
            key_metric = float(key_metric)
            improved = (key_metric < best if self.prefer_lower
                        else key_metric > best)
            improved = improved or not math.isfinite(best)
            if improved:
                best = key_metric
        name = f"step_{step}.pt"
        tmp = self._path(name + ".tmp")
        try:
            torch.save({**state, "step": int(step), "best": best}, tmp)
            os.replace(tmp, self._path(name))
        except BaseException:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise
        # the new file is complete on disk before any name moves
        _atomic_symlink(name, self._path("latest"))
        if improved:
            _atomic_symlink(name, self._path("best"))
        self._gc()
        return best

    def restore(self, device=None, tag: str = "latest"
                ) -> Optional[Dict[str, Any]]:
        """The checkpoint that `tag` names, its tensors on `device` (where
        they were saved when None), or None if there is none."""
        path = self._path(tag)
        if not os.path.exists(path):   # follows symlinks: dangling -> None
            return None
        return torch.load(path, map_location=device, weights_only=True)


def load_params(path: str) -> Dict[str, torch.Tensor]:
    """The model's state dict (on the CPU) from a checkpoint file: a step
    file, a `latest` / `best` link, or the file that
    scripts/export_torch_checkpoint.py writes from an Orbax checkpoint.
    `models.load_graspnerf` and `GraspNeRFPlanner` take it as it is."""
    return torch.load(path, map_location="cpu", weights_only=True)["model"]
