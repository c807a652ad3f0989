"""The train step and the loop around it (graspnerf_tpu/train/trainer.py):
the training forward (render, volume, grasp head, depth-loss means), the
summed losses, their gradient for every parameter, an Adam update with the
staircase-decay learning rate, skipped when a gradient is not finite; the
scene-batched loss; and `Trainer`, the step loop with validation, image
dumps, checkpoints and a JSONL metric log, on one process or as one rank of
a (data, space) mesh (`parallel`).

Single-scene batch (trainer.py:18-23): {"data": the renderer's data dict
with que["imgs"] and "grasp_index" [G,3], "true_depth" [V,H,W,1], "sdf_gt"
[res,res,res], "grasp_label" [G], "grasp_rot" [G,2,4], "grasp_width" [G]}.
Scene batch: the same tree with a leading S axis on every tensor
(`data.collate_scenes`).

The step runs with grad enabled, never under `torch.inference_mode()`. It
synchronises with the card once, to test the gradients' finiteness.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import time
from typing import (Any, Callable, Dict, Iterator, List, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from ..data.prefetch import to_device
from ..models.renderer import GraspNeRF, float32_on, resolve_device
from ..parallel import Mesh, all_mean, replicate, scene_indices
from . import losses as L
from .checkpoint import CheckpointManager
from .schedule import exp_decay_lr


@dataclasses.dataclass
class TrainState:
    """The model (in train mode), its Adam optimizer, the learning-rate
    schedule, and `step`, the number of updates applied (optax's count:
    the next update uses schedule(step))."""
    model: GraspNeRF
    optimizer: torch.optim.Adam
    schedule: Callable[[int], float]
    step: int = 0


def compute_losses(outputs, batch) -> Dict[str, torch.Tensor]:
    ld = {}
    if "pixel_colors_nr" in outputs:
        ld.update(L.render_loss(outputs))
    if "depth_mean" in outputs and "true_depth" in batch:
        ld.update(L.depth_loss(outputs, batch["true_depth"],
                               batch["data"]["ref"]["depth_range"]))
    ld.update(L.sdf_loss(outputs, batch["sdf_gt"]))
    ld.update(L.vgn_loss(outputs, batch["grasp_label"], batch["grasp_rot"],
                         batch["grasp_width"]))
    return ld


def make_loss_fn(model: GraspNeRF) -> Callable:
    """loss_fn(batch, generator) -> (total, {every loss and diagnostic,
    and "total"}), the training forward with its draws from generator."""
    def loss_fn(batch, generator: torch.Generator):
        outputs = model(batch["data"], train=True, generator=generator)
        ld = compute_losses(outputs, batch)
        ld["total"] = L.total_loss(ld)
        return ld["total"], ld
    return loss_fn


def scene(tree, i: int):
    """Scene i of a scene-batched tree."""
    if isinstance(tree, dict):
        return {k: scene(v, i) for k, v in tree.items()}
    return tree[i]


def make_batched_loss_fn(model: GraspNeRF) -> Callable:
    """loss_fn(batch, generators) over a scene batch: scene i's training
    forward and losses with its draws from generators[i], in scene order,
    and the mean over the scenes of every loss and diagnostic
    (trainer.py:74-97 vmaps over one split key a scene)."""
    single = make_loss_fn(model)

    def loss_fn(batch, generators: Sequence[torch.Generator]):
        n = batch["sdf_gt"].shape[0]
        if len(generators) != n:
            raise ValueError(f"{len(generators)} generators for {n} scenes")
        per = [single(scene(batch, i), g)[1]
               for i, g in enumerate(generators)]
        ld = {k: torch.stack([p[k] for p in per]).mean() for k in per[0]}
        return ld["total"], ld
    return loss_fn


def create_train_state(model: GraspNeRF, lr_cfg: Optional[dict] = None,
                       device=None) -> TrainState:
    """The model on `device` (the card when None, raising without one; TF32
    off there, as `load_graspnerf` does) in train mode, with Adam at
    optax's defaults (betas 0.9 / 0.999, eps 1e-8) and exp_decay_lr(**lr_cfg)."""
    device = resolve_device(device)
    float32_on(device)
    model = model.to(device).train()
    schedule = exp_decay_lr(**(lr_cfg or {}))
    optimizer = torch.optim.Adam(model.parameters(), lr=schedule(0),
                                 betas=(0.9, 0.999), eps=1e-8)
    return TrainState(model, optimizer, schedule)


def gradients(state: TrainState, total: torch.Tensor) -> List[torch.Tensor]:
    """d total / d parameter for every parameter, in `parameters()` order;
    zeros for one the total does not reach."""
    params = list(state.model.parameters())
    grads = torch.autograd.grad(total, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(params, grads)]


def mesh_gradients(state: TrainState, loss_fn: Callable, batch,
                   generators: Sequence[torch.Generator],
                   mesh: Optional[Mesh] = None
                   ) -> Tuple[Dict[str, torch.Tensor], List[torch.Tensor]]:
    """(this rank's losses and diagnostics, the gradients): loss_fn
    (`make_batched_loss_fn`) on the rank's scenes, and on a mesh every
    gradient averaged over the world, as one all-reduce (trainer.py:133-141
    under pjit). The finite guard then decides the same on every rank."""
    total, metrics = loss_fn(batch, generators)
    grads = gradients(state, total)
    if mesh is not None:
        all_mean(grads)
    return metrics, grads


def apply_gradients(state: TrainState, grads: List[torch.Tensor]) -> bool:
    """One Adam update at schedule(state.step), unless a gradient is not
    finite: then the parameters, the optimizer's state and state.step stay
    as they were (trainer.py:142-155). Returns whether it updated."""
    finite = bool(torch.isfinite(torch.cat([g.reshape(-1) for g in grads]))
                  .all())
    if finite:
        for p, g in zip(state.model.parameters(), grads):
            p.grad = g
        for group in state.optimizer.param_groups:
            group["lr"] = state.schedule(state.step)
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        state.step += 1
    return finite


TRAINABLE_DTYPES = ("float32", "bfloat16")


def check_trainable(compute_dtype: str) -> None:
    """Raise unless the port can train in `compute_dtype`: float32 or
    bfloat16 (scripts/train.py --compute-dtype)."""
    if compute_dtype not in TRAINABLE_DTYPES:
        raise NotImplementedError(
            f"compute_dtype {compute_dtype!r}: the port trains in "
            f"{' or '.join(TRAINABLE_DTYPES)}")


def make_train_step(state: TrainState) -> Callable:
    """step(batch, generator) -> metrics: every key of compute_losses,
    "total" and "nonfinite_grad" (1.0 when the update was skipped), as
    detached 0-d tensors. In bfloat16 the model computes in bfloat16 while
    the parameters, their gradients, Adam's state and the losses stay
    float32, as in JAX (`check_trainable`)."""
    check_trainable(state.model.nr_net.compute_dtype)
    loss_fn = make_loss_fn(state.model)

    def step(batch, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        total, metrics = loss_fn(batch, generator)
        finite = apply_gradients(state, gradients(state, total))
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["nonfinite_grad"] = total.new_tensor(0.0 if finite else 1.0)
        return metrics
    return step


def make_eval_step(state: TrainState) -> Callable:
    """eval_step(batch, generator) -> the losses and diagnostics of the eval
    forward (deterministic samples; the depth-loss pixels from generator)
    and psnr_nr, without gradients."""
    model = state.model

    @torch.no_grad()
    def eval_step(batch, generator: torch.Generator):
        outputs = model(batch["data"], train=False, generator=generator)
        ld = compute_losses(outputs, batch)
        if "pixel_colors_nr" in outputs:
            ld["psnr_nr"] = L.psnr(outputs["pixel_colors_nr"],
                                   outputs["pixel_colors_gt"])
        return ld
    return eval_step


def step_seed(seed: int, step: int, scene: int = 0) -> int:
    """The seed of the draws of scene `scene` of step `step`'s global
    batch: a function of (seed, step, scene) alone, so that a resumed run
    draws what an uninterrupted one would, and a data rank draws for its
    scenes what one process draws for them (JAX splits one key a scene).
    Scene 0's is the step's seed."""
    entropy = [seed, step] + ([scene] if scene else [])
    return int(np.random.SeedSequence(entropy).generate_state(1)[0])


def scene_generators(seed: int, step: int, scenes: Sequence[int],
                     device) -> List[torch.Generator]:
    """A generator for each global scene index in `scenes`, seeded with
    `step_seed(seed, step, scene)`."""
    return [torch.Generator(device=device).manual_seed(
        step_seed(seed, step, i)) for i in scenes]


def adam_updates(optimizer: torch.optim.Optimizer) -> int:
    """The updates Adam has applied (its per-parameter `step`)."""
    return max((int(s["step"]) for s in optimizer.state.values()),
               default=0)


def git_sha() -> Optional[str]:
    """The short commit of the code's checkout, or None outside git."""
    try:
        out = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                             cwd=os.path.dirname(os.path.abspath(__file__)),
                             capture_output=True, text=True, timeout=5)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


class Trainer:
    """Step loop, validation and checkpoints (trainer.py:176-401; ref
    trainer.py run/val flow) on scene batches, as scripts/train.py always
    runs the JAX one.

    train_iter yields scene batches (numpy or tensors, e.g. a
    `data.SceneLoader`); val_batches are single-scene trees. The model
    trains on `device` (the card when None, raising without one). `run`
    resumes from `<workdir>/ckpt/latest`, writes a run-config line and then
    every `log_every` steps a record to `<workdir>/metrics.jsonl`
    (synchronising with the card only there), validates every
    `val_interval` steps (each val batch's draws from a generator seeded 0),
    dumps a validation image and saves with `key_metric`, and saves every
    `save_interval` steps otherwise. Scene i of step s's batch draws from a
    generator seeded with `step_seed(seed, s, i)`.

    mesh: a `parallel.Mesh` (JAX's `mesh`): this process is one rank of it,
    train_iter yields this rank's S / n_data scenes (each data rank loads
    its own, as JAX's host-local batches), and the renderer takes its share
    of the rays and volume columns on `space`. Of a space group only the
    first rank reads train_iter and val_batches (the others may pass None)
    and broadcasts them to the rest, so that every rank of the group works
    on the same scenes. Every rank restores from the
    same `latest`, starts from rank 0's parameters, averages the gradients
    over the world before the finite guard and Adam, validates and renders
    the image dump; rank 0 alone writes the log, TensorBoard, the image and
    the checkpoints, and logs the losses averaged over the world.
    """

    def __init__(self, model: GraspNeRF, train_iter: Iterator,
                 val_batches=None, workdir: str = "data/train",
                 total_steps: int = 500_000, val_interval: int = 5000,
                 save_interval: int = 1000, lr_cfg: Optional[dict] = None,
                 key_metric: str = "loss_vgn", log_every: int = 50,
                 seed: int = 0, tensorboard: bool = True,
                 val_image_dir: Optional[str] = None, device=None,
                 mesh: Optional[Mesh] = None):
        self.model = model
        self.device = resolve_device(device)
        self.mesh = mesh
        self.lead = mesh is None or mesh.rank == 0
        self.split = None if mesh is None else mesh.split
        model.nr_net.space = self.split
        self.train_iter = train_iter
        self.val_batches = self._shared([to_device(b, self.device)
                                         for b in (val_batches or [])])
        self.workdir = workdir
        self.total_steps = total_steps
        self.val_interval = val_interval
        self.save_interval = save_interval
        self.lr_cfg = lr_cfg
        self.key_metric = key_metric
        self.log_every = log_every
        self.seed = seed
        self.val_image_dir = val_image_dir
        os.makedirs(workdir, exist_ok=True)
        self.ckpt = CheckpointManager(os.path.join(workdir, "ckpt"))
        self.log_path = os.path.join(workdir, "metrics.jsonl")
        self.tb = None
        if tensorboard and self.lead:
            try:   # the reference logs through SummaryWriter too
                from torch.utils.tensorboard import SummaryWriter
                self.tb = SummaryWriter(os.path.join(workdir, "tb"))
            except Exception:   # optional: no tensorboard, no scalars there
                self.tb = None

    def _log(self, record: Dict[str, Any]):
        if not self.lead:
            return
        rec = {k: (float(v) if isinstance(v, torch.Tensor) else v)
               for k, v in record.items()}
        with open(self.log_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self.tb is not None and "step" in rec:
            prefix = "val/" if rec.get("val") else "train/"
            for k, v in rec.items():
                if isinstance(v, float):
                    self.tb.add_scalar(prefix + k, v, rec["step"])

    def _shared(self, tree):
        """tree, or on a space group its first rank's tree (the others'
        are not read)."""
        if self.split is None:
            return tree
        return self.split.broadcast(tree if self.split.index == 0 else None,
                                    self.device)

    def _next_batch(self):
        """The next scene batch on the device; on a space group, its first
        rank's (only that rank reads train_iter)."""
        if self.split is not None and self.split.index != 0:
            return self._shared(None)
        return self._shared(to_device(next(self.train_iter), self.device))

    def _pop_data_wait(self) -> Optional[float]:
        pop = getattr(self.train_iter, "pop_data_wait", None)
        return pop() if pop is not None else None

    def restore(self) -> Tuple[TrainState, int, float]:
        """(train state, the step to start at, best key metric): the model
        and Adam from `latest` when there is a checkpoint, else as they
        are, at step 0; on a mesh, the parameters rank 0's."""
        state = create_train_state(self.model, self.lr_cfg, self.device)
        # onto the CPU first: load_state_dict copies the model's tensors and
        # Adam's moments to the parameters' device and leaves Adam's step
        # counts on the CPU, where Adam keeps them
        ckpt = self.ckpt.restore("cpu")
        start, best = 0, math.inf
        if ckpt is not None:
            state.model.load_state_dict(ckpt["model"])
            state.optimizer.load_state_dict(ckpt["optimizer"])
            state.step = adam_updates(state.optimizer)
            start, best = ckpt["step"], ckpt["best"]
        if self.mesh is not None:
            replicate(state.model)
        return state, start, best

    def _save(self, state: TrainState, step: int, best: float,
              key_metric: Optional[float] = None) -> float:
        if not self.lead:
            return best
        return self.ckpt.save({"model": state.model.state_dict(),
                               "optimizer": state.optimizer.state_dict()},
                              step, key_metric=key_metric, best=best)

    def validate(self, state: TrainState) -> Dict[str, float]:
        eval_step = make_eval_step(state)
        agg: Dict[str, list] = {}
        for batch in self.val_batches:
            gen = torch.Generator(device=self.device).manual_seed(0)
            for k, v in eval_step(batch, gen).items():
                agg.setdefault(k, []).append(float(v))
        return {k: float(np.mean(v)) for k, v in agg.items()}

    def _dump_val_images(self, state: TrainState, step: int,
                         stride: int = 4):
        """Side-by-side pred/GT dump of the first val batch's query view on
        a stride-subsampled pixel grid (ref metrics.py:86-114)."""
        if not self.val_batches or self.val_image_dir is None:
            return
        try:
            from .metrics import visualize_image
            batch = self.val_batches[0]
            que = batch["data"]["que"]
            h, w = que["imgs"].shape[1:3]
            ys = torch.arange(0, h, stride, device=self.device)
            xs = torch.arange(0, w, stride, device=self.device)
            gy, gx = torch.meshgrid(ys, xs, indexing="ij")
            coords = torch.stack([gx, gy], -1).reshape(1, -1, 2).float()
            data = {"ref": batch["data"]["ref"],
                    "que": {"coords": coords, "poses": que["poses"],
                            "Ks": que["Ks"],
                            "depth_range": que["depth_range"]}}
            with torch.no_grad():
                outputs = state.model(data, train=False)
            key = ("pixel_colors_nr_fine" if "pixel_colors_nr_fine" in outputs
                   else "pixel_colors_nr")
            if key not in outputs or not self.lead:
                return
            pred = outputs[key].reshape(len(ys), len(xs), 3)
            gt = que["imgs"][0][ys][:, xs]
            visualize_image(pred, gt, self.val_image_dir, step)
        except Exception as e:   # a failed dump must never stop training
            self._log({"step": step, "val_image_error": repr(e)})

    def _run_config(self, state: TrainState, batch, n_scenes: int,
                    start_step: int, steps: int) -> Dict[str, Any]:
        mesh = self.mesh
        cuda = self.device.type == "cuda"
        return {"run_config": True, "git_sha": git_sha(),
                "torch": torch.__version__, "cuda": torch.version.cuda,
                "device": (torch.cuda.get_device_name(self.device)
                           if cuda else str(self.device)),
                "compute_dtype": state.model.nr_net.compute_dtype,
                "use_kernels": state.model.nr_net.use_kernels,
                "mesh": None if mesh is None else mesh.shape,
                "n_devices": 1 if mesh is None else mesh.size,
                "dist_backend": (torch.distributed.get_backend()
                                 if torch.distributed.is_initialized()
                                 else None),
                "scene_batch": True, "n_scenes": n_scenes,
                "n_rays": batch["data"]["que"]["coords"].shape[2],
                "volume_res": batch["sdf_gt"].shape[-1],
                "img_hw": list(batch["data"]["ref"]["imgs"].shape[-3:-1]),
                "start_step": start_step, "seed": self.seed,
                "total_steps": steps}

    def run(self, max_steps: Optional[int] = None) -> TrainState:
        batch = self._next_batch()
        state, start_step, best = self.restore()
        steps = max_steps or self.total_steps
        n_local = batch["sdf_gt"].shape[0]
        scenes = (range(n_local) if self.mesh is None
                  else scene_indices(self.mesh, n_local))
        n_scenes = n_local * (1 if self.mesh is None else self.mesh.n_data)
        n_rays = batch["data"]["que"]["coords"].shape[2]
        res = batch["sdf_gt"].shape[-1]
        self._log(self._run_config(state, batch, n_scenes, start_step,
                                   steps))
        loss_fn = make_batched_loss_fn(state.model)
        self._pop_data_wait()
        t0 = time.perf_counter()
        for step in range(start_step, steps):
            metrics, grads = mesh_gradients(
                state, loss_fn, batch,
                scene_generators(self.seed, step, scenes, self.device),
                self.mesh)
            # the next batch, fetched and copied while the card runs the
            # backward; the update below waits for the card
            batch = self._next_batch()
            finite = apply_gradients(state, grads)
            if (step + 1) % self.log_every == 0:
                names = list(metrics)
                values = torch.stack([metrics[k].detach() for k in names])
                if self.mesh is not None:
                    all_mean([values])
                rec = dict(zip(names, values.tolist()))
                rec["nonfinite_grad"] = 0.0 if finite else 1.0
                sec = (time.perf_counter() - t0) / self.log_every
                rec = {"step": step + 1, "sec_per_step": sec,
                       "scenes_per_s": n_scenes / sec,
                       "rays_per_s": n_scenes * n_rays / sec,
                       "tsdf_queries_per_s": n_scenes * res ** 3 / sec,
                       **rec}
                wait = self._pop_data_wait()
                if wait is not None:
                    rec["data_wait_per_step"] = wait / self.log_every
                self._log(rec)
                t0 = time.perf_counter()
            if (step + 1) % self.val_interval == 0 and self.val_batches:
                val = self.validate(state)
                self._log({"step": step + 1, "val": True, **val})
                self._dump_val_images(state, step + 1)
                best = self._save(state, step + 1, best,
                                  val.get(self.key_metric))
            elif (step + 1) % self.save_interval == 0:
                best = self._save(state, step + 1, best)
        if self.tb is not None:
            self.tb.flush()
        return state
