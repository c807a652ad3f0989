"""Training steps back to back: the step that `train.make_train_step`
returns, one scene a step from a seeded pool in pinned host memory, each
batch moved to the card with the port's `data.prefetch.to_device` as
`Trainer.run` moves it, each step's draws (fine samples, depth-loss
pixels) from a generator seeded for that step. No loader, validation or
checkpoint.

Set-up builds one train state and drives it through the first
`checked_steps` steps with the same feed and step the window uses, on
scenes that all differ; it keeps each step's losses, the first gradient as
Adam holds it after step 1, and the parameters after the last; then warms
up and hands the same state to the window. After the window the reference
follows the same steps from the same weights, batches and draws
(`judge.train_numbers`)."""
from __future__ import annotations

import time
from typing import Dict

import torch

from .. import judge, reference, scenes, trace, weights
from ..record import Record
from ..spans import Spans
from . import common

KERNELS = ("view_fuse", "epipolar_gather", "epipolar_gather_backward")
BETA1 = 0.9


class Driver:
    def __init__(self, cell, seed: int, device: torch.device, trace: bool):
        self.cell, self.seed, self.device, self.trace = cell, seed, device, trace
        self.config, self.mix = c, m = cell.config, cell.traffic
        rows = (m["rays"] * (c["depth_sample_num"]
                             + c["fine_depth_sample_num"])
                + c["volume_resolution"] ** 3)
        self.record = Record("train", c["compute_dtype"], common.dims(c),
                             {k: rows for k in KERNELS})
        self.spans = Spans(device)
        self.nonfinite = []

    # ------------------------------------------------------------ set-up
    def inputs(self) -> None:
        """The weights and the scene pool."""
        c, m = self.config, self.mix
        common.build_kernels(self.device)
        self.weights = weights.seeded(common.reference_cfg(c), self.seed,
                                      self.device)
        self.pool = scenes.train_pool(
            self.seed, m["scenes"], c["num_input_views"], c["image_height"],
            c["image_width"], m["depth_range"], m["rays"],
            c["volume_resolution"], m["grasps"], self.device)

    def setup(self, fault=None) -> None:
        """inputs(), then the train state driven through the checked steps
        and warmed up; `fault(self)` plants a fault in the program first
        (the checks' own tests and calibration)."""
        from graspnerf_tpu_torch.models import GraspNeRF
        from graspnerf_tpu_torch.train import (create_train_state,
                                               make_train_step)
        c, m = self.config, self.mix
        self.inputs()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        model = GraspNeRF(common.renderer_cfg(c))
        model.load_state_dict(self.weights)
        self.state = create_train_state(model, c["lr_cfg"], self.device)
        self.step = make_train_step(self.state)
        self.undo_fault = fault(self) if fault else None
        self.steps = 0
        self.prog = self.first_steps()
        for _ in range(m["warmup_steps"]):
            self.feed()

    def feed(self):
        """One step of the window's own feed: the next pool scene to the
        card, a generator seeded for the step, the port's step."""
        from graspnerf_tpu_torch.data.prefetch import to_device
        i = self.steps
        batch = to_device(self.pool[i % len(self.pool)], self.device)
        g = torch.Generator(device=self.device).manual_seed(
            scenes.step_seed(self.seed, i))
        self.steps += 1
        return self.step(batch, g)

    def first_steps(self) -> dict:
        params = dict(self.state.model.named_parameters())
        out = {"losses": [], "grad": {}, "start": self.weights}
        for i in range(self.mix["checked_steps"]):
            metrics = self.feed()
            out["losses"].append({k: float(v) for k, v in metrics.items()
                                  if k.startswith("loss") or k == "total"})
            out["skipped"] = out.get("skipped", 0) + float(
                metrics["nonfinite_grad"])
            if i == 0:
                opt = self.state.optimizer.state
                out["grad"] = {n: opt[p]["exp_avg"] / (1 - BETA1)
                               for n, p in params.items() if p in opt}
        out["end"] = {n: p.detach().clone() for n, p in params.items()}
        return out

    # ------------------------------------------------------------ window
    def window(self, seconds: float) -> None:
        if self.trace:
            self.add_spans()
        lat = self.record.latencies_s
        t_start = t = time.perf_counter()
        end = t_start + seconds
        while t < end:
            if self.trace:
                self.spans.mark("forward")
            self.nonfinite.append(self.feed()["nonfinite_grad"])
            now = time.perf_counter()
            lat.append(now - t)
            t = now
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.record.window_s = time.perf_counter() - t_start
        self.record.failed = int(sum(float(x) for x in self.nonfinite))
        if self.trace:
            self.record.spans_ms = self.spans.ms()

    def add_spans(self) -> None:
        from graspnerf_tpu_torch.train import trainer
        sp, gradients = self.spans, trainer.gradients

        def after_forward(state, total):
            sp.close("forward")
            return gradients(state, total)
        sp.patch(trainer, "gradients", sp.wrap("backward", after_forward))
        sp.attach(trainer, "apply_gradients", "optimizer")

    def profile(self) -> None:
        self.spans.profiling = True

        def one(_):
            self.spans.mark("forward")
            self.feed()
        self.record.segment = trace.profile(
            one, self.mix["trace_steps"], common.work_kernels(KERNELS),
            self.device)
        self.spans.profiling = False
        self.spans.undo()

    def release(self) -> None:
        if self.undo_fault:
            self.undo_fault()
        del self.state, self.step
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ check
    def reference_steps(self, precision: str = "float32",
                        count_flops: bool = False) -> dict:
        ref = common.reference_model(self.config, self.weights, self.device,
                                     precision)
        out = {"losses": [], "start": self.weights}
        adam: dict = {}
        for i in range(self.mix["checked_steps"]):
            batch = scenes.on_device(self.pool[i % len(self.pool)],
                                     self.device)
            g = torch.Generator(device=self.device).manual_seed(
                scenes.step_seed(self.seed, i))
            if count_flops and i == 0:
                from torch.utils.flop_counter import FlopCounterMode
                with FlopCounterMode(display=False) as fc:
                    values, grads, _ = reference.train_step(ref, batch, g,
                                                            adam, i + 1)
                self.record.flops_per_call = float(fc.get_total_flops())
            else:
                values, grads, _ = reference.train_step(ref, batch, g, adam,
                                                        i + 1)
            out["losses"].append(values)
            if i == 0:
                out["grad"] = grads
        out["end"] = {n: p.detach().clone() for n, p in ref.named_parameters()}
        return out

    def control_samples(self, precision: str) -> None:
        """The reference in `precision` put in the program's place."""
        self.prog = self.reference_steps(precision)

    def check(self) -> Dict[str, float]:
        ref = self.reference_steps(count_flops=self.trace)
        return judge.train_numbers(self.prog, ref)
