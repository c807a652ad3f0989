"""Planning calls in a closed loop: one robot calls
`GraspNeRFPlanner.__call__` (`detect/planner.py`), waits for its grasps and
calls again, on the next scene of a seeded pool, cycled. Each call uploads
the host's views, encodes them, samples the SDF volume, runs the grasp
head and post-processing on the card, and hands the candidates to the
host (`candidates_to_grasps`), ending in the port's own synchronisation.

The quality threshold is the one at which the plain reference keeps
`threshold_candidates` NMS peaks on scene 0 (random weights put every
quality near 0.5), so it follows the reference and not the program.

`correct` compares, after the window, one call a scene drawn from the
seed (a reservoir of one over the scene's calls), with the reference run
once on each scene: the TSDF, the head's three volumes and the returned
grasps (`judge.plan_numbers`); a configuration in another dtype than
float32 runs the reference a second time with its products in that dtype,
the yardstick of the `.vs_dtype` numbers."""
from __future__ import annotations

import random
import time
from typing import Dict

import torch

from .. import judge, reference, scenes, trace, weights
from ..record import Record
from ..spans import Spans
from . import common

KERNELS = ("view_fuse", "epipolar_gather")
VOXEL_SIZE = 0.3 / 40


def ref_scene(s: dict, device) -> Dict[str, torch.Tensor]:
    """The reference's inputs for pool scene s, made from the host arrays."""
    def t(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)
    return {"imgs": t(s["images"]), "poses": t(s["extrinsics"]),
            "Ks": t(s["Ks"]), "depth_range": t(s["depth_range"]),
            "bbox3d_min": t(scenes.BBOX_MIN)}


def grasp_cands(grasps, scores):
    """The planner's grasps as (voxel, score, rotation xyzw, width in
    voxels)."""
    out = []
    for (T, w), s in zip(grasps, scores):
        v = tuple(int(round(x)) for x in T.translation / VOXEL_SIZE)
        out.append((v, float(s), list(T.rotation.as_quat()),
                    w / VOXEL_SIZE))
    return out


class Driver:
    def __init__(self, cell, seed: int, device: torch.device, trace: bool):
        self.cell, self.seed, self.device, self.trace = cell, seed, device, trace
        self.config, self.mix = cell.config, cell.traffic
        res = self.config["volume_resolution"]
        self.record = Record("plan", self.config["compute_dtype"],
                             common.dims(self.config),
                             {k: res ** 3 for k in KERNELS})
        self.spans = Spans(device)
        self.k = self.mix["max_candidates"]
        self.samples: Dict[int, tuple] = {}

    # ------------------------------------------------------------ set-up
    def inputs(self) -> None:
        """The weights, the scene pool and the quality threshold."""
        c, m = self.config, self.mix
        common.build_kernels(self.device)
        self.weights = weights.seeded(common.reference_cfg(c), self.seed,
                                      self.device)
        self.pool = scenes.plan_pool(self.seed, m["scenes"],
                                     c["num_input_views"], c["image_height"],
                                     c["image_width"], m["depth_range"],
                                     self.device)
        self.threshold = self.reference_threshold()

    def setup(self, fault=None) -> None:
        """inputs(), then the planner, warmed up; `fault(self)` plants a
        fault in the program (the checks' own tests)."""
        from graspnerf_tpu_torch.detect.planner import GraspNeRFPlanner
        c, m = self.config, self.mix
        self.inputs()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.device)
        self.planner = GraspNeRFPlanner(
            self.weights, self.device, common.renderer_cfg(c),
            qual_threshold=self.threshold, max_candidates=self.k)
        volume = self.planner.volume

        def keep(*args, **kw):      # the call's volumes, for the check
            self.last = volume(*args, **kw)
            return self.last
        self.planner.volume = keep
        self.undo_fault = fault(self) if fault else None
        self.rng = random.Random(self.seed)
        self.seen = [0] * len(self.pool)
        self.calls = 0
        for _ in range(m["warmup_calls"]):
            self.call(sample=False)

    @torch.no_grad()
    def reference_threshold(self) -> float:
        ref = common.reference_model(self.config, self.weights, self.device)
        vol, (qual, rot, width, _) = ref.plan(ref_scene(self.pool[0],
                                                        self.device))
        q = reference.process_quality(vol, qual[..., 0], width[..., 0])
        peaks = reference.peak_scores(q)
        n = self.mix["threshold_candidates"]
        if len(peaks) > n:
            return (peaks[n - 1] + peaks[n]) / 2
        # fewer peaks than asked for: keep them all
        return peaks[-1] / 2 if peaks else 0.5

    # ------------------------------------------------------------ calls
    def call(self, sample: bool = True) -> float:
        i = self.calls % len(self.pool)
        s = self.pool[i]
        t0 = time.perf_counter()
        grasps, scores, _ = self.planner(s["images"], s["extrinsics"],
                                         s["Ks"], s["depth_range"])
        dt = time.perf_counter() - t0
        self.calls += 1
        if sample:
            self.seen[i] += 1
            if self.rng.random() * self.seen[i] < 1:
                vol, heads, _ = self.last
                self.samples[i] = (vol, tuple(h[0] for h in heads),
                                   grasp_cands(grasps, scores))
        return dt

    def sweep(self) -> None:
        """One call on each scene of the pool, each kept for the check (the
        calibration's read of the program)."""
        for _ in self.pool:
            self.call()

    def window(self, seconds: float) -> None:
        if self.trace:
            self.add_spans()
        lat = self.record.latencies_s
        t_start = time.perf_counter()
        end = t_start + seconds
        while True:
            lat.append(self.call())
            if time.perf_counter() >= end:
                break
        self.record.window_s = time.perf_counter() - t_start
        if self.trace:
            self.record.spans_ms = self.spans.ms()

    def add_spans(self) -> None:
        sp = self.spans
        sp.attach(self.planner, "encode", "encode")
        sp.attach(self.planner.model.nr_net, "sample_volume", "volume")
        sp.attach(self.planner, "detect", "head")

    def profile(self) -> None:
        self.spans.profiling = True
        self.record.segment = trace.profile(
            lambda i: self.call(sample=False), self.mix["trace_calls"],
            common.work_kernels(KERNELS), self.device)
        self.spans.profiling = False
        self.spans.undo()

    def release(self) -> None:
        if self.undo_fault:
            self.undo_fault()
        del self.planner, self.last
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ check
    def control_samples(self, precision: str) -> None:
        """The reference in `precision` put in the program's place, one call
        a scene: the calibration's control."""
        ref = common.reference_model(self.config, self.weights, self.device,
                                     precision)
        with torch.no_grad():
            for i, s in enumerate(self.pool):
                vol, (qual, rot, width, _) = ref.plan(ref_scene(s,
                                                                self.device))
                q = reference.process_quality(vol, qual[..., 0],
                                              width[..., 0])
                self.samples[i] = (vol, (qual, rot, width),
                                   reference.candidates(
                                       q, rot, width[..., 0], self.threshold,
                                       self.k))

    @torch.no_grad()
    def check(self) -> Dict[str, float]:
        ref = common.reference_model(self.config, self.weights, self.device)
        dtype = self.config["compute_dtype"]
        own = None if dtype == "float32" else common.reference_model(
            self.config, self.weights, self.device, dtype)
        rows = []
        for i in sorted(self.samples):
            inputs = ref_scene(self.pool[i], self.device)
            if self.trace and self.record.flops_per_call is None:
                from torch.utils.flop_counter import FlopCounterMode
                with FlopCounterMode(display=False) as fc:
                    vol, heads = ref.plan(inputs)
                    reference.process_quality(vol, heads[0][..., 0],
                                              heads[2][..., 0])
                self.record.flops_per_call = float(fc.get_total_flops())
            else:
                vol, heads = ref.plan(inputs)
            rows.append(judge.plan_numbers(
                self.samples[i], vol, heads, self.threshold, self.k,
                None if own is None else own.plan(inputs)))
        return judge.vs_dtype(judge.worst(rows))
