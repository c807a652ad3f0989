#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (graspnerf_tpu_torch) on one
NVIDIA card: run from the repository root as `python3 chip_smoke.py`.

1. builds the CUDA kernels from csrc/ (nvcc, all sources at once: the
   float32 and the bfloat16 view fuse, the gather, the fused
   InstanceNorm);
2. drives the planner (`GraspNeRFPlanner.core`) at full width -- six
   288 x 512 views, a 40^3 volume, every layer at the shipped widths, seeded
   random weights -- for a few planning calls, counts the kernel launches,
   and compares the volume, grasp-head outputs and candidates with the same
   planner on the plain versions on the same card;
3. drives the render path (`NeuralRayRenderer.forward` without the volume,
   and `GraspNeRF.forward` with it) at full width -- the same views, 4096
   rays of view 0, 40 coarse + 40 fine samples -- counts the kernel
   launches of each, compares every output with the same model on the plain
   versions on the same card, times its phases, and keeps the kernels'
   arguments of its coarse pass;
4. drives the train step (`train.make_train_step`) at full width -- the
   same views, 512 rays of view 0 x (40 + 40) samples, the 40^3 volume,
   8192 depth-loss pixels, 32 grasps -- for a few steps, counts the
   launches of the three kernels per step, holds the losses and every
   parameter's gradient against the same model on the plain versions on
   the same card (same draws, the fine pass at equal samples), checks the
   view fuse after a weight update, times the step (forward, backward,
   optimizer) and keeps the gather's arguments of its coarse pass;
5. drives the training loop (`train.Trainer.run`, the entry script's
   loop) at full width on generated scenes -- the port's synthetic
   generator at 288 x 512, 512 rays, 40^3, 32 grasps, four data worker
   processes with the native tracer -- for 12 steps with logging, validation,
   a validation image dump (which must be written) and checkpoints, then resumes a fresh Trainer
   from `latest` for 2 more steps; checks the launches per step and per val
   batch (and the fused InstanceNorm's 62 a validation forward), that every logged loss is finite and no update was skipped, that
   the restored state equals the saved one bit for bit, and the first loop
   batch's losses and gradients against the plain versions; and prints the
   loop's time per step, its data wait and the pipeline's own scenes/s;
6. holds the view fuse against its plain version at the volume path's
   shapes, at ragged N around its row tile, with misaligned inputs, on the
   render's own inputs and through its backward, after checking its
   weight-pack guard, and times it;
7. holds the gather against its plain version on the card (atol) and on
   the CPU (bit-equal) on random, the planner's and the render's
   coordinates, at ragged P around its block and with misaligned inputs
   and outputs, and times it (wrapper and bare launch);
8. holds the gather's backward kernel against autograd through the plain
   version on the card and on the CPU, on random, the planner's and the
   train pass's coordinates, at ragged P and misaligned, checks that two
   launches give bit-equal gradients, reports its kernels' registers,
   spills and shared memory, and times it (its CUDA launches a call, and
   B'-bf16's, are counted with torch.profiler before step 2, while the
   profiler still sees every event);
9. times the planner's phases with CUDA events;
10. the bfloat16 inference path (`compute_dtype="bfloat16"`): drives the
   planner and the render at the same full widths through the bfloat16
   instances of the view fuse and the gather, counts their launches, holds
   the kernel model against the plain-version model on the same card (and
   against the float32 kernel model: the volume's gap, the candidates'
   overlap), times the phases; holds each bfloat16 kernel against its plain
   version at the main path's shapes, and times it (the bfloat16 view fuse,
   csrc/view_fuse_bf16.cu, beside the float32 kernel on the same rows, with
   its registers, spills, shared memory and resident blocks);
11. the bfloat16 train step (`compute_dtype="bfloat16"`, the float32
   parameters and Adam state): one loss and its gradients of the kernel
   model against the plain-version model (and the float32 model beside
   them), TRAIN_STEPS counted steps (3 launches of each bfloat16 kernel a
   step: the view fuse, the gather and its backward), the step's times
   beside the plain model's, and a few steps of `Trainer.run`;
12. holds the gather's bfloat16 backward kernel (B'-bf16: the maps' and
   the image's gradients) against the plain bfloat16 backward on the card
   and on the CPU, on random, the bfloat16 planner's and the bfloat16 train
   pass's coordinates, ragged and misaligned; checks two launches
   bit-equal and non-finite upstream at invalid points; reports its
   kernels' registers, spills and shared memory, and times it;
13. the closed loop (`sim.clutter_removal.run`, the entry point of
   `python3 -m graspnerf_tpu_torch.sim.cli`): SimWorld("pile") scenes, the
   domain-randomized renderer and the gripper on the host with the native
   tracer, the TSDF fusion and the float32 planner on the card, at 6 x 288
   x 512 views and 40^3, for 2 rounds of 3 objects, the threshold picked
   at each planning call; at every planning call the plain planner on the
   same views (volume, candidates but for those within 1e-4 of the
   threshold); checks no round raised, every round was
   logged, a grasp was executed, no ray was traced by numpy, and one launch
   of the view fuse and of the gather a planning call; prints the seconds
   per grasp attempt by part and the metrics; then one VGN baseline call
   on the card against the CPU (identical candidates);
14. dataset -> train: the port's dataset writer (`data.generate`, the
   entry point of `python3 -m graspnerf_tpu_torch.data.generate`) writes 2
   procedural pile scenes of 24 views at 288 x 512 with 40 executed grasp
   candidates each (the TSDF fused on the card; seconds a scene by part),
   `VGNSynDataset` reads the tree back, `Trainer.run` takes 12 steps on it
   through 4 data workers (3 launches of each kernel a step, its
   sec_per_step and data wait, their steady state past the workers'
   queued batches, and the loader's own rate), and the first batch's
   losses and gradients (and, where it draws no positive grasp label, a
   written sample's that does) are held against the plain versions; no
   ray may be traced by numpy and some written label must be positive;
15. the reference-checkpoint import: a reference-format model_best.pth of
   the planner's weights (and a dead buffer) through `python3 -m
   graspnerf_tpu_torch.convert`, the float32 planner's volume on the
   imported weights bit-equal to the original weights';
16. `ops.mesh.volume_to_mesh` on the planner's volume (host);
17. the gather's gradient with respect to xy (B'-xy, both instances), on
   no path (0 launches in every phase above): held against its plain
   version on random, the planner's and border-clamped coordinates, at
   ragged P and misaligned, through `torch.autograd.grad`, with inf and NaN
   upstream at invalid points; registers, spills and times;
18. training on a (data, space) mesh of ranks (`parallel`), at the full
   training shape: (a) `python3 -m graspnerf_tpu_torch.train.cli --mesh 1,1
   --dist-backend nccl` (world size 1) for a few steps against the same
   command without a mesh (losses and parameters; launches a step); (b)
   two gloo ranks on the one card (spawned processes, each joined with a
   timeout) at (2, 1) and (1, 2), float32 and bfloat16: one step each held
   to the one-process step on the same scenes (losses, the all-reduced
   gradients, every parameter bit-equal across the ranks), the ranks' step
   times beside the one-process step's, the launches a rank and step,
   each rank's peak memory, and which collectives gloo takes on CUDA
   tensors; (c) the command of (a) at `--mesh 1,2 --dist-backend gloo`,
   its two ranks on the one card, each batch loaded by the first and
   broadcast to the second (losses against the command without a mesh);
19. the fused InstanceNorm (csrc/instance_norm.cu, the encoders' norms with
   their activation, residual and the next convolution's reflect pad):
   62 launches a float32 planning call, a render and a forward, none in a
   train step, 62 a validation forward of the loop; held against the
   modules' chain at the encoders' four plane shapes (6 views of 288 x
   512) in each variant they call, within 1e-5 of each output's scale
   (the sum and the border bit-equal); its registers and spills; timed
   against the chain, cuDNN's norm alone and its byte bound.

`--profile` adds a torch.profiler breakdown of a planning call, of a
render and of a train step by stage and by op. It prints a `kernels` JSON
line, then as its last line
{"ok": true, "device": {...}}. Any failure raises and exits non-zero before
that. Without a CUDA device, or without the package beside it, it exits
non-zero at once.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

N_CALLS = 3            # planning calls on the counted main path
NORMS = 62             # InstanceNorms of one encode (the three encoders)
SEED = 0
VIEWS, HEIGHT, WIDTH, RES = 6, 288, 512, 40
RENDER_RAYS, RENDER_SAMPLES = 4096, 40
RENDER_ROWS = RENDER_RAYS * RENDER_SAMPLES   # a render pass's view-fuse rows
# the train step: configs/nrvgn_sdf.yaml's ray_num and depth_loss_coords_num,
# the synthetic dataset's grasps per scene (graspnerf_tpu/data/synthetic.py)
TRAIN_RAYS, DEPTH_COORDS, TRAIN_GRASPS = 512, 8192, 32
TRAIN_ROWS = TRAIN_RAYS * RENDER_SAMPLES     # a train pass's rows and points
TRAIN_STEPS = 5        # counted steps on the main path; then >= 10 timed
BF16_LOOP_LOG_EVERY = 3   # Trainer.run in bfloat16: two logged windows
# the loop: Trainer.run on the synthetic generator's scenes at the dataset's
# defaults (4 objects, 12 fusion views), through 4 data worker processes
LOOP_STEPS, LOOP_RESUMED_STEPS, LOOP_WORKERS = 12, 2, 4
LOOP_LOG_EVERY, LOOP_VAL_INTERVAL, LOOP_VAL_BATCHES, LOOP_SAVE = 4, 6, 2, 4
PIPELINE_BATCHES = 8   # timed after the workers' queues are drained
# the closed loop: clutter_removal.run on SimWorld("pile") at the shipped view
# size; cut in depth only, to 2 rounds of 3 objects (the JAX package's
# campaign ran 24 rounds of 4, data/simgrasp_r5)
CLOSED_LOOP_ROUNDS, CLOSED_LOOP_OBJECTS, CLOSED_LOOP_SEED = 2, 3, 0
# the dataset -> train phase: the port's writer at the shipped data shape
# (24 hemisphere views at 288 x 512, 40^3, 40 executed candidates a scene),
# cut in depth to 2 scenes (a dataset has thousands), then 12 steps of
# Trainer.run on them (a run has 500,000): the last 4 past the batches the
# workers queue at the start
GEN_SCENES, GEN_CANDIDATES, GEN_STEPS = 2, 40, 12
# the writer's seed: both of its scenes carry positive executed labels at
# this shape (the dataset line prints them; seed 0's have none), so that
# the rotation and width losses see written labels
GEN_SEED = 4
# the SDF output kernels scaled so that random weights leave the SDF inside
# (-1, 1) rather than clipped, and so carrying the whole chain's error
SDF_SCALE = 0.1
# Tolerances, kernel vs plain version, float32 on the card:
# - view fuse: the kernel sums 207-long dot products in another order (FMA,
#   base_fc.0's gf block in two partial sums), scales a layer's sums where
#   the plain version scales its inputs, and takes ELU's and sigmoid's exp
#   from the hardware exp (a few ulp), so outputs differ by float32 rounding
#   that grows through ten layers; num_valid is a count and must match
#   exactly.
FUSE_ATOL, FUSE_RTOL = 1e-4, 1e-4
# - gather: the kernel repeats the plain version's arithmetic op for op
#   (built with -fmad=false), but PyTorch may divide by a scalar as a
#   multiply by its reciprocal: one ulp in the normalised coordinate moves a
#   full-res sample by up to ~3e-5 px.
GATHER_ATOL = 1e-4
# - planner: both differences above pass through the geometry head.
PLANNER_ATOL = 1e-4
# - the closed loop: the kernel planner against the plain planner at every
#   planning call, the volume within PLANNER_ATOL and the candidate sets
#   identical but for candidates whose quality lies within
#   NEAR_THRESHOLD_ATOL of the threshold (the volume's differences can move
#   such a quality across it); the VGN baseline on the card against the same
#   call on the CPU: identical candidates, values within PLANNER_ATOL.
NEAR_THRESHOLD_ATOL = 1e-4
# - render: the gather's differences pass straight into the colours (a
#   convex blend of the gathered RGB) and, through the dist decoder and the
#   view fuse, into SDF, alpha (the SDF times inv_s = e^3 under a sigmoid)
#   and hit probabilities; the composite adds them up along each ray.
RENDER_ATOL = 2e-4
# - fine samples: the inverse CDF multiplies a difference in the coarse hit
#   probabilities by up to a bin's width over 1e-5 (sample_fine_depth's
#   guard), ~2.5e3 in normalised inverse depth at 40 samples; so the fine
#   pass is compared at the kernel model's own samples, and the samples
#   here, in metres.
FINE_DEPTH_ATOL = 1e-3
# - train: the losses and each parameter's gradient, kernels vs plain
#   versions, same draws, the fine pass at equal samples. The gather's
#   differences above pass into every loss; the gradients also carry the
#   backward kernel's sums in another order through ~40 layers back to the
#   encoders. Per parameter, max |kernel - plain| <= TRAIN_GRAD_RTOL x its
#   largest |gradient|; below GRAD_FLOOR a gradient is mathematically zero
#   (conv biases before InstanceNorm, the colour blend's last bias) and
#   only rounding noise. The CPU test holds the port to JAX at 1e-2.
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_RTOL, GRAD_FLOOR = 2e-2, 1e-7
# - train in bfloat16, kernel model vs plain model (same weights, draws and
#   fine samples): the bfloat16 forward kernels differ from their plain
#   versions by a bfloat16 ulp here and there (above), and each such
#   difference moves every layer after it by bfloat16 roundings, forward
#   and back; where it flips the sign of a ray's last-sample dir . ∇sdf
#   (LAST_FLIP_SHARE) that ray's alpha, and so its gradients, change
#   outright. Each loss within TRAIN_BF16_LOSS_RTOL of the plain model's
#   (2.3e-3 measured, vgn_rot_loss: the rotation normalises a raw
#   4-vector, as HEAD_BF16_RTOL says); each parameter's gradient within
#   TRAIN_BF16_GRAD_RTOL of its scale (0.12-0.157 measured over the runs,
#   the grasp head's first convolution, which reads the two models'
#   volumes, VOL_BF16_MAX apart, under that normalisation) and their
#   median within TRAIN_BF16_GRAD_MEDIAN (1.06e-2 to 1.1e-2 measured), on
#   an H100 80GB HBM3 at 700 W. Below TRAIN_BF16_GRAD_FLOOR
#   a gradient is bfloat16 rounding noise on a mathematically zero one
#   (the conv biases before InstanceNorm measured ~1e-6). The float32
#   model of the same weights, at the same fine samples, is printed beside
#   it: how far bfloat16 itself moves each loss and gradient.
TRAIN_BF16_LOSS_RTOL, TRAIN_BF16_GRAD_RTOL = 1e-2, 2.5e-1
TRAIN_BF16_GRAD_MEDIAN, TRAIN_BF16_GRAD_FLOOR = 3e-2, 1e-5
# - gather backward vs autograd through the plain version: on the card, the
#   forward's weights differ by the division's rounding (up to ~3e-5 of a
#   full-res pixel per weight, summed over a cell's contributions); on the
#   CPU the weights are bit-equal and only the sum order differs (the
#   kernel's fixed order against autograd's; d_imgs's atomics), so there
#   each map cell is held to BWD_SUM_RTOL of the sum of the absolute values
#   of its contributions. Two launches on the same inputs give bit-equal
#   maps' gradients (d_imgs, scalar atomics on no path, is not compared).
BWD_ATOL, BWD_RTOL, BWD_SUM_RTOL = 5e-4, 1e-5, 1e-4
# - gather backward in bfloat16 (B'-bf16) vs the plain bfloat16 backward, on
#   the card and the CPU: both compute the same float32 tap weights (IEEE
#   division on both sides) and round the same contributions to bfloat16;
#   a cell's float32 sum of them runs in another order (the plain version
#   adds with index_add_, atomics on the card), which is exact unless the
#   contributions span more than float32's 24 bits, and then the cell can
#   round one bfloat16 ulp apart: at most BWD_BF16_SHARE of the values may
#   differ, each by at most one bfloat16 ulp of its cell's sum of
#   |contributions|; NaN exactly where the plain version has it.
BWD_BF16_SHARE = 1e-3
# - the gather's gradient with respect to xy (B'-xy) vs its plain version
#   on the card, both instances: the same taps and weights (IEEE division
#   on both sides) and tap differences, but the kernel contracts each
#   product into its sum (FMA) and each point's sum over its 2 C + 3
#   channels runs in another order (the warp's shuffle tree against
#   PyTorch's reductions), so max |kernel - plain| <= XY_RTOL x the largest
#   |d_xy|; along an axis clamped at the border exactly 0; NaN exactly where
#   the plain version has it.
XY_RTOL = 1e-5
# bfloat16, kernel vs plain version on the card (the same model weights):
# - view fuse: both round the same float32 values to bfloat16 at the same
#   places, but sum in another order, so an operand can round one bfloat16
#   ulp (2^-8 relative) apart and move the layers after it: num_valid
#   exact, feat_const, x and vis within FUSE_BF16_RTOL of each output's
#   largest magnitude.
FUSE_BF16_RTOL = 1e-2
# - gather: the float32 blend rounded to bfloat16, so within one bfloat16
#   ulp of each value, or GATHER_ATOL where the float32 blends differ by
#   PyTorch's division (near 0 an ulp is smaller than that); bit-equal to
#   the plain version on the CPU.
# - the bfloat16 planner and render, kernel model vs plain model: the volume
#   within VOL_BF16_MAX (max) and VOL_BF16_MEAN (mean abs); the grasp
#   heads, on each model's own volume, within HEAD_BF16_RTOL of each head's
#   largest magnitude (in the planner and the render's forward); every other
#   render output within RENDER_BF16_ATOL, the fine pass at the kernel
#   model's fine samples.
#   The rotation is a raw 4-vector normalised, which magnifies the
#   volume's differences where that vector is short (0.045 on an H100 80GB
#   HBM3 at 700 W with these weights, where qual differed by 4e-4 and the
#   width by 0.031).
#   A ray's last-sample alpha is a step in the sign of dir . ∇sdf
#   (compare_outputs): at most LAST_FLIP_SHARE of the rays may flip (3 of
#   4,096 in the coarse pass there).
VOL_BF16_MAX, VOL_BF16_MEAN = 0.05, 0.005
HEAD_BF16_RTOL = 1e-1
RENDER_BF16_ATOL = 5e-2
LAST_FLIP_SHARE = 5e-3
# the parallel phase: (a) train.cli at world size 1 under NCCL against the
# same command without a mesh, PAR_NCCL_STEPS steps at full width; bit-
# equality is expected (one process, the same batches, an all-reduce over
# one rank), but the plain index_add_ and cuDNN's backward may add in
# another order between two runs, and Adam turns an ulp in a near-zero
# gradient into up to 2 x lr a step: the losses are held at
# TRAIN_LOSS_RTOL, the parameters at PAR_NCCL_ATOL, and the distance
# printed. (b) two gloo ranks on the one card, one step of each case
# (dtype, axis, mesh) against the one-process step on the same scenes, the
# fine pass at its samples: the losses at JAX's bounds for its sharded
# step (tests/test_training.py:106), the all-reduced gradients at the train
# phases' tolerances (TRAIN_GRAD_RTOL, TRAIN_BF16_GRAD_RTOL), then
# PAR_TIMED timed steps; every rank is joined within PAR_TIMEOUT seconds.
PAR_NCCL_STEPS, PAR_NCCL_ATOL = 3, 1e-3
PAR_LOSS_RTOL, PAR_LOSS_ATOL = 2e-3, 2e-4
PAR_CASES = (("float32", "data", (2, 1)), ("float32", "space", (1, 2)),
             ("bfloat16", "data", (2, 1)), ("bfloat16", "space", (1, 2)))
PAR_TIMED, PAR_TIMEOUT = 5, 300
BF16 = torch.bfloat16
# H100 SXM peaks (NVIDIA data sheet): float32 on the CUDA cores, bfloat16 on
# the tensor cores (dense), HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def log(*args):
    print(*args, flush=True)


def max_err(a, b):
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def cuda_time(fn, iters=20, warmup=3):
    """Mean ms per call over `iters` back-to-back calls, CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_time(fn, iters=200):
    """Mean host ms per call of `fn` over `iters` calls, no synchronisation
    inside: the time the caller's thread spends enqueueing."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return ms


def check(cond, what):
    if not cond:
        raise AssertionError(what)


# ------------------------------------------------------------------ inputs
def fuse_weights(gen, dev):
    from graspnerf_tpu_torch.ops.view_fuse import LAYER_DIMS
    return [((torch.randn(o, i, generator=gen) / math.sqrt(i)).to(dev),
             (0.1 * torch.randn(o, generator=gen)).to(dev))
            for i, o in LAYER_DIMS]


def fuse_inputs(gen, n, dev):
    rgbf = torch.rand(VIEWS, n, 35, generator=gen)
    neur = torch.rand(VIEWS, n, 32, generator=gen)
    rdiff = torch.rand(VIEWS, n, 4, generator=gen) - 0.5
    mask = (torch.rand(VIEWS, n, 1, generator=gen) > 0.3).float()
    mask[:, :7] = 0.0      # rows seen by no view
    mask[1:, 7:13] = 0.0   # rows seen by one view
    return [t.to(dev) for t in (rgbf, neur, rdiff, mask)]


def gather_inputs(gen, dev, P=RES ** 3):
    imgs = torch.rand(VIEWS, HEIGHT, WIDTH, 3, generator=gen)
    f1 = torch.randn(VIEWS, HEIGHT // 4, WIDTH // 4, 32, generator=gen)
    f2 = torch.randn(VIEWS, HEIGHT // 4, WIDTH // 4, 32, generator=gen)
    x = torch.rand(VIEWS, P, generator=gen) * (WIDTH + 40) - 20
    y = torch.rand(VIEWS, P, generator=gen) * (HEIGHT + 40) - 20
    xy = torch.stack([x, y], -1)
    # exact borders, pixel centres, the validity bounds and points past them
    k = min(P, 8)
    xy[:, :k] = torch.tensor([
        [-0.5, -0.5], [0.0, 0.0], [WIDTH - 1, HEIGHT - 1],
        [WIDTH - 0.5, HEIGHT - 0.5], [WIDTH - 1, 0.0], [0.0, HEIGHT - 1],
        [WIDTH + 7.25, -9.5], [-30.0, HEIGHT + 30.0]])[:k]
    valid = torch.rand(VIEWS, P, generator=gen) > 0.1
    valid[:, :k] = True
    return [t.to(dev) for t in (imgs, f1, f2, xy, valid)]


def shifted(t):
    """The same values one element past a 16-byte boundary."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    return out[1:].view_as(t).copy_(t)


# ----------------------------------------------------------------- phases
def fuse_bound(n):
    """Least time of the view fuse over n rows: its multiply-adds (the gf
    block of base_fc.0 once per row) at the float32 rate, or its bytes."""
    from graspnerf_tpu_torch.ops.view_fuse import LAYER_DIMS
    macs = n * (VIEWS * sum(i * o for i, o in LAYER_DIMS) - 5 * 140 * 64)
    nbytes = 4 * (VIEWS * n * (35 + 32 + 4 + 1) + sum(
        i * o + o for i, o in LAYER_DIMS) + n * 66 + VIEWS * n * 33)
    return bound(2 * macs / PEAK_F32_FLOPS, nbytes / PEAK_BYTES)


def check_view_fuse(dev, gen, render_args):
    """render_args: the view fuse's arguments in the render's coarse pass."""
    from graspnerf_tpu_torch.ops import view_fuse as vf
    from graspnerf_tpu_torch.ops.view_fuse import view_fuse, view_fuse_plain
    weights = fuse_weights(gen, dev)

    # the weight-pack guard: the library states the pack size it reads
    lib = vf.library()
    n_pack = vf.pack_weights(weights).numel()
    vf.check_pack(lib, n_pack)
    try:
        vf.check_pack(lib, n_pack + 4)
        refused = False
    except RuntimeError:
        refused = True
    check(refused, "view_fuse: a weight pack of the wrong size was taken")
    tile = lib.view_fuse_tile_rows()
    log(f"view_fuse: the kernel reads a {lib.view_fuse_pack_floats()}-float "
        f"pack = pack_weights' {n_pack}; {n_pack + 4} is refused; tiles of "
        f"{tile} rows")

    def compare(name, ins, w):
        got = view_fuse(*ins, w)
        torch.cuda.synchronize()
        want = view_fuse_plain(*ins, w)
        check(torch.equal(got[1], want[1]), f"view_fuse num_valid {name}")
        for what, i in (("feat_const", 0), ("x", 2), ("vis", 3)):
            g, p = got[i], want[i]
            check(bool(torch.isfinite(g).all()), f"view_fuse {what} finite")
            check(torch.allclose(g, p, atol=FUSE_ATOL, rtol=FUSE_RTOL),
                  f"view_fuse {what} {name}: max err {max_err(g, p)}")
        err = max(max_err(g, p) for g, p in zip(got, want))
        log(f"view_fuse {name}: max_abs_err {err:.3e} (atol {FUSE_ATOL}, "
            f"rtol {FUSE_RTOL}; num_valid exact)")
        return err

    errs = {}
    for n in (1, tile - 1, tile + 1, 1000, RES ** 3, "1000 shifted"):
        ins = fuse_inputs(gen, 1000 if n == "1000 shifted" else n, dev)
        if n == "1000 shifted":   # takes the kernel's float-by-float loads
            ins = [shifted(t) for t in ins]
        errs[n] = compare(f"N={n}", ins, weights)
    render = f"render N={RENDER_ROWS}"
    # the model's weights, out of autograd: no graph kept for a backward
    render_args = (*render_args[:4],
                   [(a.detach(), b.detach()) for a, b in render_args[4]])
    errs[render] = compare(render + " (the coarse pass's inputs)",
                           render_args[:4], render_args[4])

    # backward: autograd through the kernel's Function == through the plain
    ins = [t.requires_grad_() for t in fuse_inputs(gen, 256, dev)[:3]]
    mask = fuse_inputs(gen, 256, dev)[3]
    w = [(a.clone().requires_grad_(), b.clone().requires_grad_())
         for a, b in weights]
    cot = [torch.randn(s, generator=gen).to(dev)
           for s in ((256, 65), (256, 1), (VIEWS, 256, 32), (VIEWS, 256, 1))]
    leaves = ins + [t for p in w for t in p]
    grads = []
    for fn in (view_fuse, view_fuse_plain):
        out = fn(*ins, mask, w)
        loss = sum((o * c).sum() for o, c in zip(out, cot))
        grads.append(torch.autograd.grad(loss, leaves))
    bwd_err = max(max_err(a, b) for a, b in zip(*grads))
    for a, b in zip(*grads):
        check(torch.allclose(a, b, atol=FUSE_ATOL, rtol=FUSE_RTOL),
              f"view_fuse backward: max err {max_err(a, b)}")
    log(f"view_fuse backward N=256: max_abs_err {bwd_err:.3e} "
        f"(atol {FUSE_ATOL}, rtol {FUSE_RTOL})")

    times = {}
    for n in (RES ** 3, RENDER_ROWS, render):
        if n == render:
            ins, w = render_args[:4], render_args[4]
        else:
            ins, w = fuse_inputs(gen, n, dev), weights
        times[n] = {"ms": cuda_time(lambda: view_fuse(*ins, w)),
                    "plain_ms": cuda_time(lambda: view_fuse_plain(*ins, w)),
                    **fuse_bound(ins[0].shape[1])}
        del ins
    for n in (RENDER_ROWS, render):
        log(f"view_fuse, {'random' if n == RENDER_ROWS else 'render'} inputs "
            f"at the render pass's N={RENDER_ROWS}: " + json.dumps(times[n]))
    return {"name": "view_fuse", "route": "cuda",
            "source": "graspnerf_tpu_torch/csrc/view_fuse.cu",
            "replaces": "graspnerf_tpu/ops/pallas/ibrnet_fuse.py:115",
            "max_abs_err": errs[RES ** 3], "library_ms": None,
            **times[RES ** 3], "render_ms": times[render]["ms"],
            "render_plain_ms": times[render]["plain_ms"],
            "render_bound_ms": times[render]["bound_ms"],
            "render_max_abs_err": errs[render]}


def check_instance_norm(dev, launches, render, train, loop):
    """The fused InstanceNorm against the modules' chain at the encoders'
    four plane shapes, in each variant the encoders call (checked within
    1e-5 of each output's scale, the sum and the border bit-equal, by
    tools/instance_norm_timing.py), timed against the chain and against
    cuDNN's norm alone (`F.instance_norm`, the chain's first op: its
    `library_ms`). launches: the planner's N_CALLS calls; render, train,
    loop: those phases' results. Returns its `kernels` row, headed by the
    first norm's shape (6 x 32 x 144 x 256, bn1)."""
    from graspnerf_tpu_torch.ops.instance_norm import kernel_info
    from graspnerf_tpu_torch.tools import instance_norm_timing as timing
    rows = timing.time_variants(dev)
    info = kernel_info()
    log(f"instance_norm_act: the kernel as built {json.dumps(info)}")
    head = next(r for r in rows if r["variant"] == "bn1")
    return {"name": "instance_norm_act", "route": "cuda",
            "source": "graspnerf_tpu_torch/csrc/instance_norm.cu",
            "replaces": "none: XLA fuses the norms of "
                        "graspnerf_tpu/models/nn_blocks.py",
            "launches": launches["instance_norm_act"],
            "launches_per_call": launches["instance_norm_act"] // N_CALLS,
            "max_abs_err": max(r["abs_err"] for r in rows),
            "max_rel_err": max(r["rel_err"] for r in rows),
            "ms": head["kernel_ms"], "plain_ms": head["chain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": "bytes",
            "library_ms": head["library_ms"],
            "render_launches": render["norm_launches"]["render"],
            "forward_launches": render["norm_launches"]["forward"],
            "train_launches": train["norm_launches"],
            "train_steps": train["steps"],
            "loop_launches": loop["norm_launches"],
            "loop_steps": loop["steps"], **info,
            "shapes": [{k: r[k] for k in (
                "shape", "variant", "kernel_ms", "chain_ms", "library_ms",
                "bound_ms", "roofline_pct", "rel_err")} for r in rows]}


def planner_gather_inputs(planner, scene):
    """The gather's inputs on the main path: the scene's images, the maps
    from `encode`, and the volume grid projected into the views."""
    from graspnerf_tpu_torch.tools.scene import volume_coords
    ref = planner.scene(*scene)
    img_feats, ray_feats = planner.encode(ref["imgs"])
    xy, valid = volume_coords(ref["poses"], ref["Ks"], HEIGHT, WIDTH, RES)
    return [ref["imgs"], img_feats, ray_feats, xy, valid]


def gather_library(args):
    """Yardstick, which the port never calls: three F.grid_sample calls on
    NCHW maps, the grids normalised beforehand."""
    import torch.nn.functional as F
    imgs, f1, f2, xy, _ = args
    maps = [m.permute(0, 3, 1, 2).contiguous() for m in (imgs, f1, f2)]
    g = torch.stack([xy[..., 0] / (WIDTH - 1) * 2 - 1,
                     xy[..., 1] / (HEIGHT - 1) * 2 - 1], -1)[:, None]
    g = g.to(imgs.dtype)
    return lambda: [F.grid_sample(m, g, mode="bilinear", padding_mode="border",
                                  align_corners=(i == 0))
                    for i, m in enumerate(maps)]


def gather_outputs(args, dev, shift=False):
    """rgb_feats in the maps' dtype, ray_feats float32."""
    V, P = args[3].shape[:2]
    C = args[1].shape[3]
    return [torch.empty(V * P * c + shift, dtype=d, device=dev)[
        int(shift):].view(V, P, c)
        for c, d in ((3 + C, args[1].dtype), (C, torch.float32))]


def gather_bound(args, outs):
    """Least time of the gather: each input read and each output written
    once, or its multiply-adds (4 taps x (mul + add) per channel) at the
    peak rate of the maps' type."""
    nbytes = sum(t.numel() * t.element_size() for t in (*args, *outs))
    P = args[3].shape[1]
    flops = VIEWS * P * (3 + 2 * 32) * 4 * 2
    peak = PEAK_BF16_FLOPS if args[1].dtype == BF16 else PEAK_F32_FLOPS
    return bound(flops / peak, nbytes / PEAK_BYTES)


def check_gather(dev, gen, planner, scene, render_args):
    """render_args: the gather's arguments in the render's coarse pass."""
    from graspnerf_tpu_torch.ops import epipolar_gather as eg
    block = eg.library().epipolar_gather_points_per_block()
    vol, render = f"random P={RES ** 3}", f"random P={RENDER_ROWS}"
    planned, rendered = f"planner P={RES ** 3}", f"render P={RENDER_ROWS}"
    cases = {vol: gather_inputs(gen, dev), planned: planner_gather_inputs(
        planner, scene), render: gather_inputs(gen, dev, RENDER_ROWS),
        rendered: list(render_args)}
    for P in (1, block - 1, block + 1):
        cases[f"random P={P}"] = gather_inputs(gen, dev, P)
    # the maps, coordinates and outputs one float off 16 bytes: the kernel's
    # float-by-float path and the stage's shifted slab
    cases["random P=1000 shifted"] = [
        shifted(t) for t in gather_inputs(gen, dev, 1000)]
    errs = {}
    for name, args in cases.items():
        if name.endswith("shifted"):
            got = eg.launcher(*args, *gather_outputs(args, dev, True))()
        else:
            got = eg.epipolar_gather(*args)
        torch.cuda.synchronize()
        want = eg.epipolar_gather_plain(*args)
        # the plain version on the CPU divides exactly as the kernel does
        cpu = eg.epipolar_gather_plain(*[t.cpu() for t in args])
        valid = args[4]
        for g, w, c, what in zip(got, want, cpu, ("rgb_feats", "ray_feats")):
            check(torch.allclose(g, w, atol=GATHER_ATOL, rtol=0),
                  f"gather {what} {name}: max err {max_err(g, w)}")
            check(torch.equal(g.cpu(), c), f"gather {what} {name}: not "
                  f"bit-equal to the plain version on the CPU "
                  f"(max err {max_err(g.cpu(), c)})")
            check(bool((g[~valid] == 0).all()),
                  f"gather {what} {name}: invalid points not 0")
        errs[name] = max(max_err(g, w) for g, w in zip(got, want))
        log(f"epipolar_gather {name}: max_abs_err {errs[name]:.3e} vs the "
            f"plain version on the card (atol {GATHER_ATOL}), bit-equal to it "
            f"on the CPU, invalid points 0; "
            f"{float(valid.float().mean()):.3f} of the points valid")

    times = {}
    for name in (vol, planned, render, rendered):
        args = cases[name]
        outs = gather_outputs(args, dev)
        times[name] = {
            "ms": cuda_time(lambda: eg.epipolar_gather(*args)),
            "kernel_ms": cuda_time(eg.launcher(*args, *outs)),
            "host_ms": host_time(lambda: eg.epipolar_gather(*args)),
            "plain_ms": cuda_time(lambda: eg.epipolar_gather_plain(*args)),
            "library_ms": cuda_time(gather_library(args)),
            **gather_bound(args, outs)}
        log(f"epipolar_gather {name} (ms: the wrapper; kernel_ms: the bare "
            f"launch into preallocated outputs; host_ms: the wrapper's host "
            f"time per call): {json.dumps(times[name])}")
    return {"name": "epipolar_gather", "route": "cuda",
            "source": "graspnerf_tpu_torch/csrc/epipolar_gather.cu",
            "replaces": "graspnerf_tpu/ops/fused_gather.py:233",
            "max_abs_err": errs[vol], **times[vol],
            "planner_ms": times[planned]["ms"],
            "planner_kernel_ms": times[planned]["kernel_ms"],
            "render_ms": times[rendered]["ms"],
            "render_kernel_ms": times[rendered]["kernel_ms"],
            "render_plain_ms": times[rendered]["plain_ms"],
            "render_library_ms": times[rendered]["library_ms"],
            "render_bound_ms": times[rendered]["bound_ms"],
            "render_max_abs_err": errs[rendered]}


def bound(ops_s, bytes_s):
    return {"bound_ms": 1e3 * max(ops_s, bytes_s),
            "bound_by": "operations" if ops_s > bytes_s else "bytes"}


def cand_set(cand):
    keep = cand.scores > 0
    return {tuple(i): (s, r, w) for i, s, r, w in zip(
        cand.indices[keep].tolist(), cand.scores[keep].tolist(),
        cand.rotations[keep].tolist(), cand.widths[keep].tolist())}


def cand_err(ck, cp):
    """Largest difference of score, rotation and width over the candidates
    of `ck` (cand_set) that `cp` has too."""
    return max((abs(a - b) for key in set(ck) & set(cp) for a, b in zip(
        [ck[key][0], *ck[key][1], ck[key][2]],
        [cp[key][0], *cp[key][1], cp[key][2]])), default=0.0)


def planner_params():
    """The planners' seeded weights at the shipped widths (widths inside
    process()'s window, so that random weights leave candidates)."""
    from graspnerf_tpu_torch.sim.cli import seeded_params
    return seeded_params({}, SEED)


def pick_threshold(planner, inputs, what="planner"):
    """The quality threshold of `planner` on this scene: at the widest gap
    between consecutive quality peaks among the best 4..48, so that the
    candidate set has a margin on both sides and top-k's max_candidates
    cuts nothing."""
    from graspnerf_tpu_torch.detect.postprocess import nms, process
    ref = planner.scene(*inputs)
    vol, (qual, rot, width), _ = planner.volume(
        ref, *planner.encode(ref["imgs"]))
    return threshold_of(nms(process(vol, qual[0, ..., 0], width[0, ..., 0]),
                            0.0), what)


def threshold_of(peaks, what):
    """pick_threshold's choice on a volume of quality peaks (NMS at 0)."""
    top = torch.sort(peaks[peaks > 0], descending=True).values.tolist()
    check(len(top) > 4, f"{what}: only {len(top)} quality peaks")
    k = max(range(4, min(48, len(top) - 1) + 1),
            key=lambda i: top[i - 1] - top[i])
    thr = (top[k - 1] + top[k]) / 2
    log(f"{what}: qual_threshold {thr:.6f}: {k} of {len(top)} quality "
        f"peaks pass, gap to the next {top[k - 1] - top[k]:.3e}")
    return thr


def run_planner(dev):
    from graspnerf_tpu_torch.detect.planner import GraspNeRFPlanner
    from graspnerf_tpu_torch.ops.epipolar_gather import epipolar_gather
    from graspnerf_tpu_torch.ops.instance_norm import instance_norm_act
    from graspnerf_tpu_torch.ops.view_fuse import view_fuse
    from graspnerf_tpu_torch.tools.scene import synthetic_views

    sd = planner_params()
    images, poses, Ks, dr = synthetic_views(
        np.random.RandomState(SEED), VIEWS, HEIGHT, WIDTH)
    kern = GraspNeRFPlanner(sd, device=dev)
    plain = GraspNeRFPlanner(sd, device=dev, use_kernels=False)
    thr = pick_threshold(kern, (images, poses, Ks, dr))
    kern.qual_threshold = plain.qual_threshold = thr

    view_fuse.launches = epipolar_gather.launches = 0
    instance_norm_act.launches = 0
    wall = []
    for _ in range(N_CALLS):
        vol_k, cand_k, dt = kern.core(images, poses, Ks, dr)
        wall.append(dt)
    launches = {"view_fuse": view_fuse.launches,
                "epipolar_gather": epipolar_gather.launches,
                "instance_norm_act": instance_norm_act.launches}
    log(f"planner: {N_CALLS} calls, core() seconds {wall}, launches {launches}")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the main path")
    check(launches["instance_norm_act"] == NORMS * N_CALLS,
          f"planner: {launches['instance_norm_act']} fused norms in "
          f"{N_CALLS} calls, not {NORMS} a call")

    vol_p, cand_p, _ = plain.core(images, poses, Ks, dr)
    check(vol_k.shape == (RES,) * 3 and bool(torch.isfinite(vol_k).all()),
          "volume shape / finite")
    e_vol = max_err(vol_k, vol_p)
    check(e_vol <= PLANNER_ATOL, f"volume vs plain: {e_vol}")
    with torch.no_grad():
        heads_k = kern.model.vgn_net(vol_k[None, ..., None])
        heads_p = plain.model.vgn_net(vol_p[None, ..., None])
    e_heads = [max_err(a, b) for a, b in zip(heads_k, heads_p)]
    check(max(e_heads) <= PLANNER_ATOL, f"qual/rot/width vs plain: {e_heads}")
    ck, cp = cand_set(cand_k), cand_set(cand_p)
    check(len(ck) > 0, "no candidates")
    check(sorted(ck) == sorted(cp), f"candidate sets differ: {sorted(ck)} "
          f"vs {sorted(cp)}")
    e_cand = cand_err(ck, cp)
    check(e_cand <= PLANNER_ATOL, f"candidate values vs plain: {e_cand}")
    log(f"planner vs plain versions (atol {PLANNER_ATOL}): volume {e_vol:.3e}, "
        f"qual/rot/width "
        f"{[f'{e:.3e}' for e in e_heads]}, {len(ck)} candidates identical "
        f"(values {e_cand:.3e}); sdf range [{float(vol_k.min()):.3f}, "
        f"{float(vol_k.max()):.3f}]")
    return kern, launches, (images, poses, Ks, dr)


class AttemptClock:
    """Seconds per grasp attempt of the closed loop, by part: render (host:
    the six eval views and the six depth views of the TSDF), tsdf (the
    fusion on the card, acquire_tsdf's own time), planning (core() of the
    kernel planner), execution (host: the gripper state machine and the
    re-settle). attempt is the wall time from the attempt's first render to
    the end of its execution, less `check` (the plain planner run beside it
    and the comparisons)."""

    PARTS = ("render_s", "tsdf_s", "planning_s", "execution_s", "attempt_s")

    def __init__(self):
        self.cur, self.done = None, []

    def begin(self):
        if self.cur is None:
            self.cur = dict.fromkeys(self.PARTS[:-1] + ("check_s",), 0.0)
            self.cur["t0"] = time.perf_counter()

    def add(self, part, seconds):
        self.begin()
        self.cur[part] += seconds

    def timed(self, part, fn):
        def call(*args, **kw):
            self.begin()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                self.add(part, time.perf_counter() - t0)
        return call

    def close(self, executed=True):
        if self.cur is not None:
            cur = self.cur
            cur["attempt_s"] = (time.perf_counter() - cur.pop("t0")
                                - cur["check_s"])
            if executed:
                self.done.append(cur)
            self.cur = None

    def summary(self):
        """{part: [median, min, max]} over the executed attempts."""
        return {k: [float(np.median(v)), min(v), max(v)] for k, v in (
            (k, [a[k] for a in self.done]) for k in self.PARTS)}


def compare_near_threshold(cand_k, cand_p, thr):
    """The kernel planner's candidates against the plain planner's: the same
    set but for those within NEAR_THRESHOLD_ATOL of the threshold `thr`, the
    values of the common ones within PLANNER_ATOL. Returns (candidates,
    near-threshold candidates, largest value error)."""
    ck, cp = cand_set(cand_k), cand_set(cand_p)
    near = {key for c in (ck, cp) for key, v in c.items()
            if abs(v[0] - thr) <= NEAR_THRESHOLD_ATOL}
    check(sorted(set(ck) - near) == sorted(set(cp) - near),
          f"candidate sets differ beyond the threshold's margin: "
          f"{sorted(set(ck) ^ set(cp))}")
    err = cand_err(ck, cp)
    check(err <= PLANNER_ATOL, f"candidate values vs plain: {err}")
    return len(ck), len(near), err


def run_closed_loop(dev, sd):
    """clutter_removal.run, the port's closed loop, on SimWorld("pile") at
    HEIGHT x WIDTH with the float32 planner through the kernels, its
    threshold picked at each planning call on that call's views as
    pick_threshold does (by the plain planner: random weights leave no
    threshold that suits every scene); the plain planner beside it at
    every planning call; then one VGN baseline call on the card against
    the CPU."""
    import tempfile
    from graspnerf_tpu_torch.data import native
    from graspnerf_tpu_torch.detect.planner import GraspNeRFPlanner
    from graspnerf_tpu_torch.sim import clutter_removal
    from graspnerf_tpu_torch.sim import objects as sim_objects
    from graspnerf_tpu_torch.sim.world import SimWorld

    check(native.available(), "the native ray tracer did not build")
    kern = GraspNeRFPlanner(sd, device=dev)
    plain = GraspNeRFPlanner(sd, device=dev, use_kernels=False)
    world = SimWorld("pile", rng=np.random.RandomState(CLOSED_LOOP_SEED),
                     device=dev)
    clock, calls = AttemptClock(), []
    kern_core, plain_core = kern.core, plain.core

    def core(images, extrinsics, Ks, depth_range, *args):
        inputs = (images, extrinsics, Ks, depth_range)
        t0 = time.perf_counter()
        # the plain planner's pick: no kernel launch is counted
        kern.qual_threshold = plain.qual_threshold = pick_threshold(
            plain, inputs, f"closed loop call {len(calls)}")
        check_s = time.perf_counter() - t0
        vol_k, cand_k, dt = kern_core(*inputs, *args)
        clock.add("planning_s", dt)
        t0 = time.perf_counter()
        vol_p, cand_p, _ = plain_core(*inputs, *args)
        check(vol_k.shape == (RES,) * 3 and bool(torch.isfinite(vol_k).all()),
              "closed loop: volume shape / finite")
        e_vol = max_err(vol_k, vol_p)
        check(e_vol <= PLANNER_ATOL, f"closed loop: volume vs plain {e_vol}")
        n, n_near, e_cand = compare_near_threshold(cand_k, cand_p,
                                                   kern.qual_threshold)
        calls.append({"volume_err": e_vol, "candidates": n,
                      "near_threshold": n_near, "candidate_err": e_cand})
        clock.add("check_s", check_s + time.perf_counter() - t0)
        if n == 0:      # the round ends without a grasp
            clock.close(executed=False)
        return vol_k, cand_k, dt

    kern.core = core
    world.observe = clock.timed("render_s", world.observe)
    world.sim.observe = clock.timed("render_s", world.sim.observe)
    acquire = world.acquire_tsdf

    def acquire_tsdf(*args, **kw):
        tsdf, t_int = acquire(*args, **kw)
        clock.add("tsdf_s", t_int)
        return tsdf, t_int
    world.acquire_tsdf = acquire_tsdf
    execute = clock.timed("execution_s", world.execute_grasp)

    def execute_grasp(*args, **kw):
        out = execute(*args, **kw)
        clock.close()
        return out
    world.execute_grasp = execute_grasp
    reset = world.reset

    def reset_world(*args, **kw):
        clock.close(executed=False)
        return reset(*args, **kw)
    world.reset = reset_world

    logdir = tempfile.mkdtemp(prefix="closed_loop_")
    sim_objects.TRACES.update(native=0, numpy=0)
    zero_counts()
    t0 = time.time()
    metrics = clutter_removal.run(
        kern, logdir, n_rounds=CLOSED_LOOP_ROUNDS,
        n_objects=CLOSED_LOOP_OBJECTS, h=HEIGHT, w=WIDTH,
        seed=CLOSED_LOOP_SEED, world=world)
    wall = time.time() - t0
    launches = counts()
    errors = os.path.join(logdir, "errors.log")
    if os.path.exists(errors):
        with open(errors) as f:
            raise AssertionError("closed loop: a round raised:\n" + f.read())
    with open(os.path.join(logdir, "rounds.csv")) as f:
        n_rounds = len(f.read().splitlines()) - 1
    check(n_rounds == CLOSED_LOOP_ROUNDS == metrics["n_rounds"],
          f"closed loop: {n_rounds} rounds logged")
    check(metrics["n_grasps"] >= 1, "closed loop: no grasp executed")
    check(len(clock.done) == metrics["n_grasps"],
          f"closed loop: {len(clock.done)} attempts timed, "
          f"{metrics['n_grasps']} logged")
    check(sim_objects.TRACES["numpy"] == 0 and sim_objects.TRACES["native"],
          f"closed loop: rays traced {sim_objects.TRACES}")
    n = len(calls)
    check(launches["view_fuse"] == launches["epipolar_gather"] == n
          and launches["epipolar_gather_backward"] == 0
          and not any(bf16_counts()[0].values()),
          f"closed loop: launches {launches} in {n} planning calls, "
          f"expected 1 view fuse and 1 gather (float32) a call")
    log(f"closed loop: SimWorld('pile') {CLOSED_LOOP_ROUNDS} rounds x "
        f"{CLOSED_LOOP_OBJECTS} objects (depth cut from the JAX campaign's "
        f"24 rounds), {VIEWS} x {HEIGHT} x {WIDTH} views, {RES}^3, "
        f"{n} planning calls, {metrics['n_grasps']} grasps, {wall:.1f} s; "
        f"launches {launches} (view fuse and gather once a call); rays "
        f"traced {sim_objects.TRACES}; no round error")
    log(f"closed loop vs plain planner (atol {PLANNER_ATOL}): volume "
        f"{max(c['volume_err'] for c in calls):.3e}, candidates "
        f"{[c['candidates'] for c in calls]} a call, identical but for "
        f"{sum(c['near_threshold'] for c in calls)} within "
        f"{NEAR_THRESHOLD_ATOL} of the threshold, values "
        f"{max(c['candidate_err'] for c in calls):.3e}")
    times = clock.summary()
    log("closed loop seconds per grasp attempt (median, min, max of "
        f"{len(clock.done)}): " + json.dumps(times))
    log("closed loop metrics (random weights: the success rate means "
        "nothing): " + json.dumps(metrics))
    vgn = run_vgn(dev, sd, world)
    return {"launches": launches, "calls": n, "attempts": len(clock.done),
            "times": times, "metrics": metrics, "vgn": vgn}


def run_vgn(dev, sd, world):
    """One VGNPlanner call on the simulator's depth views (a fresh scene,
    the six hemisphere views of acquire_tsdf at HEIGHT x WIDTH), on the
    card and on the CPU: identical candidates."""
    from graspnerf_tpu_torch.data.synthetic import (BBOX_MIN,
                                                    hemisphere_poses,
                                                    intrinsics)
    from graspnerf_tpu_torch.detect.postprocess import nms, process
    from graspnerf_tpu_torch.detect.vgn_baseline import (
        TSDF_THRES_HIGH, TSDF_THRES_LOW, VGNPlanner)
    world.reset(CLOSED_LOOP_OBJECTS)
    K = intrinsics(HEIGHT, WIDTH)
    shift = np.eye(4, dtype=np.float32)
    shift[:3, 3] = BBOX_MIN
    depths, exts = [], []
    for pose in hemisphere_poses()[::4][:VIEWS]:
        depths.append(world.sim.observe(pose, K, HEIGHT, WIDTH)[1])
        ext = np.eye(4, dtype=np.float32)
        ext[:3] = pose
        exts.append(ext @ shift)
    args = (np.stack(depths), np.tile(K[None], (VIEWS, 1, 1)), np.stack(exts))
    params = {k[len("vgn_net."):]: v for k, v in sd.items()
              if k.startswith("vgn_net.")}
    card = VGNPlanner(params, device=dev)
    cpu = VGNPlanner(params, device="cpu")
    tsdf = card.fuse(*args)
    (qual, _, width), _ = card.detect(tsdf)
    peaks = nms(process(tsdf, qual[0, ..., 0], width[0, ..., 0],
                        tsdf_thres_high=TSDF_THRES_HIGH,
                        tsdf_thres_low=TSDF_THRES_LOW), 0.0)
    card.qual_threshold = cpu.qual_threshold = threshold_of(peaks, "vgn")
    card.core(*args)        # warm-up
    tsdf_c, cand_c, dt = card.core(*args)
    tsdf_h, cand_h, dt_cpu = cpu.core(*args)
    e_tsdf = max_err(tsdf_c.cpu(), tsdf_h)
    check(e_tsdf <= 1e-5, f"vgn: tsdf card vs cpu {e_tsdf}")
    ck, ch = cand_set(cand_c), cand_set(cand_h)
    check(len(ck) > 0 and sorted(ck) == sorted(ch),
          f"vgn: candidates card vs cpu {sorted(ck)} vs {sorted(ch)}")
    e_cand = cand_err(ck, ch)
    check(e_cand <= PLANNER_ATOL, f"vgn: candidate values card vs cpu "
          f"{e_cand}")
    log(f"vgn: VGNPlanner on {VIEWS} depth views {HEIGHT} x {WIDTH}, "
        f"thresholds ({TSDF_THRES_HIGH}, {TSDF_THRES_LOW}): {len(ck)} "
        f"candidates identical on the card and the CPU (values "
        f"{e_cand:.3e}, tsdf {e_tsdf:.3e}); core() {dt * 1e3:.1f} ms card, "
        f"{dt_cpu * 1e3:.1f} ms CPU")
    return {"candidates": len(ck), "core_ms": dt * 1e3,
            "cpu_core_ms": dt_cpu * 1e3}


def render_data(inputs, dev):
    """GraspNeRF.forward's data: the planner's views as `ref`, 4096 random
    pixels of view 0 as `que`, and a few voxel indices for `vgn_pred`."""
    from graspnerf_tpu_torch.detect.planner import DEFAULT_BBOX_MIN
    from graspnerf_tpu_torch.tools.scene import query_rays
    images, poses, Ks, dr = inputs
    rng = np.random.RandomState(SEED)
    que = query_rays(rng, images, poses, Ks, dr, RENDER_RAYS)

    def t(tree):
        return {k: torch.as_tensor(v, device=dev) for k, v in tree.items()}
    return {"ref": t({"imgs": images, "poses": poses, "Ks": Ks,
                      "depth_range": dr, "bbox3d_min": DEFAULT_BBOX_MIN}),
            "que": t(que), "grasp_index": torch.as_tensor(
                rng.randint(0, RES, (16, 3)), device=dev)}


def capture_kernel_args(fn):
    """Runs fn with the two kernel wrappers, as the models call them,
    replaced by recorders that keep the arguments of each one's first call
    and pass every call on. Returns ({wrapper name: args}, fn's result)."""
    import graspnerf_tpu_torch.models.ibrnet as ibrnet
    import graspnerf_tpu_torch.models.renderer as renderer
    seen = {}
    wrappers = ((ibrnet, "view_fuse"), (renderer, "epipolar_gather"))

    def recorder(name, wrapper):
        def record(*args, **kw):
            seen.setdefault(name, args)
            return wrapper(*args, **kw)
        return record

    originals = [getattr(mod, name) for mod, name in wrappers]
    try:
        for (mod, name), wrapper in zip(wrappers, originals):
            setattr(mod, name, recorder(name, wrapper))
        out = fn()
    finally:
        for (mod, name), wrapper in zip(wrappers, originals):
            setattr(mod, name, wrapper)
    return seen, out


def flat(x):
    return x if isinstance(x, tuple) else (x,)


# where a ray's last-sample flip (compare_outputs' flip_share) leaves a key
# uncompared: the last sample, or the whole ray
FLIP_EXEMPT = {"alpha_values": "last", "hit_prob_nr": "last",
               "pixel_colors_nr": "ray", "render_depth": "ray"}


HEAD_KEYS = ("vgn_pred_full", "vgn_pred")


def compare_outputs(got, want, what, atol=RENDER_ATOL, flip_share=None,
                    head_rtol=None):
    """Every key of `want` against `got`: bool keys equal, the rest within
    atol, the grasp heads (HEAD_KEYS) within head_rtol of each head's
    largest magnitude when it is given. Returns {key: max abs err}, and with
    flip_share the flipped rays' count under "last_sample_flips".

    flip_share: the last sample of a ray has an interval of 1e6 m
    (geometry.depth2dists), so its NeuS alpha is a step in the sign of
    dir . ∇sdf: ~0 on one side, 1 on the other. Where ∇sdf is nearly
    perpendicular to the ray, a difference in ∇sdf's last bits can flip
    it. A ray whose last-sample alpha differs beyond atol counts as
    flipped; at most flip_share of the rays may be, and there the last
    sample's alpha and hit probability and the ray's composited colour and
    depth are left out (FLIP_EXEMPT); everything else is compared."""
    errs, flipped = {}, None
    if flip_share is not None:
        a_g, a_w = got["alpha_values"][..., -1], want["alpha_values"][..., -1]
        flipped = (a_g - a_w).abs() > atol
        n = int(flipped.sum())
        check(n <= flip_share * flipped.numel(), f"render {what}: {n} of "
              f"{flipped.numel()} rays' last-sample alphas flipped")
        errs["last_sample_flips"] = n
    for key in sorted(want):
        for g, w in zip(flat(got[key]), flat(want[key])):
            check(g.shape == w.shape, f"render {what} {key}: shape")
            if g.dtype == torch.bool:
                check(torch.equal(g, w), f"render {what} {key} differs")
                e = 0.0
            else:
                d = (g.double() - w.double()).abs()
                if flipped is not None and key in FLIP_EXEMPT:
                    keep = torch.ones_like(d, dtype=torch.bool)
                    if FLIP_EXEMPT[key] == "last":
                        keep[..., -1] = ~flipped
                    else:
                        keep &= ~flipped.reshape(
                            flipped.shape + (1,) * (d.dim() - flipped.dim()))
                    d = d[keep]
                e = float(d.max()) if d.numel() else 0.0
                tol = atol
                if head_rtol is not None and key in HEAD_KEYS:
                    tol = head_rtol * float(w.abs().max())
                check(e <= tol, f"render {what} {key}: {e:.3e}")
            errs[key] = max(errs.get(key, 0.0), e)
    return errs


def compare_render(out, want, plain, data, atol=RENDER_ATOL,
                   depth_atol=FINE_DEPTH_ATOL, what="render", flip_share=None,
                   head_rtol=None):
    """The kernel model's forward `out` against the plain model's `want`:
    the coarse pass, volume and heads directly (atol; flip_share and
    head_rtol as in compare_outputs); the fine pass at the kernel model's own fine samples,
    since the inverse CDF magnifies the coarse pass's differences (the
    samples held to depth_atol, unless it is None). Returns those fine
    samples."""
    from graspnerf_tpu_torch.ops import geometry
    ref, que = data["ref"], data["que"]
    dr = que["depth_range"]
    nr = plain.nr_net
    errs = compare_outputs(out, {k: v for k, v in want.items()
                                 if not k.endswith("_fine")}, "coarse", atol,
                           flip_share, head_rtol)
    coarse_depth = geometry.sample_depth(dr, RENDER_RAYS, RENDER_SAMPLES)
    with torch.no_grad():
        fine_depth = [torch.sort(geometry.sample_fine_depth(
            coarse_depth, o["hit_prob_nr"], dr, RENDER_SAMPLES), -1).values
            for o in (out, want)]
        e_depth = max_err(*fine_depth)
        check(depth_atol is None or e_depth <= depth_atol,
              f"{what} fine samples: {e_depth:.3e} m")
        fine = nr.render_by_depth(fine_depth[0], que, ref,
                                  *nr.encode_views(ref["imgs"]), True)
    errs.update({k + "_fine": v for k, v in compare_outputs(
        {k: out[k + "_fine"] for k in fine}, fine, "fine", atol,
        flip_share).items()})
    sdf = torch.cat([out["sdf_values"], out["sdf_values_fine"]]).flatten()
    log(f"{what} vs plain versions (atol {atol}, ray masks exact): "
        + json.dumps({k: float(f"{e:.3e}") for k, e in errs.items()}))
    log(f"{what}: fine samples {e_depth:.3e} m from the plain model's "
        f"(atol {depth_atol}); sdf range [{float(sdf.min()):.3f}, "
        f"{float(sdf.max()):.3f}], {float((sdf == 1).float().mean()):.3f} "
        f"seen by no view, {float((sdf == -1).float().mean()):.3f} at -1; "
        f"ray_mask {int(out['ray_mask'].sum())} / {RENDER_RAYS}")
    return fine_depth[0]


RENDER_CFG = {"depth_sample_num": RENDER_SAMPLES,
              "fine_depth_sample_num": RENDER_SAMPLES,
              "volume_resolution": RES}


def render_params():
    """The render's seeded weights at the shipped widths, the SDF output
    kernels scaled by SDF_SCALE."""
    from graspnerf_tpu_torch.models import GraspNeRF, init_parameters_
    sd = init_parameters_(GraspNeRF(), torch.Generator().manual_seed(SEED)
                          ).state_dict()
    for net in ("agg_net", "fine_agg_net"):
        sd[f"nr_net.{net}.agg_impl.out_geometry_fc.1.weight"] *= SDF_SCALE
    return sd


def run_render(dev, inputs, iters=10):
    """The render path at full width through the kernels: counts their
    launches, holds every output against the same model on the plain
    versions on the same card, and times the phases. Returns {launches,
    args: the kernels' arguments in the coarse pass, times, stages: the
    (name, call) of a render's stages for the profile}."""
    from graspnerf_tpu_torch.models import load_graspnerf
    from graspnerf_tpu_torch.ops import geometry
    from graspnerf_tpu_torch.ops.epipolar_gather import epipolar_gather
    from graspnerf_tpu_torch.ops.instance_norm import instance_norm_act
    from graspnerf_tpu_torch.ops.view_fuse import view_fuse

    sd = render_params()
    cfg = RENDER_CFG
    kern = load_graspnerf(sd, dev, cfg)
    plain = load_graspnerf(sd, dev, cfg, use_kernels=False)
    render_only = load_graspnerf(sd, dev, dict(cfg, do_sample_volume=False)
                                 ).nr_net
    data = render_data(inputs, dev)
    ref, que = data["ref"], data["que"]

    launches, norms = {}, {}
    with torch.no_grad():
        kern(data)           # first calls: library loads, cuDNN set-up
        for name, fn in (("render", lambda: render_only(data)),
                         ("forward", lambda: kern(data))):
            view_fuse.launches = epipolar_gather.launches = 0
            instance_norm_act.launches = 0
            out = fn()
            torch.cuda.synchronize()
            launches[name] = {"view_fuse": view_fuse.launches,
                              "epipolar_gather": epipolar_gather.launches}
            norms[name] = instance_norm_act.launches
        want = plain(data)
    log(f"render: launches {launches}, fused norms {norms} "
        f"(NeuralRayRenderer.forward without the volume; GraspNeRF.forward "
        f"with it)")
    for name, n in (("render", 2), ("forward", 3)):
        check(launches[name] == {"view_fuse": n, "epipolar_gather": n},
              f"{name}: launches {launches[name]}, not {n} of each kernel")
        check(norms[name] == NORMS, f"{name}: {norms[name]} fused norms, "
              f"not {NORMS} (one encode)")
    for key, value in out.items():
        for v in flat(value):
            check(v.dtype == torch.bool or bool(torch.isfinite(v).all()),
                  f"render {key} not finite")
    check(out["pixel_colors_nr_fine"].shape == (1, RENDER_RAYS, 3)
          and out["volume"].shape == (RES,) * 3, "render shapes")
    fine_depth = compare_render(out, want, plain, data)

    knr, dr = kern.nr_net, que["depth_range"]
    coarse_depth = geometry.sample_depth(dr, RENDER_RAYS, RENDER_SAMPLES)
    with torch.no_grad():
        feats = knr.encode_views(ref["imgs"])
        phases = {
            "coarse_pass": lambda: knr.render_by_depth(
                coarse_depth, que, ref, *feats, False),
            "fine_sampling": lambda: torch.sort(geometry.sample_fine_depth(
                coarse_depth, out["hit_prob_nr"], dr, RENDER_SAMPLES), -1),
            "fine_pass": lambda: knr.render_by_depth(
                fine_depth, que, ref, *feats, True),
            "render": lambda: knr.render_rays(que, ref, *feats),
            "render_plain": lambda: plain.nr_net.render_rays(que, ref,
                                                             *feats),
            "forward": lambda: kern(data)}
        times = {name + "_ms": event_ms(fn, iters)
                 for name, fn in phases.items()}
        args, _ = capture_kernel_args(phases["coarse_pass"])
    log(f"render phases (median, min, max of {iters}) " + json.dumps(times))
    stages = (("encode", lambda: knr.encode_views(ref["imgs"])),
              *((k, phases[k]) for k in ("coarse_pass", "fine_sampling",
                                         "fine_pass")))
    return {"launches": launches, "norm_launches": norms, "args": args,
            "times": times, "stages": stages}


# -------------------------------------------------------------- bfloat16
BF16_CFG = {"compute_dtype": "bfloat16"}


def check_bf16_launches(what, expect=None):
    """The bfloat16 instances' counts since zero_counts(): each kernel
    launched (`expect` times each, when given), and every launch of the
    forward kernels a bfloat16 one. Returns {row name: launches}."""
    launched, total = bf16_counts()
    for name, n in launched.items():
        check(n > 0 if expect is None else n == expect,
              f"{what}: {name} launched {n} times")
        check(total[name] == n, f"{what}: {total[name] - n} float32 "
              f"launches of {name}'s kernel in a bfloat16 model")
    return launched


def run_planner_bf16(dev, inputs, planner32):
    """The planner in bfloat16 at full width through the bfloat16 kernels:
    N_CALLS calls counted, the kernel model against the plain-version model
    (volume, heads, candidates) and against the float32 kernel model
    `planner32` (the volume's gap, the candidates' overlap at its
    threshold), phase times. Returns (planner, launches per call)."""
    from graspnerf_tpu_torch.detect.planner import GraspNeRFPlanner
    sd = planner_params()
    kern = GraspNeRFPlanner(sd, device=dev, renderer_cfg=BF16_CFG)
    plain = GraspNeRFPlanner(sd, device=dev, renderer_cfg=BF16_CFG,
                             use_kernels=False)
    thr = pick_threshold(kern, inputs, "planner bf16")
    kern.qual_threshold = plain.qual_threshold = thr

    zero_counts()
    wall = []
    for _ in range(N_CALLS):
        vol_k, cand_k, dt = kern.core(*inputs)
        wall.append(dt)
    launches = check_bf16_launches("planner bf16")
    log(f"planner bf16: {N_CALLS} calls, core() seconds {wall}, launches "
        f"{launches}")
    check(vol_k.dtype == torch.float32 and vol_k.shape == (RES,) * 3
          and bool(torch.isfinite(vol_k).all()), "bf16 volume dtype / finite")

    vol_p, cand_p, _ = plain.core(*inputs)
    e_max, e_mean = max_err(vol_k, vol_p), float((vol_k - vol_p).abs().mean())
    check(e_max <= VOL_BF16_MAX and e_mean <= VOL_BF16_MEAN,
          f"bf16 volume vs plain: max {e_max:.3e}, mean {e_mean:.3e}")
    with torch.no_grad():
        heads_k = kern.model.vgn_net(vol_k[None, ..., None])
        heads_p = plain.model.vgn_net(vol_p[None, ..., None])
    e_heads = {}
    for name, a, b in zip(("qual", "rot", "width"), heads_k, heads_p):
        check(a.dtype == torch.float32 and bool(torch.isfinite(a).all()),
              f"bf16 {name} dtype / finite")
        scale = float(b.abs().max())
        e_heads[name] = max_err(a, b)
        check(e_heads[name] <= HEAD_BF16_RTOL * scale,
              f"bf16 {name} vs plain: {e_heads[name]:.3e} (scale {scale:.3e})")
    ck, cp = cand_set(cand_k), cand_set(cand_p)
    check(len(ck) > 0, "bf16: no candidates")
    same = len(set(ck) & set(cp))
    log(f"planner bf16 vs plain versions: volume max {e_max:.3e} (bound "
        f"{VOL_BF16_MAX}), mean {e_mean:.3e} (bound {VOL_BF16_MEAN}); heads "
        + json.dumps({k: float(f"{e:.3e}") for k, e in e_heads.items()})
        + f" (within {HEAD_BF16_RTOL} of each one's scale); candidates "
        f"{len(ck)} and {len(cp)}, {same} in both")

    vol32, cand32, _ = planner32.core(*inputs)
    kern.qual_threshold = planner32.qual_threshold
    _, cand16 = kern.detect(vol_k)
    kern.qual_threshold = thr
    c16, c32 = cand_set(cand16), cand_set(cand32)
    log(f"planner bf16 vs the float32 kernel model: volume max "
        f"{max_err(vol_k, vol32):.3e}, mean "
        f"{float((vol_k - vol32).abs().mean()):.3e}; at the float32 "
        f"threshold {len(c16)} bf16 and {len(c32)} float32 candidates, "
        f"{len(set(c16) & set(c32))} in both; sdf range "
        f"[{float(vol_k.min()):.3f}, {float(vol_k.max()):.3f}]")
    return kern, launches


def run_render_bf16(dev, inputs, iters=10):
    """The render path in bfloat16 at full width through the bfloat16
    kernels: launches of a render and of a forward, every output against
    the plain-version model (the fine pass at the kernel model's fine
    samples), phase times. Returns {launches, args, times}."""
    from graspnerf_tpu_torch.models import load_graspnerf
    from graspnerf_tpu_torch.ops import geometry
    sd = render_params()
    cfg = dict(RENDER_CFG, **BF16_CFG)
    kern = load_graspnerf(sd, dev, cfg)
    plain = load_graspnerf(sd, dev, cfg, use_kernels=False)
    render_only = load_graspnerf(sd, dev, dict(cfg, do_sample_volume=False)
                                 ).nr_net
    data = render_data(inputs, dev)
    ref, que = data["ref"], data["que"]
    launches = {}
    with torch.no_grad():
        kern(data)
        for name, fn, n in (("render", lambda: render_only(data), 2),
                            ("forward", lambda: kern(data), 3)):
            zero_counts()
            out = fn()
            torch.cuda.synchronize()
            launches[name] = check_bf16_launches(f"render bf16 {name}", n)
        want = plain(data)
    log(f"render bf16: launches {launches}")
    for key, value in out.items():
        for v in flat(value):
            check(v.dtype in (torch.bool, torch.float32)
                  and (v.dtype == torch.bool or bool(torch.isfinite(v).all())),
                  f"render bf16 {key}: dtype {v.dtype} / finite")
    compare_render(out, want, plain, data, RENDER_BF16_ATOL, None,
                   "render bf16", LAST_FLIP_SHARE, HEAD_BF16_RTOL)
    knr = kern.nr_net
    with torch.no_grad():
        feats = knr.encode_views(ref["imgs"])
        phases = {"encode": lambda: knr.encode_views(ref["imgs"]),
                  "render": lambda: knr.render_rays(que, ref, *feats),
                  "render_plain": lambda: plain.nr_net.render_rays(
                      que, ref, *feats),
                  "forward": lambda: kern(data)}
        times = {name + "_ms": event_ms(fn, iters)
                 for name, fn in phases.items()}
        coarse_depth = geometry.sample_depth(que["depth_range"], RENDER_RAYS,
                                             RENDER_SAMPLES)
        args, _ = capture_kernel_args(lambda: knr.render_by_depth(
            coarse_depth, que, ref, *feats, False))
    log(f"render bf16 phases (median, min, max of {iters}) "
        + json.dumps(times))
    return {"launches": launches, "args": args, "times": times}


def fuse_bound_bf16(n):
    """Least time of the bfloat16 view fuse over n rows: its multiply-adds
    at the bfloat16 tensor-core rate, or its bytes (bfloat16 inputs, x,
    vis and feat_const; float32 num_valid and weight pack)."""
    from graspnerf_tpu_torch.ops.view_fuse import LAYER_DIMS, PACK_FLOATS
    macs = n * (VIEWS * sum(i * o for i, o in LAYER_DIMS) - 5 * 140 * 64)
    nbytes = (2 * (VIEWS * n * (35 + 32 + 4 + 1) + n * 65 + VIEWS * n * 33)
              + 4 * (n + PACK_FLOATS))
    return bound(2 * macs / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)


def check_view_fuse_bf16(dev, gen, render_args):
    """The bfloat16 view-fuse kernel (csrc/view_fuse_bf16.cu) against its
    plain version on the card (num_valid exact, the rest within
    FUSE_BF16_RTOL of each output's scale), after its weight-pack guard, at
    ragged N (one that ends a row into a slab among them), shifted inputs
    (element loads), N = 64,000, the render pass's N on random and on the
    bfloat16 render's own inputs; its times beside the float32 kernel's on
    the same rows, each as a share of its bound; its registers, spills,
    shared memory and resident blocks. Returns its `kernels` row."""
    from graspnerf_tpu_torch.ops import view_fuse as vf
    from graspnerf_tpu_torch.ops.view_fuse import view_fuse, view_fuse_plain
    weights = fuse_weights(gen, dev)

    lib = vf.library(BF16)
    n_pack = vf.pack_weights_bf16(weights).numel()
    vf.check_pack(lib, n_pack, BF16)
    try:
        vf.check_pack(lib, n_pack + 8, BF16)
        refused = False
    except RuntimeError:
        refused = True
    check(refused, "view_fuse_bf16: a weight pack of the wrong size was taken")
    slab = lib.view_fuse_bf16_slab_rows()
    info = vf.kernel_info()
    check(info["blocks_per_sm"] >= 1,
          f"view_fuse_bf16: no block fits on an SM: {info}")
    log(f"view_fuse_bf16: the kernel reads a {lib.view_fuse_bf16_pack_elems()}"
        f"-element pack = pack_weights_bf16's {n_pack}; {n_pack + 8} is "
        f"refused; slabs of {slab} rows; " + json.dumps(info))

    def compare(name, ins, w):
        got = view_fuse(*ins, w, BF16)
        torch.cuda.synchronize()
        want = view_fuse_plain(*ins, w, BF16)
        check(torch.equal(got[1], want[1]), f"view_fuse_bf16 num_valid {name}")
        rel = {}
        for what, i in (("feat_const", 0), ("x", 2), ("vis", 3)):
            g, p = got[i], want[i]
            check(g.dtype == BF16 and bool(torch.isfinite(g).all()),
                  f"view_fuse_bf16 {what} dtype / finite")
            rel[what] = max_err(g, p) / max(float(p.abs().max()), 1e-30)
            check(rel[what] <= FUSE_BF16_RTOL,
                  f"view_fuse_bf16 {what} {name}: {rel[what]:.3e} of its scale")
        err = max(max_err(g, p) for g, p in zip(got, want))
        log(f"view_fuse_bf16 {name}: max_abs_err {err:.3e}, of each output's "
            f"scale " + json.dumps({k: float(f"{v:.3e}") for k, v in
                                    rel.items()})
            + f" (bound {FUSE_BF16_RTOL}; num_valid exact)")
        return err

    errs = {}
    for n in (1, 31, 33, 1000, RES ** 3, RES ** 3 + 17, "1000 shifted"):
        ins = fuse_inputs(gen, 1000 if n == "1000 shifted" else n, dev)
        ins = [t.to(BF16) for t in ins]
        if n == "1000 shifted":   # one element off 16 bytes: element loads
            ins = [shifted(t) for t in ins]
        errs[n] = compare(f"N={n}", ins, weights)
    render = f"render N={RENDER_ROWS}"
    render_args = (*render_args[:4],
                   [(a.detach(), b.detach()) for a, b in render_args[4]])
    errs[render] = compare(render + " (the bf16 coarse pass's inputs)",
                           render_args[:4], render_args[4])
    times = {}
    for n in (RES ** 3, RENDER_ROWS, render):
        if n == render:
            ins, w = render_args[:4], render_args[4]
        else:
            ins, w = [t.to(BF16) for t in fuse_inputs(gen, n, dev)], weights
        # the float32 kernel on the same rows, in turns with it: the bare
        # launches (into the outputs of one wrapper call), then the wrappers
        ins32 = [t.float() for t in ins]
        bare16 = vf.launcher(*ins, w, view_fuse(*ins, w, BF16), BF16)
        bare32 = vf.launcher(*ins32, w, view_fuse(*ins32, w))
        ms = [cuda_time(bare16), cuda_time(bare32), cuda_time(bare32),
              cuda_time(bare16)]
        n_rows = ins[0].shape[1]
        t = {"ms": cuda_time(lambda: view_fuse(*ins, w, BF16)),
             "kernel_ms": (ms[0] + ms[3]) / 2,
             "plain_ms": cuda_time(lambda: view_fuse_plain(*ins, w, BF16)),
             **fuse_bound_bf16(n_rows),
             "f32_ms": cuda_time(lambda: view_fuse(*ins32, w)),
             "f32_kernel_ms": (ms[1] + ms[2]) / 2,
             "f32_bound_ms": fuse_bound(n_rows)["bound_ms"]}
        t["bound_share"] = t["bound_ms"] / t["kernel_ms"]
        t["f32_bound_share"] = t["f32_bound_ms"] / t["f32_kernel_ms"]
        t["of_f32"] = t["kernel_ms"] / t["f32_kernel_ms"]
        times[n] = t
        log(f"view_fuse_bf16 {n if n == render else f'random N={n}'} (ms: "
            f"the wrapper, kernel_ms: the bare launch; bf16 vs the float32 "
            f"kernel on the same rows, CUDA events, bare turns b-f-f-b "
            f"{[round(m, 4) for m in ms]}): " + json.dumps(t))
        del ins, ins32, bare16, bare32
    return {"name": "view_fuse_bf16", "route": "cuda",
            "source": "graspnerf_tpu_torch/csrc/view_fuse_bf16.cu",
            "replaces": "graspnerf_tpu/ops/pallas/ibrnet_fuse.py:115",
            "max_abs_err": errs[RES ** 3], "library_ms": None,
            **times[RES ** 3], "ms_163840": times[RENDER_ROWS]["ms"],
            "plain_ms_163840": times[RENDER_ROWS]["plain_ms"],
            "bound_ms_163840": times[RENDER_ROWS]["bound_ms"],
            "kernel_ms_163840": times[RENDER_ROWS]["kernel_ms"],
            "f32_kernel_ms_163840": times[RENDER_ROWS]["f32_kernel_ms"],
            "of_f32_163840": times[RENDER_ROWS]["of_f32"],
            "render_ms": times[render]["ms"],
            "render_kernel_ms": times[render]["kernel_ms"],
            "render_plain_ms": times[render]["plain_ms"],
            "render_f32_kernel_ms": times[render]["f32_kernel_ms"],
            "render_max_abs_err": errs[render], **info}


def bf16_ulp(t):
    """One bfloat16 ulp at each value's magnitude (0 at 0)."""
    a = t.float().abs()
    return torch.where(a > 0, torch.exp2(torch.floor(torch.log2(a)) - 7),
                       torch.zeros_like(a))


def check_gather_bf16(dev, gen, planner, scene, render_args):
    """The gather's bfloat16 instance against its plain version on the card
    (each value within one bfloat16 ulp, or GATHER_ATOL) and on the CPU
    (bit-equal), invalid points 0, on random, the bfloat16 planner's and
    the bfloat16 render's coordinates, at ragged P and shifted; and its
    times. Returns its row."""
    from graspnerf_tpu_torch.ops import epipolar_gather as eg
    bf = lambda a: [t.to(BF16) for t in a[:3]] + list(a[3:])  # noqa: E731

    vol, render = f"random P={RES ** 3}", f"random P={RENDER_ROWS}"
    planned, rendered = f"planner P={RES ** 3}", f"render P={RENDER_ROWS}"
    planner_args = planner_gather_inputs(planner, scene)
    cases = {vol: bf(gather_inputs(gen, dev)),
             planned: [*planner.model.nr_net.gather_maps(*planner_args[:3]),
                       *planner_args[3:]],
             render: bf(gather_inputs(gen, dev, RENDER_ROWS)),
             rendered: list(render_args)}
    for P in (1, 31, 33):
        cases[f"random P={P}"] = bf(gather_inputs(gen, dev, P))
    cases["random P=1000 shifted"] = [
        shifted(t) for t in bf(gather_inputs(gen, dev, 1000))]
    errs = {}
    for name, args in cases.items():
        check(args[0].dtype == args[1].dtype == BF16, f"{name}: maps bf16")
        if name.endswith("shifted"):
            got = eg.launcher(*args, *gather_outputs(args, dev, True))()
        else:
            got = eg.epipolar_gather(*args)
        torch.cuda.synchronize()
        want = eg.epipolar_gather_plain(*args)
        cpu = eg.epipolar_gather_plain(*[t.cpu() for t in args])
        valid = args[4]
        for g, w, c, what, dtype in zip(got, want, cpu,
                                        ("rgb_feats", "ray_feats"),
                                        (BF16, torch.float32)):
            check(g.dtype == dtype, f"gather bf16 {what}: dtype {g.dtype}")
            over = ((g.float() - w.float()).abs()
                    - torch.clamp(bf16_ulp(w), min=GATHER_ATOL)).max()
            check(float(over) <= 0, f"gather bf16 {what} {name}: beyond one "
                  f"ulp (max err {max_err(g, w)})")
            check(torch.equal(g.cpu(), c), f"gather bf16 {what} {name}: not "
                  f"bit-equal to the plain version on the CPU")
            check(bool((g[~valid] == 0).all()),
                  f"gather bf16 {what} {name}: invalid points not 0")
        errs[name] = max(max_err(g, w) for g, w in zip(got, want))
        log(f"epipolar_gather_bf16 {name}: max_abs_err {errs[name]:.3e} vs "
            f"the plain version on the card (each value within one bf16 ulp "
            f"or {GATHER_ATOL}), bit-equal to it on the CPU, invalid points 0")
    times = {}
    for name in (vol, planned, render, rendered):
        args = cases[name]
        outs = gather_outputs(args, dev)
        times[name] = {
            "ms": cuda_time(lambda: eg.epipolar_gather(*args)),
            "kernel_ms": cuda_time(eg.launcher(*args, *outs)),
            "plain_ms": cuda_time(lambda: eg.epipolar_gather_plain(*args)),
            "library_ms": cuda_time(gather_library(args)),
            **gather_bound(args, outs)}
        log(f"epipolar_gather_bf16 {name} (ms: the wrapper; kernel_ms: the "
            f"bare launch): {json.dumps(times[name])}")
    return {"name": "epipolar_gather_bf16", "route": "cuda",
            "source": "graspnerf_tpu_torch/csrc/epipolar_gather.cu",
            "replaces": "graspnerf_tpu/ops/fused_gather.py:233",
            "max_abs_err": errs[vol], **times[vol],
            "ms_163840": times[render]["ms"],
            "kernel_ms_163840": times[render]["kernel_ms"],
            "bound_ms_163840": times[render]["bound_ms"],
            "planner_ms": times[planned]["ms"],
            "planner_kernel_ms": times[planned]["kernel_ms"],
            "render_ms": times[rendered]["ms"],
            "render_kernel_ms": times[rendered]["kernel_ms"],
            "render_plain_ms": times[rendered]["plain_ms"],
            "render_library_ms": times[rendered]["library_ms"],
            "render_bound_ms": times[rendered]["bound_ms"],
            "render_max_abs_err": errs[rendered]}


# ------------------------------------------------------------ train step
def train_model(use_kernels=True, seed=SEED, dtype="float32"):
    """A seeded GraspNeRF at the shipped widths, with configs/nrvgn_sdf.yaml's
    renderer settings (40 + 40 samples, the 40^3 volume, 8192 depth-loss
    pixels), the SDF output kernels scaled as for the render, computing in
    `dtype`."""
    from graspnerf_tpu_torch.models import GraspNeRF, init_parameters_
    cfg = {"depth_sample_num": RENDER_SAMPLES,
           "fine_depth_sample_num": RENDER_SAMPLES, "volume_resolution": RES,
           "depth_loss_coords_num": DEPTH_COORDS, "compute_dtype": dtype}
    model = init_parameters_(GraspNeRF(cfg, use_kernels=use_kernels),
                             torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for net in (model.nr_net.agg_net, model.nr_net.fine_agg_net):
            net.agg_impl.out_geometry_fc[1].weight *= SDF_SCALE
    return model


def train_states(dev, dtype="float32"):
    """(kernel state, plain-version state, batch): the seeded `train_model`
    in `dtype` under `create_train_state` with and without the kernels; the
    seeded full-width batch."""
    from graspnerf_tpu_torch.tools.scene import training_batch
    from graspnerf_tpu_torch.train import create_train_state
    kern, plain = (create_train_state(train_model(k, dtype=dtype), device=dev)
                   for k in (True, False))
    batch = training_batch(np.random.RandomState(SEED), dev, VIEWS, HEIGHT,
                           WIDTH, TRAIN_RAYS, RES, TRAIN_GRASPS)
    return kern, plain, batch


def counts():
    from graspnerf_tpu_torch.ops.epipolar_gather import (
        epipolar_gather, epipolar_gather_backward)
    from graspnerf_tpu_torch.ops.view_fuse import view_fuse
    return {"view_fuse": view_fuse.launches,
            "epipolar_gather": epipolar_gather.launches,
            "epipolar_gather_backward": epipolar_gather_backward.launches}


def zero_counts():
    from graspnerf_tpu_torch.ops.epipolar_gather import (
        epipolar_gather, epipolar_gather_backward)
    from graspnerf_tpu_torch.ops.view_fuse import view_fuse
    view_fuse.launches = epipolar_gather.launches = 0
    view_fuse.bf16_launches = epipolar_gather.bf16_launches = 0
    epipolar_gather_backward.launches = 0
    epipolar_gather_backward.bf16_launches = 0


def bf16_counts():
    """{bfloat16 row name: launches of that instance}, and the launches of
    both instances of each forward kernel."""
    from graspnerf_tpu_torch.ops.epipolar_gather import epipolar_gather
    from graspnerf_tpu_torch.ops.view_fuse import view_fuse
    return ({"view_fuse_bf16": view_fuse.bf16_launches,
             "epipolar_gather_bf16": epipolar_gather.bf16_launches},
            {"view_fuse_bf16": view_fuse.launches,
             "epipolar_gather_bf16": epipolar_gather.launches})


def compare_train(kern, plain, batch, dev, ref=None):
    """One training loss and its gradients on the kernel model and on the
    plain-version model: the same draws (generators of one seed), the plain
    model's fine pass at the kernel model's fine samples. Checks the
    launches (3 of each kernel), the losses, the fine samples and every
    parameter's gradient. With `ref`, a float32 state of the same weights
    (the models are bfloat16): its loss and gradients too, at the same
    samples, and the bfloat16 tolerances relative to the gap between the
    plain model and it. Returns the gather's arguments in the coarse
    pass."""
    from graspnerf_tpu_torch.ops.epipolar_gather import (
        epipolar_gather, epipolar_gather_backward)
    from graspnerf_tpu_torch.ops.view_fuse import view_fuse
    from graspnerf_tpu_torch.tools.scene import pinned_fine_samples
    from graspnerf_tpu_torch.train import gradients, make_loss_fn
    what = "train" if ref is None else "train bf16"
    zero_counts()
    args, ((total_k, ld_k), [fine_k]) = capture_kernel_args(
        lambda: pinned_fine_samples(lambda: make_loss_fn(kern.model)(
            batch, torch.Generator(device=dev).manual_seed(SEED))))
    grads_k = gradients(kern, total_k)
    torch.cuda.synchronize()
    launched = counts()
    log(f"{what}: one loss and its gradients launch {launched}")
    check(launched == {"view_fuse": 3, "epipolar_gather": 3,
                       "epipolar_gather_backward": 3},
          f"{what}: launches {launched}, not 3 of each kernel")
    if ref is not None:
        b16 = (view_fuse.bf16_launches, epipolar_gather.bf16_launches,
               epipolar_gather_backward.bf16_launches)
        check(b16 == (3, 3, 3), f"{what}: bfloat16 launches {b16}")

    def run(state):
        (total, ld), [fine] = pinned_fine_samples(
            lambda: make_loss_fn(state.model)(
                batch, torch.Generator(device=dev).manual_seed(SEED)),
            [fine_k])
        return ld, gradients(state, total), fine
    ld_p, grads_p, fine_p = run(plain)
    e_fine = max_err(fine_k, fine_p)
    # in bfloat16 a coarse hit probability an ulp apart moves a fine sample
    # by centimetres (as in the bfloat16 render): reported, not held
    check(ref is not None or e_fine <= FINE_DEPTH_ATOL,
          f"{what} fine samples: {e_fine:.3e} m")
    ld_r, grads_r = (None, None) if ref is None else run(ref)[:2]
    errs = {}
    for key in sorted(ld_k):
        k, p = float(ld_k[key].detach()), float(ld_p[key].detach())
        check(math.isfinite(k), f"{what} {key} not finite")
        errs[key] = abs(k - p) / max(abs(p), 1e-12)
        tol = TRAIN_LOSS_RTOL if ref is None else TRAIN_BF16_LOSS_RTOL
        check(errs[key] <= tol,
              f"{what} {key}: {k} vs plain {p} (rel {errs[key]:.3e}, "
              f"tol {tol:.3e})")
    floor, tol = ((GRAD_FLOOR, TRAIN_GRAD_RTOL) if ref is None else
                  (TRAIN_BF16_GRAD_FLOOR, TRAIN_BF16_GRAD_RTOL))
    rel, gaps, skipped = [], [], 0
    for i, ((name, _), gk, gp) in enumerate(zip(
            kern.model.named_parameters(), grads_k, grads_p)):
        check(bool(torch.isfinite(gk).all()), f"gradient of {name} finite")
        scale = max(float(gk.abs().max()), float(gp.abs().max()))
        if scale < floor:
            skipped += 1
            continue
        r = max_err(gk, gp) / scale
        check(r <= tol, f"{what}: gradient of {name}: {r:.3e} of its "
              f"scale {scale:.3e} from the plain version's (tol {tol})")
        rel.append((r, name, scale))
        if ref is not None:
            gaps.append(max_err(gp, grads_r[i]) / scale)
    rel.sort(reverse=True)
    median = rel[len(rel) // 2][0]
    if ref is not None:
        check(median <= TRAIN_BF16_GRAD_MEDIAN, f"{what}: median gradient "
              f"distance {median:.3e} of scale")
        gaps.sort()
        log(f"{what}: the plain bf16 model's gradients from the float32 "
            f"model's (of each scale): median {gaps[len(gaps) // 2]:.2e}, "
            f"largest {gaps[-1]:.2e}")
    log(f"{what} vs plain versions: losses (rel) "
        + json.dumps({k: float(f"{e:.3e}") for k, e in errs.items()}))
    if ref is not None:
        gaps = {k: abs(float(ld_p[k]) - float(ld_r[k]))
                / max(abs(float(ld_p[k])), 1e-12) for k in sorted(ld_p)}
        log(f"{what}: plain bf16 vs float32 losses (rel) " + json.dumps(
            {k: float(f"{e:.3e}") for k, e in gaps.items()}))
    log(f"{what}: fine samples {e_fine:.3e} m from the plain model's ("
        + ("atol " + str(FINE_DEPTH_ATOL) if ref is None else "not held")
        + f"); gradients of {len(rel)} parameters within {tol} of their "
        f"scale ({skipped} below {floor} skipped); largest: "
        + ", ".join(f"{n} {r:.2e} (scale {s:.1e})" for r, n, s in rel[:6])
        + f"; median {median:.2e}")
    log(f"{what} losses: " + json.dumps(
        {k: float(f"{float(v.detach()):.6g}") for k, v in ld_k.items()}))
    return args["epipolar_gather"]


def check_fuse_after_update(state, batch, dev):
    """After a train step the view fuse's weights have changed in place:
    the kernel on them must equal its plain version (a weight pack kept
    from before the update would not)."""
    from graspnerf_tpu_torch.ops.view_fuse import view_fuse, view_fuse_plain
    from graspnerf_tpu_torch.train import make_train_step
    agg = state.model.nr_net.agg_net.agg_impl
    args, _ = capture_kernel_args(lambda: make_train_step(state)(
        batch, torch.Generator(device=dev).manual_seed(SEED)))
    ins = [t.detach() for t in args["view_fuse"][:4]]
    before = [w.detach().clone() for pair in agg.fuse_weights() for w in pair]
    with torch.no_grad():
        view_fuse(*ins, agg.fuse_weights())        # keeps the pack
    make_train_step(state)(batch, torch.Generator(device=dev)
                           .manual_seed(SEED + 1))
    after = [w for pair in agg.fuse_weights() for w in pair]
    check(any(not torch.equal(a, b) for a, b in zip(before, after)),
          "the train step left the view fuse's weights unchanged")
    with torch.no_grad():
        got = view_fuse(*ins, agg.fuse_weights())
        want = view_fuse_plain(*ins, agg.fuse_weights())
    err = max(max_err(g, w) for g, w in zip(got, want))
    for g, w in zip(got, want):
        check(torch.allclose(g, w, atol=FUSE_ATOL, rtol=FUSE_RTOL),
              f"view_fuse after a weight update: max err {max_err(g, w)}")
    log(f"view_fuse after a weight update: max_abs_err {err:.3e} vs its "
        f"plain version (atol {FUSE_ATOL}, rtol {FUSE_RTOL})")


def train_step_ms(state, batch, dev, iters):
    """[median, min, max] ms of `iters` train steps, and of each step's
    forward (the losses), backward (the gradients) and optimizer (the
    finite test and Adam), CUDA events between them; one warm-up step."""
    from graspnerf_tpu_torch.train import (apply_gradients, gradients,
                                           make_loss_fn)
    loss_fn = make_loss_fn(state.model)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    parts = {"step": [], "forward": [], "backward": [], "optimizer": []}
    for i in range(iters + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        total, _ = loss_fn(batch, gen)
        ev[1].record()
        grads = gradients(state, total)
        ev[2].record()
        check(apply_gradients(state, grads), "train: a gradient not finite")
        ev[3].record()
        torch.cuda.synchronize()
        if i == 0:
            continue
        for name, (a, b) in (("step", (0, 3)), ("forward", (0, 1)),
                             ("backward", (1, 2)), ("optimizer", (2, 3))):
            parts[name].append(ev[a].elapsed_time(ev[b]))
    return {name + "_ms": [float(np.median(ms)), min(ms), max(ms)]
            for name, ms in parts.items()}


def run_train(dev, iters=10):
    """The train step at full width through the kernels: holds one loss
    and its gradients against the plain-version model, drives TRAIN_STEPS
    steps with the counts set to 0 before them, checks the view fuse after
    an update, and times the steps of both models. Returns {launches, steps,
    args: the gather's arguments in the coarse pass, times, stages}."""
    from graspnerf_tpu_torch.train import (apply_gradients, gradients,
                                           make_loss_fn, make_train_step)
    kern, plain, batch = train_states(dev)
    args = compare_train(kern, plain, batch, dev)

    from graspnerf_tpu_torch.ops.instance_norm import instance_norm_act
    step = make_train_step(kern)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    zero_counts()
    instance_norm_act.launches = 0
    totals = []
    for _ in range(TRAIN_STEPS):
        metrics = step(batch, gen)
        check(float(metrics["nonfinite_grad"]) == 0.0, "train: step skipped")
        totals.append(float(metrics["total"]))
    torch.cuda.synchronize()
    launches = counts()
    norms = instance_norm_act.launches
    log(f"train: {TRAIN_STEPS} steps, totals {totals}, launches {launches}, "
        f"fused norms {norms}")
    # autograd is on in a train step: the encoders keep the modules' chain
    check(norms == 0, f"train: {norms} fused norms in {TRAIN_STEPS} steps")
    check(all(math.isfinite(t) for t in totals), "train: total not finite")
    for name, n in launches.items():
        check(n == 3 * TRAIN_STEPS, f"train: {name} launched {n} times in "
              f"{TRAIN_STEPS} steps, not 3 per step")
    check(kern.step == TRAIN_STEPS, f"train: {kern.step} updates")
    check_fuse_after_update(kern, batch, dev)

    times = train_step_ms(kern, batch, dev, iters)
    times["plain_step_ms"] = train_step_ms(plain, batch, dev,
                                           iters)["step_ms"]
    log(f"train step phases (median, min, max of {iters}) "
        + json.dumps(times))
    log(f"train: peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")

    loss_fn, gen, held = make_loss_fn(kern.model), torch.Generator(
        device=dev).manual_seed(SEED), {}
    stages = (
        ("forward", lambda: held.update(total=loss_fn(batch, gen)[0])),
        ("backward", lambda: held.update(
            grads=gradients(kern, held.pop("total")))),
        ("optimizer", lambda: apply_gradients(kern, held.pop("grads"))))
    return {"launches": launches, "norm_launches": norms,
            "steps": TRAIN_STEPS, "args": args, "times": times,
            "stages": stages}


def run_train_bf16(dev, iters=10):
    """The bfloat16 train step at full width through the three kernels'
    bfloat16 instances: one loss and its gradients against the plain-
    version model (TRAIN_BF16_* tolerances; the float32 model of the same
    weights printed beside); TRAIN_STEPS steps with the counts set to 0 before them (3 bfloat16
    launches of each kernel a step, none of a float32 instance); the step
    times of both models; a few steps of Trainer.run. Returns {launches,
    steps, args: the gather's arguments in the coarse pass, times}."""
    from graspnerf_tpu_torch.ops.epipolar_gather import (
        epipolar_gather_backward)
    from graspnerf_tpu_torch.train import create_train_state, make_train_step
    kern, plain, batch = train_states(dev, "bfloat16")
    ref = create_train_state(train_model(True), device=dev)
    args = compare_train(kern, plain, batch, dev, ref)
    del ref
    check(all(p.dtype == torch.float32 for p in kern.model.parameters()),
          "train bf16: parameters not float32")

    step = make_train_step(kern)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    zero_counts()
    totals = []
    for _ in range(TRAIN_STEPS):
        metrics = step(batch, gen)
        check(float(metrics["nonfinite_grad"]) == 0.0,
              "train bf16: step skipped")
        check(all(v.dtype == torch.float32 for v in metrics.values()),
              "train bf16: a loss not float32")
        totals.append(float(metrics["total"]))
    torch.cuda.synchronize()
    launched, total = bf16_counts()
    launched["epipolar_gather_backward_bf16"] = (
        epipolar_gather_backward.bf16_launches)
    total["epipolar_gather_backward_bf16"] = counts()[
        "epipolar_gather_backward"]
    log(f"train bf16: {TRAIN_STEPS} steps, totals {totals}, bfloat16 "
        f"launches {launched}")
    check(all(math.isfinite(t) for t in totals), "train bf16: total")
    for name, n in launched.items():
        check(n == total[name] == 3 * TRAIN_STEPS, f"train bf16: {name} "
              f"launched {n} times ({total[name]} of both dtypes) in "
              f"{TRAIN_STEPS} steps, not 3 bfloat16 ones per step")
    opt_dtypes = {v.dtype for st in kern.optimizer.state.values()
                  for v in st.values() if torch.is_tensor(v)}
    check(opt_dtypes == {torch.float32}, f"train bf16: Adam {opt_dtypes}")

    times = train_step_ms(kern, batch, dev, iters)
    times["plain_step_ms"] = train_step_ms(plain, batch, dev,
                                           iters)["step_ms"]
    log(f"train bf16 step phases (median, min, max of {iters}) "
        + json.dumps(times))
    del kern, plain
    times.update(run_loop_bf16(dev))
    return {"launches": launched, "steps": TRAIN_STEPS, "args": args,
            "times": times}


def run_loop_bf16(dev):
    """BF16_LOOP_STEPS steps of Trainer.run on a bfloat16 model on
    generated scenes (LOOP_WORKERS workers, the loop phase's dataset), no
    validation or checkpoint inside: {sec_per_step, data_wait_per_step} of
    each logged window."""
    import tempfile
    from graspnerf_tpu_torch.data import (DatasetFactory, SceneLoader,
                                          SyntheticSceneDataset)
    from graspnerf_tpu_torch.train import Trainer
    factory = DatasetFactory(SyntheticSceneDataset, h=HEIGHT, w=WIDTH,
                             n_rays=TRAIN_RAYS, resolution=RES,
                             n_grasps=TRAIN_GRASPS, n_objects=4,
                             fuse_views=12)
    steps = 2 * BF16_LOOP_LOG_EVERY
    with tempfile.TemporaryDirectory() as workdir, SceneLoader(
            factory, LOOP_WORKERS, seed=SEED, pin_memory=True) as loader:
        trainer = Trainer(train_model(dtype="bfloat16"), loader,
                          workdir=workdir, log_every=BF16_LOOP_LOG_EVERY,
                          val_interval=10 * steps, save_interval=10 * steps,
                          seed=SEED, tensorboard=False, device=dev)
        state = trainer.run(steps)
        logged = [r for r in read_log(workdir) if "sec_per_step" in r]
    check(state.step == steps and len(logged) == 2,
          f"loop bf16: {state.step} updates, {len(logged)} records")
    for r in logged:
        check(r["nonfinite_grad"] == 0.0 and math.isfinite(r["loss_vgn"]),
              f"loop bf16: step {r['step']}")
    out = {k: [r[k] for r in logged]
           for k in ("sec_per_step", "data_wait_per_step")}
    log(f"loop bf16: Trainer.run {steps} steps, windows of "
        f"{BF16_LOOP_LOG_EVERY} (the first holds the workers' start): "
        + json.dumps(out))
    return {"loop_" + k: v for k, v in out.items()}


# ------------------------------------------------------------------ loop
class FirstBatch:
    """The loader, keeping its first batch."""

    def __init__(self, loader):
        self.loader, self.first = loader, None

    def __iter__(self):
        return self

    def __next__(self):
        batch = next(self.loader)
        if self.first is None:
            self.first = batch
        return batch

    def pop_data_wait(self):
        return self.loader.pop_data_wait()


def loop_trainer(dev, loader, val, workdir, seed=SEED):
    from graspnerf_tpu_torch.train import Trainer
    return Trainer(train_model(seed=seed), loader, val_batches=val,
                   workdir=workdir, log_every=LOOP_LOG_EVERY,
                   val_interval=LOOP_VAL_INTERVAL, save_interval=LOOP_SAVE,
                   seed=SEED, tensorboard=False, device=dev,
                   val_image_dir=f"{workdir}/vis_val")


def read_log(workdir):
    with open(f"{workdir}/metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def check_loop_log(recs):
    """Every step record finite with no skipped update; every val record
    finite; no failed image dump. Returns (step records, val records)."""
    logged = [r for r in recs if "sec_per_step" in r]
    vals = [r for r in recs if r.get("val")]
    check([r["step"] for r in logged] == list(range(
        LOOP_LOG_EVERY, LOOP_STEPS + 1, LOOP_LOG_EVERY)),
        f"loop: logged steps {[r['step'] for r in logged]}")
    for r in logged + vals:
        bad = [k for k, v in r.items() if isinstance(v, float)
               and not math.isfinite(v)]
        check(not bad, f"loop: step {r['step']} not finite: {bad}")
    for r in logged:
        check(r["nonfinite_grad"] == 0.0, f"loop: step {r['step']} skipped")
    for r in recs:
        check("val_image_error" not in r, f"loop: the val image dump "
              f"failed: {r.get('val_image_error')}")
    return logged, vals


def pipeline_scenes_per_s(loader):
    """The loader alone: its workers' queued batches drained, then the
    rate of PIPELINE_BATCHES more."""
    for _ in range(LOOP_WORKERS * 2):
        next(loader)
    t0 = time.perf_counter()
    for _ in range(PIPELINE_BATCHES):
        next(loader)
    return PIPELINE_BATCHES / (time.perf_counter() - t0)


def run_loop(dev, smi, step_ms):
    """The training loop at full width on generated scenes: 12 steps of
    Trainer.run, then a fresh Trainer resumed from `latest` for 2 more.
    step_ms: the train phase's seeded-step median, printed beside the
    loop's time per step. Returns {launches, resumed_launches, steps}."""
    import tempfile
    from graspnerf_tpu_torch.data import (DatasetFactory, SceneLoader,
                                          SyntheticSceneDataset, host_cores,
                                          native, to_device)
    from graspnerf_tpu_torch.ops.instance_norm import instance_norm_act
    from graspnerf_tpu_torch.train import create_train_state
    from graspnerf_tpu_torch.train.trainer import scene
    check(native.available(), "loop: the native tracer did not build")
    factory = DatasetFactory(SyntheticSceneDataset, h=HEIGHT, w=WIDTH,
                             n_rays=TRAIN_RAYS, resolution=RES,
                             n_grasps=TRAIN_GRASPS, n_objects=4,
                             fuse_views=12)
    val_ds = factory(SEED + 777_777)
    t0 = time.perf_counter()
    val = [val_ds.sample() for _ in range(LOOP_VAL_BATCHES)]
    parent_s = (time.perf_counter() - t0) / LOOP_VAL_BATCHES
    log(f"loop: native tracer in use (built {native.build()}); a scene in "
        f"this process with {native.num_threads()} OpenMP threads takes "
        f"{parent_s:.3f} s; os.cpu_count() {os.cpu_count()}, host cores "
        f"{host_cores()}")
    val_events = LOOP_STEPS // LOOP_VAL_INTERVAL
    with tempfile.TemporaryDirectory() as workdir, SceneLoader(
            factory, LOOP_WORKERS, seed=SEED, pin_memory=True) as loader:
        trainer = loop_trainer(dev, FirstBatch(loader), val, workdir)
        zero_counts()
        instance_norm_act.launches = 0
        t0 = time.perf_counter()
        state = trainer.run(LOOP_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counts()
        norms = instance_norm_act.launches
        log(f"loop: {LOOP_STEPS} steps in {wall:.2f} s wall (worker start "
            f"included), launches {launches}, fused norms {norms}")
        # the fused norms: none in a train step, one encode's in each
        # validation forward (its batches and the val image's render)
        n_val = val_events * (LOOP_VAL_BATCHES + 1)
        check(norms == NORMS * n_val, f"loop: {norms} fused norms, not "
              f"{NORMS} in each of {n_val} validation forwards")
        # 3 a step; 3 per val batch and 3 for the val image's render
        fwd = 3 * LOOP_STEPS + val_events * 3 * (LOOP_VAL_BATCHES + 1)
        check(launches == {"view_fuse": fwd, "epipolar_gather": fwd,
                           "epipolar_gather_backward": 3 * LOOP_STEPS},
              f"loop: launches {launches}, not 3 a step and 3 per val batch "
              f"and val image ({fwd} forward, {3 * LOOP_STEPS} backward)")
        logged, vals = check_loop_log(read_log(workdir))
        check(len(vals) == val_events, f"loop: {len(vals)} validations")
        dumps = sorted(os.listdir(f"{workdir}/vis_val"))
        check(len(dumps) == val_events, f"loop: val image dumps {dumps}")
        log(f"loop: val image dumps {dumps}")

        resumed = loop_trainer(dev, loader, val, workdir, seed=SEED + 1)
        restored, start, best = resumed.restore()
        check(start == LOOP_STEPS, f"loop: resumed at step {start}")
        check(best == min(v["loss_vgn"] for v in vals),
              f"loop: restored best {best}")
        check(restored.step == state.step == LOOP_STEPS,
              f"loop: {restored.step} updates restored, {state.step} saved")
        for (name, a), b in zip(state.model.state_dict().items(),
                                restored.model.state_dict().values()):
            check(torch.equal(a, b), f"loop: restored {name} differs")
        n_adam = 0
        for pa, pb in zip(state.model.parameters(),
                          restored.model.parameters()):
            sa, sb = state.optimizer.state[pa], restored.optimizer.state[pb]
            for key in ("exp_avg", "exp_avg_sq", "step"):
                check(torch.equal(sa[key], sb[key]),
                      f"loop: restored Adam {key} differs")
                n_adam += 1
        log(f"loop: restored from latest: step {start}, best {best}, "
            f"{len(state.model.state_dict())} tensors of the model and "
            f"{n_adam} of Adam bit-equal to the saved state")
        zero_counts()
        resumed.run(LOOP_STEPS + LOOP_RESUMED_STEPS)
        torch.cuda.synchronize()
        resumed_launches = counts()
        recs = read_log(workdir)
        run_cfg = [r for r in recs if r.get("run_config")]
        check(len(run_cfg) == 2 and run_cfg[1]["start_step"] == LOOP_STEPS,
              f"loop: the resumed run's config line {run_cfg[-1]}")
        check(resumed_launches == {k: 3 * LOOP_RESUMED_STEPS
                                   for k in resumed_launches},
              f"loop: resumed launches {resumed_launches}")
        pipeline = pipeline_scenes_per_s(loader)
        batch = to_device(scene(trainer.train_iter.first, 0), dev)

    kern, plain = (create_train_state(train_model(k), device=dev)
                   for k in (True, False))
    log("loop: the first loop batch (a generated scene), kernels vs plain "
        "versions:")
    compare_train(kern, plain, batch, dev)
    sec = [r["sec_per_step"] for r in logged]
    wait = [r["data_wait_per_step"] for r in logged]
    log(smi)
    log(f"loop: sec_per_step {sec} and data_wait_per_step {wait} (windows "
        f"of {LOOP_LOG_EVERY} steps; the 2nd and 3rd hold a validation and "
        f"checkpoints); the pipeline alone {pipeline:.3f} scenes/s with "
        f"{LOOP_WORKERS} workers x {max(1, host_cores() // LOOP_WORKERS)} "
        f"threads, os.cpu_count() {os.cpu_count()}; the train phase's "
        f"seeded step median {step_ms:.1f} ms")
    return {"launches": launches, "resumed_launches": resumed_launches,
            "norm_launches": norms, "steps": LOOP_STEPS}


def gather_backward_library(args, grads):
    """Yardstick, which the port never calls: the backward of three
    F.grid_sample calls (grid_sampler_2d_backward) at the same points,
    into the three maps, in the maps' dtype (grid and upstream too)."""
    import torch.nn.functional as F
    imgs, f1, f2, xy, _ = args
    maps = [m.detach().permute(0, 3, 1, 2).contiguous().requires_grad_()
            for m in (imgs, f1, f2)]
    xy = xy.detach()
    g = torch.stack([xy[..., 0] / (WIDTH - 1) * 2 - 1,
                     xy[..., 1] / (HEIGHT - 1) * 2 - 1], -1)[:, None].to(
                         imgs.dtype)
    outs = [F.grid_sample(m, g, mode="bilinear", padding_mode="border",
                          align_corners=(i == 0))
            for i, m in enumerate(maps)]
    d_rgb, d_ray = grads
    cot = [d_rgb[..., :3], d_rgb[..., 3:], d_ray]
    cot = [c.to(imgs.dtype).permute(0, 2, 1)[:, :, None].contiguous()
           for c in cot]
    return lambda: torch.autograd.grad(outs, maps, cot, retain_graph=True)


def check_gather_backward(dev, gen, planner, scene, train_args, names):
    """The gather's backward kernel against autograd through the plain
    version, on the card and on the CPU, two of its launches bit for bit,
    non-finite upstream values at invalid points, its kernels' registers,
    spills and shared memory, and its times. train_args: the gather's
    arguments in the train step's coarse pass; names: its CUDA launches a
    call as the profiler saw them (`backward_launch_events`)."""
    from graspnerf_tpu_torch.ops import epipolar_gather as eg
    vol, planned = f"random P={RES ** 3}", f"planner P={RES ** 3}"
    trained, spread = f"train P={TRAIN_ROWS}", f"random P={TRAIN_ROWS}"
    cases = {vol: gather_inputs(gen, dev), planned: planner_gather_inputs(
        planner, scene), trained: list(train_args),
        spread: gather_inputs(gen, dev, TRAIN_ROWS)}
    for P in (1, 31, 33):
        cases[f"random P={P}"] = gather_inputs(gen, dev, P)
    cases["random P=1000 shifted"] = gather_inputs(gen, dev, 1000)
    upstream = {}
    errs = {}
    for name, args in cases.items():
        V, P = args[3].shape[:2]
        C = args[1].shape[3]
        shapes = (tuple(args[0].shape), tuple(args[1].shape))
        d_rgb = torch.randn(V, P, 3 + C, generator=gen).to(dev)
        d_ray = torch.randn(V, P, C, generator=gen).to(dev)
        xy, valid = args[3].detach(), args[4]
        if name.endswith("shifted"):   # the element path: misaligned
            d_rgb, d_ray = shifted(d_rgb), shifted(d_ray)

            def run():
                outs = [shifted(torch.zeros(s, device=dev))
                        for s in (shapes[0], shapes[1], shapes[1])]
                return eg.backward_launcher(*outs, xy, valid, d_rgb, d_ray)()
        else:
            def run():
                return eg.epipolar_gather_backward(xy, valid, d_rgb, d_ray,
                                                   *shapes, need_imgs=True)
        got = run()
        again = run()
        torch.cuda.synchronize()
        for g, a, what in zip(got[1:], again[1:],
                              ("d_img_feats", "d_ray_feats")):
            check(torch.equal(g, a), f"gather backward {what} {name}: two "
                  f"launches differ (max {max_err(g, a)})")
        upstream[name] = (d_rgb, d_ray)
        want = eg.epipolar_gather_backward_plain(*shapes, xy, valid, d_rgb,
                                                 d_ray, True)
        cpu_args = [t.cpu() for t in (xy, valid, d_rgb, d_ray)]
        cpu = eg.epipolar_gather_backward_plain(*shapes, *cpu_args, True)
        sums = eg.epipolar_gather_backward_plain(
            *shapes, *cpu_args[:2], cpu_args[2].abs(), cpu_args[3].abs(),
            True)
        for g, w, c, a, what in zip(got, want, cpu, sums,
                                    ("d_imgs", "d_img_feats", "d_ray_feats")):
            check(torch.allclose(g, w, atol=BWD_ATOL, rtol=BWD_RTOL),
                  f"gather backward {what} {name}: max err {max_err(g, w)}")
            over = ((g.cpu() - c).abs() - BWD_SUM_RTOL * a).max()
            check(float(over) <= 1e-6, f"gather backward {what} {name}: "
                  f"{float(over):.3e} beyond {BWD_SUM_RTOL} of its cell's "
                  f"sum of |contributions| from the plain version on the "
                  f"CPU")
        errs[name] = max(max_err(g, w) for g, w in zip(got, want))
        log(f"epipolar_gather_backward {name}: max_abs_err {errs[name]:.3e} "
            f"vs the plain version on the card (atol {BWD_ATOL}, rtol "
            f"{BWD_RTOL}); on the CPU within {BWD_SUM_RTOL} of each cell's "
            f"sum of |contributions|; two launches bit-equal")

    # non-finite upstream values at invalid points (which the index leaves
    # out): NaN in exactly the cells and channels the plain version's g * 0
    # makes NaN, the other values as above
    args = gather_inputs(gen, dev, 1000)
    xy, valid = args[3], args[4]
    shapes = (tuple(args[0].shape), tuple(args[1].shape))
    d_rgb = torch.randn(VIEWS, 1000, 35, generator=gen).to(dev)
    d_ray = torch.randn(VIEWS, 1000, 32, generator=gen).to(dev)
    bad = (~valid).nonzero()[:4]
    d_rgb[bad[:2, 0], bad[:2, 1], 7] = float("inf")
    d_ray[bad[2:, 0], bad[2:, 1], 3] = float("nan")
    got = eg.epipolar_gather_backward(xy, valid, d_rgb, d_ray, *shapes,
                                      need_imgs=True)
    want = eg.epipolar_gather_backward_plain(*shapes, xy, valid, d_rgb, d_ray,
                                             True)
    for g, w, what in zip(got[1:], want[1:], ("d_img_feats", "d_ray_feats")):
        check(torch.equal(g.isnan(), w.isnan()) and bool(g.isnan().any()),
              f"gather backward {what}: NaN cells differ from the plain "
              f"version's with non-finite values at invalid points")
        check(torch.allclose(g.nan_to_num(0.0), w.nan_to_num(0.0),
                             atol=BWD_ATOL, rtol=BWD_RTOL),
              f"gather backward {what}: non-finite case max err "
              f"{max_err(g.nan_to_num(0.0), w.nan_to_num(0.0))}")
    log(f"epipolar_gather_backward: inf and NaN upstream at 4 invalid points "
        f"give NaN in the plain version's {int(got[1].isnan().sum())} + "
        f"{int(got[2].isnan().sum())} map values, and nowhere else")

    per_call = len(names)
    info = eg.backward_kernel_info()
    log(f"epipolar_gather_backward: kernels as built {json.dumps(info)}")

    times = {}
    for name in (vol, planned, trained, spread):
        args = cases[name]
        d_rgb, d_ray = upstream[name]
        xy, valid = args[3].detach(), args[4]
        shapes = (tuple(args[0].shape), tuple(args[1].shape))
        V, P = xy.shape[:2]
        C = shapes[1][3]
        outs = [torch.zeros(s, device=dev)
                for s in (shapes[0], shapes[1], shapes[1])]
        # each upstream gradient, xy and valid read once; the two maps'
        # gradients written once (d_imgs is not asked for on the path)
        nbytes = (sum(t.numel() * t.element_size()
                      for t in (xy, valid, d_rgb, d_ray))
                  + 2 * math.prod(shapes[1]) * 4)
        # per (view, point, channel): the mask, two row and four tap weights
        # (7 multiplies) and four adds into the map
        flops = V * P * 2 * C * 11
        # the same launch on one-float-shifted gradients and outputs: the
        # pull's element stores
        scalar = eg.backward_launcher(
            *[shifted(o) for o in outs], xy, valid, shifted(d_rgb),
            shifted(d_ray), False)
        times[name] = {
            "ms": cuda_time(lambda: eg.epipolar_gather_backward(
                xy, valid, d_rgb, d_ray, *shapes)),
            "kernel_ms": cuda_time(eg.backward_launcher(
                *outs, xy, valid, d_rgb, d_ray, False)),
            "scalar_kernel_ms": cuda_time(scalar),
            "plain_ms": cuda_time(lambda: eg.epipolar_gather_backward_plain(
                *shapes, xy, valid, d_rgb, d_ray)),
            "library_ms": cuda_time(gather_backward_library(
                args, (d_rgb, d_ray))),
            **bound(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES)}
        log(f"epipolar_gather_backward {name} (ms: the wrapper, its "
            f"allocations included; kernel_ms: the bare launch, all "
            f"{per_call} CUDA launches; scalar_kernel_ms: the bare launch "
            f"on shifted tensors, element stores): " + json.dumps(times[name]))
    return {"name": "epipolar_gather_backward", "route": "cuda",
            "source": "graspnerf_tpu_torch/csrc/epipolar_gather.cu",
            "replaces": "graspnerf_tpu/ops/fused_gather.py:260",
            "max_abs_err": errs[vol], **times[vol],
            "planner_ms": times[planned]["ms"],
            "planner_kernel_ms": times[planned]["kernel_ms"],
            "train_ms": times[trained]["ms"],
            "train_kernel_ms": times[trained]["kernel_ms"],
            "train_plain_ms": times[trained]["plain_ms"],
            "train_library_ms": times[trained]["library_ms"],
            "train_bound_ms": times[trained]["bound_ms"],
            "train_max_abs_err": errs[trained],
            "train_random_kernel_ms": times[spread]["kernel_ms"],
            "planner_scalar_kernel_ms": times[planned]["scalar_kernel_ms"],
            "train_scalar_kernel_ms": times[trained]["scalar_kernel_ms"],
            "cuda_launches_per_call": len(names), "deterministic": True,
            **info}


def check_gather_backward_bf16(dev, gen, planner, scene, train_args,
                               names):
    """The gather's bfloat16 backward kernel (B'-bf16) against the plain
    bfloat16 backward on the card and on the CPU: random, the bfloat16
    planner's and the bfloat16 train pass's coordinates at P = 64,000 and
    20,480, ragged P, misaligned; the maps' and the image's gradients bit
    for bit but for at most BWD_BF16_SHARE of the values, each within one
    bfloat16 ulp of its cell's sum of |contributions|; two launches
    bit-equal (the maps'; the image's adds with atomics); non-finite
    upstream at invalid points; registers, spills and shared memory; times.
    names: its CUDA launches a call as the profiler saw them
    (`backward_launch_events`). Returns its row."""
    from graspnerf_tpu_torch.ops import epipolar_gather as eg
    bf = lambda a: [t.to(BF16) for t in a[:3]] + list(a[3:])  # noqa: E731
    vol, planned = f"random P={RES ** 3}", f"planner P={RES ** 3}"
    trained, spread = f"train P={TRAIN_ROWS}", f"random P={TRAIN_ROWS}"
    planner_args = planner_gather_inputs(planner, scene)
    cases = {vol: bf(gather_inputs(gen, dev)),
             planned: [*planner.model.nr_net.gather_maps(*planner_args[:3]),
                       *planner_args[3:]],
             trained: [t.detach() for t in train_args],
             spread: bf(gather_inputs(gen, dev, TRAIN_ROWS))}
    for P in (1, 31, 33):
        cases[f"random P={P}"] = bf(gather_inputs(gen, dev, P))
    cases["random P=1000 shifted"] = bf(gather_inputs(gen, dev, 1000))
    upstream, errs, shares = {}, {}, {}

    def plain(shapes, xy, valid, d_rgb, d_ray, imgs=True):
        out = eg.epipolar_gather_backward_plain(*shapes, xy, valid, d_rgb,
                                                d_ray, imgs, BF16)
        return out if imgs else out[1:]

    def compare(got, want, scale, what):
        """Bit-equal values (NaN where the other is NaN) but for a share
        within one bfloat16 ulp of scale; returns that share."""
        g, w = got.float(), want.float()
        check(torch.equal(g.isnan(), w.isnan()), f"{what}: NaN cells differ")
        ok = ~w.isnan()
        g, w, a = g[ok], w[ok], scale.float()[ok]
        differ = g != w
        big = torch.maximum(torch.maximum(g.abs(), w.abs()), a)
        over = ((g - w).abs() - bf16_ulp(big))[differ]
        check(over.numel() == 0 or float(over.max()) <= 0,
              f"{what}: beyond one bfloat16 ulp of the cell's scale")
        share = float(differ.float().mean()) if differ.numel() else 0.0
        check(share <= BWD_BF16_SHARE, f"{what}: {share:.2e} of the values "
              f"differ (at most {BWD_BF16_SHARE})")
        return share

    for name, args in cases.items():
        check(args[1].dtype == BF16, f"{name}: maps bf16")
        V, P = args[3].shape[:2]
        C = args[1].shape[3]
        shapes = (tuple(args[0].shape), tuple(args[1].shape))
        d_rgb = torch.randn(V, P, 3 + C, generator=gen).to(dev, BF16)
        d_ray = torch.randn(V, P, C, generator=gen).to(dev)
        xy, valid = args[3], args[4]
        if name.endswith("shifted"):   # the element path: misaligned
            d_rgb, d_ray = shifted(d_rgb), shifted(d_ray)

            def run():
                outs = [shifted(torch.zeros(s, device=dev, dtype=d))
                        for s, d in ((shapes[0], torch.float32),
                                     (shapes[1], BF16), (shapes[1], BF16))]
                d_imgs, *maps = eg.backward_launcher(
                    *outs, xy, valid, d_rgb, d_ray)()
                return [d_imgs.to(BF16), *maps]
        else:
            def run():
                return eg.epipolar_gather_backward(
                    xy, valid, d_rgb, d_ray, *shapes, need_imgs=True,
                    dtype=BF16)
        got, again = run(), run()
        torch.cuda.synchronize()
        for g, a, what in zip(got[1:], again[1:],
                              ("d_img_feats", "d_ray_feats")):
            check(g.dtype == BF16 and torch.equal(g, a),
                  f"gather backward bf16 {what} {name}: two launches differ")
        upstream[name] = (d_rgb, d_ray)
        want = plain(shapes, xy, valid, d_rgb, d_ray)
        scale = plain(shapes, xy, valid, d_rgb.abs(), d_ray.abs())
        cpu = plain(shapes, *[t.cpu() for t in (xy, valid, d_rgb, d_ray)])
        shares[name] = max(
            max(compare(g, w, a, f"gather backward bf16 {what} {name}"),
                compare(g.cpu(), c, a.cpu(),
                        f"gather backward bf16 {what} {name} (CPU)"))
            for g, w, c, a, what in zip(got, want, cpu, scale, (
                "d_imgs", "d_img_feats", "d_ray_feats")))
        errs[name] = max(max_err(g, w) for g, w in zip(got, want))
        log(f"epipolar_gather_backward_bf16 {name}: max_abs_err "
            f"{errs[name]:.3e}; {shares[name]:.2e} of the values one bfloat16 "
            f"ulp of their cell's scale from the plain version's (on the "
            f"card or the CPU), the rest bit-equal; two launches bit-equal")

    # non-finite upstream at invalid points: NaN in every cell of such a
    # point's window, in that channel, as in the plain version
    args = bf(gather_inputs(gen, dev, 1000))
    xy, valid = args[3], args[4]
    shapes = (tuple(args[0].shape), tuple(args[1].shape))
    d_rgb = torch.randn(VIEWS, 1000, 35, generator=gen).to(dev, BF16)
    d_ray = torch.randn(VIEWS, 1000, 32, generator=gen).to(dev)
    bad = (~valid).nonzero()[:4]
    d_rgb[bad[:2, 0], bad[:2, 1], 7] = float("inf")
    d_rgb[bad[:1, 0], bad[:1, 1], 1] = float("-inf")   # an RGB channel
    d_ray[bad[2:, 0], bad[2:, 1], 3] = float("nan")
    got = eg.epipolar_gather_backward(xy, valid, d_rgb, d_ray, *shapes,
                                      need_imgs=True, dtype=BF16)
    want = plain(shapes, xy, valid, d_rgb, d_ray)
    scale = plain(shapes, xy, valid, d_rgb.abs(), d_ray.abs())
    for g, w, a, what in zip(got, want, scale,
                             ("d_imgs", "d_img_feats", "d_ray_feats")):
        check(bool(g.isnan().any()), f"gather backward bf16 {what}: no NaN")
        compare(g, w, a, f"gather backward bf16 {what} non-finite")
    log(f"epipolar_gather_backward_bf16: inf and NaN upstream at 4 invalid "
        f"points give NaN in the plain version's "
        + " + ".join(str(int(g.isnan().sum())) for g in got)
        + " image and map values, and nowhere else")

    per_call = len(names)
    info = eg.backward_kernel_info(BF16)
    log(f"epipolar_gather_backward_bf16: kernels as built "
        f"{json.dumps(info)}")

    times = {}
    for name in (vol, planned, trained, spread):
        args = cases[name]
        d_rgb, d_ray = upstream[name]
        xy, valid = args[3], args[4]
        shapes = (tuple(args[0].shape), tuple(args[1].shape))
        V, P = xy.shape[:2]
        C = shapes[1][3]
        stand_in = torch.empty(shapes[0], device=dev)
        outs = [torch.empty(shapes[1], device=dev, dtype=BF16)
                for _ in range(2)]
        # each upstream gradient (d_rgb bfloat16, d_ray float32), xy and
        # valid read once; the two maps' bfloat16 gradients written once
        nbytes = (sum(t.numel() * t.element_size()
                      for t in (xy, valid, d_rgb, d_ray))
                  + 2 * math.prod(shapes[1]) * 2)
        # per (view, point, channel of both maps), at its four cells: the
        # weight's multiply, the rounding and the add
        flops = V * P * 2 * C * 12
        times[name] = {
            "ms": cuda_time(lambda: eg.epipolar_gather_backward(
                xy, valid, d_rgb, d_ray, *shapes, dtype=BF16)),
            "kernel_ms": cuda_time(eg.backward_launcher(
                stand_in, *outs, xy, valid, d_rgb, d_ray, False)),
            "plain_ms": cuda_time(lambda: plain(shapes, xy, valid, d_rgb,
                                                d_ray, False)),
            "library_ms": cuda_time(gather_backward_library(
                args, (d_rgb, d_ray))),
            **bound(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES)}
        log(f"epipolar_gather_backward_bf16 {name} (ms: the wrapper, its "
            f"allocations included; kernel_ms: the bare launch, all "
            f"{per_call} CUDA launches): " + json.dumps(times[name]))
    return {"name": "epipolar_gather_backward_bf16", "route": "cuda",
            "dtype": "bfloat16",
            "source": "graspnerf_tpu_torch/csrc/epipolar_gather.cu",
            "replaces": "graspnerf_tpu/ops/fused_gather.py:260",
            "max_abs_err": errs[vol], "ulp_share": shares[vol], **times[vol],
            "planner_ms": times[planned]["ms"],
            "planner_kernel_ms": times[planned]["kernel_ms"],
            "train_ms": times[trained]["ms"],
            "train_kernel_ms": times[trained]["kernel_ms"],
            "train_plain_ms": times[trained]["plain_ms"],
            "train_library_ms": times[trained]["library_ms"],
            "train_bound_ms": times[trained]["bound_ms"],
            "train_max_abs_err": errs[trained],
            "train_ulp_share": shares[trained],
            "train_random_kernel_ms": times[spread]["kernel_ms"],
            "cuda_launches_per_call": len(names), "deterministic": True,
            **info}


# ---------------------------------------- the gather's gradient w.r.t. xy
def border_inputs(gen, dev, P=RES ** 3):
    """gather_inputs with every point clamped at the border on one axis:
    the first half left or right of the image's columns (0.01 to 6 px past
    the first or last pixel centre), the second half above or below its
    rows; their derivative along that axis is exactly 0."""
    args = gather_inputs(gen, dev, P)
    xy = args[3].clone()
    low = (torch.rand(VIEWS, P, generator=gen) > 0.5).to(dev)
    # at least 0.01 px past the centre: a smaller offset below 0 can round
    # to the border itself, where floor takes the inner taps
    off = (0.01 + torch.rand(VIEWS, P, generator=gen) * 6).to(dev)
    for axis, size, pts in ((0, WIDTH, slice(0, P // 2)),
                            (1, HEIGHT, slice(P // 2, P))):
        xy[:, pts, axis] = torch.where(low[:, pts], -off[:, pts],
                                       size - 1 + off[:, pts])
    args[3] = xy
    return args


def gather_xy_library(args, grads):
    """Yardstick, which the port never calls: the gradient of three
    F.grid_sample calls with respect to their (normalised) grid alone, in
    the maps' dtype."""
    import torch.nn.functional as F
    imgs, f1, f2, xy, _ = args
    maps = [m.detach().permute(0, 3, 1, 2).contiguous() for m in (imgs, f1, f2)]
    g = torch.stack([xy[..., 0] / (WIDTH - 1) * 2 - 1,
                     xy[..., 1] / (HEIGHT - 1) * 2 - 1], -1)[:, None].to(
                         imgs.dtype).detach().requires_grad_()
    with torch.enable_grad():
        outs = [F.grid_sample(m, g, mode="bilinear", padding_mode="border",
                              align_corners=(i == 0))
                for i, m in enumerate(maps)]
    d_rgb, d_ray = grads
    cot = [d_rgb[..., :3], d_rgb[..., 3:], d_ray]
    cot = [c.to(imgs.dtype).permute(0, 2, 1)[:, :, None].contiguous()
           for c in cot]
    return lambda: torch.autograd.grad(outs, g, cot, retain_graph=True)


def check_gather_backward_xy(dev, gen, planner, scene, dtype=torch.float32):
    """B'-xy, the gather's gradient with respect to xy, of the maps' `dtype`
    instance: the kernel against its plain version on the card (XY_RTOL of
    the largest |d_xy|) on random, the planner's and border-clamped
    coordinates (exactly 0 along the clamped axis), at ragged P and on
    misaligned tensors;
    `torch.autograd.grad` through `epipolar_gather` bit-equal to the
    kernel's own launch; inf and NaN upstream at invalid points (NaN
    exactly there); registers and spills; times. `planner`: of that
    dtype. Returns its row."""
    from graspnerf_tpu_torch.ops import epipolar_gather as eg
    bf16 = dtype == BF16
    name = "epipolar_gather_backward_xy" + ("_bf16" if bf16 else "")

    def cast(args):
        return [t.to(dtype) for t in args[:3]] + list(args[3:])
    vol, planned = f"random P={RES ** 3}", f"planner P={RES ** 3}"
    border = f"border P={RES ** 3}"
    planner_args = planner_gather_inputs(planner, scene)
    if bf16:
        planner_args[:3] = planner.model.nr_net.gather_maps(*planner_args[:3])
    cases = {vol: cast(gather_inputs(gen, dev)), planned: planner_args,
             border: cast(border_inputs(gen, dev))}
    for P in (1, 31, 33):
        cases[f"random P={P}"] = cast(gather_inputs(gen, dev, P))
    # maps and d_ray one element off 16 bytes: the kernel's float reads
    cases["random P=1000 shifted"] = [
        shifted(t) for t in cast(gather_inputs(gen, dev, 1000))]

    def upstream(V, P, C):
        return (torch.randn(V, P, 3 + C, generator=gen).to(dev, dtype),
                torch.randn(V, P, C, generator=gen).to(dev))
    grads, errs = {}, {}
    for case, args in cases.items():
        check(args[1].dtype == dtype, f"{name} {case}: maps {args[1].dtype}")
        grads[case] = upstream(*args[3].shape[:2], args[1].shape[3])
        if case.endswith("shifted"):
            grads[case] = tuple(shifted(g) for g in grads[case])
        got = eg.epipolar_gather_backward_xy(*args, *grads[case])
        want = eg.epipolar_gather_backward_xy_plain(*args, *grads[case])
        torch.cuda.synchronize()
        check(got.shape == args[3].shape and bool(torch.isfinite(got).all()),
              f"{name} {case}: shape {tuple(got.shape)} or not finite")
        scale = float(want.abs().max())
        errs[case] = max_err(got, want)
        check(errs[case] <= XY_RTOL * scale, f"{name} {case}: max err "
              f"{errs[case]:.3e} beyond {XY_RTOL} of its scale {scale:.3e}")
        if case == border:
            half = args[3].shape[1] // 2
            check(bool((got[:, :half, 0] == 0).all())
                  and bool((got[:, half:, 1] == 0).all()),
                  f"{name}: a clamped axis has a non-zero derivative")
        log(f"{name} {case}: max_abs_err {errs[case]:.3e} vs the plain "
            f"version on the card (scale {scale:.3e}, rtol {XY_RTOL})")

    # through autograd: the same launch, xy alone and with the maps
    args = cases[vol]
    d_rgb, d_ray = grads[vol]
    want = eg.epipolar_gather_backward_xy(*args, d_rgb, d_ray)
    for with_maps in (False, True):
        maps = [m.detach().requires_grad_(with_maps) for m in args[:3]]
        xy = args[3].detach().requires_grad_()
        with torch.enable_grad():
            got = torch.autograd.grad(eg.epipolar_gather(*maps, xy, args[4]),
                                      [xy, *maps[:with_maps * 3]],
                                      (d_rgb, d_ray))
        check(torch.equal(got[0], want), f"{name}: autograd.grad through "
              f"epipolar_gather (maps too: {with_maps}) differs from the "
              f"kernel's launch")

    # inf and NaN upstream at invalid points: NaN in both coordinates there
    args = cast(gather_inputs(gen, dev, 1000))
    valid = args[4]
    d_rgb, d_ray = upstream(VIEWS, 1000, args[1].shape[3])
    bad = (~valid).nonzero()[:3]
    d_rgb[bad[0, 0], bad[0, 1], 1] = float("inf")
    d_rgb[bad[1, 0], bad[1, 1], 5] = -float("inf")
    d_ray[bad[2, 0], bad[2, 1], 2] = float("nan")
    got = eg.epipolar_gather_backward_xy(*args, d_rgb, d_ray)
    want = eg.epipolar_gather_backward_xy_plain(*args, d_rgb, d_ray)
    expect = torch.zeros_like(valid)
    expect[bad[:, 0], bad[:, 1]] = True
    check(torch.equal(got.isnan().all(-1), expect)
          and torch.equal(got.isnan(), want.isnan()),
          f"{name}: NaN points differ with non-finite upstream values at "
          f"invalid points")
    ok = ~expect
    e = max_err(got[ok], want[ok])
    check(e <= XY_RTOL * float(want[ok].abs().max()),
          f"{name}: non-finite case max err {e:.3e}")
    info = eg.backward_xy_kernel_info(dtype)
    log(f"{name}: inf and NaN upstream at 3 invalid points give NaN in "
        f"both of their coordinates and nowhere else; kernel as built "
        f"{json.dumps(info)}")

    times = {}
    for case in (vol, planned, border):
        args = cases[case]
        d_rgb, d_ray = grads[case]
        V, P = args[3].shape[:2]
        C = args[1].shape[3]
        d_xy = torch.empty(V, P, 2, device=dev)
        # each input read once (the maps whole, as gather_bound counts
        # them), d_xy written once; per (view, point) and channel of the
        # two maps and the image: the masked upstream, two tap differences
        # and their weighting per axis (float32 in both instances)
        nbytes = (sum(t.numel() * t.element_size()
                      for t in (*args, d_rgb, d_ray)) + d_xy.numel() * 4)
        flops = V * P * (3 + 2 * C) * 16
        times[case] = {
            "ms": cuda_time(lambda: eg.epipolar_gather_backward_xy(
                *args, d_rgb, d_ray)),
            "kernel_ms": cuda_time(eg.backward_xy_launcher(
                *args, d_rgb, d_ray, d_xy)),
            "plain_ms": cuda_time(lambda: eg.epipolar_gather_backward_xy_plain(
                *args, d_rgb, d_ray)),
            "library_ms": cuda_time(gather_xy_library(args, (d_rgb, d_ray))),
            **bound(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES)}
        log(f"{name} {case} (ms: the wrapper, its allocation included; "
            f"kernel_ms: the bare launch): " + json.dumps(times[case]))
    return {"name": name, "route": "cuda",
            "source": "graspnerf_tpu_torch/csrc/epipolar_gather.cu",
            "replaces": "graspnerf_tpu/ops/fused_gather.py:268",
            "max_abs_err": errs[vol], **times[vol],
            "planner_ms": times[planned]["ms"],
            "planner_kernel_ms": times[planned]["kernel_ms"],
            "planner_library_ms": times[planned]["library_ms"],
            "planner_max_abs_err": errs[planned],
            "border_kernel_ms": times[border]["kernel_ms"],
            "border_max_abs_err": errs[border], **info}


def xy_launches():
    from graspnerf_tpu_torch.ops.epipolar_gather import (
        epipolar_gather_backward_xy)
    return epipolar_gather_backward_xy.launches


def zero_xy_launches():
    from graspnerf_tpu_torch.ops.epipolar_gather import (
        epipolar_gather_backward_xy)
    epipolar_gather_backward_xy.launches = 0


# --------------------------------------------------- dataset -> train
def run_dataset_train(dev, smi):
    """The training path from the start: the port's writer
    (`data.generate`, the entry point of `python3 -m
    graspnerf_tpu_torch.data.generate`) at the shipped data shape -- 24
    hemisphere views at 288 x 512, the 40^3 TSDF fused on the card, 40
    executed grasp candidates a scene, procedural pile scenes of 4 objects
    -- for GEN_SCENES scenes; the tree read back by `VGNSynDataset`; then
    GEN_STEPS steps of `Trainer.run` on it through LOOP_WORKERS data
    workers at the shipped training shape (512 rays x (40 + 40) samples,
    the 40^3 volume, 32 grasps), 3 launches of each kernel a step; the
    first batch's losses and gradients through the kernels against the
    plain versions, and a written sample's with a positive grasp label
    where the first batch draws none. Fails on a writer error, an empty
    label file, scenes without a positive label or a ray traced by
    numpy."""
    import csv
    import tempfile
    from graspnerf_tpu_torch.data import (DatasetFactory, SceneLoader,
                                          VGNSynDataset, hemisphere_poses,
                                          to_device)
    from graspnerf_tpu_torch.data.generate import generate
    from graspnerf_tpu_torch.data.prefetch import PREFETCH_BATCHES
    from graspnerf_tpu_torch.sim import objects
    from graspnerf_tpu_torch.train import Trainer, create_train_state
    from graspnerf_tpu_torch.train.trainer import scene

    with tempfile.TemporaryDirectory() as root:
        numpy_rays = objects.TRACES["numpy"]
        t0 = time.perf_counter()
        records = generate([root, "--scenes", str(GEN_SCENES), "--seed",
                            str(GEN_SEED), "--executed-labels",
                            "--grasp-candidates", str(GEN_CANDIDATES)])
        wall = time.perf_counter() - t0
        check(objects.TRACES["numpy"] == numpy_rays,
              f"dataset: {objects.TRACES['numpy'] - numpy_rays} rays traced "
              f"by numpy")
        for r, sid in zip(records, (f"scene_{GEN_SEED:02d}_{i:04d}"
                                    for i in range(GEN_SCENES))):
            with open(f"{root}/grasps/{sid}.csv") as f:
                rows = list(csv.DictReader(f))
            check(len(rows) == r["grasps"] == GEN_CANDIDATES,
                  f"dataset: {sid} has {len(rows)} labels")
        parts = ("scene", "render", "tsdf", "labels", "write")
        per_scene = {k: [round(r[k], 4) for r in records] for k in parts}
        log(f"dataset: {GEN_SCENES} scenes of {len(hemisphere_poses())} "
            f"views at {HEIGHT} x {WIDTH} written in {wall:.2f} s; seconds "
            f"a scene by part (scene build and settling, render: host; "
            f"tsdf: card; labels: {GEN_CANDIDATES} executed candidates, "
            f"host; write: PNG, EXR, npy, npz, csv) " + json.dumps(per_scene)
            + "; objects " + json.dumps([r["objects"] for r in records])
            + ", positive labels "
            + json.dumps([r["positive"] for r in records]))
        check(sum(r["positive"] for r in records) > 0,
              "dataset: no positive executed label in the written scenes")

        kw = dict(root=root, sdf_root=f"{root}/sdf",
                  grasp_root=f"{root}/grasps", n_rays=TRAIN_RAYS,
                  n_grasps=TRAIN_GRASPS)
        t0 = time.perf_counter()
        first = VGNSynDataset(seed=SEED, **kw).sample()
        read_s = time.perf_counter() - t0
        shapes = {"imgs": first["data"]["ref"]["imgs"].shape,
                  "sdf_gt": first["sdf_gt"].shape,
                  "grasp_index": first["data"]["grasp_index"].shape}
        check(shapes == {"imgs": (VIEWS, HEIGHT, WIDTH, 3),
                         "sdf_gt": (RES,) * 3,
                         "grasp_index": (TRAIN_GRASPS, 3)},
              f"dataset: read back {shapes}")
        check(bool(((first["sdf_gt"] > -1) & (first["sdf_gt"] < 1)).any()),
              "dataset: the read-back TSDF has no surface band")
        log(f"dataset: read back by VGNSynDataset, a sample in {read_s:.3f} "
            f"s in this process: " + json.dumps(
                {k: list(v) for k, v in shapes.items()}))

        # a written sample with a positive label, for the comparison below
        # where the loader's first batch draws none
        positive = next((b for b in (VGNSynDataset(seed=SEED + k, **kw)
                                     .sample() for k in range(64))
                         if (b["grasp_label"] > 0).any()), None)
        check(positive is not None, "dataset: 64 samples of the written "
              "tree drew no positive grasp label")

        factory = DatasetFactory(VGNSynDataset, **kw)
        with tempfile.TemporaryDirectory() as workdir, SceneLoader(
                factory, LOOP_WORKERS, seed=SEED, pin_memory=True) as loader:
            trainer = Trainer(train_model(), FirstBatch(loader),
                              workdir=workdir, log_every=1,
                              val_interval=10 ** 9, save_interval=10 ** 9,
                              seed=SEED, tensorboard=False, device=dev)
            zero_counts()
            t0 = time.perf_counter()
            trainer.run(GEN_STEPS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = counts()
            check(launches == {k: 3 * GEN_STEPS for k in launches},
                  f"dataset train: launches {launches}, not 3 of each "
                  f"kernel a step")
            recs = [r for r in read_log(workdir) if "sec_per_step" in r]
            check([r["step"] for r in recs] == list(range(1, GEN_STEPS + 1)),
                  f"dataset train: logged steps {[r['step'] for r in recs]}")
            for r in recs:
                bad = [k for k, v in r.items() if isinstance(v, float)
                       and not math.isfinite(v)]
                check(not bad and r["nonfinite_grad"] == 0.0,
                      f"dataset train: step {r['step']} not finite: {bad}")
            batch = to_device(scene(trainer.train_iter.first, 0), dev)
            rate = pipeline_scenes_per_s(loader)
    # past the LOOP_WORKERS x PREFETCH_BATCHES batches queued at the start
    queued = LOOP_WORKERS * PREFETCH_BATCHES
    steady = {k: [r[k] for r in recs[queued:]]
              for k in ("sec_per_step", "data_wait_per_step")}
    log(f"dataset train: Trainer.run {GEN_STEPS} steps on the written tree "
        f"in {wall:.2f} s wall (worker start included), launches "
        f"{launches}; sec_per_step "
        + json.dumps([r["sec_per_step"] for r in recs])
        + ", data_wait_per_step "
        + json.dumps([r.get("data_wait_per_step", float("nan"))
                      for r in recs]) + f" ({LOOP_WORKERS} workers); steady "
        f"state (steps {queued + 1}-{GEN_STEPS}, past the {LOOP_WORKERS} x "
        f"{PREFETCH_BATCHES} queued batches): sec_per_step mean "
        f"{np.mean(steady['sec_per_step'])}, data_wait_per_step mean "
        f"{np.mean(steady['data_wait_per_step'])}; the loader alone "
        f"{rate} scenes/s; {smi}")
    kern, plain = (create_train_state(train_model(k), device=dev)
                   for k in (True, False))
    log("dataset train: the first batch (a written scene), kernels vs plain "
        "versions:")
    compare_train(kern, plain, batch, dev)
    if not bool((batch["grasp_label"] > 0).any()):
        log("dataset train: the first batch draws no positive grasp label; "
            "a written sample that does, kernels vs plain versions:")
        compare_train(kern, plain, to_device(positive, dev), dev)
    return {"launches": launches, "steps": GEN_STEPS,
            "per_scene": per_scene}


# ------------------------------------------------------------- parallel
def stack_scenes(trees):
    if isinstance(trees[0], dict):
        return {k: stack_scenes([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def first_scene(tree):
    if isinstance(tree, dict):
        return {k: first_scene(v) for k, v in tree.items()}
    return tree[:1]


def parallel_batches(dev):
    """{case: its global batch}: two seeded full-width scenes for the data
    axis, the first alone for the space axis."""
    from graspnerf_tpu_torch.tools.scene import training_batch
    rng = np.random.RandomState(SEED)
    two = stack_scenes([training_batch(rng, dev, VIEWS, HEIGHT, WIDTH,
                                       TRAIN_RAYS, RES, TRAIN_GRASPS)
                        for _ in range(2)])
    return {"data": two, "space": first_scene(two)}


class CollectiveClock:
    """Counts the all_gather and all_reduce calls of torch.distributed while
    it is entered, and the host ms spent inside them with the card drained
    before and after each (so the card's queued work is not counted; the
    wait for the other ranks to arrive is)."""

    def __enter__(self):
        import torch.distributed as dist
        self.calls, self.ms, self.saved = 0, 0.0, {}
        for name in ("all_gather", "all_reduce"):
            self.saved[name] = original = getattr(dist, name)

            def timed(*args, _call=original, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _call(*args, **kw)
                torch.cuda.synchronize()
                self.ms += (time.perf_counter() - t0) * 1e3
                self.calls += 1
                return out
            setattr(dist, name, timed)
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist
        for name, original in self.saved.items():
            setattr(dist, name, original)


def parallel_step(dev, dtype, mesh, batch, fine=None, timed=PAR_TIMED):
    """One training step of the seeded `train_model(dtype)` on this rank's
    share of `batch` (the whole batch without a mesh), the fine pass at
    `fine` (one tensor a scene of the global batch) when given: {metrics,
    grads and params (on the CPU), finite, fine, launches, ms: the median,
    min and max of `timed` more steps (CUDA events), peak_gib}."""
    from graspnerf_tpu_torch.ops.epipolar_gather import (
        epipolar_gather_backward)
    from graspnerf_tpu_torch.parallel import (replicate, scene_indices,
                                              shard_batch)
    from graspnerf_tpu_torch.tools.scene import pinned_fine_samples
    from graspnerf_tpu_torch.train import (apply_gradients,
                                           create_train_state,
                                           make_batched_loss_fn,
                                           mesh_gradients, scene_generators)
    torch.cuda.reset_peak_memory_stats(dev)
    state = create_train_state(train_model(dtype=dtype), device=dev)
    local, scenes = batch, range(batch["sdf_gt"].shape[0])
    if mesh is not None:
        state.model.nr_net.space = mesh.split
        replicate(state.model)
        local = shard_batch(mesh, batch)
        scenes = scene_indices(mesh, local["sdf_gt"].shape[0])
    loss_fn = make_batched_loss_fn(state.model)

    def step(i):
        metrics, grads = mesh_gradients(
            state, loss_fn, local, scene_generators(SEED, i, scenes, dev),
            mesh)
        return metrics, grads, apply_gradients(state, grads)
    zero_counts()
    (metrics, grads, finite), own = pinned_fine_samples(
        lambda: step(0), None if fine is None else [fine[i] for i in scenes])
    torch.cuda.synchronize()
    launches = dict(counts(), **bf16_counts()[0],
                    epipolar_gather_backward_bf16=epipolar_gather_backward
                    .bf16_launches)
    out = {"metrics": {k: float(v.detach()) for k, v in metrics.items()},
           "grads": [g.cpu() for g in grads], "finite": finite,
           "params": [p.detach().cpu() for p in state.model.parameters()],
           "fine": [f.cpu() for f in own], "launches": launches}
    ms = []
    for i in range(timed):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        step(i + 1)
        ev[1].record()
        torch.cuda.synchronize()
        ms.append(ev[0].elapsed_time(ev[1]))
    out["ms"] = [float(np.median(ms)), min(ms), max(ms)]
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    if mesh is not None:   # one more step, its collectives timed alone
        with CollectiveClock() as clock:
            step(timed + 1)
        out["collectives"] = (clock.calls, clock.ms)
    return out


def gloo_collectives(dev):
    """What gloo takes on this rank's card: each collective on a float32
    and a bfloat16 CUDA tensor, 'ok' or the error."""
    import torch.distributed as dist
    out = {}
    for dtype in (torch.float32, BF16):
        x = torch.ones(8, device=dev, dtype=dtype)
        calls = {
            "all_gather": lambda: dist.all_gather(
                [torch.empty_like(x) for _ in range(2)], x),
            "all_reduce_sum": lambda: dist.all_reduce(x.clone()),
            "all_reduce_avg": lambda: dist.all_reduce(
                x.clone(), op=dist.ReduceOp.AVG),
            "broadcast": lambda: dist.broadcast(x.clone(), 0),
            "all_to_all_single": lambda: dist.all_to_all_single(
                torch.empty_like(x), x.clone())}
        for name, call in calls.items():
            try:
                call()
                torch.cuda.synchronize()
                out[f"{name} {str(dtype)[6:]}"] = "ok"
            except Exception as e:   # recorded: what the backend refuses
                out[f"{name} {str(dtype)[6:]}"] = repr(e)[:120]
    return out


def parallel_rank(rank, addr, tmp, dev):
    """One of two gloo ranks on the card `dev` (a spawned process): the
    gloo probe, then each case of PAR_CASES at its fine samples; writes
    <tmp>/rank<r>.pt."""
    from graspnerf_tpu_torch.parallel import initialize, make_mesh, shutdown
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    initialize(addr, 2, rank, "gloo", dev)
    try:
        fine = torch.load(f"{tmp}/fine.pt", weights_only=True)
        batches = parallel_batches(dev)
        out = {"collectives": gloo_collectives(dev)}
        for dtype, case, shape in PAR_CASES:
            out[dtype, case] = parallel_step(
                dev, dtype, make_mesh(*shape), batches[case],
                [f.to(dev) for f in fine[f"{dtype} {case}"]])
        torch.save(out, f"{tmp}/rank{rank}.pt")
    finally:
        shutdown()


def run_parallel_ranks(tmp, dev):
    """The two ranks, each joined with a timeout; any failure fails."""
    import torch.multiprocessing as mp
    from graspnerf_tpu_torch.train.cli import free_port
    ctx = mp.get_context("spawn")
    addr = f"tcp://127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=parallel_rank, args=(r, addr, tmp, dev))
             for r in range(2)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + PAR_TIMEOUT
    try:
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        alive = [p.pid for p in procs if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    check(not alive, f"parallel: ranks {alive} still running after "
          f"{PAR_TIMEOUT} s")
    codes = [p.exitcode for p in procs]
    check(codes == [0, 0], f"parallel: rank exit codes {codes}")
    return [torch.load(f"{tmp}/rank{r}.pt", weights_only=False)
            for r in range(2)]


def grad_distance(got, want, names, floor):
    """The largest max |got - want| of a parameter's gradient over its
    scale (those below `floor` skipped), and its name."""
    worst = (0.0, None)
    for name, g, w in zip(names, got, want):
        scale = float(w.abs().max())
        if scale >= floor and max_err(g, w) / scale > worst[0]:
            worst = (max_err(g, w) / scale, name)
    return worst


def run_parallel_nccl(dev):
    """(a) `train.cli --mesh 1,1 --dist-backend nccl` (world size 1) against
    the same command without --mesh: PAR_NCCL_STEPS steps at full width
    each, the same batches (in-process loading from one seed), every
    logged loss held at TRAIN_LOSS_RTOL and the checkpoint's parameters at
    PAR_NCCL_ATOL; the distances printed beside the command's distance
    from itself. Returns {launches, steps}."""
    import tempfile
    from graspnerf_tpu_torch.train import cli, load_params
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, extra in (("one process", []),
                            ("mesh 1,1", ["--mesh", "1,1",
                                          "--dist-backend", "nccl"]),
                            ("one process again", [])):
            zero_counts()
            check(cli.main([
                "--steps", str(PAR_NCCL_STEPS), "--workers", "0",
                "--workdir", f"{tmp}/{len(runs)}", "--log-every", "1",
                "--save-interval", str(PAR_NCCL_STEPS),
                "--val-interval", "1000", "--no-tensorboard", *extra]) == 0,
                f"parallel: train.cli {name}")
            torch.cuda.synchronize()
            recs = read_log(f"{tmp}/{len(runs)}")
            runs[name] = {"launches": counts(), "recs": recs,
                          "params": load_params(
                              f"{tmp}/{len(runs)}/ckpt/latest")}
    one, mesh, again = (runs[k] for k in ("one process", "mesh 1,1",
                                          "one process again"))
    cfg = mesh["recs"][0]
    check(cfg["mesh"] == {"data": 1, "space": 1} and cfg["n_devices"] == 1
          and cfg["dist_backend"] == "nccl", f"parallel (a): {cfg}")

    def distance(a, b):
        """Each step's largest relative loss difference, and the largest
        parameter difference after the last step."""
        steps = [[r for r in run["recs"] if "sec_per_step" in r]
                 for run in (a, b)]
        check(len(steps[0]) == len(steps[1]) == PAR_NCCL_STEPS,
              "parallel (a): logged steps")
        losses = [max(abs(x[k] - y[k]) / max(abs(x[k]), 1e-12) for k in x
                      if k.startswith(("loss", "total")))
                  for x, y in zip(*steps)]
        return losses, max(max_err(a["params"][k], b["params"][k])
                           for k in a["params"])
    loss_err, param_err = distance(one, mesh)
    check(max(loss_err) <= TRAIN_LOSS_RTOL and param_err <= PAR_NCCL_ATOL,
          f"parallel (a): losses {loss_err} (rel), parameters "
          f"{param_err:.3e} from one process")
    check(one["launches"] == mesh["launches"] == {
        k: 3 * PAR_NCCL_STEPS for k in one["launches"]},
        f"parallel (a): launches {one['launches']} / {mesh['launches']}")
    sec = {k: [r["sec_per_step"] for r in run["recs"] if "sec_per_step" in r]
           for k, run in runs.items()}
    log(f"parallel (a) train.cli --mesh 1,1 --dist-backend nccl, "
        f"{PAR_NCCL_STEPS} steps at full width vs the same command without "
        f"a mesh: losses {[f'{e:.3e}' for e in loss_err]} (rel, a step) and "
        f"parameters {param_err:.3e} apart (bit-equal: "
        f"{max(loss_err) == 0 and param_err == 0}); the command without a "
        f"mesh against itself: {distance(one, again)}; sec_per_step "
        f"{json.dumps(sec)}; launches {mesh['launches']} "
        f"({one['launches']} without)")
    return {"launches": mesh["launches"], "steps": PAR_NCCL_STEPS,
            "one_process": one["recs"]}


def run_parallel_space_cli(one_process):
    """(c) `train.cli --mesh 1,2 --dist-backend gloo` on the one card: the
    command's own two ranks, the scene group's first rank loading each
    batch and broadcasting it to the other (CUDA tensors through gloo),
    PAR_NCCL_STEPS steps at full width, the command stopped after
    PAR_TIMEOUT s: it exits 0, one run-config line (rank 0's) with the
    mesh, every step finite, and each step's losses held to those of (a)'s
    command without a mesh (the same scenes and draws) at JAX's bounds for
    its sharded step."""
    import signal
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "graspnerf_tpu_torch.train.cli", "--mesh",
             "1,2", "--dist-backend", "gloo", "--steps", str(PAR_NCCL_STEPS),
             "--workers", "0", "--workdir", tmp, "--log-every", "1",
             "--save-interval", str(PAR_NCCL_STEPS), "--val-interval",
             "1000", "--no-tensorboard"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            start_new_session=True)   # its ranks are stopped with it
        try:
            out, _ = proc.communicate(timeout=PAR_TIMEOUT)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            out, _ = proc.communicate()
            check(False, f"parallel (c): train.cli --mesh 1,2 still running "
                  f"after {PAR_TIMEOUT} s: {out[-2000:]}")
        wall = time.perf_counter() - t0
        check(proc.returncode == 0, f"parallel (c): train.cli --mesh 1,2 "
              f"exit {proc.returncode}: {out[-3000:]}")
        recs = read_log(tmp)
        saved = sorted(os.listdir(f"{tmp}/ckpt"))
    cfgs = [r for r in recs if r.get("run_config")]
    check(len(cfgs) == 1 and cfgs[0]["mesh"] == {"data": 1, "space": 2}
          and cfgs[0]["n_devices"] == 2 and cfgs[0]["dist_backend"] == "gloo",
          f"parallel (c): run-config lines {cfgs}")
    check(saved == ["latest", f"step_{PAR_NCCL_STEPS}.pt"],
          f"parallel (c): checkpoints {saved}")
    steps = [r for r in recs if "sec_per_step" in r]
    want = [r for r in one_process if "sec_per_step" in r]
    check([r["step"] for r in steps] == [r["step"] for r in want],
          f"parallel (c): logged steps {[r['step'] for r in steps]}")
    worst = 0.0
    for got, w in zip(steps, want):
        bad = [k for k, v in got.items() if isinstance(v, float)
               and not math.isfinite(v)]
        check(not bad and got["nonfinite_grad"] == 0.0,
              f"parallel (c): step {got['step']} not finite: {bad}")
        for k in w:
            if k.startswith(("loss", "total")):
                err = abs(got[k] - w[k])
                check(err <= PAR_LOSS_ATOL + PAR_LOSS_RTOL * abs(w[k]),
                      f"parallel (c) step {got['step']} {k}: {got[k]} vs "
                      f"{w[k]} without a mesh")
                worst = max(worst, err / max(abs(w[k]), 1e-12))
    log(f"parallel (c) train.cli --mesh 1,2 --dist-backend gloo (two ranks "
        f"on the one card, the group's first rank loading and broadcasting "
        f"each batch), {PAR_NCCL_STEPS} steps at full width: losses within "
        f"{worst:.3e} (rel, largest) of the command without a mesh; "
        f"sec_per_step {[r['sec_per_step'] for r in steps]} against "
        f"{[r['sec_per_step'] for r in want]} without; the command "
        f"{wall:.1f} s wall, its two processes' start included")


def run_parallel(dev, smi):
    """The parallel phase: (a) NCCL at world size 1 through train.cli, (c)
    train.cli on a (1, 2) mesh of two gloo ranks, (b) two gloo ranks on the
    one card at (2, 1) and (1, 2), float32 and bfloat16, one step each held
    to the one-process step on the same scenes (the fine pass at its
    samples): losses at JAX's sharded-step bounds, the all-reduced
    gradients at the train phases' tolerances, every parameter bit-equal
    across the ranks; step times and launches per rank beside the
    one-process step's. Returns {launches: (a)'s, per rank and step of
    each case}."""
    import tempfile
    cards = torch.cuda.device_count()
    log(f"parallel: {cards} card(s) on this machine; multi-card scaling "
        + ("not measured (one card)" if cards == 1 else
           "not measured by this script"))
    nccl = run_parallel_nccl(dev)
    run_parallel_space_cli(nccl.pop("one_process"))
    batches = parallel_batches(dev)
    names = [n for n, _ in train_model().named_parameters()]
    with tempfile.TemporaryDirectory() as tmp:
        ref, fine = {}, {}
        for dtype, case, _ in PAR_CASES:
            ref[dtype, case] = parallel_step(dev, dtype, None, batches[case])
            fine[f"{dtype} {case}"] = ref[dtype, case]["fine"]
        torch.save(fine, f"{tmp}/fine.pt")
        del batches
        torch.cuda.empty_cache()
        ranks = run_parallel_ranks(tmp, dev)
    log(f"parallel (b): gloo on CUDA tensors: "
        + json.dumps(ranks[0]["collectives"]))
    launches = {}
    for dtype, case, shape in PAR_CASES:
        want, got = ref[dtype, case], [r[dtype, case] for r in ranks]
        what = f"parallel (b) {shape} {dtype}"
        loss_rtol, grad_tol, floor = (
            (PAR_LOSS_RTOL, TRAIN_GRAD_RTOL, GRAD_FLOOR) if dtype == "float32"
            else (PAR_LOSS_RTOL, TRAIN_BF16_GRAD_RTOL, TRAIN_BF16_GRAD_FLOOR))
        check(all(g["finite"] for g in got), f"{what}: an update skipped")
        per_rank = [g["metrics"] for g in got]
        merged = ({k: sum(m[k] for m in per_rank) / 2 for k in per_rank[0]}
                  if case == "data" else per_rank[0])
        if case == "space":
            check(per_rank[0] == per_rank[1], f"{what}: ranks' losses differ")
        loss_err = 0.0
        for k, w in want["metrics"].items():
            err = abs(merged[k] - w)
            check(err <= PAR_LOSS_ATOL + loss_rtol * abs(w),
                  f"{what} {k}: {merged[k]} vs one process {w}")
            loss_err = max(loss_err, err / max(abs(w), 1e-12))
        grad_err = [grad_distance(g["grads"], want["grads"], names, floor)
                    for g in got]
        for err, name in grad_err:
            check(err <= grad_tol, f"{what}: gradient of {name} {err:.3e} "
                  f"of its scale from one process (tol {grad_tol})")
        same = all(torch.equal(a, b) for a, b in zip(got[0]["params"],
                                                     got[1]["params"]))
        check(same, f"{what}: the ranks' parameters differ after the update")
        launches[f"{dtype} {case}"] = [g["launches"] for g in got]
        kern = ("view_fuse", "epipolar_gather", "epipolar_gather_backward")
        if dtype == "bfloat16":
            kern += tuple(k + "_bf16" for k in kern)
        for g in got:
            check(all(g["launches"][k] == 3 for k in kern),
                  f"{what}: launches a rank and step {g['launches']}")
        share = ("2 scenes, one a rank" if case == "data" else
                 f"{TRAIN_RAYS // 2} rays and {RES * RES // 2} volume "
                 f"columns a rank")
        log(f"{what} ({share}): "
            f"losses {loss_err:.3e} (rel, largest) from one process; "
            f"all-reduced gradients within {max(e for e, _ in grad_err):.3e} "
            f"of their scale ({grad_err[0][1]}); parameters bit-equal across "
            f"ranks; step ms a rank (median, min, max of {PAR_TIMED}) "
            f"{[g['ms'] for g in got]} vs one process {want['ms']}; launches "
            f"a rank and step {got[0]['launches']}; collectives a step "
            f"and host ms inside them, the card drained around each, a rank "
            f"{[g['collectives'] for g in got]}; peak GiB a rank "
            f"{[round(g['peak_gib'], 2) for g in got]} (one process "
            f"{want['peak_gib']:.2f})")
    log(smi)
    return {"nccl": nccl, "gloo": launches}


def run_checkpoint_import(dev, inputs):
    """The reference-checkpoint import: a reference-format model_best.pth
    (network_state_dict in torch layout with one dead buffer, step, an
    empty optimizer_state_dict) written from planner_params(), imported by
    `python3 -m graspnerf_tpu_torch.convert`; the float32 planner through
    the kernels on the imported weights, its volume bit-equal to the
    volume on the original weights. Returns that volume."""
    import tempfile
    from graspnerf_tpu_torch.detect.planner import GraspNeRFPlanner
    from graspnerf_tpu_torch.train.checkpoint import load_params
    sd = planner_params()
    dead = "nr_net.init_net.bn.num_batches_tracked"
    with tempfile.TemporaryDirectory() as d:
        torch.save({"network_state_dict": {**sd, dead: torch.tensor(3)},
                    "step": 7, "optimizer_state_dict": {}},
                   f"{d}/model_best.pth")
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "graspnerf_tpu_torch.convert",
             f"{d}/model_best.pth", f"{d}/port.pt"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=300)
        cli_s = time.perf_counter() - t0
        check(out.returncode == 0, f"checkpoint import failed: "
              f"{out.stderr[-2000:]}")
        check("1 unused torch keys" in out.stdout and dead in out.stdout,
              f"checkpoint import: the dead buffer was not reported: "
              f"{out.stdout[-500:]}")
        imported = load_params(f"{d}/port.pt")
    check(sorted(imported) == sorted(sd) and all(
        torch.equal(imported[k], v) for k, v in sd.items()),
        "checkpoint import: the imported weights differ")
    vols = [GraspNeRFPlanner(p, device=dev).core(*inputs)[0]
            for p in (sd, imported)]
    check(torch.equal(vols[0], vols[1]), f"checkpoint import: the planner's "
          f"volume on the imported weights differs by "
          f"{max_err(vols[0], vols[1]):.3e}")
    log(f"checkpoint import: python3 -m graspnerf_tpu_torch.convert in "
        f"{cli_s:.2f} s ({len(imported)} tensors, the dead buffer reported "
        f"unused); the float32 planner through the kernels on the imported "
        f"weights: volume bit-equal to the original weights'")
    return vols[1]


def run_mesh(vol):
    """`ops.mesh.volume_to_mesh` on the planner's volume (host)."""
    from graspnerf_tpu_torch.ops.mesh import volume_to_mesh
    t0 = time.perf_counter()
    verts, faces = volume_to_mesh(vol.cpu().numpy(),
                                  origin=(-0.15, -0.15, -0.05))
    ms = (time.perf_counter() - t0) * 1e3
    check(len(faces) > 0 and bool(np.isfinite(verts).all()),
          "mesh: no surface in the planner's volume")
    log(f"mesh: volume_to_mesh on the planner's {RES}^3 volume: "
        f"{len(verts)} vertices, {len(faces)} faces, {ms:.1f} ms host")


def backward_launch_events(dev):
    """CUDA launches (kernels and memsets) of one bare call of each
    instance of the gather's backward, B' and B'-bf16, at P = 64,000, as
    torch.profiler records them, each held to the library's own count:
    {row name: event names}. Taken first, in a process that has run no
    loop: once Trainer.run with its data workers has run, this script's
    profiler sessions lose device events at random, a call's memset or
    all of it (graspnerf_tpu_torch/tools/profiler_events.py)."""
    from graspnerf_tpu_torch.ops import epipolar_gather as eg
    gen = torch.Generator().manual_seed(SEED + 3)
    args = gather_inputs(gen, dev)
    V, P = args[3].shape[:2]
    C = args[1].shape[3]
    d_rgb = torch.randn(V, P, 3 + C, generator=gen).to(dev)
    d_ray = torch.randn(V, P, C, generator=gen).to(dev)
    stand_in = torch.empty(args[0].shape, device=dev)
    per_call = eg.backward_cuda_launches()
    out = {}
    for name, dtype in (("epipolar_gather_backward", torch.float32),
                        ("epipolar_gather_backward_bf16", BF16)):
        maps = [torch.empty(args[1].shape, device=dev, dtype=dtype)
                for _ in range(2)]
        names = device_events(eg.backward_launcher(
            stand_in, *maps, args[3], args[4], d_rgb.to(dtype), d_ray,
            False))
        check(len(names) == per_call <= 4, f"{name}: {len(names)} CUDA "
              f"launches a call ({names}), the library says {per_call}")
        log(f"{name}: {len(names)} CUDA launches a call "
            f"({', '.join(names)})")
        out[name] = names
    zero_counts()
    return out


def backward_profile(dev, planner, scene, train_args):
    """Per instance of the gather's backward (B' and B'-bf16): the device
    time of each CUDA launch of one bare call (torch.profiler, mean of 5
    calls) on random, the planner's and the train pass's coordinates, and
    what the index held on each: the longest tile list (entries, chunks,
    work items it was cut into) and the work items a view. Taken before the
    loop phase (backward_launch_events). {row name: row keys}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from graspnerf_tpu_torch.ops import epipolar_gather as eg
    gen = torch.Generator().manual_seed(SEED + 5)
    coords = {f"random P={RES ** 3}": gather_inputs(gen, dev)[3:],
              f"planner P={RES ** 3}": planner_gather_inputs(planner,
                                                             scene)[3:],
              f"train P={TRAIN_ROWS}": [t.detach() for t in train_args[3:]]}
    maps = (VIEWS, HEIGHT // 4, WIDTH // 4, 32)
    per_call = eg.backward_cuda_launches()
    out = {}
    for name, dtype in (("epipolar_gather_backward", torch.float32),
                        ("epipolar_gather_backward_bf16", BF16)):
        times, index = {}, {}
        for case, (xy, valid) in coords.items():
            V, P = xy.shape[:2]
            d_rgb = torch.randn(V, P, 35, generator=gen).to(dev, dtype)
            d_ray = torch.randn(V, P, 32, generator=gen).to(dev)
            launch = eg.backward_launcher(
                torch.empty(VIEWS, HEIGHT, WIDTH, 3, device=dev),
                *[torch.empty(maps, device=dev, dtype=dtype)
                  for _ in range(2)], xy, valid, d_rgb, d_ray, False)
            launch()
            torch.cuda.synchronize()
            # a profile that lost device events (all of a call's launches
            # not seen 5 times) is taken again, at most twice more
            for _ in range(3):
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(5):
                        launch()
                    torch.cuda.synchronize()
                us = {}
                for e in prof.events():
                    if (e.device_type == DeviceType.CUDA
                            and not e.is_user_annotation):
                        us.setdefault(e.name[:48], []).append(
                            e.time_range.elapsed_us())
                if len(us) == per_call and all(len(u) == 5
                                               for u in us.values()):
                    break
            times[case] = {k: round(sum(u) / len(u), 2)
                           for k, u in us.items()}
            if len(us) != per_call or any(len(u) != 5 for u in us.values()):
                times[case]["events lost"] = True
            index[case] = eg.backward_index_stats(launch)
        log(f"{name} device us a launch (one bare call): "
            + json.dumps(times))
        log(f"{name} index: " + json.dumps(index))
        out[name] = {"device_us": times, "index": index}
    zero_counts()
    return out


def device_events(fn):
    """Names of the device events (kernels, memsets, copies) of one call of
    fn, after a warm-up call, as torch.profiler records them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]


def event_ms(fn, iters):
    """[median, min, max] ms of `iters` calls of fn after one warm-up, CUDA
    events around each call."""
    fn()
    ms = []
    for _ in range(iters):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    return [float(np.median(ms)), min(ms), max(ms)]


def phase_times(planner, inputs, iters=20):
    """Per-phase ms of a planning call: median and spread (min, max) of
    `iters` calls of each phase."""
    ref = planner.scene(*inputs)
    feats = planner.encode(ref["imgs"])
    with torch.no_grad():
        vol = planner.model.nr_net.sample_volume(ref, *feats)
    phases = {"encode": lambda: planner.encode(ref["imgs"]),
              "volume": lambda: planner.model.nr_net.sample_volume(ref, *feats),
              "head_postprocess": lambda: planner.detect(vol)}
    with torch.no_grad():
        return {name + "_ms": event_ms(fn, iters)
                for name, fn in phases.items()}


def planner_stages(planner, inputs):
    """(name, call) of each stage of a planning call, on one scene."""
    ref = planner.scene(*inputs)
    with torch.no_grad():
        feats = planner.encode(ref["imgs"])
        vol = planner.model.nr_net.sample_volume(ref, *feats)
    return (("encode", lambda: planner.encode(ref["imgs"])),
            ("volume", lambda: planner.model.nr_net.sample_volume(
                ref, *feats)),
            ("head_postprocess", lambda: planner.detect(vol)))


def profile_call(title, stages, calls=3, grad=False):
    """torch.profiler over `calls` calls of `stages` ((name, call), run in
    order under named ranges), under no_grad unless `grad`: the device's
    busy share of the wall time, device ms per call of each stage, and the
    top ops by self device time."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with torch.set_grad_enabled(grad):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                for name, fn in stages:
                    with record_function(name):
                        fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    # kernels only: op rows and user ranges would count a kernel twice
    from torch.autograd import DeviceType
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    log(f"profile of a {title} ({calls} calls): device busy "
        f"{busy_us / calls / 1e3:.3f} ms "
        f"of {wall_us / calls / 1e3:.3f} ms wall per call "
        f"({100 * busy_us / wall_us:.1f} %), {len(kernels) // calls} kernels")
    inside_any = 0
    for name, _ in stages:   # kernels that start inside the stage's range
        spans = [e.time_range for e in events if e.is_user_annotation
                 and e.device_type == DeviceType.CUDA and e.name == name]
        host_us = sum(e.time_range.elapsed_us() for e in events
                      if e.is_user_annotation and e.name == name
                      and e.device_type == DeviceType.CPU)
        inside = [k.time_range.elapsed_us() for k in kernels if any(
            r.start <= k.time_range.start < r.end for r in spans)]
        inside_any += len(inside)
        log(f"  stage {name}: kernels busy {sum(inside) / calls / 1e3:.3f} "
            f"ms per call, {len(inside) // calls} kernels, host range "
            f"{host_us / calls / 1e3:.3f} ms"
            + ("" if spans else " (no device-side range)"))
    if inside_any < len(kernels):   # e.g. autograd's backward thread
        log(f"  {(len(kernels) - inside_any) // calls} kernels per call "
            f"launched outside the stages' device ranges (by another "
            f"thread)")
    totals = {}
    for k in kernels:
        t, n = totals.get(k.name, (0, 0))
        totals[k.name] = (t + k.time_range.elapsed_us(), n + 1)
    for name, (t, n) in sorted(totals.items(), key=lambda kv: -kv[1][0])[:15]:
        log(f"  {t / calls / 1e3:8.3f} ms {n // calls:5d}x  {name[:90]}")
    # where the host's time goes: ops by self CPU time (under the profiler,
    # which adds its own cost to every op)
    stage_names = {name for name, _ in stages}
    ops = [a for a in prof.key_averages() if a.key not in stage_names]
    log("  host, by self CPU time per call:")
    for a in sorted(ops, key=lambda a: -a.self_cpu_time_total)[:12]:
        log(f"  {a.self_cpu_time_total / calls / 1e3:8.3f} ms "
            f"{a.count // calls:5d}x  {a.key[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from graspnerf_tpu_torch import build
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    t0 = time.time()
    reports = build.build()
    log(f"build: {time.time() - t0:.1f} s ({', '.join(reports) or 'cached'})")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    gen = torch.Generator().manual_seed(SEED)
    zero_xy_launches()
    events = backward_launch_events(dev)
    planner, launches, inputs = run_planner(dev)
    planner16, launches16 = run_planner_bf16(dev, inputs, planner)
    render = run_render(dev, inputs)
    render16 = run_render_bf16(dev, inputs)
    train = run_train(dev)
    bwd_profile = backward_profile(dev, planner, inputs, train["args"])
    if "--profile" in sys.argv[1:]:
        # before the loop, after which the profiler loses events
        # (backward_launch_events)
        profile_call("planning call", planner_stages(planner, inputs))
        profile_call("bf16 planning call", planner_stages(planner16, inputs))
        profile_call("render", render["stages"])
        profile_call("train step", train["stages"], grad=True)
    loop = run_loop(dev, smi, train["times"]["step_ms"][0])
    # the float32 train and loop phases launched no bfloat16 kernel (their
    # counts were last set to 0 before the loop's resumed steps)
    check(not any(bf16_counts()[0].values()),
          f"bfloat16 launches in the float32 train loop: {bf16_counts()[0]}")
    train16 = run_train_bf16(dev)
    closed = run_closed_loop(dev, planner_params())
    dataset = run_dataset_train(dev, smi)
    parallel = run_parallel(dev, smi)
    run_mesh(run_checkpoint_import(dev, inputs))
    # no path of either package asks for the gradient with respect to xy
    # (the cameras and samples carry none): 0 launches in every phase above
    xy_path = xy_launches()
    check(xy_path == 0, f"the gather's xy gradient was launched {xy_path} "
          f"times on the paths")
    args, args16 = render["args"], render16["args"]
    rows = [check_view_fuse(dev, gen, args["view_fuse"]),
            check_gather(dev, gen, planner, inputs, args["epipolar_gather"]),
            check_gather_backward(dev, gen, planner, inputs, train["args"],
                                  events["epipolar_gather_backward"])]
    rows16 = [check_view_fuse_bf16(dev, gen, args16["view_fuse"]),
              check_gather_bf16(dev, gen, planner16, inputs,
                                args16["epipolar_gather"]),
              check_gather_backward_bf16(
                  dev, gen, planner16, inputs, train16["args"],
                  events["epipolar_gather_backward_bf16"])]
    for row in (rows[2], rows16[2]):
        row.update(bwd_profile[row["name"]])
    rows_xy = [check_gather_backward_xy(dev, gen, planner, inputs),
               check_gather_backward_xy(dev, gen, planner16, inputs, BF16)]
    row_norm = check_instance_norm(dev, launches, render, train, loop)
    phases = phase_times(planner, inputs)
    log("phases (median, min, max of 20) " + json.dumps(phases))
    phases16 = phase_times(planner16, inputs)
    log("bf16 phases (median, min, max of 20) " + json.dumps(phases16))
    log(f"bf16 render phases: {json.dumps(render16['times'])}")
    for row in rows16:
        # `launches`: in the bfloat16 planner's N_CALLS planning calls for
        # the forward kernels, in the bfloat16 train steps for the
        # backward; per render and forward of the bfloat16 model; in the
        # bfloat16 train steps; the float32 loop launches none
        name = row["name"]
        row["train_launches"] = train16["launches"][name]
        row["train_steps"] = train16["steps"]
        row["launches"] = launches16.get(name, row["train_launches"])
        row["render_launches"] = render16["launches"]["render"].get(name, 0)
        row["forward_launches"] = render16["launches"]["forward"].get(name, 0)
        row["loop_launches"] = row["closed_loop_launches"] = 0
    for row in rows:
        # `launches`: the row's main path, the planner for the forward
        # kernels, the train steps for the backward
        name = row["name"]
        row["launches"] = launches.get(name, train["launches"][name])
        row["render_launches"] = render["launches"]["render"].get(name, 0)
        row["forward_launches"] = render["launches"]["forward"].get(name, 0)
        row["train_launches"] = train["launches"][name]
        row["train_steps"] = train["steps"]
        # the loop's 12 steps with their validations, then the resumed 2
        row["loop_launches"] = loop["launches"][name]
        row["loop_steps"] = loop["steps"]
        row["loop_resumed_launches"] = loop["resumed_launches"][name]
        # the closed loop's planning calls, one a grasp attempt
        row["closed_loop_launches"] = closed["launches"][name]
        row["closed_loop_calls"] = closed["calls"]
        # Trainer.run on the written dataset
        row["dataset_train_launches"] = dataset["launches"][name]
        row["dataset_train_steps"] = dataset["steps"]
        # train.cli --mesh 1,1 under NCCL
        row["parallel_nccl_launches"] = parallel["nccl"]["launches"][name]
        row["parallel_nccl_steps"] = parallel["nccl"]["steps"]
    for dtype, group in (("float32", rows), ("bfloat16", rows16)):
        for row in group:
            # each gloo rank's one step, by case of the row's dtype
            row["parallel_gloo_launches_per_rank_step"] = {
                case: [r[row["name"]] for r in ranks]
                for case, ranks in parallel["gloo"].items()
                if case.startswith(dtype)}
    for row in rows_xy:
        # reached by torch.autograd.grad with respect to xy only: no path
        for k in ("launches", "render_launches", "forward_launches",
                  "train_launches", "loop_launches", "closed_loop_launches",
                  "dataset_train_launches"):
            row[k] = xy_path
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "render_launches", "train_launches", "loop_launches")
    rows += rows16 + rows_xy + [row_norm]
    for row in rows:
        check(all(k in row for k in keys), f"{row['name']}: a key is missing")
    log(json.dumps({"kernels": [
        {k: r[k] for k in (*keys, *sorted(set(r) - set(keys)))}
        for r in rows]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
