#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (graspnerf_tpu_torch) on one
NVIDIA card: run from the repository root as `python3 chip_smoke.py`.

1. builds both CUDA kernels from csrc/ (nvcc, all sources at once);
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
5. holds the view fuse against its plain version at the volume path's
   shapes, at ragged N around its row tile, with misaligned inputs, on the
   render's own inputs and through its backward, after checking its
   weight-pack guard, and times it;
6. holds the gather against its plain version on the card (atol) and on
   the CPU (bit-equal) on random, the planner's and the render's
   coordinates, at ragged P around its block and with misaligned inputs
   and outputs, and times it (wrapper and bare launch);
7. holds the gather's backward kernel against autograd through the plain
   version on the card and on the CPU, on random, the planner's and the
   train pass's coordinates, at ragged P and misaligned, and times it;
8. times the planner's phases with CUDA events.

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
import subprocess
import sys
import time

import numpy as np
import torch

N_CALLS = 3            # planning calls on the counted main path
SEED = 0
VIEWS, HEIGHT, WIDTH, RES = 6, 288, 512, 40
RENDER_RAYS, RENDER_SAMPLES = 4096, 40
RENDER_ROWS = RENDER_RAYS * RENDER_SAMPLES   # a render pass's view-fuse rows
# the train step: configs/nrvgn_sdf.yaml's ray_num and depth_loss_coords_num,
# the synthetic dataset's grasps per scene (graspnerf_tpu/data/synthetic.py)
TRAIN_RAYS, DEPTH_COORDS, TRAIN_GRASPS = 512, 8192, 32
TRAIN_ROWS = TRAIN_RAYS * RENDER_SAMPLES     # a train pass's rows and points
TRAIN_STEPS = 5        # counted steps on the main path; then >= 10 timed
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
# - gather backward vs autograd through the plain version: on the card, the
#   forward's weights differ by the division's rounding (up to ~3e-5 of a
#   full-res pixel per weight, summed over a cell's contributions); on the
#   CPU the weights are bit-equal and only the sum order differs (atomics),
#   so there each map cell is held to BWD_SUM_RTOL of the sum of the
#   absolute values of its contributions.
BWD_ATOL, BWD_RTOL, BWD_SUM_RTOL = 5e-4, 1e-5, 1e-4
# H100 SXM peaks (NVIDIA data sheet): float32 on the CUDA cores, HBM3.
PEAK_F32_FLOPS = 67e12
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
    return lambda: [F.grid_sample(m, g, mode="bilinear", padding_mode="border",
                                  align_corners=(i == 0))
                    for i, m in enumerate(maps)]


def gather_outputs(args, dev, shift=False):
    V, P = args[3].shape[:2]
    C = args[1].shape[3]
    return [torch.empty(V * P * c + shift, device=dev)[int(shift):].view(V, P, c)
            for c in (3 + C, C)]


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
        nbytes = (sum(t.numel() * t.element_size() for t in args)
                  + sum(t.numel() * 4 for t in outs))
        P = args[3].shape[1]
        flops = VIEWS * P * (3 + 2 * 32) * 4 * 2     # 4 taps x (mul + add)
        times[name] = {
            "ms": cuda_time(lambda: eg.epipolar_gather(*args)),
            "kernel_ms": cuda_time(eg.launcher(*args, *outs)),
            "host_ms": host_time(lambda: eg.epipolar_gather(*args)),
            "plain_ms": cuda_time(lambda: eg.epipolar_gather_plain(*args)),
            "library_ms": cuda_time(gather_library(args)),
            **bound(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES)}
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


def run_planner(dev):
    from graspnerf_tpu_torch.detect.planner import GraspNeRFPlanner
    from graspnerf_tpu_torch.detect.postprocess import nms, process
    from graspnerf_tpu_torch.models import GraspNeRF, init_parameters_
    from graspnerf_tpu_torch.ops.epipolar_gather import epipolar_gather
    from graspnerf_tpu_torch.ops.view_fuse import view_fuse
    from graspnerf_tpu_torch.tools.scene import synthetic_views

    model = init_parameters_(GraspNeRF(), torch.Generator().manual_seed(SEED))
    sd = model.state_dict()
    # widths inside process()'s [1.33, 9.33] voxel window, so that random
    # weights leave candidates
    sd["vgn_net.conv_width.bias"].fill_(4.0)
    images, poses, Ks, dr = synthetic_views(
        np.random.RandomState(SEED), VIEWS, HEIGHT, WIDTH)
    kern = GraspNeRFPlanner(sd, device=dev)
    plain = GraspNeRFPlanner(sd, device=dev, use_kernels=False)

    # the threshold: at the widest gap between consecutive quality peaks of
    # this scene among the best 4..48, so that the candidate set has a margin
    # on both sides and top-k's max_candidates cuts nothing
    ref = kern.scene(images, poses, Ks, dr)
    vol, (qual, rot, width), _ = kern.volume(ref, *kern.encode(ref["imgs"]))
    peaks = nms(process(vol, qual[0, ..., 0], width[0, ..., 0]), 0.0)
    top = torch.sort(peaks[peaks > 0], descending=True).values.tolist()
    check(len(top) > 4, f"only {len(top)} quality peaks")
    k = max(range(4, min(48, len(top) - 1) + 1),
            key=lambda i: top[i - 1] - top[i])
    thr = (top[k - 1] + top[k]) / 2
    kern.qual_threshold = plain.qual_threshold = thr
    log(f"planner: qual_threshold {thr:.6f}: {k} of {len(top)} quality "
        f"peaks pass, gap to the next {top[k - 1] - top[k]:.3e}")

    view_fuse.launches = epipolar_gather.launches = 0
    wall = []
    for _ in range(N_CALLS):
        vol_k, cand_k, dt = kern.core(images, poses, Ks, dr)
        wall.append(dt)
    launches = {"view_fuse": view_fuse.launches,
                "epipolar_gather": epipolar_gather.launches}
    log(f"planner: {N_CALLS} calls, core() seconds {wall}, launches {launches}")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the main path")

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
    e_cand = max(abs(a - b) for key in ck for a, b in zip(
        [ck[key][0], *ck[key][1], ck[key][2]],
        [cp[key][0], *cp[key][1], cp[key][2]]))
    check(e_cand <= PLANNER_ATOL, f"candidate values vs plain: {e_cand}")
    log(f"planner vs plain versions (atol {PLANNER_ATOL}): volume {e_vol:.3e}, "
        f"qual/rot/width "
        f"{[f'{e:.3e}' for e in e_heads]}, {len(ck)} candidates identical "
        f"(values {e_cand:.3e}); sdf range [{float(vol_k.min()):.3f}, "
        f"{float(vol_k.max()):.3f}]")
    return kern, launches, (images, poses, Ks, dr)


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
        def record(*args):
            seen.setdefault(name, args)
            return wrapper(*args)
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


def compare_outputs(got, want, what):
    """Every key of `want` against `got`: bool keys equal, the rest within
    RENDER_ATOL. Returns {key: max abs err}."""
    errs = {}
    for key in sorted(want):
        for g, w in zip(flat(got[key]), flat(want[key])):
            check(g.shape == w.shape, f"render {what} {key}: shape")
            if g.dtype == torch.bool:
                check(torch.equal(g, w), f"render {what} {key} differs")
                e = 0.0
            else:
                e = max_err(g, w)
                check(e <= RENDER_ATOL, f"render {what} {key}: {e:.3e}")
            errs[key] = max(errs.get(key, 0.0), e)
    return errs


def compare_render(out, want, plain, data):
    """The kernel model's forward `out` against the plain model's `want`:
    the coarse pass, volume and heads directly; the fine pass at the kernel
    model's own fine samples, since the inverse CDF magnifies the coarse
    pass's differences (FINE_DEPTH_ATOL). Returns those fine samples."""
    from graspnerf_tpu_torch.ops import geometry
    ref, que = data["ref"], data["que"]
    dr = que["depth_range"]
    nr = plain.nr_net
    errs = compare_outputs(out, {k: v for k, v in want.items()
                                 if not k.endswith("_fine")}, "coarse")
    coarse_depth = geometry.sample_depth(dr, RENDER_RAYS, RENDER_SAMPLES)
    with torch.no_grad():
        fine_depth = [torch.sort(geometry.sample_fine_depth(
            coarse_depth, o["hit_prob_nr"], dr, RENDER_SAMPLES), -1).values
            for o in (out, want)]
        e_depth = max_err(*fine_depth)
        check(e_depth <= FINE_DEPTH_ATOL, f"fine samples: {e_depth:.3e} m")
        fine = nr.render_by_depth(fine_depth[0], que, ref,
                                  *nr.encode_views(ref["imgs"]), True)
    errs.update({k + "_fine": v for k, v in compare_outputs(
        {k: out[k + "_fine"] for k in fine}, fine, "fine").items()})
    sdf = torch.cat([out["sdf_values"], out["sdf_values_fine"]]).flatten()
    log(f"render vs plain versions (atol {RENDER_ATOL}, ray masks exact): "
        + json.dumps({k: float(f"{e:.3e}") for k, e in errs.items()}))
    log(f"render: fine samples {e_depth:.3e} m from the plain model's "
        f"(atol {FINE_DEPTH_ATOL}); sdf range [{float(sdf.min()):.3f}, "
        f"{float(sdf.max()):.3f}], {float((sdf == 1).float().mean()):.3f} "
        f"seen by no view, {float((sdf == -1).float().mean()):.3f} at -1; "
        f"ray_mask {int(out['ray_mask'].sum())} / {RENDER_RAYS}")
    return fine_depth[0]


def run_render(dev, inputs, iters=10):
    """The render path at full width through the kernels: counts their
    launches, holds every output against the same model on the plain
    versions on the same card, and times the phases. Returns {launches,
    args: the kernels' arguments in the coarse pass, times, stages: the
    (name, call) of a render's stages for the profile}."""
    from graspnerf_tpu_torch.models import (GraspNeRF, init_parameters_,
                                            load_graspnerf)
    from graspnerf_tpu_torch.ops import geometry
    from graspnerf_tpu_torch.ops.epipolar_gather import epipolar_gather
    from graspnerf_tpu_torch.ops.view_fuse import view_fuse

    sd = init_parameters_(GraspNeRF(), torch.Generator().manual_seed(SEED)
                          ).state_dict()
    for net in ("agg_net", "fine_agg_net"):
        sd[f"nr_net.{net}.agg_impl.out_geometry_fc.1.weight"] *= SDF_SCALE
    cfg = {"depth_sample_num": RENDER_SAMPLES,
           "fine_depth_sample_num": RENDER_SAMPLES, "volume_resolution": RES}
    kern = load_graspnerf(sd, dev, cfg)
    plain = load_graspnerf(sd, dev, cfg, use_kernels=False)
    render_only = load_graspnerf(sd, dev, dict(cfg, do_sample_volume=False)
                                 ).nr_net
    data = render_data(inputs, dev)
    ref, que = data["ref"], data["que"]

    launches = {}
    with torch.no_grad():
        kern(data)           # first calls: library loads, cuDNN set-up
        for name, fn in (("render", lambda: render_only(data)),
                         ("forward", lambda: kern(data))):
            view_fuse.launches = epipolar_gather.launches = 0
            out = fn()
            torch.cuda.synchronize()
            launches[name] = {"view_fuse": view_fuse.launches,
                              "epipolar_gather": epipolar_gather.launches}
        want = plain(data)
    log(f"render: launches {launches} (NeuralRayRenderer.forward without the "
        f"volume; GraspNeRF.forward with it)")
    for name, n in (("render", 2), ("forward", 3)):
        check(launches[name] == {"view_fuse": n, "epipolar_gather": n},
              f"{name}: launches {launches[name]}, not {n} of each kernel")
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
    return {"launches": launches, "args": args, "times": times,
            "stages": stages}


# ------------------------------------------------------------ train step
def pinned_fine_samples(fn, pinned=None):
    """Runs fn with `sample_fine_depth`, as the renderer calls it, recording
    the samples it returns; with `pinned`, the renderer gets those instead.
    Returns (fn's result, the samples sample_fine_depth computed)."""
    from graspnerf_tpu_torch.ops import geometry
    original, own = geometry.sample_fine_depth, []

    def record(*args, **kw):
        own.append(original(*args, **kw))
        return own[-1] if pinned is None else pinned
    geometry.sample_fine_depth = record
    try:
        return fn(), own[0]
    finally:
        geometry.sample_fine_depth = original


def train_states(dev):
    """(kernel state, plain-version state, batch): one seeded GraspNeRF at
    the shipped widths, the SDF output kernels scaled as for the render,
    under `create_train_state` twice; the seeded full-width batch."""
    from graspnerf_tpu_torch.models import GraspNeRF, init_parameters_
    from graspnerf_tpu_torch.tools.scene import training_batch
    from graspnerf_tpu_torch.train import create_train_state
    cfg = {"depth_sample_num": RENDER_SAMPLES,
           "fine_depth_sample_num": RENDER_SAMPLES, "volume_resolution": RES,
           "depth_loss_coords_num": DEPTH_COORDS}
    sd = init_parameters_(GraspNeRF(cfg), torch.Generator().manual_seed(SEED)
                          ).state_dict()
    for net in ("agg_net", "fine_agg_net"):
        sd[f"nr_net.{net}.agg_impl.out_geometry_fc.1.weight"] *= SDF_SCALE
    states = []
    for use_kernels in (True, False):
        model = GraspNeRF(cfg, use_kernels=use_kernels)
        model.load_state_dict(sd, strict=True)
        states.append(create_train_state(model, device=dev))
    batch = training_batch(np.random.RandomState(SEED), dev, VIEWS, HEIGHT,
                           WIDTH, TRAIN_RAYS, RES, TRAIN_GRASPS)
    return states[0], states[1], batch


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
    epipolar_gather_backward.launches = 0


def compare_train(kern, plain, batch, dev):
    """One training loss and its gradients on the kernel model and on the
    plain-version model: the same draws (generators of one seed), the plain
    model's fine pass at the kernel model's fine samples. Checks the
    launches (3 of each kernel), the losses, the fine samples and every
    parameter's gradient. Returns the gather's arguments in the coarse
    pass."""
    from graspnerf_tpu_torch.train import gradients, make_loss_fn
    zero_counts()
    args, ((total_k, ld_k), fine_k) = capture_kernel_args(
        lambda: pinned_fine_samples(lambda: make_loss_fn(kern.model)(
            batch, torch.Generator(device=dev).manual_seed(SEED))))
    grads_k = gradients(kern, total_k)
    torch.cuda.synchronize()
    launched = counts()
    log(f"train: one loss and its gradients launch {launched}")
    check(launched == {"view_fuse": 3, "epipolar_gather": 3,
                       "epipolar_gather_backward": 3},
          f"train: launches {launched}, not 3 of each kernel")
    (total_p, ld_p), fine_p = pinned_fine_samples(
        lambda: make_loss_fn(plain.model)(
            batch, torch.Generator(device=dev).manual_seed(SEED)), fine_k)
    grads_p = gradients(plain, total_p)
    e_fine = max_err(fine_k, fine_p)
    check(e_fine <= FINE_DEPTH_ATOL, f"train fine samples: {e_fine:.3e} m")
    errs = {}
    for key in sorted(ld_k):
        k, p = float(ld_k[key].detach()), float(ld_p[key].detach())
        check(math.isfinite(k), f"train {key} not finite")
        errs[key] = abs(k - p) / max(abs(p), 1e-12)
        check(errs[key] <= TRAIN_LOSS_RTOL,
              f"train {key}: {k} vs plain {p} (rel {errs[key]:.3e})")
    rel, skipped = [], 0
    for (name, _), gk, gp in zip(kern.model.named_parameters(), grads_k,
                                 grads_p):
        check(bool(torch.isfinite(gk).all()), f"gradient of {name} finite")
        scale = max(float(gk.abs().max()), float(gp.abs().max()))
        if scale < GRAD_FLOOR:
            skipped += 1
            continue
        r = max_err(gk, gp) / scale
        check(r <= TRAIN_GRAD_RTOL, f"gradient of {name}: {r:.3e} of its "
              f"scale {scale:.3e} from the plain version's")
        rel.append((r, name, scale))
    rel.sort(reverse=True)
    log(f"train vs plain versions: losses (rel, tol {TRAIN_LOSS_RTOL}) "
        + json.dumps({k: float(f"{e:.3e}") for k, e in errs.items()}))
    log(f"train: fine samples {e_fine:.3e} m from the plain model's (atol "
        f"{FINE_DEPTH_ATOL}); gradients of {len(rel)} parameters within "
        f"{TRAIN_GRAD_RTOL} of their scale ({skipped} below {GRAD_FLOOR} "
        f"skipped); largest: " + ", ".join(
            f"{n} {r:.2e} (scale {s:.1e})" for r, n, s in rel[:6])
        + f"; median {rel[len(rel) // 2][0]:.2e}")
    log("train losses: " + json.dumps(
        {k: float(f"{float(v):.6g}") for k, v in ld_k.items()}))
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

    step = make_train_step(kern)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    zero_counts()
    totals = []
    for _ in range(TRAIN_STEPS):
        metrics = step(batch, gen)
        check(float(metrics["nonfinite_grad"]) == 0.0, "train: step skipped")
        totals.append(float(metrics["total"]))
    torch.cuda.synchronize()
    launches = counts()
    log(f"train: {TRAIN_STEPS} steps, totals {totals}, launches {launches}")
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
    return {"launches": launches, "steps": TRAIN_STEPS, "args": args,
            "times": times, "stages": stages}


def gather_backward_library(args, grads):
    """Yardstick, which the port never calls: the backward of three
    F.grid_sample calls (grid_sampler_2d_backward) at the same points,
    into the three maps."""
    import torch.nn.functional as F
    imgs, f1, f2, xy, _ = args
    maps = [m.detach().permute(0, 3, 1, 2).contiguous().requires_grad_()
            for m in (imgs, f1, f2)]
    xy = xy.detach()
    g = torch.stack([xy[..., 0] / (WIDTH - 1) * 2 - 1,
                     xy[..., 1] / (HEIGHT - 1) * 2 - 1], -1)[:, None]
    outs = [F.grid_sample(m, g, mode="bilinear", padding_mode="border",
                          align_corners=(i == 0))
            for i, m in enumerate(maps)]
    d_rgb, d_ray = grads
    cot = [d_rgb[..., :3], d_rgb[..., 3:], d_ray]
    cot = [c.permute(0, 2, 1)[:, :, None].contiguous() for c in cot]
    return lambda: torch.autograd.grad(outs, maps, cot, retain_graph=True)


def check_gather_backward(dev, gen, planner, scene, train_args):
    """The gather's backward kernel against autograd through the plain
    version, on the card and on the CPU, and its times. train_args: the
    gather's arguments in the train step's coarse pass."""
    from graspnerf_tpu_torch.ops import epipolar_gather as eg
    # xy requiring a gradient is refused, not silently dropped
    xy = gather_inputs(gen, dev, 64)
    try:
        with torch.enable_grad():
            eg.epipolar_gather(*xy[:3], xy[3].requires_grad_(), xy[4])
        refused = False
    except NotImplementedError:
        refused = True
    check(refused, "gather: xy requiring a gradient was taken")

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
        if name.endswith("shifted"):   # the float path: scalar atomics
            d_rgb, d_ray = shifted(d_rgb), shifted(d_ray)
            outs = [shifted(torch.zeros(s, device=dev))
                    for s in (shapes[0], shapes[1], shapes[1])]
            got = eg.backward_launcher(*outs, xy, valid, d_rgb, d_ray)()
        else:
            got = eg.epipolar_gather_backward(xy, valid, d_rgb, d_ray,
                                              *shapes, need_imgs=True)
        torch.cuda.synchronize()
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
            f"sum of |contributions|")

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
        # kernel's scalar atomics, one per tap and channel
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
        log(f"epipolar_gather_backward {name} (ms: the wrapper, zeroed "
            f"outputs included; kernel_ms: the bare launch; "
            f"scalar_kernel_ms: the bare launch on shifted tensors, scalar "
            f"atomics): " + json.dumps(times[name]))
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
            "train_scalar_kernel_ms": times[trained]["scalar_kernel_ms"]}


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
    planner, launches, inputs = run_planner(dev)
    render = run_render(dev, inputs)
    train = run_train(dev)
    args = render["args"]
    rows = [check_view_fuse(dev, gen, args["view_fuse"]),
            check_gather(dev, gen, planner, inputs, args["epipolar_gather"]),
            check_gather_backward(dev, gen, planner, inputs, train["args"])]
    phases = phase_times(planner, inputs)
    log("phases (median, min, max of 20) " + json.dumps(phases))
    if "--profile" in sys.argv[1:]:
        profile_call("planning call", planner_stages(planner, inputs))
        profile_call("render", render["stages"])
        profile_call("train step", train["stages"], grad=True)
    for row in rows:
        # `launches`: the row's main path, the planner for the forward
        # kernels, the train steps for the backward
        name = row["name"]
        row["launches"] = launches.get(name, train["launches"][name])
        row["render_launches"] = render["launches"]["render"].get(name, 0)
        row["forward_launches"] = render["launches"]["forward"].get(name, 0)
        row["train_launches"] = train["launches"][name]
        row["train_steps"] = train["steps"]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "render_launches", "train_launches")
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
