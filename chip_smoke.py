#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (graspnerf_tpu_torch) on one
NVIDIA card: run from the repository root as `python3 chip_smoke.py`.

1. builds both CUDA kernels from csrc/ (nvcc, all sources at once);
2. holds the view fuse against its plain PyTorch version at the volume
   path's shapes, at ragged N around its row tile, with misaligned inputs
   and through its backward, after checking its weight-pack guard, and
   times it, also at the render pass's N;
3. drives the planner (`GraspNeRFPlanner.core`) at full width -- six
   288 x 512 views, a 40^3 volume, every layer at the shipped widths, seeded
   random weights -- for a few planning calls, counts the kernel launches,
   and compares the volume, grasp-head outputs and candidates with the same
   planner on the plain versions on the same card;
4. holds the gather against its plain version on the card (atol) and on
   the CPU (bit-equal) on random and on the planner's own coordinates, at
   ragged P around its block and with misaligned inputs and outputs, and
   times it (wrapper and bare launch), also at the render pass's P;
5. times the phases and the kernels with CUDA events.

`--profile` adds a torch.profiler breakdown of a planning call by stage
and by op. It prints a `kernels` JSON line, then as its last line
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
RENDER_ROWS = 4096 * 40   # the render pass's view-fuse rows: rays x samples
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


def check_view_fuse(dev, gen):
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

    errs = {}
    for n in (1, tile - 1, tile + 1, 1000, RES ** 3, "1000 shifted"):
        ins = fuse_inputs(gen, 1000 if n == "1000 shifted" else n, dev)
        if n == "1000 shifted":   # takes the kernel's float-by-float loads
            ins = [shifted(t) for t in ins]
        got = view_fuse(*ins, weights)
        torch.cuda.synchronize()
        want = view_fuse_plain(*ins, weights)
        check(torch.equal(got[1], want[1]), f"view_fuse num_valid N={n}")
        for name, i in (("feat_const", 0), ("x", 2), ("vis", 3)):
            g, w = got[i], want[i]
            check(bool(torch.isfinite(g).all()), f"view_fuse {name} finite")
            check(torch.allclose(g, w, atol=FUSE_ATOL, rtol=FUSE_RTOL),
                  f"view_fuse {name} N={n}: max err {max_err(g, w)}")
        errs[n] = max(max_err(g, w) for g, w in zip(got, want))
        log(f"view_fuse N={n}: max_abs_err {errs[n]:.3e} (atol {FUSE_ATOL}, "
            f"rtol {FUSE_RTOL}; num_valid exact)")

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
    for n in (RES ** 3, RENDER_ROWS):
        ins = fuse_inputs(gen, n, dev)
        times[n] = {"ms": cuda_time(lambda: view_fuse(*ins, weights)),
                    "plain_ms": cuda_time(
                        lambda: view_fuse_plain(*ins, weights)),
                    **fuse_bound(n)}
        del ins
    log(f"view_fuse at the render pass's N={RENDER_ROWS} (4096 rays x 40 "
        f"samples): " + json.dumps(times[RENDER_ROWS]))
    return {"name": "view_fuse", "route": "cuda",
            "source": "graspnerf_tpu_torch/csrc/view_fuse.cu",
            "replaces": "graspnerf_tpu/ops/pallas/ibrnet_fuse.py:115",
            "max_abs_err": errs[RES ** 3], "library_ms": None,
            **times[RES ** 3]}


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


def check_gather(dev, gen, planner, scene):
    from graspnerf_tpu_torch.ops import epipolar_gather as eg
    block = eg.library().epipolar_gather_points_per_block()
    vol, render = f"random P={RES ** 3}", f"random P={RENDER_ROWS}"
    planned = f"planner P={RES ** 3}"
    cases = {vol: gather_inputs(gen, dev), planned: planner_gather_inputs(
        planner, scene), render: gather_inputs(gen, dev, RENDER_ROWS)}
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
    for name in (vol, planned, render):
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
            "planner_kernel_ms": times[planned]["kernel_ms"]}


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


def phase_times(planner, inputs, iters=20):
    """Per-phase ms of a planning call: median and spread (min, max) of
    `iters` calls of each phase, CUDA events around each call."""
    ref = planner.scene(*inputs)
    feats = planner.encode(ref["imgs"])
    with torch.no_grad():
        vol = planner.model.nr_net.sample_volume(ref, *feats)
    phases = {"encode": lambda: planner.encode(ref["imgs"]),
              "volume": lambda: planner.model.nr_net.sample_volume(ref, *feats),
              "head_postprocess": lambda: planner.detect(vol)}
    out = {}
    with torch.no_grad():
        for name, fn in phases.items():
            fn()
            ms = []
            for _ in range(iters):
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                start.record()
                fn()
                end.record()
                torch.cuda.synchronize()
                ms.append(start.elapsed_time(end))
            out[name + "_ms"] = [float(np.median(ms)), min(ms), max(ms)]
    return out


def profile_call(planner, inputs, calls=3):
    """torch.profiler over `calls` planning calls, run stage by stage under
    named ranges: the device's busy share of the wall time, device ms per
    call of each stage, and the top ops by self device time."""
    from torch.profiler import ProfilerActivity, profile, record_function
    ref = planner.scene(*inputs)
    stages = (("encode", lambda: planner.encode(ref["imgs"])),
              ("volume", lambda: planner.model.nr_net.sample_volume(
                  ref, *feats)),
              ("head_postprocess", lambda: planner.detect(vol)))
    with torch.no_grad():
        feats = planner.encode(ref["imgs"])
        vol = planner.model.nr_net.sample_volume(ref, *feats)
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
    log(f"profile ({calls} calls): device busy {busy_us / calls / 1e3:.3f} ms "
        f"of {wall_us / calls / 1e3:.3f} ms wall per call "
        f"({100 * busy_us / wall_us:.1f} %), {len(kernels) // calls} kernels")
    for name, _ in stages:   # kernels that start inside the stage's range
        spans = [e.time_range for e in events if e.is_user_annotation
                 and e.device_type == DeviceType.CUDA and e.name == name]
        inside = sum(k.time_range.elapsed_us() for k in kernels if any(
            r.start <= k.time_range.start < r.end for r in spans))
        log(f"  stage {name}: kernels busy {inside / calls / 1e3:.3f} ms "
            f"per call" + ("" if spans else " (no device-side range)"))
    totals = {}
    for k in kernels:
        t, n = totals.get(k.name, (0, 0))
        totals[k.name] = (t + k.time_range.elapsed_us(), n + 1)
    for name, (t, n) in sorted(totals.items(), key=lambda kv: -kv[1][0])[:15]:
        log(f"  {t / calls / 1e3:8.3f} ms {n // calls:5d}x  {name[:90]}")


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
    rows = [check_view_fuse(dev, gen)]
    planner, launches, inputs = run_planner(dev)
    rows.append(check_gather(dev, gen, planner, inputs))
    phases = phase_times(planner, inputs)
    log("phases (median, min, max of 20) " + json.dumps(phases))
    if "--profile" in sys.argv[1:]:
        profile_call(planner, inputs)
    for row in rows:
        row["launches"] = launches[row["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
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
