"""What each design choice of the epipolar-gather kernel is worth, on the card.

Builds csrc/epipolar_gather.cu with nvcc into graspnerf_tpu_torch/_build/:
as it is, with each entry of VARIANTS (one design choice undone by text
substitutions of the source; the probe_* builds compute wrong results on
purpose, to show what one cost is), and, with `--against FILE`, another
source of the same C interface (for example an earlier commit's kernel,
unpacked with `git archive`). Prints each build's ptxas registers and spills
and the SASS instruction count of its kernels (`cuobjdump -sass`), checks
that every build but the probes writes what the kernel writes, and times
the bare launch of each into preallocated outputs with CUDA events (mean of
20 launches, in turns, then back), beside two `fill_` calls that write the
same outputs and nothing else, on three inputs: random coordinates at the
volume path's P = 64,000, the planner's own coordinates there (its 40^3 grid
projected into the synthetic scene's six 288 x 512 views), and random
coordinates at the render pass's P = 163,840.

With `--backward`, the same for the backward (`epipolar_gather_backward`
and `epipolar_gather_backward_bf16`, each build's two instances): the build
as it is; each entry of BACKWARD_VARIANTS (the pull's rows copied by
TMA bulk copies or through registers instead of 16-byte cp.async, one or
three row stages instead of two, two meta stages instead of four, long lists not split or split at other lengths, a block per work
item instead of the persistent grid, other chunks and warp shapes, ranks
from shuffles, invalid points kept in the index, the pull's roles in SM
cycles (`stamps`), and probes that leave out the finiteness check of the
invalid points, or launch the index passes alone or the pull alone on an
index built beforehand); and with `--against FILE` that source (an earlier
commit's: a pull, or the atomic design, whose backward adds into zeroed
outputs). A build nvcc refuses is left out with its log. Every build but
the probes is held to the plain version (float32 within chip_smoke.py's
atol and rtol, bfloat16 bit-equal but for 1e-3 of the values one ulp
apart) and its two launches to each other; each build's bare call (all
its CUDA launches, into preallocated outputs) is timed on random and the
planner's coordinates at P = 64,000 and on a training batch's coarse-pass
coordinates at P = 20,480, beside one `zero_` of the two bfloat16 outputs
(what the atomic design's wrapper adds); the longest tile list and the
work items are read from the index, and the build's own call is broken
down by device event (torch.profiler).

With `--xy`, the same for the gradient with respect to xy
(`epipolar_gather_backward_xy` and its bfloat16 instance): the build as it
is, each entry of XY_VARIANTS (a step of its design undone, and probes
without map reads or upstream reads), and with `--against FILE` that
source and each entry of XY_PARENT_PROBES that applies to it (the same
probes written for PR 14's kernel). Each build's registers, spills and
shared memory (its `epipolar_gather_backward_xy_info`); every build but
the probes held to the plain version within chip_smoke.py's XY_RTOL of
the largest |d_xy|, and to the kernel build bit for bit (printed, not a
failure); bare launches on random, the planner's and border-clamped
coordinates at P = 64,000, beside the forward (B and B-bf16) of the
kernel build on the same inputs, the yardstick that reads the same taps.
Run from the repository root on a machine with a CUDA card:

    python3 -m graspnerf_tpu_torch.tools.gather_variants [--backward
        [--variants A,B] | --xy] [--against FILE ...]
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

from .. import build
from .scene import synthetic_views, training_batch, train_coords, volume_coords
from .view_fuse_phases import cuda_ms, smi, variant

SRC = os.path.join(build.CSRC_DIR, "epipolar_gather.cu")
V, H, W, C = 6, 288, 512, 32
CASES = {"random P=64000": ("random", 64000),
         "planner P=64000": ("planner", 64000),
         "random P=163840": ("random", 163840)}

STCS = [["*reinterpret_cast<uint4*>(dst + s - a) =\n          "
         "*reinterpret_cast<const uint4*>(stage + s);",
         "__stcs(reinterpret_cast<uint4*>(dst + s - a), "
         "*reinterpret_cast<const uint4*>(stage + s));"],
        ["  *reinterpret_cast<float4*>(p) = v;",
         "  __stcs(reinterpret_cast<float4*>(p), v);"]]
NO_MAP_READS = ["return __ldg(reinterpret_cast<const float4*>(p));",
                "return make_float4(p == nullptr, 1.0f, 1.0f, 1.0f);"]


def points(n):
    return [["constexpr int kPoints = 32;", f"constexpr int kPoints = {n};"]]


VARIANTS = {
    # each design choice undone
    "scalar_loads": [["const bool vec = C % 4 == 0 &&",
                      "const bool vec = false &&"]],
    "no_output_staging": [   # rgb_feats rows written straight out
        ["    T* row = stage + a + i * R;", "    T* row = dst + i * R;"],
        ["for (int s = E * t; s < end;", "for (int s = end; s < end;"]],
    "rgb_one_thread_per_point": [   # twelve float reads each, after phase 1
        ["      if (l < 6) {\n        const T* px",
         "      if (false) {\n        const T* px"],
        ["    if (l < 3) row[l] = from_f<T>(blend(r0, s0, r1, s1, g));\n", ""],
        ["  const int l = t % kLanes, c = 4 * l;\n",
         "  if (t >= kPoints && t - kPoints < n) {\n"
         "    T* row = stage + a + (t - kPoints) * R;\n"
         "    for (int c = 0; c < 3; ++c)\n"
         "      row[c] = from_f<T>(sample1(imgs, rgbs[t - kPoints], c));\n"
         "  }\n  const int l = t % kLanes, c = 4 * l;\n"]],
    "taps_l2_only": [["return __ldg(reinterpret_cast<const float4*>(p));",
                      "return __ldcg(reinterpret_cast<const float4*>(p));"]],
    "phase2_not_unrolled": [["#pragma unroll\n  for (int k = 0;",
                             "#pragma unroll 1\n  for (int k = 0;"]],
    # other block sizes, register caps and store hints
    "points_64": points(64),
    "points_128": points(128),
    # register caps: 32 and 40 blocks of 64 threads on an SM
    "regs_32": [["__launch_bounds__(kThreads)",
                 "__launch_bounds__(kThreads, 32)"]],
    "regs_40": [["__launch_bounds__(kThreads)",
                 "__launch_bounds__(kThreads, 24)"]],
    "streaming_stores": STCS,
    # probes, wrong on purpose: no feature-map reads; no reads of any map
    "probe_no_map_reads": [NO_MAP_READS],
    "probe_writes_only": [NO_MAP_READS, [
        "        r0 = to_f(__ldg(px));\n        r1 = to_f(__ldg(px + g.dy));",
        "        r0 = px == nullptr;\n        r1 = 1.0f;"]],
}


def bwd_sub(name, old, new):
    return [[f"constexpr int {name} = {old};", f"constexpr int {name} = {new};"]]


def bwd_flag(name, old, new):
    return [[f"constexpr bool {name} = {old};",
             f"constexpr bool {name} = {new};"]]


UNROLL_2 = [["#pragma unroll 1\n  for (int j = seg[k]; j < end;",
             "#pragma unroll 2\n  for (int j = seg[k]; j < end;"]]
WARPS_2X2 = [["constexpr int kWarpY = 2, kWarpX = 4;",
              "constexpr int kWarpY = 2, kWarpX = 2;"]]

BACKWARD_VARIANTS = {
    # the pull's design choices undone or moved: rows by a TMA bulk copy
    # each (a thread an entry) or through registers instead of 16-byte
    # cp.async a thread a block; two row stages (a chunk's rows copied
    # during the sums of the chunk before it, not after); two or four meta
    # stages (the producer at most two or four chunks ahead); long lists
    # not split, or split at other lengths; other chunks; the summing warps' segment
    # loops unrolled twice (twice their code); summing warps of 2 x 2 cells
    # (16 of them, at most 2 blocks an SM); other register caps (2 or 4
    # blocks an SM)
    "rows_tma": bwd_sub("kRowCopy", 1, 2),
    "rows_registers": bwd_sub("kRowCopy", 1, 0),
    "two_row_stages": [["kRowStages = 1, kMetaStages = 3;",
                        "kRowStages = 2, kMetaStages = 3;"]],
    "two_meta_stages": [["kRowStages = 1, kMetaStages = 3;",
                         "kRowStages = 1, kMetaStages = 2;"]],
    "four_meta_stages": [["kRowStages = 1, kMetaStages = 3;",
                          "kRowStages = 1, kMetaStages = 4;"]],
    "no_split": bwd_sub("kSplit", 8, 65536),
    "split_4": bwd_sub("kSplit", 8, 4),
    "split_16": bwd_sub("kSplit", 8, 16),
    "split_2": bwd_sub("kSplit", 8, 2),
    "chunk_64": bwd_sub("kChunk", 128, 64),
    "chunk_256": bwd_sub("kChunk", 128, 256),
    "segments_unroll_2": UNROLL_2,
    "warps_2x2": WARPS_2X2 + bwd_sub("kPullMinBlocks", 3, 2),
    "min_blocks_2": bwd_sub("kPullMinBlocks", 3, 2),
    "four_blocks": bwd_sub("kPullMinBlocks", 3, 4),
    # float32 through the pipelined pull (its lists whole), not the
    # block-synchronous one
    "float32_pipelined": bwd_flag("kSyncPullF32", "true", "false"),
    # index blocks of 4 rounds of 32 points a warp: half the chunks the
    # count pass's last block scans
    "index_rounds_4": bwd_sub("kRounds", 2, 4),
    "rank_by_shuffles": [   # peers from 32 shuffles, not match.any
        ["  const unsigned peers = __match_any_sync(0xffffffffu, key);",
         "  unsigned peers = 0;\n"
         "  for (int j = 0; j < 32; ++j)\n"
         "    peers |= unsigned(__shfl_sync(0xffffffffu, key, j) == key) << j;"]],
    # invalid points left out unchecked: a non-finite upstream value there
    # would not reach the maps (unlike the plain version); what the check
    # costs
    "probe_no_finite_check": [[
        "    const bool check = kFill && out && p < P;",
        "    const bool check = false;"]],
    "keep_invalid": bwd_flag("kDropInvalid", "true", "false"),
    # the pull's roles in SM cycles (clock64 around each wait and phase)
    "stamps": bwd_flag("kStamps", "false", "true"),
    # probes: one part of a call alone
    "probe_index_only": [["kRunIndex = true, kRunPull = true;",
                          "kRunIndex = true, kRunPull = false;"]],
    "probe_pull_only": [["kRunIndex = true, kRunPull = true;",
                         "kRunIndex = false, kRunPull = true;"]],
}

BWD_CASES = {"random P=64000": ("random", 64000),
             "planner P=64000": ("planner", 64000),
             "train P=20480": ("train", 20480)}
BWD_ATOL, BWD_RTOL = 5e-4, 1e-5   # chip_smoke.py's, against the plain version


def compile_all(srcs, strict=True):
    """{name: source text} -> {name: (CDLL, path, ptxas register lines)}.
    strict=False leaves out a build nvcc refuses (its log printed)."""
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    flags = build.ARCH_FLAGS + build.COMMON_FLAGS + build.EXTRA_FLAGS.get(
        "epipolar_gather", [])
    procs = {}
    for name, text in srcs.items():
        cu = os.path.join(build.BUILD_DIR, f"gather_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = cu[:-3] + ".so"
        procs[name] = (subprocess.Popen(
            [build.nvcc_path()] + flags + ["-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    out = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            if strict:
                raise RuntimeError(f"nvcc failed for {name}:\n{log}")
            print(f"nvcc failed for {name}, left out:\n{log[-6000:]}")
            continue
        lib = ctypes.CDLL(so)
        lib.epipolar_gather_forward.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        lib.epipolar_gather_forward.restype = ctypes.c_int
        out[name] = (lib, so, [l.strip() for l in log.splitlines()
                               if "registers" in l or "spill" in l])
    return out


def sass_counts(so):
    """{kernel function: SASS instructions} of a built library."""
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    text = subprocess.run([tool, "-sass", so], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    counts, fn = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn and re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+\S", line):
            counts[fn] += 1
    return counts


def inputs(dev, coords, P, seed=0):
    gen = torch.Generator().manual_seed(seed)
    imgs = torch.rand(V, H, W, 3, generator=gen)
    maps = [torch.randn(V, H // 4, W // 4, C, generator=gen) for _ in range(2)]
    if coords == "random":
        xy = torch.stack([torch.rand(V, P, generator=gen) * (W + 40) - 20,
                          torch.rand(V, P, generator=gen) * (H + 40) - 20], -1)
        valid = torch.rand(V, P, generator=gen) > 0.1
    else:
        _, poses, Ks, _ = synthetic_views(np.random.RandomState(seed), V, H, W)
        xy, valid = volume_coords(torch.from_numpy(poses),
                                  torch.from_numpy(Ks), H, W)
        assert xy.shape[1] == P
    return [t.to(dev) for t in (imgs, *maps, xy, valid)]


def launcher(lib, args, outs):
    P = args[3].shape[1]
    ptrs = [t.data_ptr() for t in (*args, *outs)]
    stream = torch.cuda.current_stream().cuda_stream
    fn = lib.epipolar_gather_forward

    def launch():
        build.check(fn(*ptrs, V, P, H, W, H // 4, W // 4, C, stream),
                    "epipolar_gather")
    return launch


INSTANCES = {"float32": ("epipolar_gather_backward", torch.float32),
             "bfloat16": ("epipolar_gather_backward_bf16", torch.bfloat16)}


def bwd_inputs(dev, coords, P, seed=0):
    """(xy, valid, d_rgb, d_ray) on the card, float32."""
    gen = torch.Generator().manual_seed(seed)
    if coords == "train":
        xy, valid = train_coords(training_batch(np.random.RandomState(seed),
                                                "cpu", V, H, W))
    else:
        xy, valid = inputs("cpu", coords, P, seed)[3:]
    assert xy.shape[1] == P
    d_rgb = torch.randn(V, P, 3 + C, generator=gen)
    d_ray = torch.randn(V, P, C, generator=gen)
    return [t.to(dev) for t in (xy, valid, d_rgb, d_ray)]


def bwd_launcher(lib, ins, outs, scratch, instance="float32"):
    """The bare call of a build's backward instance into outs (d_imgs
    stand-in, d_img_feats, d_ray_feats, of the instance's dtype): the
    pull's interface with `scratch`, or the atomic design's, which adds
    into them. ins: the float32 (xy, valid, d_rgb, d_ray); the bfloat16
    instance takes d_rgb rounded to bfloat16."""
    name, dtype = INSTANCES[instance]
    xy, valid, d_rgb, d_ray = ins
    d_rgb = d_rgb.to(dtype)
    P = xy.shape[1]
    fn = getattr(lib, name)
    pull = hasattr(lib, "epipolar_gather_backward_scratch")
    ptrs = ([t.data_ptr() for t in (xy, valid, d_rgb, d_ray)] + [None]
            + [o.data_ptr() for o in outs[1:]])
    if pull:
        ptrs.append(scratch.data_ptr())
    fn.argtypes = [ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        build.check(fn(*ptrs, V, P, H, W, H // 4, W // 4, C, stream), name)
    launch.keep = d_rgb
    return launch


def device_us(fn, calls=5):
    """[(name, mean us)] of the device events (kernels, memsets) of one
    call of fn, over `calls` calls under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    per_call = len(events) // calls
    return [(events[i].name[:40], sum(
        events[i + k * per_call].time_range.elapsed_us()
        for k in range(calls)) / calls) for i in range(per_call)]


def print_stamps(case, lib, launch):
    """The stamps build's pull, per block: SM cycles of its first summing
    warp and of its producer warp by part, per chunk, over the blocks that
    took chunks, and the busiest block."""
    launch()
    torch.cuda.synchronize()
    buf = (ctypes.c_longlong * (128 * 10))()
    lib.epipolar_gather_backward_stamps.argtypes = [ctypes.c_void_p]
    build.check(lib.epipolar_gather_backward_stamps(buf), "stamps")
    rows = [list(buf[10 * b:10 * b + 10]) for b in range(128)]
    rows = [r for r in rows if r[8] > 0]
    parts = ("sum warp: wait for rows", "sums", "finish",
             "wait for next header", "wait for free row stage",
             "start copies", "producer: wait", "sort")
    per = {p: sum(r[i] for r in rows) / max(1, sum(r[8] for r in rows))
           for i, p in enumerate(parts)}
    busy = max(rows, key=lambda r: r[8]) if rows else None
    # a summing warp's cycles in the pull, and chunks, over the blocks
    total = sorted(sum(r[:6]) for r in rows)
    chunks = sorted(r[8] for r in rows)
    spread = {"cycles min / median / max": total[::max(1, len(total) // 2)]
              + total[-1:], "chunks": chunks[::max(1, len(chunks) // 2)]
              + chunks[-1:]}
    print(f"{case}: pull stamps over {len(rows)} blocks, SM cycles a chunk "
          + json.dumps({k: round(v) for k, v in per.items()})
          + f"; per block {json.dumps(spread)}; the block with most chunks "
          f"[{', '.join(parts)}, chunks, items]: {busy}")


def bwd_check(got, want, scale, instance):
    """Whether a build's maps' gradients match the plain version's:
    float32 within chip_smoke.py's atol and rtol; bfloat16 bit-equal but
    for at most 1e-3 of the values, each within one bfloat16 ulp of the
    cell's scale."""
    if instance == "float32":
        return all(torch.allclose(g, w, atol=BWD_ATOL, rtol=BWD_RTOL)
                   for g, w in zip(got, want))
    for g, w, a in zip(got, want, scale):
        g, w, a = g.float(), w.float(), a.float()
        big = torch.maximum(torch.maximum(g.abs(), w.abs()), a)
        ulp = torch.exp2(torch.floor(torch.log2(big.clamp_min(1e-38))) - 7)
        differ = g != w
        if (differ.float().mean() > 1e-3
                or bool(((g - w).abs() > ulp)[differ].any())):
            return False
    return True


def backward_main(src, against, dev, only=None) -> int:
    from ..ops.epipolar_gather import epipolar_gather_backward_plain
    srcs = {"kernel": src}
    for name, subs in BACKWARD_VARIANTS.items():
        if only is None or name in only:
            srcs[name] = variant(src, subs)
    for k, text in enumerate(against):   # against, against_1, ...
        srcs["against" + (f"_{k}" if k else "")] = text
    libs = compile_all(srcs, strict=False)
    if "kernel" not in libs:
        return 1
    print(smi("name,power.limit"))
    for name, (_, so, rep) in libs.items():
        print(f"{name}: {'; '.join(rep)}; SASS instructions "
              f"{json.dumps(sass_counts(so))}")
    lib0 = libs["kernel"][0]
    for name, (lib, _, _) in libs.items():   # the pull's registers, blocks
        for fn in ("epipolar_gather_backward_info",
                   "epipolar_gather_backward_bf16_info"):
            if name.startswith("probe_") or not hasattr(lib, fn):
                continue
            out = (ctypes.c_int * 12)()
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
            if getattr(lib, fn)(out) == 0:
                print(f"{name} {fn[25:]}: count / fill / pull registers "
                      f"{out[0]} / {out[3]} / {out[6]}, spills {out[1]} / "
                      f"{out[4]} / {out[7]} bytes, pull shared memory "
                      f"{out[9]} bytes, {out[10]} blocks an SM")
    for lib, _, _ in libs.values():
        if hasattr(lib, "epipolar_gather_backward_scratch"):
            lib.epipolar_gather_backward_scratch.argtypes = [ctypes.c_int] * 4
            lib.epipolar_gather_backward_scratch.restype = ctypes.c_longlong
    lib0.epipolar_gather_backward_layout.argtypes = (
        [ctypes.c_int] * 5 + [ctypes.c_void_p])
    runs = [(name, inst) for name, (lib, _, _) in libs.items()
            for inst, (fn, _) in INSTANCES.items() if hasattr(lib, fn)]
    ms = {f"{n} {i}": {case: [] for case in BWD_CASES} for n, i in runs}
    zero, bad = {}, set()
    for case, (coords, P) in BWD_CASES.items():
        ins = bwd_inputs(dev, coords, P)
        shapes = ((V, H, W, 3), (V, H // 4, W // 4, C))
        # each build's own scratch (its sizes); the pull-only probe reads
        # the kernel's index
        scratch = {name: torch.empty(
            max(0, lib.epipolar_gather_backward_scratch(V, P, H // 4, W // 4))
            if hasattr(lib, "epipolar_gather_backward_scratch") else 0,
            dtype=torch.int32, device=dev) for name, (lib, _, _) in libs.items()}
        if "probe_pull_only" in scratch:
            scratch["probe_pull_only"] = scratch["kernel"]
        for inst, (_, dtype) in INSTANCES.items():
            outs = [torch.empty(shapes[0], device=dev)] + [
                torch.empty(shapes[1], device=dev, dtype=dtype)
                for _ in range(2)]
            d_rgb = ins[2].to(dtype)
            want = epipolar_gather_backward_plain(*shapes, ins[0], ins[1],
                                                  d_rgb, ins[3], False,
                                                  dtype)[1:]
            scale = epipolar_gather_backward_plain(
                *shapes, ins[0], ins[1], d_rgb.abs(), ins[3].abs(), False,
                dtype)[1:]
            for name, i in runs:
                if i != inst or name.startswith("probe_"):
                    continue
                for o in outs:
                    o.zero_()   # the atomic design adds into them
                launch = bwd_launcher(libs[name][0], ins, outs,
                                      scratch[name], inst)
                launch()
                again = [o.clone() for o in outs[1:]]
                launch()
                torch.cuda.synchronize()
                if not (bwd_check(outs[1:], want, scale, inst)
                        and (not hasattr(libs[name][0],
                                         "epipolar_gather_backward_scratch")
                             or all(torch.equal(a, o) for a, o in
                                    zip(again, outs[1:])))):
                    bad.add(f"{name} {inst}")
            # the index the pull-only probe reads: the kernel's, built above
            launch = bwd_launcher(lib0, ins, outs, scratch["kernel"], inst)
            launch()
            order = [n for n, i in runs if i == inst]
            for name in order + order[::-1]:     # in turns, then back
                ms[f"{name} {inst}"][case].append(cuda_ms(bwd_launcher(
                    libs[name][0], ins, outs, scratch[name], inst)))
            if "stamps" in libs and inst == "bfloat16":   # the pipelined pull
                print_stamps(f"{case} {inst}", libs["stamps"][0], bwd_launcher(
                    libs["stamps"][0], ins, outs, scratch["stamps"], inst))
            print(f"{case} {inst}: the kernel build's device events, us: "
                  + json.dumps(device_us(launch)))
            for name in libs:   # the other sources' too
                if name.startswith("against") and (name, inst) in runs:
                    print(f"{case} {inst}: {name}'s device events, us: "
                          + json.dumps(device_us(bwd_launcher(
                              libs[name][0], ins, outs, scratch[name],
                              inst))))
            if inst == "bfloat16":
                zero[case] = cuda_ms(lambda: [o.zero_() for o in outs[1:]])
        # the kernel's index of this case, as its bfloat16 call (the last)
        # left it
        layout = (ctypes.c_longlong * 5)()
        lib0.epipolar_gather_backward_layout(V, P, H // 4, W // 4, 1, layout)
        at, n_at, tiles, chunk, split = layout
        starts = scratch["kernel"][at:at + V * (tiles + 1)].view(V, tiles + 1)
        lengths = starts[:, 1:] - starts[:, :-1]
        longest = int(lengths.max())
        print(f"{case}: {int(lengths.sum())} list entries, "
              f"{int(((lengths + chunk - 1) // chunk).sum())} chunks; "
              f"longest tile list {longest} entries, "
              f"{-(-longest // chunk)} chunks of {chunk}, work items of at "
              f"most {split} chunks a view: "
              f"{scratch['kernel'][n_at:n_at + V].tolist()}")
        del ins, scratch
    print(f"builds not held to the plain version (float32 within atol "
          f"{BWD_ATOL}, rtol {BWD_RTOL}; bfloat16 one ulp on 1e-3 of the "
          f"values) or whose two launches differ: {sorted(bad)}")
    print(f"bare call ms (CUDA events, mean of 20, two turns), SM clock "
          f"after the run {smi('clocks.sm')}:")
    for key in ms:
        inst = key.split()[-1]
        base = [sum(ms[f"kernel {inst}"][c]) / 2 for c in BWD_CASES]
        mean = [sum(ms[key][c]) / 2 for c in BWD_CASES]
        print(f"  {key:26s} " + "  ".join(
            f"{c}: {m:.4f} ({100 * (m / b - 1):+.1f} %)"
            for c, m, b in zip(BWD_CASES, mean, base)))
    print("  the bf16 outputs' zero_    " + "  ".join(
        f"{c}: {m:.4f}" for c, m in zero.items()))
    print(json.dumps({"ms": ms, "zero_ms": zero, "bad": sorted(bad)}))
    return 1 if any(b.startswith("kernel ") for b in bad) else 0


def xy_points(n):
    return [["constexpr int kXyPoints = 32;", f"constexpr int kXyPoints = {n};"]]


def xy_min_blocks(n):
    return [["__launch_bounds__(kXyThreads)\nxy_grad_kernel",
             f"__launch_bounds__(kXyThreads, {n})\nxy_grad_kernel"]]


def xy_lanes(f32, bf16):
    return [["constexpr int kXyLanesF32 = 8, kXyLanesBF16 = 4;",
             f"constexpr int kXyLanesF32 = {f32}, kXyLanesBF16 = {bf16};"]]


# The element path's taps (the same text in PR 14's source) and the image's
_ELEMENT_TAPS = [
    "          to_f(__ldg(t + j)), to_f(__ldg(t + q.dx + j)),\n"
    "          to_f(__ldg(t + q.dy + j)), to_f(__ldg(t + q.dy + q.dx + j)), q);",
    "          q.wx + j, q.wy, q.owx, q.owy, q);"]
_NO_MAPS = [
    ["    load_k<K>(t, a);\n    load_k<K>(t + q.dx, b);\n"
     "    load_k<K>(t + q.dy, d);\n    load_k<K>(t + q.dy + q.dx, e);",
     "    for (int j = 0; j < K; ++j) {\n      a[j] = q.wx + j;\n"
     "      b[j] = q.wy;\n      d[j] = q.owx;\n      e[j] = q.owy;\n    }"],
    _ELEMENT_TAPS,
    ["        r0 = to_f(__ldg(tap));\n        r1 = to_f(__ldg(tap + f.dy));",
     "        r0 = f.wx;\n        r1 = f.wy;"],
    ["          r2 = to_f(__ldg(tap + f.dx));\n"
     "          r3 = to_f(__ldg(tap + f.dy + f.dx));",
     "          r2 = f.owx;\n          r3 = f.owy;"]]
_NO_SLAB = ["    for (int s = t; s < blocks; s += kXyThreads)\n",
            "    for (int s = blocks; s < blocks; s += kXyThreads)\n"]
_NO_UPSTREAM = [_NO_SLAB, [
    "          load_k<K>(ray, gr);",
    "          for (int j = 0; j < K; ++j) gr[j] = 1.0f;"]]
_TAPS_PER_LANE = [
    ["      f = rgbs[i];",
     "      f = full_point(normalised(xy, p0 + i, H, W), H, W,\n"
     "                     valid[p0 + i] ? 1.0f : 0.0f);"],
    ["      const Point q = pts[i];",
     "      const Point q = quarter_point(normalised(xy, p0 + i, H, W), fh,\n"
     "                                    fw, C, valid[p0 + i] ? 1.0f : 0.0f);"],
    ["  for (int j = t; j < 2 * kXyPoints; j += kXyThreads) {",
     "  for (int j = 2 * kXyPoints; j < 2 * kXyPoints; j += kXyThreads) {"]]
_UPSTREAM_DIRECT = [
    ["    const T* up = slab + a + i * R;", "    const T* up = rows + i * R;"],
    _NO_SLAB]
_IMAGE_TAPS = [["  constexpr bool kRows = L == 8;", "  constexpr bool kRows = false;"]]
_SHUFFLE = ("    if (kRows) {   // the x1 column from lane l + 3, landed meanwhile\n"
            "      r2 = __shfl_down_sync(0xffffffffu, r0, 3, L);\n"
            "      r3 = __shfl_down_sync(0xffffffffu, r1, 3, L);\n"
            "    }\n")
_ACC = "    float2 q_acc = make_float2(0.0f, 0.0f), f_acc = q_acc;\n"
_NO_FMA = [   # the products rounded before each sum, in PR 14's order
    ["  return make_float2(fmaf(v11 - v10, q.wy, (v01 - v00) * q.owy),\n"
     "                     fmaf(v11 - v01, q.wx, (v10 - v00) * q.owx));",
     "  return make_float2((v01 - v00) * q.owy + (v11 - v10) * q.wy,\n"
     "                     (v10 - v00) * q.owx + (v11 - v01) * q.wx);"],
    ["#pragma unroll\n    for (int j = 0; j < K; ++j) {\n"
     "      const float2 s = slopes(a[j], b[j], d[j], e[j], q);\n"
     "      acc.x = fmaf(g[j], s.x, acc.x);\n"
     "      acc.y = fmaf(g[j], s.y, acc.y);\n    }",
     "    float2 sum = make_float2(0.0f, 0.0f);\n"
     "#pragma unroll\n    for (int j = 0; j < K; ++j) {\n"
     "      const float2 s = slopes(a[j], b[j], d[j], e[j], q);\n"
     "      sum.x = j ? sum.x + g[j] * s.x : g[j] * s.x;\n"
     "      sum.y = j ? sum.y + g[j] * s.y : g[j] * s.y;\n    }\n"
     "    acc.x += sum.x;\n    acc.y += sum.y;"],
    ["      f_acc.x = fmaf(gc, s.x, f_acc.x);\n"
     "      f_acc.y = fmaf(gc, s.y, f_acc.y);",
     "      f_acc.x += gc * s.x;\n      f_acc.y += gc * s.y;"]]
def xy_threads(k):
    return [["constexpr int kXyThreads = 2 * kXyPoints;",
             f"constexpr int kXyThreads = {k} * kXyPoints;"]]
_RAY_STAGED = [
    ["  __shared__ __align__(16) T slab[kXyPoints * kMaxRow + E];\n",
     "  __shared__ __align__(16) T slab[kXyPoints * kMaxRow + E];\n"
     "  __shared__ __align__(16) float rays[kXyPoints * kMaxC];\n"],
    ["    asm volatile(\"cp.async.commit_group;\" ::: \"memory\");\n  }\n"
     "  for (int j = t; j < 2 * kXyPoints;",
     "    if (kVec)\n"
     "      for (int s = t; s < n * C / 4; s += kXyThreads)\n"
     "        asm volatile(\"cp.async.cg.shared.global [%0], [%1], 16;\" ::\"r\"(\n"
     "                         smem_addr(rays + 4 * s)),\n"
     "                     \"l\"(d_ray + p0 * C + 4 * s)\n"
     "                     : \"memory\");\n"
     "    asm volatile(\"cp.async.commit_group;\" ::: \"memory\");\n  }\n"
     "  for (int j = t; j < 2 * kXyPoints;"],
    ["          load_k<K>(ray, gr);",
     "          for (int j = 0; j < K; ++j) gr[j] = rays[i * C + c + j];"]]

# B'-xy, csrc/epipolar_gather.cu's xy_grad_kernel: each step of its design
# undone (the taps computed by every lane of a point; d_rgb_feats read from
# global memory, a float a lane and channel; the image's taps by lanes 0-2,
# four floats each; the image's taps awaited before the maps' are read; no
# FMAs; bfloat16 at 8 lanes a point (four channels, 8-byte reads); blocks
# of 128 threads, a point a lane in bfloat16 and two in float32; all of
# these, at 8 lanes a point and 256 threads: PR 14's design in this source;
# the rounds not unrolled; d_xy divided and stored by lane 0 alone),
# d_ray_feats staged too, float32 at 4 lanes a point, other block sizes and
# register caps, and probes (wrong on purpose) without map reads, without
# upstream reads, or both
XY_VARIANTS = {
    "taps_per_lane": _TAPS_PER_LANE,
    "upstream_direct": _UPSTREAM_DIRECT,
    "image_taps": _IMAGE_TAPS,
    "image_shuffle_first": [[_SHUFFLE, ""], [_ACC, _SHUFFLE + _ACC]],
    "no_fma": _NO_FMA,
    "lanes_8_bf16": xy_lanes(8, 8),
    "threads_128": xy_threads(4),
    "pr14_steps": _TAPS_PER_LANE + _UPSTREAM_DIRECT + _IMAGE_TAPS
    + _NO_FMA + xy_lanes(8, 8) + xy_threads(8),
    "rounds_not_unrolled": [
        ["#pragma unroll\n  for (int r = 0; r < kXyRounds;",
         "#pragma unroll 1\n  for (int r = 0; r < kXyRounds;"]],
    "dxy_lane_0": [[   # lane 0 divides both and stores them as one float2
        "    if (l < 2 && live)   // lane 0 d_x, lane 1 d_y: one division for "
        "both\n      d_xy[2 * (p0 + i) + l] =\n"
        "          (l ? dy : dx) * 2.0f / static_cast<float>(l ? H - 1 : W - 1);",
        "    if (l == 0 && live) {\n"
        "      const float ox = dx * 2.0f / static_cast<float>(W - 1);\n"
        "      const float oy = dy * 2.0f / static_cast<float>(H - 1);\n"
        "      float* out = d_xy + 2 * (p0 + i);\n"
        "      if (reinterpret_cast<uintptr_t>(out) % 8 == 0) {\n"
        "        *reinterpret_cast<float2*>(out) = make_float2(ox, oy);\n"
        "      } else {\n        out[0] = ox;\n        out[1] = oy;\n      }\n"
        "    }"]],
    "ray_staged": _RAY_STAGED,
    "lanes_4_f32": xy_lanes(4, 4),
    "points_64": xy_points(64),
    "points_128": xy_points(128),
    # 48 registers: 20 blocks of 64 threads an SM
    "min_blocks_20": xy_min_blocks(20),
    "probe_no_map_reads": _NO_MAPS,
    "probe_no_upstream_reads": _NO_UPSTREAM,
    "probe_no_reads": _NO_MAPS + _NO_UPSTREAM,
}

# The same probes, and block shapes, written for PR 14's xy kernel (eight
# lanes a point, each computing the point's taps; 256-thread blocks):
# applied to each --against source that holds their texts.
_NO_MAPS_PR14 = [
    ["    const float4 a = load4(t), b = load4(t + q.dx), d = load4(t + q.dy),\n"
     "                 e = load4(t + q.dy + q.dx);",
     "    const float4 a = make_float4(q.wx, q.wy, q.owx, q.owy),\n"
     "                 b = make_float4(q.wy, q.owx, q.owy, q.wx),\n"
     "                 d = make_float4(q.owx, q.owy, q.wx, q.wy),\n"
     "                 e = make_float4(q.owy, q.wx, q.wy, q.owx);"],
    _ELEMENT_TAPS]
_NO_UPSTREAM_PR14 = [
    ["gi[j] = j < k ? to_f(up[j]) * m : 0.0f;",
     "gi[j] = j < k ? (up == nullptr) + m : 0.0f;"],
    ["        const float4 r = ld4(d_ray + p * C + c);",
     "        const float4 r = make_float4(m, 1.0f, 1.0f, 1.0f);"],
    ["      const float g = to_f(d_rgb[p * (3 + C) + l]) * m;",
     "      const float g = m;"]]
XY_PARENT_PROBES = {
    "probe_no_map_reads": _NO_MAPS_PR14,
    "probe_no_upstream_reads": _NO_UPSTREAM_PR14,
    "probe_no_reads": _NO_MAPS_PR14 + _NO_UPSTREAM_PR14,
    # the taps and weights computed once a point (threads 0-31 the
    # quarter-res ones, 32-63 the full-res ones, into shared memory), the
    # rest as it is
    "taps_once": [
        ["  float2 q_acc = make_float2(0.0f, 0.0f), f_acc = q_acc;\n"
         "  if (p < P) {   // the same for all lanes of the point\n"
         "    const float m = valid[p] ? 1.0f : 0.0f;\n"
         "    const float2 n = normalised(xy, p, H, W);\n",
         "  __shared__ Point pts[kXyPoints], rgbs[kXyPoints];\n"
         "  {\n"
         "    const int t = threadIdx.x, i = t % kXyPoints;\n"
         "    const int pt = blockIdx.x * kXyPoints + i;\n"
         "    if (t < 2 * kXyPoints && pt < P) {\n"
         "      const float mt = valid[pt] ? 1.0f : 0.0f;\n"
         "      const float2 nt = normalised(xy, pt, H, W);\n"
         "      if (t < kXyPoints) pts[i] = quarter_point(nt, fh, fw, C, mt);\n"
         "      else rgbs[i] = full_point(nt, H, W, mt);\n"
         "    }\n"
         "  }\n"
         "  __syncthreads();\n"
         "  float2 q_acc = make_float2(0.0f, 0.0f), f_acc = q_acc;\n"
         "  if (p < P) {   // the same for all lanes of the point\n"
         "    const float m = pts[threadIdx.x / kLanes].m;\n"],
        ["      const Point q = quarter_point(n, fh, fw, C, m);",
         "      const Point q = pts[threadIdx.x / kLanes];"],
        ["add_slopes<false>(imgs, full_point(n, H, W, m), l, 1, &g, f_acc);",
         "add_slopes<false>(imgs, rgbs[threadIdx.x / kLanes], l, 1, &g, "
         "f_acc);"]],
    # 64-thread blocks; register caps of 40 and 32 (6 and 8 blocks of 256
    # threads an SM)
    "warps_2": [["constexpr int kXyWarps = 8;", "constexpr int kXyWarps = 2;"]],
    "min_blocks_6": [["__launch_bounds__(32 * kXyWarps)\nxy_grad_kernel",
                      "__launch_bounds__(32 * kXyWarps, 6)\nxy_grad_kernel"]],
    "min_blocks_8": [["__launch_bounds__(32 * kXyWarps)\nxy_grad_kernel",
                      "__launch_bounds__(32 * kXyWarps, 8)\nxy_grad_kernel"]],
}

XY_CASES = {"random P=64000": ("random", 64000),
            "planner P=64000": ("planner", 64000),
            "border P=64000": ("border", 64000)}
XY_RTOL = 1e-5   # chip_smoke.py's, of the largest |d_xy|
XY_INSTANCES = {"float32": ("epipolar_gather_backward_xy", torch.float32),
                "bfloat16": ("epipolar_gather_backward_xy_bf16",
                             torch.bfloat16)}
FWD_NAMES = {"float32": "epipolar_gather_forward",
             "bfloat16": "epipolar_gather_forward_bf16"}


def xy_inputs(dev, coords, P, seed=0):
    """The gather's float32 inputs and upstream on the card: imgs,
    img_feats, ray_feats, xy, valid, d_rgb, d_ray. "border": the random
    coordinates with every point clamped on one axis, as chip_smoke.py's
    border_inputs (the first half left or right of the columns, the second
    above or below the rows, 0.01 to 6 px past the outer pixel centre)."""
    gen = torch.Generator().manual_seed(seed + 1)
    imgs, f1, f2, xy, valid = inputs(
        "cpu", "random" if coords == "border" else coords, P, seed)
    if coords == "border":
        low = torch.rand(V, P, generator=gen) > 0.5
        off = 0.01 + torch.rand(V, P, generator=gen) * 6
        xy = xy.clone()
        for axis, size, pts in ((0, W, slice(0, P // 2)),
                                (1, H, slice(P // 2, P))):
            xy[:, pts, axis] = torch.where(low[:, pts], -off[:, pts],
                                           size - 1 + off[:, pts])
    d_rgb = torch.randn(V, P, 3 + C, generator=gen)
    d_ray = torch.randn(V, P, C, generator=gen)
    return [t.to(dev) for t in (imgs, f1, f2, xy, valid, d_rgb, d_ray)]


def xy_args(ins, dtype):
    """xy_inputs in an instance's dtypes: the maps and d_rgb in `dtype`."""
    imgs, f1, f2, xy, valid, d_rgb, d_ray = ins
    return ([t.to(dtype) for t in (imgs, f1, f2)]
            + [xy, valid, d_rgb.to(dtype), d_ray])


def shifted(t):
    """The same values one element past a 16-byte boundary (chip_smoke.py's
    misaligned case)."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    return out[1:].view_as(t).copy_(t)


def c_launch(lib, name, tensors, P):
    """A bare launch of one of the gather's C entry points on `tensors`
    (pointers, then V, P, H, W, fh, fw, C and the stream)."""
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * len(tensors) + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ptrs = [t.data_ptr() for t in tensors]
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        build.check(fn(*ptrs, V, P, H, W, H // 4, W // 4, C, stream), name)
    launch.keep = tensors
    return launch


def xy_bound_ms(args):
    """chip_smoke.py's bound of B'-xy: every input read once (the maps
    whole), d_xy written once, over 3.35 TB/s (it is bound by bytes)."""
    return 1e3 * (sum(t.numel() * t.element_size() for t in args)
                  + args[3].numel() * 4) / 3.35e12


def xy_main(src, against, dev) -> int:
    from ..ops.epipolar_gather import epipolar_gather_backward_xy_plain
    srcs = {"kernel": src}
    for name, subs in XY_VARIANTS.items():
        srcs[name] = variant(src, subs)
    for k, text in enumerate(against):   # against, against_1, ...
        key = "against" + (f"_{k}" if k else "")
        srcs[key] = text
        for name, subs in XY_PARENT_PROBES.items():
            try:
                srcs[f"{key}+{name}"] = variant(text, subs)
            except ValueError:
                print(f"{key}: {name} does not apply, left out")
    libs = compile_all(srcs, strict=False)
    if "kernel" not in libs:
        return 1
    print(smi("name,power.limit"))
    for name, (lib, so, _) in libs.items():
        # SASS instructions of the xy kernel's four instances
        info = {"sass": {re.sub(r".*xy_grad_kernelILb(\d)E(\w+?)E.*", r"vec \1 \2",
                                k): v for k, v in sass_counts(so).items()
                         if "xy_grad_kernel" in k}}
        for inst in XY_INSTANCES:
            out = (ctypes.c_int * 3)()
            lib.epipolar_gather_backward_xy_info.argtypes = [
                ctypes.c_int, ctypes.c_void_p]
            build.check(lib.epipolar_gather_backward_xy_info(
                int(inst == "bfloat16"), out), "xy_info")
            info[inst] = dict(zip(("registers", "spill_bytes",
                                   "static_smem"), out))
        print(f"{name}: xy kernel as built {json.dumps(info)}")
    probes = {n for n in libs if "probe_" in n}
    bad = set()
    # ragged blocks, and tensors one element past 16 bytes (the element
    # path; the upstream slab at every offset), held to the plain version
    for P, shift in ((1, False), (33, False), (1000, False), (1000, True)):
        ins = xy_inputs(dev, "random", P)
        for inst, (fn, dtype) in XY_INSTANCES.items():
            args = xy_args(ins, dtype)
            if shift:
                args = [shifted(t) for t in args]
            want = epipolar_gather_backward_xy_plain(*args)
            d_xy = shifted(torch.empty(V, P, 2, device=dev)) if shift else (
                torch.empty(V, P, 2, device=dev))
            for name, (lib, _, _) in libs.items():
                if name in probes:
                    continue
                d_xy.fill_(float("nan"))
                c_launch(lib, fn, args + [d_xy], P)()
                torch.cuda.synchronize()
                if not float((d_xy - want).abs().max()) <= XY_RTOL * float(
                        want.abs().max()):
                    bad.add(f"{name} {inst} P={P}" + " shifted" * shift)
    ms = {f"{n} {i}": {c: [] for c in XY_CASES}
          for n in libs for i in XY_INSTANCES}
    fwd = {i: {} for i in XY_INSTANCES}
    bound = {i: {} for i in XY_INSTANCES}
    differ = {}
    for case, (coords, P) in XY_CASES.items():
        ins = xy_inputs(dev, coords, P)
        for inst, (fn, dtype) in XY_INSTANCES.items():
            args = xy_args(ins, dtype)
            want = epipolar_gather_backward_xy_plain(*args)
            scale = float(want.abs().max())
            d_xy = torch.empty(V, P, 2, device=dev)
            got = {}
            for name, (lib, _, _) in libs.items():
                if name in probes:
                    continue
                d_xy.fill_(float("nan"))
                c_launch(lib, fn, args + [d_xy], P)()
                torch.cuda.synchronize()
                got[name] = d_xy.clone()
                err = float((d_xy - want).abs().max())
                if not err <= XY_RTOL * scale:
                    bad.add(f"{name} {inst}")
                half = P // 2   # border: exactly 0 along the clamped axis
                if coords == "border" and not (
                        bool((d_xy[:, :half, 0] == 0).all())
                        and bool((d_xy[:, half:, 1] == 0).all())):
                    bad.add(f"{name} {inst} clamped axis")
            differ[f"{case} {inst}"] = {
                n: float((g - got["kernel"]).abs().max())
                for n, g in got.items() if not torch.equal(g, got["kernel"])}
            order = list(libs)
            for name in order + order[::-1]:     # in turns, then back
                ms[f"{name} {inst}"][case].append(cuda_ms(c_launch(
                    libs[name][0], fn, args + [d_xy], P)))
            # the yardstick: the kernel build's forward on the same inputs
            rgb = torch.empty(V, P, 3 + C, device=dev, dtype=dtype)
            ray = torch.empty(V, P, C, device=dev)
            fwd[inst][case] = cuda_ms(c_launch(
                libs["kernel"][0], FWD_NAMES[inst], args[:5] + [rgb, ray], P))
            bound[inst][case] = xy_bound_ms(args)
        del ins
    print(f"builds beyond {XY_RTOL} of the plain version's largest |d_xy|: "
          f"{sorted(bad)}")
    print("builds whose d_xy differs from the kernel build's (max abs "
          "difference): " + json.dumps(differ))
    print(f"bare launch ms (CUDA events, mean of 20, two turns), SM clock "
          f"after the run {smi('clocks.sm')}:")
    for inst in XY_INSTANCES:
        base = {c: sum(ms[f"kernel {inst}"][c]) / 2 for c in XY_CASES}
        print(f"  {inst}: bound " + "  ".join(
            f"{c}: {bound[inst][c]:.4f}" for c in XY_CASES))
        print(f"  {inst}: forward (kernel build) " + "  ".join(
            f"{c}: {fwd[inst][c]:.4f}" for c in XY_CASES))
        for name in libs:
            mean = {c: sum(ms[f"{name} {inst}"][c]) / 2 for c in XY_CASES}
            print(f"  {name + ' ' + inst:42s} " + "  ".join(
                f"{c}: {mean[c]:.4f} ({100 * (mean[c] / base[c] - 1):+.1f} %,"
                f" {100 * bound[inst][c] / mean[c]:.1f} % of bound, "
                f"{mean[c] / fwd[inst][c]:.2f} x fwd)" for c in XY_CASES))
    print(json.dumps({"ms": ms, "forward_ms": fwd, "bound_ms": bound,
                      "bad": sorted(bad)}))
    return 1 if any(b.startswith("kernel ") for b in bad) else 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", metavar="FILE", action="append",
                    default=[], help="another source of the same C "
                    "interface, timed too (repeatable)")
    ap.add_argument("--backward", action="store_true",
                    help="the backward's builds instead of the forward's")
    ap.add_argument("--variants", metavar="A,B",
                    help="with --backward: only these BACKWARD_VARIANTS")
    ap.add_argument("--xy", action="store_true",
                    help="the gradient with respect to xy's builds instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gather_variants: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    with open(SRC) as f:
        src = f.read()
    against = []
    for path in args.against:
        with open(path) as f:
            against.append(f.read())
    if args.xy:
        return xy_main(src, against, dev)
    if args.backward:
        only = args.variants.split(",") if args.variants else None
        if only and set(only) - set(BACKWARD_VARIANTS):
            ap.error(f"no such variants: {set(only) - set(BACKWARD_VARIANTS)}")
        return backward_main(src, against, dev, only)
    srcs = {"kernel": src}
    for k, text in enumerate(against):
        srcs["against" + (f"_{k}" if k else "")] = text
    for name, subs in VARIANTS.items():
        srcs[name] = variant(src, subs)
    libs = compile_all(srcs)
    print(smi("name,power.limit"))
    for name, (_, so, rep) in libs.items():
        print(f"{name}: {'; '.join(rep)}; SASS instructions "
              f"{json.dumps(sass_counts(so))}")

    ms = {name: {case: [] for case in CASES} for name in libs}
    fill = []
    order = list(libs)
    for case, (coords, P) in CASES.items():
        ins = inputs(dev, coords, P)
        outs = [torch.empty(V, P, c, device=dev) for c in (3 + C, C)]
        launcher(libs["kernel"][0], ins, outs)()
        ref = [o.clone() for o in outs]
        differ = []
        for name, (lib, _, _) in libs.items():
            for o in outs:
                o.fill_(float("nan"))
            launcher(lib, ins, outs)()
            torch.cuda.synchronize()
            if not all(torch.equal(o, r) for o, r in zip(outs, ref)):
                differ.append(name)
        print(f"{case}: builds whose outputs differ from the kernel's: "
              f"{differ}")
        if any(n in VARIANTS and not n.startswith("probe_") for n in differ):
            raise AssertionError(f"a variant writes something else ({case})")
        for name in order + order[::-1]:     # in turns, then back
            ms[name][case].append(cuda_ms(launcher(libs[name][0], ins, outs)))
        # yardstick: what writing the outputs alone takes (two fill_ calls)
        fill.append(cuda_ms(lambda: [o.fill_(0.0) for o in outs]))
        del ins, outs, ref
    print(f"bare launch ms (CUDA events, mean of 20, two turns), SM clock "
          f"after the run {smi('clocks.sm')}:")
    for name in libs:
        base = [sum(ms["kernel"][c]) / 2 for c in CASES]
        mean = [sum(ms[name][c]) / 2 for c in CASES]
        print(f"  {name:22s} " + "  ".join(
            f"{c}: {m:.4f} ({100 * (m / b - 1):+.1f} %)"
            for c, m, b in zip(CASES, mean, base)))
    print("  outputs' fill_ alone   " + "  ".join(
        f"{c}: {m:.4f}" for c, m in zip(CASES, fill)))
    print(json.dumps({"ms": ms, "fill_ms": dict(zip(CASES, fill))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
