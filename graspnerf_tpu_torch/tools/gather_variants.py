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

With `--backward`, the same for the backward (`epipolar_gather_backward`):
the build as it is; each entry of BACKWARD_VARIANTS (tile, chunk and index
sizes, ranks from shuffles, the gradient rows read from global memory or
copied through registers, invalid points kept in the index, the pull's
phases in SM cycles (`stamps`), and probes that leave out the finiteness
check of the invalid points, or launch the index passes alone or the pull
alone on an index built beforehand); and with `--against FILE` that source
(an earlier commit's, whose backward adds into zeroed outputs with
atomics) and, as `against_merged`, that source with the reductions of
equal taps merged across a warp first (`__match_any_sync`). Every build but
the probes is held to the plain version; each build's bare call (all its
CUDA launches, into preallocated outputs) is timed on random and the
planner's coordinates at P = 64,000 and on a training batch's coarse-pass
coordinates at P = 20,480, beside one `zero_` of the two outputs (what the
atomic design's wrapper adds); the build's own call is also broken down by
device event (torch.profiler). Run from the repository root on a machine
with a CUDA card:

    python3 -m graspnerf_tpu_torch.tools.gather_variants [--backward] [--against FILE]
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


BACKWARD_VARIANTS = {
    "tile_4x8": [["constexpr int kTileY = 8, kTileX = 8;",
                  "constexpr int kTileY = 4, kTileX = 8;"]],
    "tile_8x16": [["constexpr int kTileY = 8, kTileX = 8;",
                   "constexpr int kTileY = 8, kTileX = 16;"]],
    "chunk_128": bwd_sub("kChunk", 256, 128),
    "chunk_512": bwd_sub("kChunk", 256, 512),
    "index_rounds_4": bwd_sub("kRounds", 2, 4),
    "rank_by_shuffles": [   # peers from 32 shuffles, not match.any
        ["  const unsigned peers = __match_any_sync(0xffffffffu, key);",
         "  unsigned peers = 0;\n"
         "  for (int j = 0; j < 32; ++j)\n"
         "    peers |= unsigned(__shfl_sync(0xffffffffu, key, j) == key) << j;"]],
    "rows_from_global": [["constexpr bool kStageRows = true;",
                          "constexpr bool kStageRows = false;"]],
    "rows_plain_loads": [   # the row copies through registers, not cp.async
        ['  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(\n'
         '                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),\n'
         '               "l"(src));', "  *dst = *src;"]],
    # invalid points left out unchecked: a non-finite upstream value there
    # would not reach the maps (unlike the plain version); what the check
    # costs
    "probe_no_finite_check": [[
        "    const bool check = kFill && out && p < P;",
        "    const bool check = false;"]],
    "keep_invalid": [["constexpr bool kDropInvalid = true;",
                      "constexpr bool kDropInvalid = false;"]],
    # the pull's phases in SM cycles (clock64 after each barrier)
    "stamps": [["constexpr bool kStamps = false;",
                "constexpr bool kStamps = true;"]],
    # probes: one part of a call alone
    "probe_index_only": [["kRunIndex = true, kRunPull = true;",
                          "kRunIndex = true, kRunPull = false;"]],
    "probe_pull_only": [["kRunIndex = true, kRunPull = true;",
                         "kRunIndex = false, kRunPull = true;"]],
}

# The atomic design (an earlier source, --against) with each warp's equal
# taps merged before the reductions: lanes that hold the same four channels
# of points with the same taps sum their contributions with shuffles, and
# the lowest of them issues the four vector reductions.
MERGE_HELPER = """
__device__ __forceinline__ void taps4(float t[16], const Point& q, float4 g) {
  const float gg[4] = {g.x * q.m, g.y * q.m, g.z * q.m, g.w * q.m};
  for (int j = 0; j < 4; ++j) {
    const float top = gg[j] * q.owy, bot = gg[j] * q.wy;
    t[j] = top * q.owx;
    t[4 + j] = top * q.wx;
    t[8 + j] = bot * q.owx;
    t[12 + j] = bot * q.wx;
  }
}

__device__ __forceinline__ void merged_splat4(float* map, const Point& q,
                                              float4 g) {
  float t[16];
  taps4(t, q, g);
  const unsigned long long key =
      static_cast<unsigned long long>(reinterpret_cast<uintptr_t>(map + q.o00))
          << 2 | (q.dx != 0) << 1 | (q.dy != 0);
  const unsigned peers = __match_any_sync(__activemask(), key);
  const int lane = threadIdx.x % 32;
  float u[16] = {};
  for (unsigned rest = peers; rest; rest &= rest - 1) {
    const int j = __ffs(rest) - 1;
    for (int i = 0; i < 16; ++i) u[i] += __shfl_sync(peers, t[i], j);
  }
  if (lane != __ffs(peers) - 1) return;
  float* m = map + q.o00;
  red4(m, u[0], u[1], u[2], u[3]);
  red4(m + q.dx, u[4], u[5], u[6], u[7]);
  red4(m + q.dy, u[8], u[9], u[10], u[11]);
  red4(m + q.dy + q.dx, u[12], u[13], u[14], u[15]);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
gather_backward_kernel("""
AGAINST_MERGED = [
    ["template <bool kVec>\n__global__ void __launch_bounds__(kThreads)\n"
     "gather_backward_kernel(", MERGE_HELPER],
    ["      splat4(d_ray_feats + c, q, ld4(d_ray + p * C + c));",
     "      merged_splat4(d_ray_feats + c, q, ld4(d_ray + p * C + c));"],
    ["      splat4(d_img_feats + c, q, make_float4(gi[0], gi[1], gi[2], gi[3]));",
     "      merged_splat4(d_img_feats + c, q,\n"
     "                    make_float4(gi[0], gi[1], gi[2], gi[3]));"]]
BWD_CASES = {"random P=64000": ("random", 64000),
             "planner P=64000": ("planner", 64000),
             "train P=20480": ("train", 20480)}
BWD_ATOL, BWD_RTOL = 5e-4, 1e-5   # chip_smoke.py's, against the plain version


def compile_all(srcs):
    """{name: source text} -> {name: (CDLL, path, ptxas register lines)}."""
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
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
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


def bwd_inputs(dev, coords, P, seed=0):
    """(xy, valid, d_rgb, d_ray) on the card."""
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


def bwd_launcher(lib, ins, outs, scratch):
    """The bare call of a build's backward into outs (d_imgs stand-in,
    d_img_feats, d_ray_feats): the pull's interface with `scratch`, or the
    atomic design's, which adds into them."""
    P = ins[0].shape[1]
    fn = lib.epipolar_gather_backward
    pull = hasattr(lib, "epipolar_gather_backward_scratch")
    ptrs = ([t.data_ptr() for t in ins] + [None]
            + [o.data_ptr() for o in outs[1:]])
    if pull:
        ptrs.append(scratch.data_ptr())
    fn.argtypes = [ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        build.check(fn(*ptrs, V, P, H, W, H // 4, W // 4, C, stream),
                    "epipolar_gather_backward")
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


def print_stamps(case, lib, ins, outs, scratch):
    """The stamps build's pull phases, per view: the first block (the
    longest list) and the middle one."""
    bwd_launcher(lib, ins, outs, scratch)()
    torch.cuda.synchronize()
    buf = (ctypes.c_longlong * (2 * 64 * 8))()
    lib.epipolar_gather_backward_stamps.argtypes = [ctypes.c_void_p]
    build.check(lib.epipolar_gather_backward_stamps(buf), "stamps")
    print(f"{case}: pull phases, SM cycles (1 entries, 2 copies start + "
          f"ranks, 3 key scan, 4 scatter + copies wait, 5 sums), chunks, "
          f"entries, tile; per view, longest list | middle tile:")
    for v in range(V):
        print("  view", v, " | ".join(
            str(list(buf[(2 * v + i) * 8:(2 * v + i + 1) * 8]))
            for i in range(2)))


def backward_main(src, against, dev) -> int:
    from ..ops.epipolar_gather import epipolar_gather_backward_plain
    srcs = {"kernel": src}
    for name, subs in BACKWARD_VARIANTS.items():
        srcs[name] = variant(src, subs)
    if against:
        srcs["against"] = against
        srcs["against_merged"] = variant(against, AGAINST_MERGED)
    libs = compile_all(srcs)
    print(smi("name,power.limit"))
    for name, (_, so, rep) in libs.items():
        print(f"{name}: {'; '.join(rep)}; SASS instructions "
              f"{json.dumps(sass_counts(so))}")
    lib0 = libs["kernel"][0]
    for lib, _, _ in libs.values():
        if hasattr(lib, "epipolar_gather_backward_scratch"):
            lib.epipolar_gather_backward_scratch.argtypes = [ctypes.c_int] * 4
            lib.epipolar_gather_backward_scratch.restype = ctypes.c_longlong
    ms = {name: {case: [] for case in BWD_CASES} for name in libs}
    zero = {}
    order = list(libs)
    for case, (coords, P) in BWD_CASES.items():
        ins = bwd_inputs(dev, coords, P)
        shapes = ((V, H, W, 3), (V, H // 4, W // 4, C))
        outs = [torch.empty(shapes[0], device=dev)] + [
            torch.empty(shapes[1], device=dev) for _ in range(2)]
        # each build's own scratch (its sizes); the pull-only probe reads
        # the kernel's index
        scratch = {name: torch.empty(
            max(0, lib.epipolar_gather_backward_scratch(V, P, H // 4, W // 4))
            if hasattr(lib, "epipolar_gather_backward_scratch") else 0,
            dtype=torch.int32, device=dev) for name, (lib, _, _) in libs.items()}
        scratch["probe_pull_only"] = scratch["kernel"]
        want = epipolar_gather_backward_plain(*shapes, *ins)[1:]
        bad = []
        for name, (lib, _, _) in libs.items():
            if name.startswith("probe_"):
                continue
            for o in outs:
                o.zero_()   # the atomic design adds into them
            bwd_launcher(lib, ins, outs, scratch[name])()
            torch.cuda.synchronize()
            if not all(torch.allclose(o, w, atol=BWD_ATOL, rtol=BWD_RTOL)
                       for o, w in zip(outs[1:], want)):
                bad.append(name)
        print(f"{case}: builds not within atol {BWD_ATOL}, rtol {BWD_RTOL} "
              f"of the plain version: {bad}")
        if bad:
            raise AssertionError(f"a build computes something else ({case})")
        # the index the pull-only probe reads: the kernel's, built above
        bwd_launcher(lib0, ins, outs, scratch["kernel"])()
        for name in order + order[::-1]:     # in turns, then back
            ms[name][case].append(cuda_ms(bwd_launcher(
                libs[name][0], ins, outs, scratch[name])))
        zero[case] = cuda_ms(lambda: [o.zero_() for o in outs[1:]])
        if "stamps" in libs:
            print_stamps(case, libs["stamps"][0], ins, outs, scratch["stamps"])
        print(f"{case}: the kernel build's device events, us: "
              + json.dumps(device_us(bwd_launcher(lib0, ins, outs,
                                                  scratch["kernel"]))))
        del ins, outs, scratch, want
    print(f"bare call ms (CUDA events, mean of 20, two turns), SM clock "
          f"after the run {smi('clocks.sm')}:")
    for name in libs:
        base = [sum(ms["kernel"][c]) / 2 for c in BWD_CASES]
        mean = [sum(ms[name][c]) / 2 for c in BWD_CASES]
        print(f"  {name:22s} " + "  ".join(
            f"{c}: {m:.4f} ({100 * (m / b - 1):+.1f} %)"
            for c, m, b in zip(BWD_CASES, mean, base)))
    print("  the two outputs' zero_  " + "  ".join(
        f"{c}: {m:.4f}" for c, m in zero.items()))
    print(json.dumps({"ms": ms, "zero_ms": zero}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", metavar="FILE",
                    help="another source of the same C interface, timed too")
    ap.add_argument("--backward", action="store_true",
                    help="the backward's builds instead of the forward's")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gather_variants: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    with open(SRC) as f:
        src = f.read()
    if args.backward:
        against = None
        if args.against:
            with open(args.against) as f:
                against = f.read()
        return backward_main(src, against, dev)
    srcs = {"kernel": src}
    if args.against:
        with open(args.against) as f:
            srcs["against"] = f.read()
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
