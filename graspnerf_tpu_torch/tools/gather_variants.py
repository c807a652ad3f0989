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
coordinates at the render pass's P = 163,840. Run from the repository root
on a machine with a CUDA card:

    python3 -m graspnerf_tpu_torch.tools.gather_variants [--against FILE]
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
from .scene import synthetic_views, volume_coords
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", metavar="FILE",
                    help="another source of the same C interface, timed too")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gather_variants: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    with open(SRC) as f:
        src = f.read()
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
