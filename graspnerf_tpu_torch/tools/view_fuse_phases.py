"""Where the view-fuse kernel's time goes, phase by phase, on the card.

Builds csrc/view_fuse.cu twice with nvcc into graspnerf_tpu_torch/_build/:
as it is, and with a clock64() stamp after each barrier of its tile loop
(thread 0 of block 0 adds each phase's cycles to a device array; one more
barrier closes the loop's last phase). Runs both on the same seeded inputs
at the volume path's 64,000 rows, checks that they agree, times both with
CUDA events (in turns, then back) and prints, per phase, the mean SM cycles
per tile of block 0 and its share, labelled by the phase's first
statement. `--ablations` adds a build for each entry of ABLATIONS (one
design choice undone by text substitutions), timed in the same turns. Run
from the repository root on a machine with a CUDA card:

    python3 -m graspnerf_tpu_torch.tools.view_fuse_phases [--ablations]
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import torch

from .. import build
from ..ops.view_fuse import LAYER_DIMS, pack_weights

SRC = os.path.join(build.CSRC_DIR, "view_fuse.cu")
ROWS = 64000            # the volume path's 40^3 rows
LOOP = "  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {\n"
STAMP = ("if (blockIdx.x == 0 && threadIdx.x == 0) {{ "
         "const unsigned long long t_ = clock64(); "
         "g_phase[{k}] += t_ - t_last; t_last = t_; }}")


def stamped_source(src: str):
    """The source with a stamp after every barrier of the tile loop, and the
    label of each phase (its first statement)."""
    head, body = src.split(LOOP)
    end = body.index("\n  }\n}\n")            # the tile loop's closing brace
    loop, tail = body[:end], body[end:]
    loop = loop.replace("    const int n0 = tile * T;\n",
                        "    const int n0 = tile * T;\n"
                        "    unsigned long long t_last = clock64();\n", 1)
    loop += "\n    __syncthreads();"
    labels, parts = [], loop.split("__syncthreads();")
    for k, part in enumerate(parts[:-1]):
        code = [l.strip() for l in part.splitlines()
                if l.strip() and not l.strip().startswith(("//", "}", "#"))
                and "t_last" not in l and "n0 = tile" not in l]
        labels.append(code[0][:70] if code else "?")
        parts[k] = part + "__syncthreads(); " + STAMP.format(k=k)
    loop = "".join(parts[:-1]) + parts[-1]
    head = head.replace("namespace {\n",
                        "namespace {\n__device__ unsigned long long "
                        "g_phase[64];\n", 1)
    exports = """
extern "C" int view_fuse_phases(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
}
extern "C" int view_fuse_phases_reset() {
  static const unsigned long long zero[64] = {};
  return (int)cudaMemcpyToSymbol(g_phase, zero, sizeof(zero));
}
"""
    return head + LOOP + loop + tail + exports, labels


def compile_all(srcs):
    """{name: source text} -> {name: (CDLL, ptxas register/spill lines)}."""
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    procs = {}
    for name, text in srcs.items():
        cu = os.path.join(build.BUILD_DIR, f"phases_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = cu[:-3] + ".so"
        cmd = [build.nvcc_path()] + build.ARCH_FLAGS + build.COMMON_FLAGS + [
            "-o", so, cu]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       so)
    out = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(so)
        lib.view_fuse_forward.argtypes = ([ctypes.c_void_p] * 9
                                          + [ctypes.c_int, ctypes.c_void_p])
        lib.view_fuse_forward.restype = ctypes.c_int
        out[name] = (lib, [l.strip() for l in log.splitlines()
                           if "registers" in l or "spill" in l])
    return out


def inputs(n, dev, seed=0):
    gen = torch.Generator().manual_seed(seed)
    weights = [(torch.randn(o, i, generator=gen) / i ** 0.5,
                0.1 * torch.randn(o, generator=gen)) for i, o in LAYER_DIMS]
    ins = [torch.rand(6, n, 35, generator=gen),
           torch.rand(6, n, 32, generator=gen),
           torch.rand(6, n, 4, generator=gen) - 0.5,
           (torch.rand(6, n, 1, generator=gen) > 0.3).float()]
    return [t.to(dev) for t in ins], pack_weights(weights).to(dev)


def launch(lib, ins, wpack):
    V, N = ins[0].shape[:2]
    outs = [torch.empty(s, device=ins[0].device)
            for s in ((N, 65), (N, 1), (V, N, 32), (V, N, 1))]
    status = lib.view_fuse_forward(
        *[t.data_ptr() for t in ins], wpack.data_ptr(),
        *[o.data_ptr() for o in outs], N,
        torch.cuda.current_stream().cuda_stream)
    build.check(status, "view_fuse")
    return outs


def cuda_ms(fn, iters=20, warmup=3):
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


def smi(query):
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()


# Each design choice of csrc/view_fuse.cu undone on its own, as text
# substitutions of the source (`--ablations` times them all). The probe_*
# builds compute wrong results on purpose: each removes one cost (every
# lane of a warp reads the same activations; the tile load's scatter writes
# one address) to show what that cost is.
ABLATIONS = {
    "probe_uniform_activation_reads": [["    const float* a = A + 4 * mq;",
                                        "    const float* a = A;"]],
    "probe_one_scatter_address": [["        d[c * MP + r] = f[j];",
                                   "        d[j] = f[j];"]],
    "tiles_4x4_only": [[
        "pad4(O) % 32 == 0 && warp_tiles(O, MC, Shape{8, 4}) >= kWarps",
        "false"]],
    "lanes_8x4_only": [["MC / 4 % 16 == 0 &&", "false &&"]],
    "unroll_4": [["#pragma unroll 8\n    for (int i = 0; i < I; ++i) {",
                  "#pragma unroll 4\n    for (int i = 0; i < I; ++i) {"]],
    "warps_8": [["constexpr int kWarps = 12;", "constexpr int kWarps = 8;"]],
    "warps_16": [["constexpr int kWarps = 12;", "constexpr int kWarps = 16;"]],
    "gf_block_whole": [["constexpr int kGfParts = 2, kGfK = 70;",
                        "constexpr int kGfParts = 1, kGfK = 140;"]],
    "gf_block_in_6": [["constexpr int kGfParts = 2, kGfK = 70;",
                       "constexpr int kGfParts = 6, kGfK = 24;"]],
    "no_l2_prefetch": [["    if (tile + gridDim.x < ntiles)\n      prefetch_inputs(",
                        "    if (false)\n      prefetch_inputs("]],
    "scalar_tile_loads": [["    if (vec) {\n      Inputs<In> in;",
                           "    if (false) {\n      Inputs<In> in;"]],
    "libm_exp": [["return x > 0.0f ? x : __expf(x) - 1.0f;",
                  "return x > 0.0f ? x : expm1f(x);"],
                 ["return __fdividef(1.0f, 1.0f + __expf(-x));",
                  "return 1.0f / (1.0f + expf(-x));"]],
    "w2_by_division": [[
        "      const float inv = 1.0f / (vsum + 1e-8f);\n#pragma unroll\n"
        "      for (int u = 0; u < V; ++u) w2[u] = vis[u * T + r] * inv;",
        "#pragma unroll\n"
        "      for (int u = 0; u < V; ++u) w2[u] = vis[u * T + r] / "
        "(vsum + 1e-8f);"]],
}


def variant(src: str, subs) -> str:
    """The source with each (old, new) text substitution made; each old
    text must occur."""
    for old, new in subs:
        if old not in src:
            raise ValueError(f"variant text not in the source: {old!r}")
        src = src.replace(old, new)
    return src


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ablations", action="store_true",
                    help="also time every build of ABLATIONS")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("view_fuse_phases: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    with open(SRC) as f:
        src = f.read()
    stamped, labels = stamped_source(src)
    srcs = {"plain": src, "stamped": stamped}
    for name, subs in (ABLATIONS.items() if args.ablations else ()):
        srcs[name] = variant(src, subs)
    libs = compile_all(srcs)
    print(smi("name,power.limit"))
    for name, (_, rep) in libs.items():
        print(f"{name}: {'; '.join(rep)}")

    ins, wpack = inputs(ROWS, dev)
    ref = launch(libs["plain"][0], ins, wpack)
    for name, (lib, _) in libs.items():
        got = launch(lib, ins, wpack)
        torch.cuda.synchronize()
        err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        if name == "stamped" and err != 0.0:
            raise AssertionError("the stamped build computes something else")
        print(f"{name}: max abs difference from plain {err:.3e}")

    stamped_lib = libs["stamped"][0]
    ms = {name: [] for name in libs}
    order = list(libs)
    for name in order + order[::-1]:     # in turns, then back
        if name == "stamped":
            build.check(stamped_lib.view_fuse_phases_reset(), "reset")
        ms[name].append(cuda_ms(lambda: launch(libs[name][0], ins, wpack)))
    clock = smi("clocks.sm")
    buf = (ctypes.c_ulonglong * 64)()
    build.check(stamped_lib.view_fuse_phases(buf), "phases")
    blocks = min(torch.cuda.get_device_properties(0).multi_processor_count,
                 -(-ROWS // 32))
    tiles = len(range(0, -(-ROWS // 32), blocks)) * 23  # block 0, 3+20
    cycles = [buf[k] / tiles for k in range(len(labels))]
    total = sum(cycles)
    print(f"N={ROWS}: kernel ms per launch (CUDA events, mean of 20, "
          f"two turns): {json.dumps(ms)}; SM clock after the run {clock}")
    print(f"block 0 of the stamped build: {total:.0f} cycles per tile, by "
          f"phase (each ends at the barrier after it):")
    for k, (c, label) in enumerate(zip(cycles, labels)):
        print(f"  {k + 1:2d} {c:8.0f} {100 * c / total:5.1f} %  {label}")
    print(json.dumps({"rows": ROWS, "ms": ms, "cycles_per_tile": total,
                      "phases": [{"label": l, "cycles": c}
                                 for l, c in zip(labels, cycles)]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
