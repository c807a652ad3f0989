"""Where a view-fuse kernel's time goes, phase by phase, on the card.

Builds the kernel's source (csrc/view_fuse.cu, or csrc/view_fuse_bf16.cu
with `--bf16`) twice with nvcc into graspnerf_tpu_torch/_build/: as it is,
and with a clock64() stamp after each barrier of its tile loop (thread 0 of
block 0 adds each phase's cycles to a device array and counts its tiles;
one more barrier closes the loop's last phase). Runs both on the same
seeded inputs at the volume path's 64,000 rows, checks that they agree,
times both with CUDA events (in turns, then back) and prints, per phase,
the mean SM cycles per tile of block 0 and its share, labelled by the
phase's first statement. `--ablations` adds a build for each entry of the
kernel's ablations (one design choice undone by text substitutions), timed
in the same turns. Run from the repository root on a machine with a CUDA
card:

    python3 -m graspnerf_tpu_torch.tools.view_fuse_phases [--bf16] [--ablations]
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

from .. import build
from ..ops.view_fuse import LAYER_DIMS, pack_weights, pack_weights_bf16

ROWS = 64000            # the volume path's 40^3 rows
STAMP = ("if (blockIdx.x == 0 && threadIdx.x == 0) {{ "
         "const unsigned long long t_ = clock64(); "
         "p_[{k}] += t_ - t_last; t_last = t_; }}")
COUNT = "if (blockIdx.x == 0 && threadIdx.x == 0) p_[63] += 1;"
# the phases' cycles and the tile count are kept in thread 0's registers
# (a global read-modify-write per stamp would stall its warp for an L2
# round trip each phase) and added to g_phase once, after the loop
FLUSH = "atomicAdd(&g_phase[{k}], p_[{i}]); "


def stamped_source(src: str, mode: dict):
    """The source with a stamp after every barrier of the tile loop, and the
    label of each phase (its first statement)."""
    loop_line, bar, first = mode["loop"], mode["barrier"], mode["first"]
    head, body = src.split(loop_line)
    end = body.index("\n  }\n}\n")            # the tile loop's closing brace
    loop, tail = body[:end], body[end:]
    loop = loop.replace(first, first + "    unsigned long long t_last = "
                        "clock64();\n    " + COUNT + "\n", 1)
    loop += "\n    " + bar
    labels, parts = [], loop.split(bar)
    for k, part in enumerate(parts[:-1]):
        code = [l.strip() for l in part.splitlines()
                if l.strip() not in ("", "{")
                and not l.strip().startswith(("//", "}", "#"))
                and "t_last" not in l and "p_[" not in l
                and l not in first]
        labels.append(code[0][:70] if code else "?")
        parts[k] = part + bar + " " + STAMP.format(k=k)
    loop = "".join(parts[:-1]) + parts[-1]
    loop = loop.replace("p_[63]", f"p_[{len(labels)}]")
    head = head.replace("namespace {\n",
                        "namespace {\n__device__ unsigned long long "
                        "g_phase[64];\n", 1)
    head += (f"  unsigned long long p_[{len(labels) + 1}] = {{}};\n")
    flush = "".join(FLUSH.format(k=k, i=k) for k in range(len(labels)))
    flush += FLUSH.format(k=63, i=len(labels))
    tail = (tail[:len("\n  }\n")] + "  if (blockIdx.x == 0 && threadIdx.x "
            "== 0) { " + flush + "}\n" + tail[len("\n  }\n"):])
    exports = """
extern "C" int view_fuse_phases(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
}
extern "C" int view_fuse_phases_reset() {
  static const unsigned long long zero[64] = {};
  return (int)cudaMemcpyToSymbol(g_phase, zero, sizeof(zero));
}
"""
    return head + loop_line + loop + tail + exports, labels


def compile_all(srcs, entry):
    """{name: source text} -> {name: (CDLL, ptxas register/spill lines)};
    `entry` is the forward's C name."""
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
        fn = getattr(lib, entry)
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        out[name] = (lib, [l.strip() for l in log.splitlines()
                           if "registers" in l or "spill" in l])
    return out


def inputs(n, dev, dtype, seed=0):
    """Seeded inputs in `dtype` and the weight pack of its kernel."""
    gen = torch.Generator().manual_seed(seed)
    weights = [(torch.randn(o, i, generator=gen) / i ** 0.5,
                0.1 * torch.randn(o, generator=gen)) for i, o in LAYER_DIMS]
    ins = [torch.rand(6, n, 35, generator=gen),
           torch.rand(6, n, 32, generator=gen),
           torch.rand(6, n, 4, generator=gen) - 0.5,
           (torch.rand(6, n, 1, generator=gen) > 0.3).float()]
    pack = (pack_weights if dtype == torch.float32 else pack_weights_bf16)
    return ([t.to(dev, dtype) for t in ins],
            pack(weights).to(dev))


def launch(lib, entry, ins, wpack):
    V, N = ins[0].shape[:2]
    outs = [torch.empty(s, device=ins[0].device,
                        dtype=torch.float32 if k == 1 else ins[0].dtype)
            for k, s in enumerate(((N, 65), (N, 1), (V, N, 32), (V, N, 1)))]
    status = getattr(lib, entry)(
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
    "scalar_tile_loads": [["    if (vec) {\n      Inputs in;",
                           "    if (false) {\n      Inputs in;"]],
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


# The same for csrc/view_fuse_bf16.cu. The probe_* builds compute wrong
# results on purpose, each removing one cost: the exponentials (ex2 becomes
# a multiply), the tensor-core products (each mma becomes four float adds
# of its operands' bits), the input reads (every cp.async zero-fills).
# Then the layer chains staged in shared
# memory (each product's A fragments written by the warp and read back;
# three groups a block, to make room: compare with groups_3) against kept
# in registers; fewer groups: three; three with two input buffers (slab
# s + 1 loading while s computes); one group a block, one and two blocks
# per SM; the weights read through L1; element tile loads; IEEE divisions
# for the weights; __expf (denormal results kept) and libm's exponentials.
ABLATIONS_BF16 = {
    "probe_no_exponentials": [[
        'asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x * 1.44269504f));',
        "y = x * 1.44269504f;"]],
    "probe_no_tensor_products": [[
        '  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "\n'
        '      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\\n"\n'
        '      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])\n'
        '      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), '
        '"r"(b.y));',
        "  d[0] += __uint_as_float((a[0] ^ b.x) & 0x3fffffffu);\n"
        "  d[1] += __uint_as_float((a[1] ^ b.y) & 0x3fffffffu);\n"
        "  d[2] += __uint_as_float((a[2] ^ b.x) & 0x3fffffffu);\n"
        "  d[3] += __uint_as_float((a[3] ^ b.y) & 0x3fffffffu);"]],
    "probe_no_input_reads": [['"r"(in ? 16 : 0) : "memory");',
                              '"r"(0) : "memory");']],
    "layers_in_shared_memory": [["constexpr bool kStageLayers = false;",
                                 "constexpr bool kStageLayers = true;"],
                                ["constexpr int kGroups = 4;",
                                 "constexpr int kGroups = 3;"]],
    "groups_3": [["constexpr int kGroups = 4;", "constexpr int kGroups = 3;"]],
    "groups_3_two_input_buffers": [["constexpr int kGroups = 4;",
                                    "constexpr int kGroups = 3;"],
                                   ["constexpr int kInBuffers = 1;",
                                    "constexpr int kInBuffers = 2;"]],
    "one_group": [["constexpr int kGroups = 4;", "constexpr int kGroups = 1;"]],
    "two_blocks_of_one_group": [["constexpr int kGroups = 4;",
                                 "constexpr int kGroups = 1;"],
                                ["constexpr int kBlocksPerSM = 1;",
                                 "constexpr int kBlocksPerSM = 2;"]],
    "weights_in_l1": [["constexpr bool kWeightsInSmem = true;",
                       "constexpr bool kWeightsInSmem = false;"]],
    "scalar_tile_loads": [["const bool vec = N % 8 == 0 && addr % 16 == 0;",
                           "const bool vec = false;"]],
    "ieee_division": [["wt[h] = mk[h] * __frcp_rn(nv + 1e-8f);",
                       "wt[h] = mk[h] / (nv + 1e-8f);"],
                      ["w2[u] *= __frcp_rn(vsum + 1e-8f);",
                       "w2[u] /= vsum + 1e-8f;"]],
    "expf_with_denormals": [["return x > 0.0f ? x : exp_ftz(x) - 1.0f;",
                             "return x > 0.0f ? x : __expf(x) - 1.0f;"],
                            ["return __fdividef(1.0f, 1.0f + exp_ftz(-x));",
                             "return __fdividef(1.0f, 1.0f + __expf(-x));"]],
    "libm_exp": [["return x > 0.0f ? x : exp_ftz(x) - 1.0f;",
                  "return x > 0.0f ? x : expm1f(x);"],
                 ["return __fdividef(1.0f, 1.0f + exp_ftz(-x));",
                  "return 1.0f / (1.0f + expf(-x));"]],
}

# Per kernel: its source, tile loop, barrier, the loop's first statement,
# its forward's C name, its input dtype and its ablations
MODES = {
    "f32": {"src": "view_fuse.cu",
            "loop": "  for (int tile = blockIdx.x; tile < ntiles; "
                    "tile += gridDim.x) {\n",
            "barrier": "__syncthreads();",
            "first": "    const int n0 = tile * T;\n",
            "entry": "view_fuse_forward", "dtype": torch.float32,
            "ablations": ABLATIONS},
    "bf16": {"src": "view_fuse_bf16.cu",
             "loop": "  for (int slab = blockIdx.x * kGroups + gid; "
                     "slab < nslabs; slab += step) {\n",
             "barrier": "bar_group(gid);",
             "first": "    const int n0 = slab * R;\n",
             "entry": "view_fuse_bf16_forward", "dtype": torch.bfloat16,
             "ablations": ABLATIONS_BF16},
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
    ap.add_argument("--bf16", action="store_true",
                    help="the bfloat16 kernel, csrc/view_fuse_bf16.cu")
    ap.add_argument("--ablations", action="store_true",
                    help="also time every build of the kernel's ablations")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("view_fuse_phases: no CUDA device", file=sys.stderr)
        return 2
    mode = MODES["bf16" if args.bf16 else "f32"]
    entry = mode["entry"]
    dev = torch.device("cuda", 0)
    with open(os.path.join(build.CSRC_DIR, mode["src"])) as f:
        src = f.read()
    stamped, labels = stamped_source(src, mode)
    srcs = {"plain": src, "stamped": stamped}
    for name, subs in (mode["ablations"].items() if args.ablations else ()):
        srcs[name] = variant(src, subs)
    libs = compile_all(srcs, entry)
    print(smi("name,power.limit"))
    for name, (_, rep) in libs.items():
        print(f"{name}: {'; '.join(rep)}")

    ins, wpack = inputs(ROWS, dev, mode["dtype"])
    ref = launch(libs["plain"][0], entry, ins, wpack)
    for name, (lib, _) in libs.items():
        got = launch(lib, entry, ins, wpack)
        torch.cuda.synchronize()
        err = max(float((g.float() - r.float()).abs().max())
                  for g, r in zip(got, ref))
        if name == "stamped" and err != 0.0:
            raise AssertionError("the stamped build computes something else")
        print(f"{name}: max abs difference from plain {err:.3e}")

    stamped_lib = libs["stamped"][0]
    ms = {name: [] for name in libs}
    order = list(libs)
    for name in order + order[::-1]:     # in turns, then back
        if name == "stamped":
            build.check(stamped_lib.view_fuse_phases_reset(), "reset")
        ms[name].append(cuda_ms(
            lambda: launch(libs[name][0], entry, ins, wpack)))
    clock = smi("clocks.sm")
    buf = (ctypes.c_ulonglong * 64)()
    build.check(stamped_lib.view_fuse_phases(buf), "phases")
    tiles = buf[63]            # block 0's tiles over the timed launches
    cycles = [buf[k] / tiles for k in range(len(labels))]
    total = sum(cycles)
    print(f"{mode['src']} N={ROWS}: kernel ms per launch (CUDA events, mean "
          f"of 20, two turns): {json.dumps(ms)}; SM clock after the run "
          f"{clock}")
    print(f"block 0 of the stamped build: {total:.0f} cycles per tile, by "
          f"phase (each ends at the barrier after it):")
    for k, (c, label) in enumerate(zip(cycles, labels)):
        print(f"  {k + 1:2d} {c:8.0f} {100 * c / total:5.1f} %  {label}")
    print(json.dumps({"source": mode["src"], "rows": ROWS, "ms": ms,
                      "cycles_per_tile": total,
                      "phases": [{"label": l, "cycles": c}
                                 for l, c in zip(labels, cycles)]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
