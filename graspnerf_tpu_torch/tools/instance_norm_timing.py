"""The fused InstanceNorm (csrc/instance_norm.cu) on the card: its time
alone against the plain chain it replaces, at the encoders' four plane
shapes, and one encode's device time both ways.

For each shape (6 views of 288 x 512: 144 x 256, 72 x 128, 36 x 64, 18 x
32 planes at the encoders' widths) and each variant the encoders call
(`bn1`: ReLU, padded only; `bn2`: ReLU after BasicBlock's residual,
unpadded and padded; `down`: no activation, unpadded; `rb`:
ResidualBlock's sum then ReLU, padded; `up`: ELU, upsampled x2 and
padded; `cat`: ELU, padded into the first half of a padded
concatenation), it checks the kernel against the plain chain (within 1e-5
of each output's scale; the sum, and the border against `F.pad` of the
kernel's own interior, bit-equal) and times the kernel, the chain and the
library's norm alone (`F.instance_norm`) with CUDA events, 200 calls
captured in one CUDA graph, in turns (chain, kernel, kernel, chain), each
beside its byte bound: the bytes the variant must read and write once,
over 3.35 TB/s. Then the kernel's registers, spills and static shared
memory, and the encode (`encode_views`' graph replays, 6 x 288 x 512) with
the fused norms and with the modules' chain (`use_kernels` False), device
ms by CUDA events, median of 20 in turns; with `--profile` each encode's
device time by kernel (torch.profiler, 5 replays). Run from the
repository root on a machine with a CUDA card:

    python3 -m graspnerf_tpu_torch.tools.instance_norm_timing [--profile]
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys

import torch
import torch.nn.functional as F

from ..ops import instance_norm as norm_op
from ..ops.instance_norm import instance_norm_act, instance_norm_act_plain

HBM_BYTES_PER_S = 3.35e12
SHAPES = ((6, 32, 144, 256), (6, 32, 72, 128), (6, 64, 36, 64),
          (6, 128, 18, 32))
# name: (act, shortcut, pad, unpadded, up, into a concatenation)
VARIANTS = {"bn1": ("relu", None, 1, False, False, False),
            "bn2": ("relu", "residual", 1, True, False, False),
            "down": (None, None, 0, True, False, False),
            "rb": ("relu", "add", 1, False, False, False),
            "up": ("elu", None, 1, False, True, False),
            "cat": ("elu", None, 1, False, False, True)}
REPS = 200


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def device_ms(fn, reps: int = REPS) -> float:
    """Mean device ms a call of fn: `reps` calls captured in one CUDA graph
    (no host time between them, as in the encode's replay), replayed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(shape, shortcut, pad, unpadded, up) -> float:
    v, c, h, w = shape
    plane, f = h * w, 2 if up else 1
    reads = plane * (2 if shortcut else 1)
    writes = ((plane if unpadded else 0) + (plane if shortcut == "add" else 0)
              + ((f * h + 2 * pad) * (f * w + 2 * pad) if pad else 0))
    return 1e3 * 4 * v * c * (reads + writes) / HBM_BYTES_PER_S


def rel_err(got, want) -> float:
    """The largest |got - want| over the largest |want| (at least 1)."""
    return (got - want).abs().max().item() / max(want.abs().max().item(),
                                                  1.0)


def time_variants(dev, shapes=SHAPES) -> list:
    """A row for each shape and variant: the kernel's error against the
    chain (checked), its launch plan, and the device ms of the kernel, the
    chain and `F.instance_norm` alone, beside the byte bound."""
    gen = torch.Generator().manual_seed(0)
    rows = []
    for shape in shapes:
        v, c, h, w_ = shape
        w = (1 + 0.3 * torch.randn(c, generator=gen)).to(dev)
        b = (0.3 * torch.randn(c, generator=gen)).to(dev)
        x = (3 * torch.randn(shape, generator=gen) + 0.5).to(dev)
        other = torch.randn(shape, generator=gen).to(dev)
        buf = torch.empty(v, 2 * c, h + 2, w_ + 2, device=dev)
        for name, (act, shortcut, pad, unpadded, up, into) in (
                VARIANTS.items()):
            kw = dict(pad=pad, unpadded=unpadded, up=up)
            if shortcut:
                kw[shortcut] = other
            if into:
                kw["padded"] = buf[:, :c]

            def kernel():
                return instance_norm_act(x, w, b, act, **kw)

            def chain():
                return instance_norm_act_plain(x, w, b, act, **kw)

            def library():
                return F.instance_norm(x, weight=w, bias=b)
            want = [None if t is None else t.clone() for t in chain()]
            got = kernel()
            pairs = [(g, r) for g, r in zip(got, want) if r is not None]
            err = max(rel_err(g, r) for g, r in pairs)
            assert err <= 1e-5, (shape, name, err)
            if shortcut == "add":
                assert torch.equal(got.sum, want[0]), (shape, name)
            if pad and not up:
                inner = got.padded[..., pad:-pad, pad:-pad]
                assert torch.equal(got.padded, F.pad(inner, (pad,) * 4,
                                                     mode="reflect"))
            times = {"chain": [], "kernel": []}
            for who in ("chain", "kernel", "kernel", "chain"):
                times[who].append(device_ms(kernel if who == "kernel"
                                            else chain))
            bound = bound_ms(shape, shortcut, pad, unpadded, up)
            k = statistics.mean(times["kernel"])
            rows.append({"shape": shape, "variant": name,
                         "plan": norm_op.launch_plan(h, w_),
                         "rel_err": err, "abs_err": max(
                             (g - r).abs().max().item() for g, r in pairs),
                         "bound_ms": bound,
                         "kernel_ms": k, "chain_ms":
                         statistics.mean(times["chain"]),
                         "library_ms": device_ms(library),
                         "roofline_pct": 100 * bound / k})
            print(json.dumps(rows[-1]), flush=True)
    return rows


def encode_ms(dev, profile: bool = False) -> dict:
    """The encode's replay in device ms, fused norms against the modules'
    chain, and the largest difference of their outputs over their scale."""
    from ..models.renderer import NeuralRayRenderer, float32_on, \
        init_parameters_
    float32_on(dev)
    gen = torch.Generator().manual_seed(1)
    imgs = torch.rand(6, 288, 512, 3, generator=gen).to(dev)
    out = {}
    models = {}
    for name, use in (("chain", False), ("fused", True)):
        nr = NeuralRayRenderer(use_kernels=use)
        init_parameters_(nr, torch.Generator().manual_seed(2))
        models[name] = nr.to(dev).eval()
    with torch.no_grad():
        feats = {k: m._encode_views(imgs) for k, m in models.items()}
        for a, b in zip(feats["fused"], feats["chain"]):
            err = (a - b).abs().max().item() / b.abs().max().item()
            out.setdefault("rel_err", []).append(err)
        for m in models.values():       # warm-up, capture
            for _ in range(2):
                m.encode_views(imgs)
        ms = {"chain": [], "fused": []}
        for name in ("chain", "fused", "fused", "chain"):
            m = models[name]
            for _ in range(10):
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                start.record()
                m.encode_views(imgs)
                end.record()
                torch.cuda.synchronize()
                ms[name].append(start.elapsed_time(end))
        out.update({k: statistics.median(v) for k, v in ms.items()})
        if profile:
            from torch.profiler import ProfilerActivity
            for name, m in models.items():
                with torch.profiler.profile(
                        activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(5):
                        m.encode_views(imgs)
                    torch.cuda.synchronize()
                print(f"--- {name}: device time of 5 replays by kernel")
                print(prof.key_averages().table(
                    sort_by="cuda_time_total", row_limit=30,
                    max_name_column_width=90))
    return out


def main() -> int:
    dev = torch.device("cuda", 0)
    print(smi("name,power.limit"))
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    time_variants(dev)
    print(json.dumps({"kernel": norm_op.kernel_info()}))
    print(json.dumps({"encode_ms": encode_ms(dev, "--profile" in sys.argv)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
