"""Whether torch.profiler still sees every device event of a call, before
and after one step of the training loop's machinery, on the card.

Profiles one bare call of each instance of the gather's backward (B' and
B'-bf16 at P = 64,000: a memset and three kernels each) in `--sessions`
separate profiler sessions, runs the step that `--after` names, and
profiles them again; prints the device events each session saw. The steps,
at chip_smoke.py's loop shapes (288 x 512 views, 512 rays, 40^3, 32
grasps, 4 objects, 12 fusion views):

  none     nothing
  tracer   two generated scenes in this process (the native tracer's
           OpenMP threads here)
  loader   8 batches from SceneLoader with 4 forkserver workers
  pinned   the same, pin_memory=True
  trainer  Trainer.run for 4 steps on the pinned loader

Each run is one process, so that a step's effect stays its own. Run from
the repository root on a machine with a CUDA card:

    python3 -m graspnerf_tpu_torch.tools.profiler_events --after pinned
"""
from __future__ import annotations

import argparse
import json
import tempfile

import torch

from .. import build
from ..ops import epipolar_gather as eg

V, H, W, RES = 6, 288, 512, 40
P = RES ** 3


def backward_calls(dev):
    """{name: a bare call of that backward instance} on seeded inputs."""
    gen = torch.Generator().manual_seed(0)
    C = 32
    xy = torch.stack([torch.rand(V, P, generator=gen) * W,
                      torch.rand(V, P, generator=gen) * H], -1).to(dev)
    valid = (torch.rand(V, P, generator=gen) > 0.1).to(dev)
    d_rgb = torch.randn(V, P, 3 + C, generator=gen).to(dev)
    d_ray = torch.randn(V, P, C, generator=gen).to(dev)
    stand_in = torch.empty(V, H, W, 3, device=dev)
    calls = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        maps = [torch.empty(V, H // 4, W // 4, C, device=dev, dtype=dtype)
                for _ in range(2)]
        calls[name] = eg.backward_launcher(stand_in, *maps, xy, valid,
                                           d_rgb.to(dtype), d_ray, False)
    return calls


def events(fn):
    """Device event names of one call of fn in a session of its own."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name.split("(")[0] for e in prof.events()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]


def step(after, dev):
    if after == "none":
        return
    from ..data import DatasetFactory, SceneLoader, SyntheticSceneDataset
    factory = DatasetFactory(SyntheticSceneDataset, h=H, w=W, n_rays=512,
                             resolution=RES, n_grasps=32, n_objects=4,
                             fuse_views=12)
    if after == "tracer":
        ds = factory(1)
        for _ in range(2):
            ds.sample()
        return
    with SceneLoader(factory, 4, seed=0,
                     pin_memory=after != "loader") as loader:
        if after in ("loader", "pinned"):
            for _ in range(8):
                next(loader)
            return
        from ..models import GraspNeRF
        from ..train import Trainer
        with tempfile.TemporaryDirectory() as workdir:
            cfg = {"depth_sample_num": 40, "fine_depth_sample_num": 40,
                   "volume_resolution": RES, "depth_loss_coords_num": 8192}
            Trainer(GraspNeRF(cfg), loader, workdir=workdir, log_every=2,
                    val_interval=100, save_interval=100, seed=0,
                    tensorboard=False, device=dev).run(4)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--after", default="pinned",
                   choices=["none", "tracer", "loader", "pinned", "trainer"])
    p.add_argument("--sessions", type=int, default=6)
    args = p.parse_args()
    dev = torch.device("cuda", 0)
    build.build()
    calls = backward_calls(dev)
    seen = {}
    for when in ("before", "after"):
        if when == "after":
            step(args.after, dev)
            torch.cuda.synchronize()
        for name, fn in calls.items():
            seen[f"{when} {name}"] = [events(fn)
                                      for _ in range(args.sessions)]
    counts = {k: [len(s) for s in v] for k, v in seen.items()}
    print(json.dumps({"after": args.after,
                      "launches_per_call": eg.backward_cuda_launches(),
                      "events_per_session": counts,
                      "names": sorted({n for v in seen.values() for s in v
                                       for n in s})}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
