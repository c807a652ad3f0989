"""The port's training loop on the CPU: the scene-batched loss, `Trainer`
(learning, the metric log, validation, checkpoints, resume), the checkpoint
manager's latest/best links and crash safety, the entry script, the Orbax
bridge (scripts/export_torch_checkpoint.py), and the validation metrics,
config and profiling helpers against the JAX package.

Size: the small config of the port's CPU checks (64 x 96 views, 24 rays,
16 + 16 samples, an 8^3 volume, 256 depth-loss pixels, 5 grasps; ~0.3 s a
step), on scenes from the port's synthetic generator.
"""
import importlib.util
import itertools
import json
import math
import os
import pathlib
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from graspnerf_tpu.config import trainer_cfg_from as j_trainer_cfg_from
from graspnerf_tpu.train import metrics as JM
from graspnerf_tpu.train import profiling as JP

from graspnerf_tpu_torch import train as TT
from graspnerf_tpu_torch.config import load_cfg, trainer_cfg_from
from graspnerf_tpu_torch.convert import flax_to_state_dict
from graspnerf_tpu_torch.data import (SyntheticSceneDataset, collate_scenes,
                                      to_device)
from graspnerf_tpu_torch.detect.planner import GraspNeRFPlanner
from graspnerf_tpu_torch.models import GraspNeRF, init_parameters_
from graspnerf_tpu_torch.train import checkpoint as TCK
from graspnerf_tpu_torch.train import cli
from graspnerf_tpu_torch.train import metrics as TM
from graspnerf_tpu_torch.train import profiling as TP
from graspnerf_tpu_torch.train.trainer import scene

from test_torch_models import graspnerf_params
from _torch_util import one_thread  # noqa: F401  (autouse)

REPO = pathlib.Path(__file__).resolve().parents[1]
CFG = dict(cli.SMALL_RENDERER)
SHAPE = dict(cli.SMALL_SHAPE, resolution=CFG["volume_resolution"],
             fuse_views=6)
LOG_KEYS = {"step", "sec_per_step", "scenes_per_s", "rays_per_s",
            "tsdf_queries_per_s", "data_wait_per_step", "total",
            "nonfinite_grad"}


@pytest.fixture(scope="module")
def scenes():
    """Six single-scene samples of the port's generator (numpy)."""
    ds = SyntheticSceneDataset(seed=0, **SHAPE)
    return [ds.sample() for _ in range(6)]


def make_model(seed=0):
    return init_parameters_(GraspNeRF(CFG), torch.Generator().manual_seed(seed))


class Batches:
    """A train iterator over given scene batches, with the loader's
    pop_data_wait."""

    def __init__(self, batches):
        self.it = iter(batches)

    def __iter__(self):
        return self

    def __next__(self):
        return next(self.it)

    def pop_data_wait(self):
        return 0.0


def trainer(model, batches, workdir, **kw):
    kw = dict(dict(tensorboard=False, device="cpu", log_every=1,
                   val_interval=10 ** 6, save_interval=10 ** 6), **kw)
    return TT.Trainer(model, Batches(batches), workdir=str(workdir), **kw)


def records(workdir):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_batched_loss_is_mean_of_scenes(scenes):
    """S = 2: every loss is the mean of the two single-scene losses, each
    scene drawing from its own generator, and so is every parameter's
    gradient; scene 0's draws are those of a one-scene batch."""
    model = TT.create_train_state(make_model(), device="cpu").model
    params = list(model.parameters())
    batch = to_device(collate_scenes(scenes[:2]), "cpu")
    total, ld = TT.make_batched_loss_fn(model)(
        batch, TT.scene_generators(3, 5, range(2), "cpu"))
    grads = torch.autograd.grad(total, params, allow_unused=True)
    seeds = [TT.trainer.step_seed(3, 5, i) for i in range(2)]
    assert seeds[0] == TT.trainer.step_seed(3, 5) != seeds[1]
    single = [TT.make_loss_fn(model)(scene(batch, i),
                                     torch.Generator().manual_seed(seeds[i]))
              for i in range(2)]
    for k in ld:
        want = torch.stack([s[1][k] for s in single]).mean()
        assert torch.equal(ld[k], want), k
    want_grads = torch.autograd.grad(
        single[0][0] + single[1][0], params, allow_unused=True)
    compared = 0
    for p, g, w in zip(params, grads, want_grads):
        if w is None:
            assert g is None
            continue
        torch.testing.assert_close(g, w / 2, rtol=1e-5,
                                   atol=1e-6 * float(w.abs().max()) + 1e-12)
        compared += 1
    assert compared > 0.9 * len(params)


def test_trainer_learns_and_logs(scenes, tmp_path):
    """Six steps on one generated scene lower the total loss; the log
    holds the run-config line, a record per step, and validation; the
    validation image is dumped."""
    batch = collate_scenes(scenes[:1])
    t = trainer(make_model(), itertools.repeat(batch), tmp_path,
                val_batches=[scenes[1]], val_interval=3,
                val_image_dir=str(tmp_path / "vis"))
    state = t.run(6)
    assert state.step == 6
    recs = records(tmp_path)
    cfg = recs[0]
    assert cfg["run_config"] and cfg["start_step"] == 0
    assert cfg["torch"] == torch.__version__ and cfg["device"] == "cpu"
    assert (cfg["n_scenes"], cfg["n_rays"], cfg["volume_res"]) == (1, 24, 8)
    steps = [r for r in recs if "sec_per_step" in r]
    assert [r["step"] for r in steps] == list(range(1, 7))
    for r in steps:
        assert LOG_KEYS <= set(r) and r["nonfinite_grad"] == 0.0
        assert all(math.isfinite(v) for v in r.values())
    totals = [r["total"] for r in steps]
    assert totals[-1] < totals[0], totals
    val = [r for r in recs if r.get("val")]
    assert [r["step"] for r in val] == [3, 6]
    assert "loss_vgn" in val[0] and "psnr_nr" in val[0]
    assert sorted(os.listdir(tmp_path / "vis")) == ["3-val.png", "6-val.png"]
    assert os.path.realpath(tmp_path / "ckpt" / "latest").endswith("step_6.pt")


def adam_state(state):
    return [(s["exp_avg"], s["exp_avg_sq"], s["step"])
            for s in (state.optimizer.state[p]
                      for p in state.model.parameters())]


def test_checkpoint_round_trip_and_resume(scenes, tmp_path):
    """Save at step 2, restore into a fresh Trainer (another init):
    parameters, Adam's moments and count, and best bit-equal; resuming to
    step 4 gives the parameters of an uninterrupted 4-step run on the same
    batches."""
    batches = [collate_scenes([s]) for s in scenes[:5]]
    kw = dict(val_batches=[scenes[5]], val_interval=2, save_interval=2)
    first = trainer(make_model(), batches, tmp_path / "a", **kw)
    saved = first.run(2)
    val = [r for r in records(tmp_path / "a") if r.get("val")]
    fresh = trainer(make_model(seed=1), batches[2:], tmp_path / "a", **kw)
    state, start, best = fresh.restore()
    assert start == 2 and best == val[-1]["loss_vgn"]
    assert state.step == saved.step == 2
    for a, b in zip(saved.model.state_dict().values(),
                    state.model.state_dict().values()):
        assert torch.equal(a, b)
    for a, b in zip(adam_state(saved), adam_state(state)):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    resumed = fresh.run(4)
    assert records(tmp_path / "a")[-4]["start_step"] == 2   # run-config line
    straight = trainer(make_model(), batches, tmp_path / "b", **kw).run(4)
    for (name, a), b in zip(straight.model.state_dict().items(),
                            resumed.model.state_dict().values()):
        assert torch.equal(a, b), name
    assert resumed.step == straight.step == 4


def tiny_payload(value):
    return {"model": {"w": torch.full((3,), float(value))}, "optimizer": {}}


def link(directory, tag):
    return os.path.basename(os.path.realpath(os.path.join(directory, tag)))


def test_checkpoint_latest_best(tmp_path):
    """latest and best point where the JAX manager's would
    (tests/test_training.py:85-103): a worse metric keeps best, a better
    one moves it; only the linked step files remain."""
    cm = TCK.CheckpointManager(str(tmp_path))
    best = cm.save(tiny_payload(1), step=1, key_metric=0.5)
    assert best == 0.5 and link(tmp_path, "latest") == link(
        tmp_path, "best") == "step_1.pt"
    best = cm.save(tiny_payload(2), step=2, key_metric=0.7, best=best)
    assert best == 0.5
    assert (link(tmp_path, "latest"), link(tmp_path, "best")) == (
        "step_2.pt", "step_1.pt")
    best = cm.save(tiny_payload(3), step=3, best=best)   # no metric
    assert best == 0.5 and link(tmp_path, "best") == "step_1.pt"
    assert sorted(os.listdir(tmp_path)) == ["best", "latest", "step_1.pt",
                                            "step_3.pt"]
    best = cm.save(tiny_payload(4), step=4, key_metric=0.3, best=best)
    assert best == 0.3
    out = cm.restore()
    assert (out["step"], out["best"]) == (4, 0.3)
    assert torch.equal(out["model"]["w"], torch.full((3,), 4.0))
    assert cm.restore(tag="best")["step"] == 4
    assert sorted(os.listdir(tmp_path)) == ["best", "latest", "step_4.pt"]
    assert os.path.islink(tmp_path / "latest")
    assert TCK.CheckpointManager(str(tmp_path / "empty")).restore() is None


def test_checkpoint_crash_safe(tmp_path, monkeypatch):
    """An exception from inside torch.save (after writing part of the file)
    leaves the previous latest loadable and no partial file behind; a
    stale partial file from a killed run is removed by the next save."""
    cm = TCK.CheckpointManager(str(tmp_path))
    best = cm.save(tiny_payload(1), step=1, key_metric=0.5)
    real_save = torch.save

    def crash(obj, f, *a, **kw):
        with open(f, "wb") as fh:
            fh.write(b"partial")
        raise OSError("disk full")
    monkeypatch.setattr(TCK.torch, "save", crash)
    with pytest.raises(OSError):
        cm.save(tiny_payload(2), step=2, key_metric=0.1, best=best)
    monkeypatch.setattr(TCK.torch, "save", real_save)
    assert sorted(os.listdir(tmp_path)) == ["best", "latest", "step_1.pt"]
    assert cm.restore()["step"] == 1
    assert torch.equal(TCK.load_params(str(tmp_path / "latest"))["w"],
                       torch.full((3,), 1.0))
    (tmp_path / "step_2.pt.tmp").write_bytes(b"killed mid-write")
    assert cm.restore()["step"] == 1
    cm.save(tiny_payload(3), step=3, key_metric=0.4, best=best)
    assert sorted(os.listdir(tmp_path)) == ["best", "latest", "step_3.pt"]


def test_planner_loads_trainer_checkpoint(scenes, tmp_path):
    """load_params reads a step file or a link; the planner takes it."""
    t = trainer(make_model(), itertools.repeat(collate_scenes(scenes[:1])),
                tmp_path, save_interval=1)
    state = t.run(1)
    for name in ("latest", "best", "step_1.pt"):
        if name == "best":   # saved without a key metric: no best link
            assert not os.path.lexists(tmp_path / "ckpt" / name)
            continue
        sd = TT.load_params(str(tmp_path / "ckpt" / name))
        for a, b in zip(sd.values(), state.model.state_dict().values()):
            assert torch.equal(a, b)
    planner = GraspNeRFPlanner(sd, device="cpu", renderer_cfg=CFG)
    assert planner.model.nr_net.volume_resolution == 8


def test_entry_script_runs(tmp_path):
    """python -m graspnerf_tpu_torch.train.cli --device cpu --small
    --steps 2 --workers 0 exits 0 and logs both steps."""
    path = os.pathsep.join(filter(None, [str(REPO),
                                         os.environ.get("PYTHONPATH")]))
    out = subprocess.run(
        [sys.executable, "-m", "graspnerf_tpu_torch.train.cli", "--device",
         "cpu", "--small", "--steps", "2", "--workers", "0", "--workdir",
         str(tmp_path), "--log-every", "1", "--no-tensorboard"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=path, OMP_NUM_THREADS="1"),
        capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    recs = records(tmp_path)
    assert recs[0]["run_config"] and recs[0]["img_hw"] == [64, 96]
    assert [r["step"] for r in recs[1:]] == [1, 2]


def test_entry_script_refuses_bfloat16(capsys, tmp_path):
    """The entry script refuses a compute dtype it cannot train before it
    touches a device: float16 from the YAML. (It refused bfloat16 until the
    bfloat16 train step was ported; tests/test_torch_train_bf16.py trains
    with --compute-dtype bfloat16.)"""
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("compute_dtype: float16\n")
    with pytest.raises(SystemExit) as e:
        cli.main(["--device", "cpu", "--cfg", str(cfg)])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "'float16'" in err and "float32 or bfloat16" in err


def test_entry_script_trains_bfloat16(tmp_path):
    """Two steps of `train/cli.py --compute-dtype bfloat16 --small` on the
    CPU, in this process, with a validation (the bfloat16 eval step): every
    logged loss finite, no update skipped, a checkpoint of float32
    parameters."""
    assert cli.main(["--device", "cpu", "--small", "--steps", "2",
                     "--workers", "0", "--workdir", str(tmp_path),
                     "--log-every", "1", "--save-interval", "2",
                     "--val-interval", "2",
                     "--no-tensorboard", "--compute-dtype", "bfloat16"]) == 0
    recs = records(tmp_path)
    assert recs[0]["run_config"]
    assert recs[0]["compute_dtype"] == "bfloat16"
    assert recs[0]["mesh"] is None and recs[0]["n_devices"] == 1
    steps = [r for r in recs if "sec_per_step" in r]
    assert [r["step"] for r in steps] == [1, 2]
    for r in steps:
        assert r["nonfinite_grad"] == 0.0 and np.isfinite(r["loss_vgn"])
    vals = [r for r in recs if r.get("val")]
    assert len(vals) == 1 and np.isfinite(vals[0]["loss_vgn"])
    params = TT.load_params(str(tmp_path / "ckpt" / "latest"))
    assert all(t.dtype == torch.float32 for t in params.values())


def export_script():
    spec = importlib.util.spec_from_file_location(
        "export_torch_checkpoint", REPO / "scripts" / "export_torch_checkpoint.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_orbax_bridge_on_repo_checkpoint(tmp_path):
    """data/train_r4_proof/ckpt/step_50 exported and loaded: the keys and
    shapes of a port GraspNeRF's state_dict(), and a strict load. Values are
    not compared: that run was NaN by step 50."""
    mod = export_script()
    params, step, best = mod.read_orbax(
        str(REPO / "data" / "train_r4_proof" / "ckpt" / "step_50"))
    out = tmp_path / "step_50.pt"
    mod.write_torch(params, str(out), step, best)
    sd = TT.load_params(str(out))
    model = GraspNeRF()
    want = model.state_dict()
    assert sorted(sd) == sorted(want)
    for k in want:
        assert sd[k].shape == want[k].shape and sd[k].dtype == torch.float32, k
    model.load_state_dict(sd, strict=True)
    payload = torch.load(str(out), weights_only=True)
    assert sorted(payload) == ["best", "model", "step"]
    assert payload["step"] == 50


def test_orbax_bridge_seeded_tree(tmp_path):
    """A seeded flax tree written by the bridge and read back is
    flax_to_state_dict of it, bit for bit, in the shapes of a port
    GraspNeRF's state dict (the NeuS variances 0-d)."""
    params = graspnerf_params()
    out = tmp_path / "seeded.pt"
    export_script().write_torch(params, str(out), 7, 0.25)
    sd = TT.load_params(str(out))
    want = flax_to_state_dict(params)
    shapes = {k: v.shape for k, v in GraspNeRF().state_dict().items()}
    assert sorted(sd) == sorted(want) == sorted(shapes)
    for k in want:
        assert torch.equal(sd[k], want[k]) and sd[k].shape == shapes[k], k


@pytest.mark.parametrize("cfg", ["configs/nrvgn_sdf.yaml", None])
def test_trainer_cfg_matches_jax(cfg):
    y = load_cfg(str(REPO / cfg)) if cfg else {}
    assert trainer_cfg_from(y) == j_trainer_cfg_from(y)


def test_metrics_match_jax():
    rng = np.random.RandomState(0)
    pred = rng.rand(20, 24, 3).astype(np.float32)
    gt = np.clip(pred + 0.1 * rng.randn(20, 24, 3), 0, 1).astype(np.float32)
    mask = rng.rand(20, 24, 3) > 0.5
    t, j = torch.from_numpy, jnp.asarray
    for got, want in (
            (TM.psnr(t(pred), t(gt)), JM.psnr(j(pred), j(gt))),
            (TM.ssim(t(pred), t(gt)), JM.ssim(j(pred), j(gt))),
            (TM.depth_mae(t(pred), t(gt)), JM.depth_mae(j(pred), j(gt))),
            (TM.depth_mae(t(pred), t(gt), t(mask)),
             JM.depth_mae(j(pred), j(gt), j(mask)))):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_profiling_helpers(tmp_path):
    """rays_per_step against JAX's; `train.trace` writes a Chrome trace that
    holds the program's spans (the views' encoding here)."""
    assert TP.rays_per_step(512) == JP.rays_per_step(512) == 512 * 80
    assert TP.rays_per_step(512, hierarchical=False) == 512 * 40
    model = GraspNeRF(CFG)
    with TT.trace(str(tmp_path)), torch.no_grad():
        model.nr_net.encode_views(torch.rand(2, 32, 32, 3))
    with open(tmp_path / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"graspnerf.encode", "graspnerf.encode.image"} <= names
