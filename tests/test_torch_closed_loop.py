"""The port's closed-loop clutter-removal evaluation against the JAX
package's on the CPU: whole campaigns (graspnerf_tpu_torch.sim.clutter_removal
.run against graspnerf_tpu.sim.clutter_removal.run) with the GraspNeRF
planner, a random and an oracle planner; the VGN baseline;
load_rendered_views; the entry points.

Both packages trace with one library (`same_tracer`: the JAX package's
native module is handed the port's build, or both trace with numpy), so
scenes and images are bit-equal and the campaigns see the same pixels.

Tolerances:
- the planner: its volume within PLANNER_ATOL (1e-4, float32 through ~40
  layers, tests/test_torch_planner.py), its candidate sets identical and
  their values within PLANNER_ATOL;
- grasps.csv: rows equal but for scene_id (a uuid4) and the timing columns
  (integration_time, planning_time); the pose columns (quaternion,
  translation, width, logged to 6 decimals) within POSE_ATOL = 1e-5, since
  the rotation and width heads differ from JAX's by float32 rounding, which
  can move the sixth decimal; score (4 decimals), label and round_id equal;
- rounds.csv equal; the metrics equal but for planning_time.
"""
import contextlib
import csv
import importlib.util
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import graspnerf_tpu.data.native as j_native
from graspnerf_tpu.detect.planner import GraspNeRFPlanner as JPlanner
from graspnerf_tpu.detect.planner import load_rendered_views as j_load_views
from graspnerf_tpu.detect.postprocess import (
    candidates_to_grasps as j_candidates_to_grasps)
from graspnerf_tpu.detect.vgn_baseline import VGNPlanner as JVGNPlanner
from graspnerf_tpu.sim import clutter_removal as JCR
from graspnerf_tpu.sim.render import DomainRandomizer as JDR
from graspnerf_tpu.sim.render import render_views_to_dir as j_render_dir
from graspnerf_tpu.sim.transform import Rotation as JRotation
from graspnerf_tpu.sim.transform import Transform as JTransform
from graspnerf_tpu.sim.world import AnalyticWorld as JAnalyticWorld
from graspnerf_tpu.sim.world import SimWorld as JSimWorld

import graspnerf_tpu_torch.data.native as t_native
from graspnerf_tpu_torch.convert import flax_to_state_dict
from graspnerf_tpu_torch.data.synthetic import (BBOX_MIN, hemisphere_poses,
                                                intrinsics)
from graspnerf_tpu_torch.detect.planner import GraspNeRFPlanner
from graspnerf_tpu_torch.detect.planner import load_rendered_views
from graspnerf_tpu_torch.detect.vgn_baseline import VOXEL_SIZE, VGNPlanner
from graspnerf_tpu_torch.sim import clutter_removal as TCR
from graspnerf_tpu_torch.sim import cli, stats
from graspnerf_tpu_torch.sim.render import DomainRandomizer
from graspnerf_tpu_torch.sim.render import render_views_to_dir
from graspnerf_tpu_torch.sim.simulation import ClutterRemovalSim
from graspnerf_tpu_torch.sim.transform import Rotation, Transform
from graspnerf_tpu_torch.sim.world import AnalyticWorld, SimWorld

from test_torch_models import graspnerf_params

REPO = Path(__file__).resolve().parents[1]
# scripts/sim_grasp.py --small: 96 x 128 views, a 16^3 volume, threshold 0.5
H, W, RES, QUAL_THRESHOLD = 96, 128, 16, 0.5
ROUNDS, OBJECTS, SEED = 2, 3, 0
PLANNER_ATOL = 1e-4
POSE_ATOL = 1e-5
POSE_COLUMNS = ("qx", "qy", "qz", "qw", "x", "y", "z", "width")
TIMING_COLUMNS = ("scene_id", "integration_time", "planning_time")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread (the parallel test workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def same_tracer(monkeypatch):
    """Both packages trace with the port's build of native/raytrace.cpp, or
    both with numpy where it cannot be built: native against native from
    two builds would test the compilers."""
    monkeypatch.setattr(j_native, "_lib", t_native._load())
    monkeypatch.setattr(j_native, "_tried", True)


def read_csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def assert_logs_match(got_dir, want_dir):
    """grasps.csv and rounds.csv of two campaigns, at the module's
    tolerances; returns the grasp rows."""
    assert (read_csv(os.path.join(got_dir, "rounds.csv"))
            == read_csv(os.path.join(want_dir, "rounds.csv")))
    got = read_csv(os.path.join(got_dir, "grasps.csv"))
    want = read_csv(os.path.join(want_dir, "grasps.csv"))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            if k in POSE_COLUMNS:
                assert abs(float(g[k]) - float(w[k])) <= POSE_ATOL, (k, g, w)
            elif k not in TIMING_COLUMNS:
                assert g[k] == w[k], (k, g, w)
    assert not os.path.exists(os.path.join(got_dir, "errors.log"))
    assert not os.path.exists(os.path.join(want_dir, "errors.log"))
    return want


def assert_metrics_match(got, want):
    assert set(got) == set(want)
    for k in want:
        if k != "planning_time":
            assert float(got[k]) == float(want[k]), k


def recorder(planner):
    """Wrap planner.core; returns the list of its outputs, call by call."""
    calls, core = [], planner.core

    def record(*args, **kw):
        out = core(*args, **kw)
        calls.append(out)
        return out
    planner.core = record
    return calls


def cand_set(cand):
    """{voxel index: (score, rotation, width)} of the slots with score > 0."""
    scores = np.asarray(cand.scores)
    keep = scores > 0
    rows = zip(np.asarray(cand.indices)[keep].tolist(), scores[keep],
               np.asarray(cand.rotations)[keep], np.asarray(cand.widths)[keep])
    return {tuple(i): (s, r, w) for i, s, r, w in rows}


def assert_candidates_match(got, want):
    got, want = cand_set(got), cand_set(want)
    assert sorted(got) == sorted(want)
    for key, (score, rot, width) in want.items():
        np.testing.assert_allclose(got[key][0], score, atol=PLANNER_ATOL)
        np.testing.assert_allclose(got[key][1], rot, atol=PLANNER_ATOL)
        np.testing.assert_allclose(got[key][2], width, atol=PLANNER_ATOL)
    return len(want)


def sim_worlds(seed=SEED, scene="pile"):
    """The JAX package's and the port's SimWorld on one seed."""
    return (JSimWorld(scene, rng=np.random.RandomState(seed)),
            SimWorld(scene, rng=np.random.RandomState(seed), device="cpu"))


def campaigns(tmp_path, j_planner, t_planner, j_world, t_world, **kw):
    """The same campaign in both packages: (port metrics, JAX metrics)."""
    args = dict(n_rounds=ROUNDS, n_objects=OBJECTS, h=H, w=W, seed=SEED)
    args.update(kw)
    want = JCR.run(j_planner, str(tmp_path / "jax"), world=j_world, **args)
    got = TCR.run(t_planner, str(tmp_path / "port"), world=t_world,
                  device="cpu", **args)
    return got, want


def test_campaign_graspnerf_planner_matches_jax(tmp_path, same_tracer):
    """SimWorld pile campaign with the GraspNeRF planner on the same
    (converted) weights: every planning call's volume and candidates, then
    the logs and the metrics."""
    params = graspnerf_params()
    cfg = {"volume_resolution": RES}
    jp = JPlanner(params, renderer_cfg=cfg, qual_threshold=QUAL_THRESHOLD)
    tp = GraspNeRFPlanner(flax_to_state_dict(params), device="cpu",
                          renderer_cfg=cfg, qual_threshold=QUAL_THRESHOLD)
    j_calls, t_calls = recorder(jp), recorder(tp)
    got, want = campaigns(tmp_path, jp, tp, *sim_worlds())
    assert len(t_calls) == len(j_calls) >= ROUNDS
    for (vol_t, cand_t, _), (vol_j, cand_j, _) in zip(t_calls, j_calls):
        np.testing.assert_allclose(vol_t.numpy(), np.asarray(vol_j),
                                   atol=PLANNER_ATOL)
        assert assert_candidates_match(cand_t, cand_j) > 0
    rows = assert_logs_match(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert len(rows) == len(t_calls)
    assert_metrics_match(got, want)
    assert got["n_rounds"] == ROUNDS and got["n_grasps"] == len(rows)


def oracle_planner(world, transform, rotation):
    """A planner that cheats (tests/test_clutter_removal.py): top-down
    candidates over each object, scored with the simulator's own collision
    and antipodal checks, so that grasps succeed and objects leave the
    scene. `transform` and `rotation` are the package's classes."""
    def planner(images, extrinsics, Ks, depth_range, round_idx, n_grasp):
        sim, best = world.sim, None
        g = sim.gripper
        for ob in sim.scene.objects:
            for dz in (-0.02, -0.01, 0.0, 0.01):
                for yaw in np.linspace(0, np.pi, 4, endpoint=False):
                    t = ob.t.copy()
                    t[2] = max(t[2] + dz, 0.012)
                    cy, sy = np.cos(yaw), np.sin(yaw)
                    R = np.array([[cy, -sy, 0.0], [sy, cy, 0.0],
                                  [0.0, 0.0, -1.0]])
                    R[:, 0] = np.cross(R[:, 1], R[:, 2])
                    pose = transform(rotation.from_matrix(R), t)
                    pre = transform(pose.rotation, t - 0.05 * R[:, 2])
                    if (sim._body_collides(pre, g.max_opening_width)
                            or sim._body_collides(pose, g.max_opening_width)):
                        continue
                    w_, _, cos_ok = sim._close_fingers(pose)
                    if (w_ is None or w_ < 0.1 * g.max_opening_width
                            or cos_ok < sim.friction_cos):
                        continue
                    if best is None or cos_ok > best[1]:
                        best = (pose, cos_ok)
        if best is None:
            return [], np.zeros(0), 0.0
        pose, score = best
        vol_pose = transform(pose.rotation,
                             np.asarray(pose.translation) - BBOX_MIN)
        return [(vol_pose, 0.08)], np.asarray([score]), 0.0
    return planner


def jax_script(name):
    """The module of scripts/<name>.py, the JAX package's entry scripts."""
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_random_planner(seed):
    """scripts/sim_grasp.py's random_planner_factory."""
    return jax_script("sim_grasp").random_planner_factory(seed)


@pytest.mark.parametrize("planner", ["random", "oracle"])
def test_campaign_host_planners_match_jax(tmp_path, same_tracer, planner):
    """The random planner of the entry scripts and the oracle: identical
    logs. The oracle's grasps succeed, so objects leave the scene, the
    survivors re-settle and keep their materials across re-renders."""
    j_world, t_world = sim_worlds(seed=3)
    if planner == "random":
        jp, tp = jax_random_planner(3), cli.random_planner_factory(3)
    else:
        jp = oracle_planner(j_world, JTransform, JRotation)
        tp = oracle_planner(t_world, Transform, Rotation)
    got, want = campaigns(tmp_path, jp, tp, j_world, t_world, seed=3)
    rows = assert_logs_match(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert_metrics_match(got, want)
    assert len(rows) > 0
    if planner == "oracle":
        assert got["success_rate"] > 0


def test_campaign_analytic_world_matches_jax(tmp_path):
    """AnalyticWorld (no acquire_tsdf of its own: the module's fusion on
    the given device) with the random planner."""
    got, want = campaigns(tmp_path, jax_random_planner(1),
                          cli.random_planner_factory(1),
                          JAnalyticWorld(np.random.RandomState(1)),
                          AnalyticWorld(np.random.RandomState(1)), seed=1)
    assert_logs_match(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert_metrics_match(got, want)


def test_acquire_tsdf_matches_jax(same_tracer):
    """clutter_removal.acquire_tsdf (the module's, for worlds without their
    own): within 1e-5 of JAX's, unobserved voxels -1 in both."""
    j_world, t_world = sim_worlds(seed=4)
    j_world.reset(3)
    t_world.reset(3)
    want, _ = JCR.acquire_tsdf(j_world, 6, 48, 64)
    got, t_int = TCR.acquire_tsdf(t_world, 6, 48, 64, device="cpu")
    assert got.dtype == np.float32 and got.shape == (40,) * 3 and t_int >= 0
    np.testing.assert_array_equal(got == -1.0, np.asarray(want) == -1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_vgn_planner_matches_jax(same_tracer):
    """The VGN baseline on the simulator's depth views: the fused TSDF
    within 1e-5, the candidates identical (values within PLANNER_ATOL),
    the shuffled grasps in the same order with poses within PLANNER_ATOL."""
    sim = ClutterRemovalSim("pile", rng=np.random.RandomState(2),
                            device="cpu")
    sim.reset(4)
    K = intrinsics(H, W)
    shift = np.eye(4, dtype=np.float32)
    shift[:3, 3] = BBOX_MIN
    depths, exts = [], []
    for pose in hemisphere_poses()[::4]:
        depths.append(sim.observe(pose, K, H, W)[1])
        ext = np.eye(4, dtype=np.float32)
        ext[:3] = pose
        exts.append(ext @ shift)
    args = (np.stack(depths), np.tile(K[None], (len(depths), 1, 1)),
            np.stack(exts))
    params = graspnerf_params()["vgn_net"]
    jv = JVGNPlanner(params, qual_threshold=QUAL_THRESHOLD)
    tv = VGNPlanner(flax_to_state_dict(params), qual_threshold=QUAL_THRESHOLD,
                    device="cpu")
    tsdf_j, cand_j = jv._core(jv.params, *args)
    tsdf_t, cand_t, _ = tv.core(*args)
    np.testing.assert_allclose(tsdf_t.numpy(), np.asarray(tsdf_j), atol=1e-5)
    assert assert_candidates_match(cand_t, cand_j) > 0
    # JAX's VGNPlanner.__call__ calls its jitted core without the params
    # (a TypeError; ROADMAP Queue 3), so its grasps are made here as that
    # call means to: candidates_to_grasps with the seed + round + grasp rng
    gj, sj = j_candidates_to_grasps(cand_j, VOXEL_SIZE,
                                    np.random.RandomState(jv.seed + 1 + 2))
    gt, st, _ = tv(*args, 1, 2)
    assert len(gt) == len(gj) > 0
    np.testing.assert_allclose(st, sj, atol=PLANNER_ATOL)
    for (pt, wt), (pj, wj) in zip(gt, gj):
        np.testing.assert_allclose(pt.as_matrix(), pj.as_matrix(),
                                   atol=PLANNER_ATOL)
        assert abs(wt - wj) <= PLANNER_ATOL


def test_load_rendered_views_matches_jax(tmp_path, same_tracer):
    """render_views_to_dir writes the reference's file contract as the JAX
    package does (PNGs decode equal, camera_pose.npy equal); both loaders
    read it back equal."""
    sims = [S("pile", rng=np.random.RandomState(5), **kw) for S, kw in (
        (JSimWorld, {}), (SimWorld, {"device": "cpu"}))]
    for s in sims:
        s.reset(3)
    dr_j = JDR(np.random.RandomState(5)).init_scene(sims[0].sim.scene)
    dr_t = DomainRandomizer(np.random.RandomState(5)).init_scene(
        sims[1].sim.scene)
    poses, K, ids = hemisphere_poses(), intrinsics(48, 64), [2, 6, 10]
    j_render_dir(sims[0].sim.scene, poses, K, 48, 64, str(tmp_path / "j"),
                 dr_j, frame_ids=ids)
    render_views_to_dir(sims[1].sim.scene, poses, K, 48, 64,
                        str(tmp_path / "t"), dr_t, frame_ids=ids)
    cam = "camera_pose.npy"
    np.testing.assert_array_equal(np.load(tmp_path / "t" / cam),
                                  np.load(tmp_path / "j" / cam))
    for wh, k in (((64, 48), K), ((128, 96), None)):
        got = load_rendered_views(str(tmp_path / "t"),
                                  str(tmp_path / "t" / cam), ids, wh=wh, K=k)
        want = j_load_views(str(tmp_path / "j"), str(tmp_path / "j" / cam),
                            ids, wh=wh, K=k)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(got[1], poses[ids], atol=1e-4)


def test_cli_small_campaign_on_the_cpu(tmp_path):
    """`python3 -m graspnerf_tpu_torch.sim.cli --small --rounds 1 --device
    cpu` in a subprocess: exit 0, the metrics JSON, the logs; then the
    stats of that log dir equal scripts/stat_expresult.py's."""
    logdir = tmp_path / "log"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [str(REPO), os.environ.get("PYTHONPATH")])),
        OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "graspnerf_tpu_torch.sim.cli", "--small",
         "--rounds", "1", "--objects", "2", "--device", "cpu",
         "--logdir", str(logdir)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    metrics = json.loads(proc.stdout)
    assert metrics["n_rounds"] == 1
    assert metrics == TCR.compute_metrics(str(logdir))
    assert not (logdir / "errors.log").exists()

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jax_script("stat_expresult").main([str(logdir), str(logdir)])
    assert stats.aggregate([str(logdir), str(logdir)]) == json.loads(
        out.getvalue())


def test_cli_exits_nonzero_on_a_round_error(tmp_path, monkeypatch, capsys):
    """A round that raises: the campaign goes on (errors.log), the entry
    point prints the metrics and returns 1."""
    def boom(*args, **kw):
        raise RuntimeError("planner failed")
    monkeypatch.setattr(cli, "random_planner_factory", lambda seed: boom)
    rc = cli.main(["--random-planner", "--rounds", "2", "--objects", "2",
                   "--device", "cpu", "--height", "32", "--width", "32",
                   "--logdir", str(tmp_path)])
    assert rc == 1
    assert json.loads(capsys.readouterr().out)["n_rounds"] == 2
    assert "planner failed" in (tmp_path / "errors.log").read_text()


ENTRY_POINTS = {
    "SimWorld": lambda tmp: SimWorld("pile"),
    "ClutterRemovalSim": lambda tmp: ClutterRemovalSim("pile"),
    "VGNPlanner": lambda tmp: VGNPlanner(
        flax_to_state_dict(graspnerf_params()["vgn_net"])),
    "acquire_tsdf": lambda tmp: TCR.acquire_tsdf(
        AnalyticWorld(np.random.RandomState(0)), 2, 32, 32),
    "run": lambda tmp: TCR.run(cli.random_planner_factory(0), str(tmp),
                               n_rounds=1, h=32, w=32),
    "run_analytic_world": lambda tmp: TCR.run(
        cli.random_planner_factory(0), str(tmp), n_rounds=1, h=32, w=32,
        world=AnalyticWorld(np.random.RandomState(0))),
    "cli": lambda tmp: cli.main(["--random-planner", "--rounds", "1",
                                 "--logdir", str(tmp)]),
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_point_without_a_card_raises(tmp_path, monkeypatch, entry):
    """Without a card and without device="cpu" every entry point raises
    before it runs anything; none falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[entry](tmp_path)
    assert not (tmp_path / "grasps.csv").exists()
