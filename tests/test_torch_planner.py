"""The whole slice on the CPU: the port's GraspNeRFPlanner(device="cpu").core
against the JAX GraspNeRFPlanner.core on the same weights and views
(6 x 64 x 96 views, a 16^3 volume).

Tolerances: float32 on both sides; the SDF passes ~40 layers (encoders, gather,
decoder, view fuse, attention), and the stated atol of 1e-4 is the port's
target for that chain. Candidates are compared as the sorted set of
(index, score) with score > 0, since top-k breaks ties in no fixed order.
"""
import numpy as np
import pytest
import torch

from graspnerf_tpu.detect.planner import GraspNeRFPlanner as JaxPlanner
from graspnerf_tpu_torch.convert import flax_to_state_dict
from graspnerf_tpu_torch.detect.planner import GraspNeRFPlanner

from ref_harness import rand_cameras
from test_torch_models import V, H, W, graspnerf_params
from _torch_util import one_thread  # noqa: F401  (autouse)

RES = 16
QUAL_THRESHOLD = 0.5
ATOL = 1e-4


def _scene(seed=0):
    rng = np.random.RandomState(seed)
    poses, Ks = rand_cameras(rng, V, H, W, radius=0.5, center=(0.0, 0.0, 0.05))
    imgs = rng.rand(V, H, W, 3).astype(np.float32)
    dr = np.tile(np.array([[0.2, 0.8]], np.float32), (V, 1))
    return imgs, poses, Ks, dr


def _cand_set(cand):
    """{voxel index: (score, rotation, width)} of the slots with score > 0."""
    scores = np.asarray(cand.scores)
    keep = scores > 0
    rows = zip(np.asarray(cand.indices)[keep].tolist(), scores[keep],
               np.asarray(cand.rotations)[keep], np.asarray(cand.widths)[keep])
    return {tuple(i): (s, r, w) for i, s, r, w in rows}


@pytest.fixture(scope="module")
def jax_core():
    """JAX's GraspNeRFPlanner.core on the seeded weights and _scene(): the
    volume, the candidates and the head outputs recomputed on its own
    volume (one JAX compile for the module)."""
    params = graspnerf_params()
    jp = JaxPlanner(params, renderer_cfg={"volume_resolution": RES},
                    qual_threshold=QUAL_THRESHOLD)
    vol_j, cand_j, _ = jp.core(*_scene())
    heads = jp.model.apply({"params": params}, vol_j[None, ..., None],
                           method=lambda m, v: m.vgn_net(v))
    return vol_j, cand_j, heads


def assert_core_matches_jax(state_dict, jax_core):
    """The port's planner on `state_dict` against JAX's, within ATOL."""
    vol_j, cand_j, heads_j = jax_core
    tp = GraspNeRFPlanner(state_dict, device="cpu",
                          renderer_cfg={"volume_resolution": RES},
                          qual_threshold=QUAL_THRESHOLD)
    vol_t, cand_t, _ = tp.core(*_scene())
    assert vol_t.shape == (RES,) * 3
    np.testing.assert_allclose(vol_t.numpy(), np.asarray(vol_j), atol=ATOL)
    with torch.no_grad():
        heads = tp.model.vgn_net(vol_t[None, ..., None])
    for got, want in zip(heads, heads_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)

    got, want = _cand_set(cand_t), _cand_set(cand_j)
    assert len(want) > 0, "scene must yield candidates"
    assert sorted(got) == sorted(want)
    for key, (score, rot, width) in want.items():
        np.testing.assert_allclose(got[key][0], score, atol=ATOL)
        np.testing.assert_allclose(got[key][1], rot, atol=ATOL)
        np.testing.assert_allclose(got[key][2], width, atol=ATOL)


def test_planner_core_matches_jax(jax_core):
    assert_core_matches_jax(flax_to_state_dict(graspnerf_params()), jax_core)


def test_planner_on_imported_checkpoint_matches_jax(jax_core, tmp_path):
    """The planner on a reference-format model_best.pth of the same weights
    imported by `python3 -m graspnerf_tpu_torch.convert` (its `main`) and
    read by `load_params`, against JAX's planner."""
    from graspnerf_tpu_torch.convert import main
    from graspnerf_tpu_torch.train.checkpoint import load_params
    from test_torch_convert import reference_state_dict
    pth, out = tmp_path / "model_best.pth", tmp_path / "port.pt"
    torch.save({"network_state_dict": reference_state_dict(
        graspnerf_params()), "step": 5, "optimizer_state_dict": {}}, pth)
    assert main([str(pth), str(out)]) == 0
    assert_core_matches_jax(load_params(str(out)), jax_core)


def test_planner_call_returns_grasps():
    """__call__: metric grasps from the candidates, shuffled with the seed."""
    tp = GraspNeRFPlanner(flax_to_state_dict(graspnerf_params()), device="cpu",
                          renderer_cfg={"volume_resolution": RES},
                          qual_threshold=QUAL_THRESHOLD)
    imgs, poses, Ks, _ = _scene()
    grasps, scores, toc = tp(imgs, poses, Ks)
    assert len(grasps) == len(scores) > 0 and toc > 0
    pose, width = grasps[0]
    m = pose.as_matrix()
    np.testing.assert_allclose(m[:3, :3] @ m[:3, :3].T, np.eye(3), atol=1e-6)
    assert width > 0
    # the port's Transform copy agrees with the JAX package's
    from graspnerf_tpu.sim.transform import Rotation as JaxRotation
    np.testing.assert_allclose(
        m[:3, :3], JaxRotation.from_quat(pose.rotation.as_quat()).as_matrix(),
        atol=1e-12)


def test_planner_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GraspNeRFPlanner(flax_to_state_dict(graspnerf_params()))
