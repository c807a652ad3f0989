"""The port's mesh tools (graspnerf_tpu_torch/ops/mesh.py, a numpy copy of
graspnerf_tpu/ops/mesh.py) against the JAX package's, bit for bit: the
marching-tetrahedra surface of a sphere SDF and of a random volume, the
deduplicated mesh, `volume_to_mesh`, the PLY file's bytes and the gripper
wireframe."""
import numpy as np
import pytest
import torch

from graspnerf_tpu.ops import mesh as JM
from graspnerf_tpu_torch.ops import mesh as TM
from _torch_util import one_thread  # noqa: F401  (autouse)


def volumes():
    ax = (np.arange(20) + 0.5) / 20 - 0.5
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    sphere = (np.sqrt(x ** 2 + y ** 2 + z ** 2) - 0.3).astype(np.float32)
    noise = np.random.RandomState(0).uniform(-1, 1, (9, 11, 7)).astype(
        np.float32)
    return {"sphere": sphere, "random": noise,
            "empty": np.ones((4, 4, 4), np.float32)}


def assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", sorted(volumes()))
def test_marching_tetrahedra_matches_jax(name):
    vol = volumes()[name]
    kw = dict(level=0.1, spacing=0.01, origin=(0.1, -0.2, 0.3))
    got = TM.marching_tetrahedra(vol, **kw)
    assert_same(got, JM.marching_tetrahedra(vol, **kw))
    if name != "empty":
        assert len(got[1]) > 0
    assert_same(TM.dedupe_mesh(*got), JM.dedupe_mesh(*got))


@pytest.mark.parametrize("name", sorted(volumes()))
def test_volume_to_mesh_matches_jax(name):
    vol = volumes()[name]
    got = TM.volume_to_mesh(vol, origin=(-0.15, -0.15, -0.05))
    assert_same(got, JM.volume_to_mesh(vol, origin=(-0.15, -0.15, -0.05)))
    if name == "sphere":   # deduplicated: fewer vertices than 3 a face
        assert 0 < len(got[0]) < 3 * len(got[1])


@pytest.mark.parametrize("colors", (False, True))
def test_save_ply_bytes_match_jax(tmp_path, colors):
    verts, faces = TM.volume_to_mesh(volumes()["sphere"])
    c = (np.random.RandomState(1).rand(len(verts), 3) * 1.2 - 0.1
         if colors else None)
    TM.save_ply(str(tmp_path / "port.ply"), verts, faces, c)
    JM.save_ply(str(tmp_path / "jax.ply"), verts, faces, c)
    got = (tmp_path / "port.ply").read_bytes()
    assert got == (tmp_path / "jax.ply").read_bytes()
    assert got.startswith(b"ply\nformat ascii 1.0\n")


def test_gripper_lines_match_jax():
    rng = np.random.RandomState(2)
    q, _ = np.linalg.qr(rng.randn(3, 3))
    pose = np.eye(4)
    pose[:3, :3], pose[:3, 3] = q, rng.randn(3)
    got = TM.gripper_lines(pose, width=0.07, depth=0.04)
    assert got.shape == (4, 2, 3)
    assert_same([got], [JM.gripper_lines(pose, width=0.07, depth=0.04)])
