"""The port's data pipeline against the JAX package on the CPU: the TSDF
fusion, the synthetic scene generator, the native tracer, the
augmentations, view selection, EXR I/O, the vgn_syn file dataset and the
loader.

Both generators trace with their numpy tracer here (each package's
`native.available` patched to False): the native tracer agrees with numpy
on only > 99.9 % of the rays (tests/test_native.py), so native against
native from two builds would test the compilers, not the port. On the same
tracer every generated array is bit-equal to JAX's except `sdf_gt`, which
the port fuses with torch instead of XLA: held to SDF_ATOL (float32
rounding of the projection and the average), with the support of its
weights exact.
"""
import csv
import os

import numpy as np
import jax
import pytest
import torch

import graspnerf_tpu.data.native as j_native
from graspnerf_tpu.data import augment as JA
from graspnerf_tpu.data import exr as JE
from graspnerf_tpu.data import view_select as JV
from graspnerf_tpu.data.dataset import VGNSynDataset as JVGNSynDataset
from graspnerf_tpu.data.prefetch import collate_scenes as j_collate
from graspnerf_tpu.data.synthetic import Scene as JScene
from graspnerf_tpu.data.synthetic import SyntheticSceneDataset as JSynthetic
from graspnerf_tpu.ops.tsdf import integrate_tsdf as j_integrate

import graspnerf_tpu_torch.data.native as t_native
from graspnerf_tpu_torch.data import augment as TA
from graspnerf_tpu_torch.data import exr as TE
from graspnerf_tpu_torch.data import view_select as TV
from graspnerf_tpu_torch.data import (DatasetFactory, SceneLoader,
                                      SyntheticSceneDataset, VGNSynDataset,
                                      collate_scenes, hemisphere_poses,
                                      intrinsics, to_device)
from graspnerf_tpu_torch.build import BUILD_DIR
from graspnerf_tpu_torch.data.synthetic import Scene
from graspnerf_tpu_torch.ops.tsdf import integrate_tsdf

SDF_ATOL = 1e-5
# the parity scenes: small views, few rays, a 16^3 volume, 6 fusion views
SMALL = dict(h=48, w=64, n_rays=32, resolution=16, fuse_views=6)


def flat(tree, prefix=""):
    """{"a/b": leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def assert_trees_equal(got, want):
    got, want = flat(got), flat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture
def numpy_tracers(monkeypatch):
    monkeypatch.setattr(j_native, "available", lambda: False)
    monkeypatch.setattr(t_native, "available", lambda: False)


def fusion_inputs(seed, n=5, h=48, w=64):
    rng = np.random.RandomState(seed)
    depth = rng.uniform(0.2, 0.8, (n, h, w)).astype(np.float32)
    depth[rng.rand(n, h, w) < 0.1] = 0.0           # no return
    Ks = np.tile(intrinsics(h, w)[None], (n, 1, 1))
    ids = rng.choice(24, n, replace=False)
    ext = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    ext[:, :3] = hemisphere_poses()[ids]
    shift = np.eye(4, dtype=np.float32)
    shift[:3, 3] = [-0.15, -0.15, -0.05]
    return depth, Ks, ext @ shift


@pytest.mark.parametrize("seed,res", [(0, 8), (1, 16), (2, 40)])
def test_integrate_tsdf_matches_jax(seed, res):
    args = fusion_inputs(seed)
    tsdf_j, w_j = (np.asarray(a) for a in j_integrate(*args, 0.3, res))
    tsdf_t, w_t = integrate_tsdf(*args, 0.3, res, device="cpu")
    assert tsdf_t.shape == w_t.shape == (res,) * 3
    np.testing.assert_array_equal(w_t.numpy(), w_j)
    assert (w_j > 0).any() and (w_j == 0).any()
    np.testing.assert_allclose(tsdf_t.numpy(), tsdf_j, rtol=0, atol=SDF_ATOL)


def test_integrate_tsdf_runs_on_the_card_by_default(monkeypatch):
    """No device means the card: without one the fusion raises instead of
    running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        integrate_tsdf(*fusion_inputs(0), 0.3, 8)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_synthetic_matches_jax(seed, numpy_tracers):
    """Two samples per seed: images, depths, poses, rays, grasp voxels,
    labels, rotations and widths bit-equal; sdf_gt within SDF_ATOL with the
    same observed voxels (-1 marks the unobserved ones)."""
    ours = SyntheticSceneDataset(seed=seed, **SMALL)
    ref = JSynthetic(seed=seed, **SMALL)
    for _ in range(2):
        got, want = ours.sample(), ref.sample()
        sdf, sdf_j = got.pop("sdf_gt"), want.pop("sdf_gt")
        assert_trees_equal(got, want)
        np.testing.assert_array_equal(sdf == -1.0, sdf_j == -1.0)
        np.testing.assert_allclose(sdf, sdf_j, rtol=0, atol=SDF_ATOL)
        assert sdf.dtype == np.float32 and (sdf != -1.0).any()


def test_native_tracer_matches_numpy(rng):
    """The port's build of the tracer against its numpy version, at the
    thresholds of tests/test_native.py."""
    if not t_native.available():
        pytest.skip("no C++ compiler: the port traces with numpy")
    # built into the port's build directory, never the committed library
    assert os.path.dirname(t_native.build()) == BUILD_DIR
    scene = Scene(rng, 5)
    h, w = 96, 128
    K = intrinsics(h, w)
    pose = hemisphere_poses()[3]
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    pix = np.stack([xs, ys, np.ones_like(xs)], -1).reshape(-1, 3)
    R, t = pose[:3, :3], pose[:3, 3]
    dirs = (pix @ np.linalg.inv(K).T) @ R
    dirs = (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).astype(
        np.float32)
    origins = np.broadcast_to(-R.T @ t, dirs.shape).astype(np.float32).copy()
    t_np, n_np, id_np = scene._trace_numpy(origins, dirs)
    t_cc, n_cc, id_cc = scene.trace(origins, dirs)
    agree = id_np == id_cc
    assert agree.mean() > 0.999, agree.mean()
    hit = np.isfinite(t_np) & np.isfinite(t_cc) & agree
    np.testing.assert_allclose(t_cc[hit], t_np[hit], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(n_cc[hit], n_np[hit], rtol=1e-2, atol=1e-3)
    t_native.set_num_threads(2)
    assert t_native.num_threads() == 2
    again = scene.trace(origins, dirs)
    for a, b in zip(again, (t_cc, n_cc, id_cc)):
        np.testing.assert_array_equal(a, b)


def test_scene_trace_matches_jax():
    """The numpy tracer of both packages on the same scene."""
    rng_t, rng_j = np.random.RandomState(3), np.random.RandomState(3)
    ours, ref = Scene(rng_t, 6), JScene(rng_j, 6)
    dirs = rng_t.randn(4000, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    origins = np.tile(np.array([0.0, 0.0, 0.5], np.float32), (4000, 1))
    for a, b in zip(ours._trace_numpy(origins, dirs),
                    ref._trace_numpy(origins, dirs)):
        np.testing.assert_array_equal(a, b)


def as_tree(x):
    """A function's result as a dict of arrays."""
    if isinstance(x, dict):
        return x
    if isinstance(x, tuple):
        return {str(i): np.asarray(v) for i, v in enumerate(x)}
    return {"out": np.asarray(x)}


def _imgs_info(rng):
    return {"imgs": rng.rand(3, 20, 28, 3).astype(np.float32),
            "true_depth": rng.rand(3, 20, 28, 1).astype(np.float32),
            "masks": rng.rand(3, 20, 28) > 0.5,
            "Ks": np.tile(intrinsics(20, 28)[None], (3, 1, 1))}


AUGMENT_CASES = {
    "get_ref_que_ids": lambda m, rng: m.get_ref_que_ids(rng, 24, 6),
    "random_change_depth_range": lambda m, rng: m.random_change_depth_range(
        rng.uniform(0.2, 0.8, (7, 2)), rng, prob=0.7),
    "consistent_depth_range": lambda m, rng: m.consistent_depth_range(
        rng.uniform(0.1, 0.5, (6, 2)) + [0, 0.4], rng.uniform(
            0.1, 0.5, (1, 2)) + [0, 0.6]),
    "consistent_depth_range_min_max": lambda m, rng: m.consistent_depth_range(
        rng.uniform(0.1, 0.9, (6, 2)), rng.uniform(0.1, 0.9, (1, 2)), True),
    "add_depth_offset": lambda m, rng: _offset(m, rng),
    "random_crop": lambda m, rng: m.random_crop(_imgs_info(rng), (12, 16),
                                                rng),
    "random_flip": lambda m, rng: m.random_flip(_imgs_info(rng)),
    "pad_imgs_to_interval": lambda m, rng: m.pad_imgs_to_interval(
        _imgs_info(rng), 8),
}


def _offset(m, rng):
    depth = rng.uniform(0.3, 0.7, (20, 28)).astype(np.float32)
    mask = rng.rand(20, 28) > 0.4
    m.add_depth_offset(depth, mask, 0.1, 0.2, 0.01, 0.05, 0.005, 0.6, rng)
    return depth


@pytest.mark.parametrize("case", sorted(AUGMENT_CASES))
def test_augment_matches_jax(case):
    """Same RandomState, same draws, same arrays."""
    for seed in range(3):
        got = AUGMENT_CASES[case](TA, np.random.RandomState(seed))
        want = AUGMENT_CASES[case](JA, np.random.RandomState(seed))
        assert_trees_equal(as_tree(got), as_tree(want))


def test_view_select_matches_jax():
    rng = np.random.RandomState(0)
    ref_poses = hemisphere_poses()[rng.choice(24, 10, replace=False)]
    que_poses = hemisphere_poses()[rng.choice(24, 3, replace=False)]
    np.testing.assert_array_equal(TV.camera_centers(ref_poses),
                                  JV.camera_centers(ref_poses))
    np.testing.assert_array_equal(
        TV.compute_nearest_camera_indices(ref_poses),
        JV.compute_nearest_camera_indices(ref_poses))
    for exclude in (False, True):
        np.testing.assert_array_equal(
            TV.select_working_views(ref_poses, que_poses, 4, exclude),
            JV.select_working_views(ref_poses, que_poses, 4, exclude))


@pytest.mark.parametrize("channels,half", [(1, False), (3, False), (3, True),
                                           (5, True)])
def test_exr_round_trip(tmp_path, channels, half):
    """The port's writer read back by both readers, and JAX's writer read
    by the port's."""
    rng = np.random.RandomState(channels)
    arr = rng.uniform(-2, 2, (13, 17, channels)).astype(np.float32)
    if channels == 1:
        arr = arr[..., 0]
    want = arr.astype(np.float16).astype(np.float32) if half else arr
    TE.write_exr(str(tmp_path / "t.exr"), arr, half=half)
    JE.write_exr(str(tmp_path / "j.exr"), arr, half=half)
    assert (tmp_path / "t.exr").read_bytes() == (tmp_path / "j.exr").read_bytes()
    np.testing.assert_array_equal(TE.read_exr(str(tmp_path / "t.exr")), want)
    np.testing.assert_array_equal(JE.read_exr(str(tmp_path / "t.exr")), want)
    np.testing.assert_array_equal(TE.read_exr(str(tmp_path / "j.exr")), want)


def test_exr_zip_predictor_matches_jax():
    buf = np.random.RandomState(0).randint(0, 256, 1001).astype(np.uint8)
    assert TE._zip_reconstruct(buf.tobytes()) == JE._zip_reconstruct(
        buf.tobytes())


def write_vgn_syn(root):
    """A tiny vgn_syn tree: two train scenes (pile, packed) of 24 views with
    PNG images, EXR depth (port's writer), .npy masks, camera poses, an SDF
    grid and grasp CSVs in the reference schema (voxel indices) and the
    legacy one (metres)."""
    from PIL import Image
    rng = np.random.RandomState(0)
    blender = np.diag([1.0, -1.0, -1.0, 1.0])
    for n, kind in enumerate(("pile", "packed")):
        sid = f"scene_{n:04d}"
        d = root / "scenes" / kind / "train" / sid
        for sub in ("rgb", "depth", "mask"):
            (d / sub).mkdir(parents=True)
        cams = []
        for i, pose in enumerate(hemisphere_poses()):
            w2c = np.eye(4)
            w2c[:3] = pose
            cams.append(np.linalg.inv(w2c) @ blender)   # cam->world, Blender
            img = rng.randint(0, 256, (36, 64, 3)).astype(np.uint8)
            Image.fromarray(img).save(d / "rgb" / f"{i:04d}.png")
            depth = rng.uniform(0.2, 0.8, (288, 512)).astype(np.float32)
            TE.write_exr(str(d / "depth" / f"{i:04d}.exr"), depth)
            np.save(d / "mask" / f"{i:04d}.npy",
                    (rng.rand(288, 512) > 0.7).astype(np.float32))
        np.save(d / "camera_pose.npy", np.stack(cams).astype(np.float32))
        (root / "sdf").mkdir(exist_ok=True)
        np.savez(root / "sdf" / f"{sid}.npz",
                 grid=rng.rand(1, 40, 40, 40).astype(np.float32))
        (root / "grasps").mkdir(exist_ok=True)
        q = rng.randn(20, 4)
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
        with open(root / "grasps" / f"{sid}.csv", "w", newline="") as f:
            if n == 0:
                cols = ["i", "j", "k"]
                pos = rng.uniform(0, 39, (20, 3))
                width = rng.uniform(1, 9, 20)
            else:
                cols = ["x", "y", "z"]
                pos = rng.uniform(0, 0.3, (20, 3))
                width = rng.uniform(0.01, 0.07, 20)
            out = csv.writer(f)
            out.writerow(cols + ["qx", "qy", "qz", "qw", "width", "label"])
            for p, qq, wd in zip(pos, q, width):
                out.writerow([*p, *qq, wd, rng.randint(0, 2)])
    return root


def test_vgn_syn_dataset_matches_jax(tmp_path):
    root = write_vgn_syn(tmp_path)
    kw = dict(root=str(root / "scenes"), sdf_root=str(root / "sdf"),
              grasp_root=str(root / "grasps"), n_rays=64, seed=4)
    ours, ref = VGNSynDataset(**kw), JVGNSynDataset(**kw)
    assert ours.scenes == ref.scenes and len(ours.scenes) == 2
    for _ in range(3):
        assert_trees_equal(ours.sample(), ref.sample())


def small_factory():
    return DatasetFactory(SyntheticSceneDataset, **SMALL)


def test_loader_in_process_matches_jax_collate():
    """0 workers: the loader's scene batches are JAX's collate_scenes of
    factory(seed)'s samples, as tensors."""
    ds = small_factory()(5)
    want = [j_collate([ds.sample() for _ in range(2)]) for _ in range(2)]
    with SceneLoader(small_factory(), num_workers=0, scenes_per_batch=2,
                     seed=5) as loader:
        got = [next(loader) for _ in range(2)]
        assert loader.pop_data_wait() > 0 and loader.pop_data_wait() == 0
    for g, w in zip(got, want):
        assert isinstance(g["data"]["ref"]["imgs"], torch.Tensor)
        assert_trees_equal(g, w)
    one = ds.sample()
    assert_trees_equal(collate_scenes([one]), j_collate([one]))


def test_loader_workers_own_seeds():
    """2 workers from the fork server after this process has run the
    tracer: the
    batches alternate between the workers, each from factory(seed + 1000 w),
    and the loader's timeout is set."""
    factory = small_factory()
    want = {w: factory(3 + 1000 * w) for w in (0, 1)}
    expect = [want[w].sample() for _ in range(2) for w in (0, 1)]
    with SceneLoader(factory, num_workers=2, seed=3, timeout=120) as loader:
        assert loader._loader.timeout == 120
        assert loader._loader.multiprocessing_context.get_start_method() \
            == "forkserver"
        for e in expect:
            got = next(loader)
            assert_trees_equal({k: v[0] for k, v in flat(got).items()},
                               flat(e))


def test_loader_worker_error_reaches_consumer():
    bad = DatasetFactory(SyntheticSceneDataset, n_objects=None, **SMALL)
    with SceneLoader(bad, num_workers=1, timeout=120) as loader:
        with pytest.raises(TypeError):
            next(loader)


def test_to_device_dtypes():
    tree = {"a": np.arange(3, dtype=np.int32), "b": {
        "c": np.ones(2, np.float64), "d": np.array([True, False])},
        "e": torch.arange(2, dtype=torch.uint8)}
    out = to_device(tree, "cpu")
    assert out["a"].dtype == torch.int64 and out["e"].dtype == torch.int64
    assert out["b"]["c"].dtype == torch.float32
    assert out["b"]["d"].dtype == torch.float32
    np.testing.assert_array_equal(out["b"]["d"].numpy(), [1.0, 0.0])
