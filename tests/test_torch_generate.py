"""The port's dataset writer (`python3 -m graspnerf_tpu_torch.data.generate`)
against the JAX package's scripts/generate_data.py on the CPU, at 72 x 96:
procedural scenes with heuristic labels, procedural scenes with executed
labels, and a replayed mesh_pose_list descriptor (the fixture of
tests/test_data_contract.py). Both run in this process, tracing with one
build of native/raytrace.cpp (`same_tracer`, tests/test_torch_sim.py), so
that both see the same rays.

Equal: every PNG, EXR and camera_pose.npy byte for byte, grasps.csv
line for line; the sdf grid within SDF_ATOL (the port fuses with torch,
JAX with XLA: float32 rounding of the projection and the average; the
npz's zip timestamps differ anyway). `executed_grasp_labels` identical on
the same TSDF and simulator state. Then the port's VGNSynDataset reads the
written tree and one small CPU train step on it is finite.

Also the PNG codec the writer and reader use (data/png.py): PIL's bytes on
encode, PIL's pixels on decode, `VGNSynDatabase.get_image` through PIL
with and without a resize, and, where PIL does not import, its in-tree
decode of images at the database's size equal to PIL's.
"""
import importlib.util
import io
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import graspnerf_tpu.data.native as j_native
import graspnerf_tpu_torch.data.native as t_native
from graspnerf_tpu_torch.data import VGNSynDataset, png, to_device
from graspnerf_tpu_torch.data.database import VGNSynDatabase
from graspnerf_tpu_torch.data.generate import (executed_grasp_labels,
                                               generate)
from _torch_util import one_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
SDF_ATOL = 1e-5
SMALL = ["--height", "72", "--width", "96", "--grasp-candidates", "8"]


@pytest.fixture
def same_tracer(monkeypatch):
    """Both packages trace with the port's build of native/raytrace.cpp."""
    monkeypatch.setattr(j_native, "_lib", t_native._load())
    monkeypatch.setattr(j_native, "_tried", True)


def jax_script():
    """scripts/generate_data.py as a module."""
    spec = importlib.util.spec_from_file_location(
        "generate_data", REPO / "scripts" / "generate_data.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_generate(argv, monkeypatch):
    """scripts/generate_data.py's main() in this process."""
    monkeypatch.setattr(sys, "argv", ["generate_data.py", *argv, "--cpu"])
    jax_script().main()


def files(root):
    return sorted(str(p.relative_to(root)) for p in Path(root).rglob("*")
                  if p.is_file())


def assert_trees_equal(got, want):
    assert files(got) == files(want)
    for rel in files(want):
        a, b = Path(got) / rel, Path(want) / rel
        if rel.startswith("sdf/"):
            ga, gb = np.load(a)["grid"], np.load(b)["grid"]
            assert ga.shape == gb.shape == (1, 40, 40, 40)
            np.testing.assert_allclose(ga, gb, rtol=0, atol=SDF_ATOL,
                                       err_msg=rel)
        else:
            assert a.read_bytes() == b.read_bytes(), rel


def run_both(tmp_path, monkeypatch, argv):
    port, ref = tmp_path / "port", tmp_path / "jax"
    records = generate([str(port), *argv, "--device", "cpu"])
    jax_generate([str(ref), *argv], monkeypatch)
    assert_trees_equal(port, ref)
    return port, records


def test_procedural_heuristic_labels_match_jax(tmp_path, monkeypatch,
                                               same_tracer):
    port, records = run_both(tmp_path, monkeypatch,
                             ["--scenes", "2", "--seed", "3", *SMALL])
    assert len(records) == 2 and all(r["grasps"] == 32 for r in records)
    assert all(r["scene"] == 0.0 for r in records)   # no simulated scene


def test_executed_labels_match_jax(tmp_path, monkeypatch, same_tracer):
    port, records = run_both(tmp_path, monkeypatch,
                             ["--scenes", "1", "--executed-labels", *SMALL])
    assert records[0]["grasps"] == 8 and records[0]["objects"] > 0
    assert set(records[0]) >= {"scene", "render", "tsdf", "labels", "write"}


@pytest.fixture
def descriptors(tmp_path):
    """tests/test_data_contract.py's replay fixture: two cube URDFs in a
    reference-format mesh_pose_list descriptor."""
    from test_mesh_objects import _cube_urdf
    assets = tmp_path / "assets"
    assets.mkdir()
    _cube_urdf(str(assets), "obj_a", h=0.018)
    _cube_urdf(str(assets), "obj_b", h=0.022)
    rng = np.random.RandomState(5)
    desc = {}
    for i, u in enumerate(["obj_a.urdf", "obj_b.urdf"]):
        q = rng.randn(4)
        q /= np.linalg.norm(q)
        desc[i] = [np.float32(0.9), q.astype(np.float32),
                   rng.uniform(0.1, 0.2, 2).astype(np.float32), u]
    ddir = tmp_path / "descs"
    ddir.mkdir()
    np.save(ddir / "scene_a.npy", np.array(desc, dtype=object),
            allow_pickle=True)
    return ddir, assets


def test_descriptor_replay_matches_jax_and_trains(tmp_path, monkeypatch,
                                                  same_tracer, descriptors):
    from graspnerf_tpu_torch.models import GraspNeRF
    from graspnerf_tpu_torch.train import create_train_state, make_train_step
    from graspnerf_tpu_torch.train.cli import SMALL_RENDERER
    ddir, assets = descriptors
    port, records = run_both(tmp_path, monkeypatch, [
        "--mesh-pose-dir", str(ddir), "--asset-root", str(assets), *SMALL])
    assert records[0]["objects"] == 2
    ds = VGNSynDataset(str(port), sdf_root=str(port / "sdf"),
                       grasp_root=str(port / "grasps"), n_rays=24,
                       n_grasps=5)
    b = ds.sample()
    sdf = b["sdf_gt"]
    assert sdf.shape == (40, 40, 40) and (sdf < 0).any() and (sdf > -1).any()
    assert b["data"]["ref"]["imgs"].shape == (6, 288, 512, 3)
    # a small CPU step: the 8^3 volume (the GT and grasp voxels strided
    # 5 x) and the views' top-left 96 x 128 pixels (the same intrinsics on
    # a smaller sensor; the query's rays wrapped into it)
    b["sdf_gt"] = sdf[::5, ::5, ::5]
    b["data"]["grasp_index"] = b["data"]["grasp_index"] // 5
    b["true_depth"] = b["true_depth"][:, :96, :128]
    for v in ("ref", "que"):
        b["data"][v]["imgs"] = b["data"][v]["imgs"][:, :96, :128]
    b["data"]["que"]["coords"] %= np.array([128, 96], np.float32)
    model = GraspNeRF(dict(SMALL_RENDERER))
    state = create_train_state(model, device="cpu")
    metrics = make_train_step(state)(to_device(b, "cpu"),
                                     torch.Generator().manual_seed(0))
    assert float(metrics["nonfinite_grad"]) == 0.0
    assert np.isfinite(float(metrics["total"]))
    assert np.isfinite(float(metrics["loss_vgn"]))


def test_executed_grasp_labels_match_jax(same_tracer):
    """The same TSDF and simulator state, the same draws: identical labels."""
    from graspnerf_tpu.sim.simulation import ClutterRemovalSim as JSim
    from graspnerf_tpu_torch.sim.simulation import ClutterRemovalSim
    sims = [ClutterRemovalSim("pile", rng=np.random.RandomState(7),
                              device="cpu"),
            JSim("pile", rng=np.random.RandomState(7))]
    for sim in sims:
        sim.reset(3)
    rng = np.random.RandomState(1)
    tsdf = rng.uniform(-1, 1, (40, 40, 40)).astype(np.float32)
    tsdf[:, :, :4] = -1.0
    bbox_min = np.array([-0.15, -0.15, -0.05], np.float32)
    got = executed_grasp_labels(sims[0], tsdf, np.random.RandomState(2), 10,
                                0.3 / 40, bbox_min)
    want = jax_script().executed_grasp_labels(
        sims[1], tsdf, np.random.RandomState(2), 10, 0.3 / 40, bbox_min)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_generate_needs_a_card_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate([str(tmp_path), "--scenes", "1", *SMALL])


def images():
    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[:45, :70]
    smooth = ((np.stack([yy, xx, yy + xx], -1) * 3
               + rng.rand(45, 70, 3) * 4) % 256).astype(np.uint8)
    smooth[10:14] = 200          # flat rows: None and Up filters
    return {"noise": rng.randint(0, 256, (33, 50, 3)).astype(np.uint8),
            "smooth": smooth, "grey": smooth[..., 0],
            "grey_alpha": smooth[..., :2],
            "rgba": np.dstack([smooth, smooth[..., :1]]),
            # IDAT chunks of 65536 bytes
            "tall": rng.randint(0, 256, (300, 100, 3)).astype(np.uint8)}


@pytest.mark.parametrize("name", sorted(images()))
def test_png_codec_matches_pil(name):
    from PIL import Image
    img = images()[name]
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    assert png.encode_png(img) == buf.getvalue()
    want = np.asarray(Image.open(io.BytesIO(buf.getvalue())))
    got, = png.decode_pngs([buf.getvalue()])
    np.testing.assert_array_equal(got, want.reshape(got.shape))


def test_png_writer_cuts_wide_images_like_pil():
    """IDAT chunks of 4 x width bytes past 16,384 pixels a row."""
    from PIL import Image
    img = np.random.RandomState(2).randint(0, 256, (2, 20000, 3)).astype(
        np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    assert png.encode_png(img) == buf.getvalue()


def test_png_decoder_refuses_what_it_cannot_read():
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(images()["smooth"]).convert("P").save(buf, format="PNG")
    with pytest.raises(ValueError, match="unsupported PNG"):
        png.decode_pngs([buf.getvalue()])


@pytest.mark.parametrize("hw", ((288, 512), (36, 64)))
def test_get_image_matches_pil(tmp_path, hw):
    """PIL's convert("RGB") and bilinear resize, at the database's size and
    at another."""
    from PIL import Image
    d = tmp_path / "scene"
    (d / "rgb").mkdir(parents=True)
    np.save(d / "camera_pose.npy", np.tile(np.eye(4, dtype=np.float32),
                                           (24, 1, 1)))
    img = np.random.RandomState(1).randint(0, 256, hw + (4,)).astype(np.uint8)
    Image.fromarray(img).save(d / "rgb" / "0000.png")
    db = VGNSynDatabase(str(d))
    want = Image.open(d / "rgb" / "0000.png").convert("RGB").resize(
        db.wh, Image.BILINEAR)
    np.testing.assert_array_equal(db.get_image(0),
                                  np.asarray(want, np.float32) / 255.0)
    assert os.path.exists(d / "rgb" / "0000.png")


def test_get_images_without_pil(tmp_path, monkeypatch):
    """Without PIL: RGBA, RGB, grey and grey + alpha PNGs at the database's
    size decoded in-tree in one call, equal to PIL's convert("RGB"); an
    image of another size raises."""
    from PIL import Image
    d = tmp_path / "scene"
    (d / "rgb").mkdir(parents=True)
    np.save(d / "camera_pose.npy", np.tile(np.eye(4, dtype=np.float32),
                                           (24, 1, 1)))
    rng = np.random.RandomState(4)
    for i, c in enumerate((4, 3, 1, 2, 3)):
        img = rng.randint(0, 256, (288, 512, c)).astype(np.uint8)
        Image.fromarray(img.squeeze(-1) if c == 1 else img).save(
            d / "rgb" / ("%04d.png" % i))
    Image.fromarray(img[:36, :64]).save(d / "rgb" / "0005.png")
    want = np.stack([np.asarray(Image.open(d / "rgb" / ("%04d.png" % i))
                                .convert("RGB"), np.float32) / 255.0
                     for i in (0, 1, 2, 3, 4)])
    monkeypatch.setitem(sys.modules, "PIL", None)
    db = VGNSynDatabase(str(d))
    np.testing.assert_array_equal(db.get_images([0, 1, 2, 3, 4]), want)
    with pytest.raises(ImportError, match="needs PIL"):
        db.get_image(5)
