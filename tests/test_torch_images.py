"""The port's image files without PIL (the card's host has none): the
reference's rendered-view contract written by `sim.render.render_views_to_dir`
and read by `detect.planner.load_rendered_views`, and the trainer's
validation dump `train.metrics.visualize_image`, each with PIL hidden held
to its output with PIL, on the CPU. No JAX: the PIL path of the first two is
held to the JAX package in tests/test_torch_closed_loop.py."""
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from graspnerf_tpu_torch.data.synthetic import hemisphere_poses, intrinsics
from graspnerf_tpu_torch.detect.planner import load_rendered_views
from graspnerf_tpu_torch.sim.objects import PrimObject, PrimScene
from graspnerf_tpu_torch.sim.render import render_views_to_dir
from graspnerf_tpu_torch.train.metrics import visualize_image
from _torch_util import one_thread  # noqa: F401  (autouse)

H, W, IDS = 48, 64, [2, 6]


def hide_pil(monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)


def write_views(outdir):
    scene = PrimScene([PrimObject(0, (0.03, 0.03, 0.03),
                                  t=(0.15, 0.15, 0.03))])
    render_views_to_dir(scene, hemisphere_poses(), intrinsics(H, W), H, W,
                        str(outdir), frame_ids=IDS, write_ir=True)


def test_render_views_to_dir_without_pil(tmp_path, monkeypatch):
    """Every PNG (rgb, the IR pair) byte-equal to the one PIL writes, and
    camera_pose.npy equal."""
    write_views(tmp_path / "pil")
    hide_pil(monkeypatch)
    write_views(tmp_path / "own")
    files = sorted(p.relative_to(tmp_path / "pil")
                   for p in (tmp_path / "pil").rglob("*") if p.is_file())
    assert len(files) == 1 + 3 * len(IDS)
    for f in files:
        assert (tmp_path / "own" / f).read_bytes() == (
            tmp_path / "pil" / f).read_bytes(), f


def test_load_rendered_views_without_pil(tmp_path, monkeypatch):
    """The views at their own size read as PIL reads them; at another size,
    which needs PIL's resample, the in-tree reader raises."""
    write_views(tmp_path)
    cam = str(tmp_path / "camera_pose.npy")
    want = load_rendered_views(str(tmp_path), cam, IDS, wh=(W, H))
    hide_pil(monkeypatch)
    got = load_rendered_views(str(tmp_path), cam, IDS, wh=(W, H))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ImportError, match="needs PIL"):
        load_rendered_views(str(tmp_path), cam, IDS, wh=(2 * W, 2 * H))


def test_visualize_image_without_pil(tmp_path, monkeypatch):
    """The pred | gt panel byte-equal to PIL's file, from tensors."""
    rng = np.random.RandomState(0)
    pred = torch.from_numpy(rng.uniform(-0.2, 1.2, (12, 16, 3))
                            .astype(np.float32))
    gt = rng.uniform(0, 1, (12, 16, 3)).astype(np.float32)
    want = visualize_image(pred, gt, str(tmp_path / "pil"), 3)
    hide_pil(monkeypatch)
    got = visualize_image(pred, gt, str(tmp_path / "own"), 3)
    assert open(got, "rb").read() == open(want, "rb").read()
    monkeypatch.undo()
    assert np.asarray(Image.open(got)).shape == (12, 32, 3)
