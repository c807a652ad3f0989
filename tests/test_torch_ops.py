"""Port ops (graspnerf_tpu_torch.ops, detect.postprocess) against the JAX
package on the CPU, and the port's import boundary.

Tolerances: geometry and sampling are a handful of float32 ops, so the
results agree to float32 rounding of the operands (atol 1e-5 on pixel coords
of a few hundred, 1e-6 on unit-scale values). The gather's plain version
repeats the JAX arithmetic op for op and is held to 1e-6. Filters on
[0,1] volumes: 1e-6; NMS masks and candidate indices: exact.
"""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from graspnerf_tpu.ops import geometry as G
from graspnerf_tpu.ops import image as I
from graspnerf_tpu.ops import interpolate as IP
from graspnerf_tpu.ops.fused_gather import (pack_feature_maps,
                                            fused_epipolar_gather)
from graspnerf_tpu.ops.tsdf import grid_points_device
from graspnerf_tpu.detect import postprocess as PP

from graspnerf_tpu_torch.ops import geometry as TG
from graspnerf_tpu_torch.ops import image as TI
from graspnerf_tpu_torch.ops import interpolate as TIP
from graspnerf_tpu_torch.ops import epipolar_gather as EG
from graspnerf_tpu_torch.ops.epipolar_gather import (epipolar_gather,
                                                     epipolar_gather_plain)
from graspnerf_tpu_torch.ops.tsdf import grid_points
from graspnerf_tpu_torch.detect import postprocess as TPP

from ref_harness import rand_cameras

REPO = pathlib.Path(__file__).resolve().parents[1]
T = torch.from_numpy


def close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=rtol)


def test_geometry_matches_jax(rng):
    V, h, w = 6, 32, 48
    poses, Ks = rand_cameras(rng, V, h, w)
    pts = (rng.rand(500, 3) - 0.5).astype(np.float32) * 0.6
    pts[0] = G.camera_centers(jnp.asarray(poses))[0]    # depth 0 in view 0
    xy_j, d_j, ok_j = G.project_points(jnp.asarray(pts), jnp.asarray(poses),
                                       jnp.asarray(Ks), h, w)
    xy_t, d_t, ok_t = TG.project_points(T(pts), T(poses), T(Ks), h, w)
    # the point at camera 0's center has depth ~0: its xy is rounding noise
    # over the safe depth, and it is invalid on both sides
    close(xy_t[:, 1:], np.asarray(xy_j)[:, 1:], 1e-5, 1e-5)
    close(d_t, d_j, 1e-6, 1e-6)
    assert (ok_t.numpy() == np.asarray(ok_j)).all()
    assert not ok_t[0, 0] and ok_t.any() and not ok_t.all()
    close(TG.camera_centers(T(poses)), G.camera_centers(jnp.asarray(poses)), 1e-6)
    close(TG.view_directions(T(pts[1:]), T(poses)),
          G.view_directions(jnp.asarray(pts[1:]), jnp.asarray(poses)), 1e-6)
    depth = rng.uniform(0.1, 1.0, (V, 1, 4, 5)).astype(np.float32)
    dr = np.tile(np.array([[0.2, 0.8]], np.float32), (V, 1))
    close(TG.to_inv_norm(T(depth), T(dr)),
          G.to_inv_norm(jnp.asarray(depth), jnp.asarray(dr)), 1e-6)
    for g, j in zip(TG.near_far_bounds_fixed(T(depth), T(dr)),
                    G.near_far_bounds_fixed(jnp.asarray(depth), jnp.asarray(dr))):
        close(g, j, 1e-6)


def test_grid_points_match_jax():
    for res in (16, 40):
        close(grid_points(res, 0.3), grid_points_device(res, 0.3), 0)


def _gather_case(rng, V=3, H=32, W=48, C=32, P=400):
    imgs = rng.rand(V, H, W, 3).astype(np.float32)
    f1 = rng.randn(V, H // 4, W // 4, C).astype(np.float32)
    f2 = rng.randn(V, H // 4, W // 4, C).astype(np.float32)
    xy = np.stack([rng.uniform(-3, W + 2, (V, P)),
                   rng.uniform(-3, H + 2, (V, P))], -1).astype(np.float32)
    # exact borders, pixel centers and the validity bounds
    xy[:, :6] = [[-0.5, -0.5], [0, 0], [W - 1, H - 1], [W - 0.5, H - 0.5],
                 [W - 1, 0], [0, H - 1]]
    valid = rng.rand(V, P) > 0.2
    return imgs, f1, f2, xy, valid


def test_interpolate_matches_jax(rng):
    imgs, f1, _, xy, valid = _gather_case(rng)
    H, W = imgs.shape[1:3]
    for feats in (imgs, f1):
        close(TIP.interpolate_feature_map(T(feats), T(xy), T(valid), H, W),
              IP.interpolate_feature_map(jnp.asarray(feats), jnp.asarray(xy),
                                         jnp.asarray(valid), H, W), 1e-6)
    close(TIP.interpolate_feats(T(f1), T(xy), H, W, "zeros", True),
          IP.interpolate_feats(jnp.asarray(f1), jnp.asarray(xy), H, W,
                               "zeros", True), 1e-6)
    x = rng.rand(2, 5, 7, 3).astype(np.float32)
    up = TIP.resize_bilinear_align_corners(T(x).permute(0, 3, 1, 2), 10, 14)
    close(up.permute(0, 2, 3, 1), IP.resize_bilinear_align_corners(
        jnp.asarray(x), 10, 14), 1e-6)
    v = rng.rand(2, 3, 5, 4, 6).astype(np.float32)   # [B,D,H,W,C]
    nn3 = TIP.resize_nearest_3d(T(v).permute(0, 4, 1, 2, 3), 10, 10, 12)
    close(nn3.permute(0, 2, 3, 4, 1),
          IP.resize_nearest_3d(jnp.asarray(v), 10, 10, 12), 0)


def test_gather_plain_matches_fused_gather(rng):
    """The gather's plain version (the wrapper's CPU path) == the JAX
    fused_epipolar_gather, including border and invalid points."""
    imgs, f1, f2, xy, valid = _gather_case(rng)
    H, W = imgs.shape[1:3]
    rgb, img_f, ray_f = fused_epipolar_gather(
        pack_feature_maps(jnp.asarray(imgs), jnp.asarray(f1), jnp.asarray(f2)),
        jnp.asarray(xy), jnp.asarray(valid), H, W)
    args = (T(imgs), T(f1), T(f2), T(xy), T(valid))
    rgbf_t, ray_t = epipolar_gather(*args)
    for a, b in zip((rgbf_t, ray_t), epipolar_gather_plain(*args)):
        assert torch.equal(a, b)
    close(rgbf_t[..., :3], rgb, 1e-6)
    close(rgbf_t[..., 3:], img_f, 1e-6)
    close(ray_t, ray_f, 1e-6)
    assert (ray_t[~T(valid)] == 0).all()


def _kernel_args(V=2, H=32, W=48, C=8, P=5, device="cpu"):
    """Arguments of the gather kernel's launch, as `_check` takes them."""
    f = dict(dtype=torch.float32, device=device)
    return dict(imgs=torch.zeros(V, H, W, 3, **f),
                img_feats=torch.zeros(V, H // 4, W // 4, C, **f),
                ray_feats=torch.zeros(V, H // 4, W // 4, C, **f),
                xy=torch.zeros(V, P, 2, **f),
                valid=torch.zeros(V, P, dtype=torch.bool, device=device),
                rgb_out=torch.zeros(V, P, 3 + C, **f),
                ray_out=torch.zeros(V, P, C, **f))


# P * (3 + C) at C = 32 just past 2^31 - 1; meta tensors hold no storage
_P_OVER = 2 ** 31 // 35 + 1
_REFUSED = {
    "more than 32 channels": lambda: _kernel_args(C=36),
    "full-res maps": lambda: dict(_kernel_args(), **{
        k: torch.zeros(2, 32, 48, 8) for k in ("img_feats", "ray_feats")}),
    "maps of other views": lambda: dict(_kernel_args(), **{
        k: torch.zeros(3, 8, 12, 8) for k in ("img_feats", "ray_feats")}),
    "maps that differ": lambda: dict(_kernel_args(),
                                     ray_feats=torch.zeros(2, 8, 12, 4)),
    "xy of other views": lambda: dict(_kernel_args(), xy=torch.zeros(3, 5, 2)),
    "valid not bool": lambda: dict(_kernel_args(),
                                   valid=torch.zeros(2, 5, dtype=torch.uint8)),
    "outputs of another shape": lambda: dict(_kernel_args(),
                                             rgb_out=torch.zeros(2, 5, 8)),
    "float64": lambda: dict(_kernel_args(),
                            imgs=torch.zeros(2, 32, 48, 3, dtype=torch.float64)),
    "not contiguous": lambda: dict(_kernel_args(),
                                   xy=torch.zeros(2, 2, 5).transpose(1, 2)),
    "on two devices": lambda: dict(_kernel_args(),
                                   imgs=torch.zeros(2, 32, 48, 3,
                                                    device="meta")),
    "over 32-bit indexing": lambda: _kernel_args(C=32, P=_P_OVER,
                                                 device="meta"),
}


@pytest.mark.parametrize("case", sorted(_REFUSED))
def test_gather_check_refuses(case):
    """The launch's argument checks refuse what the kernel cannot take,
    before anything reaches the card."""
    with pytest.raises((ValueError, TypeError)):
        EG._check(**_REFUSED[case]())


@pytest.mark.parametrize("kw", [dict(), dict(C=20), dict(C=3, P=1),
                                dict(C=32, P=_P_OVER - 1, device="meta")],
                         ids=["C=8", "C=20", "C=3,P=1", "largest P"])
def test_gather_check_accepts(kw):
    """C need not be a multiple of 4 (the kernel's float path), and a view
    may hold up to 2^31 - 1 output floats."""
    EG._check(**_kernel_args(**kw))


def test_image_filters_match_jax(rng):
    vol = rng.rand(9, 8, 7).astype(np.float32)
    close(TI.gaussian_filter_3d(T(vol)), I.gaussian_filter_3d(jnp.asarray(vol)),
          1e-6)
    close(TI.maximum_filter_3d(T(vol)), I.maximum_filter_3d(jnp.asarray(vol)), 0)
    x = rng.rand(9, 8, 7) > 0.9
    m = rng.rand(9, 8, 7) > 0.3
    got = TI.binary_dilation_masked(T(x), T(m))
    assert (got.numpy() == np.asarray(
        I.binary_dilation_masked(jnp.asarray(x), jnp.asarray(m)))).all()


def test_postprocess_matches_jax(rng):
    """process -> nms -> extract_candidates on a crafted volume: a surface
    slab, quality peaks above the threshold, widths in and out of range."""
    res = 12
    tsdf = np.ones((res, res, res), np.float32)
    tsdf[:, :, :4] = -0.5                       # inside band below z=4
    tsdf[:, :, :2] = -1.0
    qual = 0.3 * rng.rand(res, res, res).astype(np.float32)
    for ix, iy, iz in [(2, 3, 5), (8, 8, 6), (5, 9, 4), (9, 2, 7)]:
        qual[ix - 1:ix + 2, iy - 1:iy + 2, iz - 1:iz + 2] += 1.5
    width = rng.uniform(0.5, 10.0, (res, res, res)).astype(np.float32)
    rot = rng.randn(res, res, res, 4).astype(np.float32)
    q_j = PP.process(jnp.asarray(tsdf), jnp.asarray(qual), jnp.asarray(width))
    q_t = TPP.process(T(tsdf), T(qual), T(width))
    close(q_t, q_j, 1e-6)
    s_j = PP.nms(q_j, 0.5)
    s_t = TPP.nms(q_t, 0.5)
    assert ((s_t.numpy() > 0) == (np.asarray(s_j) > 0)).all()
    c_j = PP.extract_candidates(s_j, jnp.asarray(rot), jnp.asarray(width), k=8)
    c_t = TPP.extract_candidates(s_t, T(rot), T(width), k=8)
    keep_j = np.asarray(c_j.scores) > 0
    keep_t = c_t.scores.numpy() > 0
    assert keep_j.sum() >= 2
    got = sorted(zip(map(tuple, c_t.indices.numpy()[keep_t].tolist()),
                     c_t.widths.numpy()[keep_t].tolist()))
    want = sorted(zip(map(tuple, np.asarray(c_j.indices)[keep_j].tolist()),
                      np.asarray(c_j.widths)[keep_j].tolist()))
    assert got == want
    grasps, scores = TPP.candidates_to_grasps(c_t)
    assert len(grasps) == keep_t.sum()


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    """No module of the port, nor chip_smoke.py, names jax, flax, optax or
    the JAX package; and importing the port, its train step included, loads
    none of them."""
    banned = ("jax", "jaxlib", "flax", "optax", "graspnerf_tpu")
    files = sorted((REPO / "graspnerf_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    for f in files:
        for mod in _imports(f):
            assert mod.split(".")[0] not in banned, (f, mod)
    code = ("import sys, graspnerf_tpu_torch.detect.planner, "
            "graspnerf_tpu_torch.train, graspnerf_tpu_torch.build; "
            f"bad = [m for m in sys.modules if m.split('.')[0] in {banned}]; "
            "assert not bad, bad")
    path = os.pathsep.join(filter(None, [str(REPO),
                                         os.environ.get("PYTHONPATH")]))
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   env=dict(os.environ, PYTHONPATH=path), timeout=120)
