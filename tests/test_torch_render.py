"""The port's render path against the JAX package on the CPU: the new
geometry functions, `compute_prob` with per-sample intervals, `neus_alpha`,
IBRNetNeus's ∇sdf, NeusAggregationNet.forward, and the whole
`GraspNeRF.forward` (coarse and fine render, volume, grasp heads).

Size: 6 reference views of 64 x 96, one query view with 24 rays, 16 coarse
+ 16 fine samples, an 8^3 volume. Weights: the random flax tree of
test_torch_models.py, with both aggregators' SDF output kernels scaled down
so that the SDF stays strictly inside (-1, 1): the clip's gradient at
exactly +-1 differs between jnp.clip and torch.clamp.

Tolerances (float32 on both sides; JAX at matmul precision 'highest'):
- geometry: 1e-6 relative to metric depths, 1e-6 absolute on the
  compositing functions (a few ulps; XLA's cumsum/cumprod may associate
  differently from PyTorch's running sum);
- fine depths: 1e-5. They invert the hit-probability CDF, whose cumsum
  differs by ulps between the two libraries, and a bin's slope can be up to
  1 / 1e-5 in normalised inverse depth; a `u` tying with a CDF entry would
  move a sample to another bin, which the test would show;
- modules: 2e-5, as in test_torch_models.py; ∇sdf 2e-5 (the geometry head's
  backward, ~10 layers);
- the whole forward: 1e-4, the planner's target for the ~40-layer chain; the
  fine pass adds the sampling above. ray_mask and num_valid are exact.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from graspnerf_tpu import models as M
from graspnerf_tpu.ops import geometry as G
from graspnerf_tpu.ops.fused_gather import pack_feature_maps

from graspnerf_tpu_torch import models as TM
from graspnerf_tpu_torch.convert import flax_to_state_dict
from graspnerf_tpu_torch.ops import geometry as TG
from graspnerf_tpu_torch.ops.epipolar_gather import epipolar_gather
from graspnerf_tpu_torch.ops.view_fuse import view_fuse

from ref_harness import rand_cameras
from test_torch_models import V, H, W, close, graspnerf_params, sub
from _torch_util import one_thread  # noqa: F401  (autouse)

RN, DN, FDN, RES = 24, 16, 16, 8
CFG = {"depth_sample_num": DN, "fine_depth_sample_num": FDN,
       "volume_resolution": RES}
GEOM_ATOL, FINE_ATOL, MODULE_ATOL, FORWARD_ATOL = 1e-6, 1e-5, 2e-5, 1e-4
FINE_DEPTH_ATOL = 1e-4   # metres, the whole forward's fine samples
RENDER_KEYS = ("alpha_values", "colors_nr", "hit_prob_nr", "pixel_colors_nr",
               "sdf_values", "sdf_gradient_error", "s", "render_depth")


def _params():
    """graspnerf_params() copied, with fine_agg_net's SDF output kernel
    scaled as agg_net's is there."""
    params = jax.tree_util.tree_map(np.array, graspnerf_params())
    params["nr_net"]["fine_agg_net"]["agg_impl"]["out_geometry_fc.1"][
        "kernel"] *= 0.05
    return params


def _scene(seed=5):
    rng = np.random.RandomState(seed)
    poses, Ks = rand_cameras(rng, V + 1, H, W, radius=0.5,
                             center=(0.0, 0.0, 0.05))
    imgs = rng.rand(V + 1, H, W, 3).astype(np.float32)
    coords = np.stack([rng.uniform(-0.5, W - 0.5, RN),
                       rng.uniform(-0.5, H - 0.5, RN)], -1)
    dr = np.array([[0.2, 0.8]], np.float32)
    ref = {"imgs": imgs[:V], "poses": poses[:V], "Ks": Ks[:V],
           "depth_range": np.tile(dr, (V, 1)),
           "bbox3d_min": np.array([-0.15, -0.15, -0.05], np.float32)}
    que = {"coords": coords[None].astype(np.float32), "poses": poses[V:],
           "Ks": Ks[V:], "depth_range": dr, "imgs": imgs[V:]}
    return {"ref": ref, "que": que,
            "grasp_index": rng.randint(0, RES, (5, 3)).astype(np.int32)}


def _torch(tree):
    return {k: _torch(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


def _jax_forward(params, data, fine_depth):
    """The JAX GraspNeRF forward; its fine pass again, at `fine_depth` (the
    port's fine samples); and its own fine samples."""
    jm = M.GraspNeRF(renderer_cfg=dict(CFG, use_depth_loss=False))
    out = jm.apply({"params": params}, data, train=False)
    ref, que = data["ref"], data["que"]

    def fine_pass(m):
        feats = m.nr_net.encode_views(ref)
        packed = pack_feature_maps(ref["imgs"], *feats, jnp.float32)
        return m.nr_net.render_by_depth(fine_depth, que, ref, *feats, True,
                                        False, packed)

    fine = jm.apply({"params": params}, method=fine_pass)
    coarse = G.sample_depth(que["depth_range"], RN, DN)
    own = jnp.sort(G.sample_fine_depth(coarse, out["hit_prob_nr"],
                                       que["depth_range"], FDN), -1)
    return out, fine, own


@pytest.fixture(scope="module")
def render():
    """One GraspNeRF forward of the port (use_kernels=True on CPU tensors)
    and of JAX on the same weights and scene: {params, data, got, launched
    (kernel launches counted), fine_depth (the port's fine samples), want,
    want_fine (JAX's fine pass at the port's fine samples), jax_fine_depth}."""
    params = _params()
    data = _scene()
    model = TM.load_graspnerf(flax_to_state_dict(params), "cpu", CFG)
    before = view_fuse.launches + epipolar_gather.launches
    with torch.no_grad():
        got = model(_torch(data))
    launched = view_fuse.launches + epipolar_gather.launches - before
    dr = torch.from_numpy(data["que"]["depth_range"])
    fine_depth = torch.sort(TG.sample_fine_depth(
        TG.sample_depth(dr, RN, DN), got["hit_prob_nr"], dr, FDN), -1).values
    want, want_fine, jax_fine_depth = jax.jit(_jax_forward)(
        params, jax.tree_util.tree_map(jnp.asarray, data),
        jnp.asarray(fine_depth.numpy()))
    return {"params": params, "data": data, "got": got, "launched": launched,
            "fine_depth": fine_depth, "want": want, "want_fine": want_fine,
            "jax_fine_depth": jax_fine_depth}


# ------------------------------------------------------------- geometry
def _depths(rng, n=3):
    return np.sort(rng.uniform(0.2, 0.8, (1, n, DN)), -1).astype(np.float32)


def _geometry_case(name, rng):
    """(JAX value, port value, atol) of one geometry function."""
    scene = _scene()
    que = scene["que"]
    dr = que["depth_range"]
    depth = _depths(rng)
    if name == "sample_depth":
        return (G.sample_depth(jnp.asarray(dr), RN, DN),
                TG.sample_depth(torch.from_numpy(dr), RN, DN), GEOM_ATOL)
    if name == "sample_fine_depth":
        hit = rng.rand(1, 3, DN).astype(np.float32)
        hit[0, 1] = 0.0          # all mass at 1e-5: every bin flat (denom=1)
        hit[0, 1, 4] = 1.0       # but one
        args = (depth, hit, dr)
        return (G.sample_fine_depth(*map(jnp.asarray, args), FDN),
                TG.sample_fine_depth(*map(torch.from_numpy, args), FDN),
                FINE_ATOL)
    if name == "depth2points":
        args = (que["coords"][:, :3], que["poses"], que["Ks"], depth)
        pj, dj = G.depth2points(*map(jnp.asarray, args))
        pt, dt = TG.depth2points(*map(torch.from_numpy, args))
        return (np.concatenate([pj, dj], -1),
                torch.cat([pt, dt], -1), GEOM_ATOL)
    if name == "depth2inv_dists":
        return (G.depth2inv_dists(jnp.asarray(depth), jnp.asarray(dr)),
                TG.depth2inv_dists(torch.from_numpy(depth),
                                   torch.from_numpy(dr)), GEOM_ATOL)
    if name == "from_inv_norm":
        u = rng.rand(1, 3, DN).astype(np.float32)
        return (G.from_inv_norm(jnp.asarray(u), jnp.asarray(dr)),
                TG.from_inv_norm(torch.from_numpy(u), torch.from_numpy(dr)),
                GEOM_ATOL)
    if name == "near_far_bounds_ref":
        prj_depth = rng.uniform(0.1, 1.0, (V, 1, 3, DN)).astype(np.float32)
        prj_depth[0, 0, 0, :2] = (-0.3, 0.0)   # behind the camera: clamped
        interval = (rng.rand(1, 1, 3, DN) * 0.1).astype(np.float32)
        vdr = np.tile(dr, (V, 1))
        args = (prj_depth, interval, vdr)
        return (np.stack(G.near_far_bounds_ref(*map(jnp.asarray, args))),
                torch.stack(TG.near_far_bounds_ref(*map(torch.from_numpy,
                                                        args))), GEOM_ATOL)
    alpha = rng.rand(1, 3, DN).astype(np.float32)
    alpha[0, 0, 5] = 1.0          # an opaque sample: nothing behind it
    if name == "alpha2hit_prob":
        return (G.alpha2hit_prob(jnp.asarray(alpha)),
                TG.alpha2hit_prob(torch.from_numpy(alpha)), GEOM_ATOL)
    assert name == "composite"
    values = rng.rand(1, 3, DN, 3).astype(np.float32)
    return (G.composite(jnp.asarray(alpha), jnp.asarray(values)),
            TG.composite(torch.from_numpy(alpha), torch.from_numpy(values)),
            GEOM_ATOL)


@pytest.mark.parametrize("name", [
    "sample_depth", "sample_fine_depth", "depth2points", "depth2inv_dists",
    "from_inv_norm", "near_far_bounds_ref", "alpha2hit_prob", "composite"])
def test_geometry_matches_jax(name, rng):
    want, got, atol = _geometry_case(name, rng)
    assert tuple(got.shape) == np.shape(want)
    close(got, want, atol)


# -------------------------------------------------------------- modules
def test_compute_prob_with_interval_matches_jax(rng):
    """The render pass's bins: each sample's interval in normalised inverse
    depth (near_far_bounds_ref), on the decoder's mixture."""
    params = sub(graspnerf_params(), "nr_net", "dist_decoder")
    feats = rng.randn(V, 1, 3, DN, 32).astype(np.float32)
    depth = rng.uniform(0.1, 1.0, (V, 1, 3, DN)).astype(np.float32)
    interval = (rng.rand(1, 1, 3, DN) * 0.1).astype(np.float32)
    dr = np.tile(np.array([[0.2, 0.8]], np.float32), (V, 1))

    def jax_prob(p, feats, depth, interval, dr):
        mean, var, vis, aw = M.MixtureLogisticsDistDecoder().apply(
            {"params": p}, feats)
        return M.compute_prob(depth, interval, mean, var, vis, aw, dr)

    want = jax.jit(jax_prob)(params, *map(jnp.asarray, (feats, depth,
                                                        interval, dr)))
    tm = TM.MixtureLogisticsDistDecoder()
    tm.load_state_dict(flax_to_state_dict(params), strict=True)
    with torch.no_grad():
        m, v, a = tm(torch.from_numpy(feats))
        got = TM.compute_prob(torch.from_numpy(depth), m, v, a,
                              torch.from_numpy(dr), torch.from_numpy(interval))
    close(got[1], want[1], 1e-5)   # visibility
    close(got[2], want[2], 1e-5)   # hit_prob
    # alpha: log-odds of a difference of two CDFs (see test_torch_models.py)
    close(got[0], want[0], 1e-5, 1e-4)


def test_neus_alpha_matches_jax(rng):
    n = (1, 4, DN)
    sdf = rng.uniform(-0.5, 0.5, n).astype(np.float32)
    grad = rng.randn(*n, 3).astype(np.float32)
    que_dir = rng.randn(*n, 3).astype(np.float32)
    que_dir /= np.linalg.norm(que_dir, axis=-1, keepdims=True)
    dists = rng.uniform(0.0, 0.05, n).astype(np.float32)
    dists[..., -1] = 1e6           # depth2dists' sentinel after the last
    for ratio in (1.0, 0.3):
        want = M.neus_alpha(*map(jnp.asarray, (sdf, grad, que_dir, dists)),
                            jnp.float32(20.0), ratio)
        got = TM.neus_alpha(*map(torch.from_numpy, (sdf, grad, que_dir,
                                                    dists)),
                            torch.tensor(20.0), ratio)
        close(got, want, MODULE_ATOL)


def _fuse_inputs(rng, N):
    rgbf = rng.rand(V, N, 35).astype(np.float32)
    neur = rng.rand(V, N, 32).astype(np.float32)
    diff = (rng.rand(V, N, 4) - 0.5).astype(np.float32)
    mask = (rng.rand(V, N, 1) > 0.3).astype(np.float32)
    mask[:, :3] = 0.0    # rows seen by no view: sdf = 1
    mask[1:, 3:6] = 0.0  # rows seen by one view
    return rgbf, neur, diff, mask


def test_ibrnet_grad_matches_jax(rng):
    """∇sdf with respect to the query points, the fused features constant
    (the JAX module's jax.vjp), through a local autograd under no_grad."""
    params = sub(_params(), "nr_net", "fine_agg_net", "agg_impl")
    R, D = 3, DN
    args = (*_fuse_inputs(rng, R * D),
            ((rng.rand(1, R, D, 3) - 0.5) * 0.4).astype(np.float32))
    rgb_j, sdf_j, grad_j = jax.jit(lambda p, *a: M.IBRNetNeus().apply(
        {"params": p}, *a, (R, D)))(params, *map(jnp.asarray, args))
    tm = TM.IBRNetNeus()
    tm.load_state_dict(flax_to_state_dict(params), strict=True)
    with torch.no_grad():
        rgb_t, sdf_t, grad_t = tm.eval()(*map(torch.from_numpy, args), (R, D))
    assert grad_t.shape == (1, R, D, 3) and not grad_t.requires_grad
    close(sdf_t, sdf_j, MODULE_ATOL)
    close(rgb_t, rgb_j, MODULE_ATOL)
    close(grad_t, grad_j, MODULE_ATOL)
    # strictly unclipped, apart from the unseen rows' constant 1
    seen = args[3].sum(0).reshape(-1) >= 1
    assert np.abs(np.asarray(sdf_j)).reshape(-1)[seen].max() < 1.0


def test_aggregation_forward_matches_jax(rng):
    """NeusAggregationNet.forward: sdf, colours, ∇sdf, alpha, grad_error,
    s on a random projection dict."""
    params = sub(_params(), "nr_net", "agg_net")
    qn, rn, dn = 1, 3, DN
    rgbf, neur, diff, mask = (x.reshape(V, qn, rn, dn, -1)
                              for x in _fuse_inputs(rng, qn * rn * dn))
    prj_dir = rng.randn(V, qn, rn, dn, 3).astype(np.float32)
    que_dir = rng.randn(qn, rn, dn, 3).astype(np.float32)
    que_dir /= np.linalg.norm(que_dir, axis=-1, keepdims=True)
    pts = ((rng.rand(qn, rn, dn, 3) - 0.5) * 0.4).astype(np.float32)
    dists = TG.depth2dists(torch.from_numpy(_depths(rng, rn))).numpy()
    prj = {"ray_feats": neur, "hit_prob": rng.rand(V, qn, rn, dn, 1) * mask,
           "vis": rng.rand(V, qn, rn, dn, 1) * mask, "dir": prj_dir,
           "mask": mask}
    prj = {k: v.astype(np.float32) for k, v in prj.items()}
    prj_j = dict(prj, rgb=rgbf[..., :3], img_feats=rgbf[..., 3:])
    want = jax.jit(lambda p, *a: M.NeusAggregationNet().apply(
        {"params": p}, *a))(params, jax.tree_util.tree_map(jnp.asarray, prj_j),
                            *map(jnp.asarray, (que_dir, pts, dists)))
    tm = TM.NeusAggregationNet()
    tm.load_state_dict(flax_to_state_dict(params), strict=True)
    with torch.no_grad():
        got = tm.eval()(_torch(dict(prj, rgb_feats=rgbf)),
                        *map(torch.from_numpy, (que_dir, pts, dists)))
    assert set(got) == set(want)
    for key in want:
        assert tuple(got[key].shape) == want[key].shape, key
        close(got[key], want[key], MODULE_ATOL)


# ---------------------------------------------------------- whole model
def _flat(x):
    """An output (a tensor or a tuple of them) as one numpy vector."""
    if isinstance(x, (tuple, list)):
        return np.concatenate([_flat(t) for t in x])
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x,
                      np.float64).reshape(-1)


@pytest.mark.parametrize("key", [
    *RENDER_KEYS, "ray_mask", *(k + "_fine" for k in RENDER_KEYS),
    "ray_mask_fine", "pixel_colors_gt", "volume", "vgn_pred_full",
    "vgn_pred"])
def test_forward_matches_jax(render, key):
    """Every output key. The `_fine` keys are held against JAX's fine pass
    at the port's fine samples (see test_fine_samples_match_jax)."""
    got = render["got"]
    want = dict(render["want"])
    want.update({k + "_fine": v for k, v in render["want_fine"].items()})
    assert set(got) == set(want)
    g, w = got[key], want[key]
    if key.startswith("ray_mask"):
        assert g.dtype == torch.bool
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        # 16 samples: the mask (more than 8 samples seen by more than 2
        # views) takes both values
        assert 0 < int(g.sum()) < RN
        return
    shapes = [tuple(t.shape) for t in (g if isinstance(g, tuple) else [g])]
    assert shapes == [t.shape for t in (w if isinstance(w, tuple) else [w])]
    assert np.isfinite(_flat(g)).all()
    np.testing.assert_allclose(_flat(g), _flat(w), atol=FORWARD_ATOL, rtol=0)


def test_fine_samples_match_jax(render):
    """The port's fine samples against those JAX draws from its own coarse
    pass. The function itself agrees to 1e-5 on equal inputs (the geometry
    test); here its inputs, the coarse hit probabilities, differ by ~1e-7,
    and the inverse CDF multiplies that by up to a bin's width over 1e-5
    (the denominator's guard), ~6.7e3 in normalised inverse depth. Seed 5
    shows it: ray 16, sample 2 lies at 0.28721857 m in JAX and 0.28720418 m
    in the port (1.44e-5 m), where that ray's coarse hit probabilities agree
    to 1.2e-7; random image texture then moves its colour by 9.8e-4. So
    the fine pass is held at the port's samples above, and the samples here
    at FINE_DEPTH_ATOL."""
    got = render["fine_depth"].numpy()
    want = np.asarray(render["jax_fine_depth"])
    np.testing.assert_allclose(got, want, atol=FINE_DEPTH_ATOL, rtol=0)
    # the samples moved off the coarse ones, towards the hit probabilities
    assert not np.allclose(render["got"]["render_depth"].numpy(),
                           render["got"]["render_depth_fine"].numpy())


def test_forward_exercises_every_branch(render):
    """The scene reaches both of the geometry head's branches in both
    passes: samples seen by no view (sdf = 1), and the rest strictly inside
    (-1, 1)."""
    for key in ("sdf_values", "sdf_values_fine"):
        sdf = render["got"][key].numpy()
        assert (sdf == 1.0).any() and (np.abs(sdf) < 1).any(), key


def test_forward_kernel_wrappers_take_plain_path_on_cpu(render):
    """use_kernels=True on CPU tensors: the wrappers run their plain
    versions (no launch counted), bit-equal to a use_kernels=False model."""
    assert render["launched"] == 0
    plain = TM.load_graspnerf(flax_to_state_dict(render["params"]), "cpu",
                              CFG, use_kernels=False)
    with torch.no_grad():
        again = plain(_torch(render["data"]))
    for key, value in render["got"].items():
        for a, b in zip(*(v if isinstance(v, tuple) else (v,)
                          for v in (value, again[key]))):
            assert torch.equal(a, b), key


def test_load_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.load_graspnerf(flax_to_state_dict(graspnerf_params()))
