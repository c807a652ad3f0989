"""The port's bfloat16 inference path against the JAX package's on the CPU:
`compute_dtype="bfloat16"` in every module, the plain versions of both
kernels' bfloat16 instances, and the whole path (the volume and a render).

Size: the view fuse at N = 512 rows; the gather on test_fused_gather.py's
border cases; the modules at 6 views of 32 x 64; the whole forward at 6
views of 32 x 64, 8 rays, 8 + 8 samples, an 8^3 volume. Weights: the random
flax tree of test_torch_models.py, carried across with `convert`.

Tolerances. bfloat16 keeps 8 significant bits, so one rounding errs by up
to 2^-9 of the value (half an ulp, "1 ulp" below is 2^-8 of the value's
binade). The two libraries round at the same places but sum in another
order, and XLA's CPU backend and PyTorch's may compute an elementwise op
on bfloat16 through float32 or not; so a value can land one ulp apart, and
through the layers of a module such a difference grows. Each tolerance is
stated at the test, relative to the output's largest magnitude (its scale):
- the view fuse's plain version against the Pallas kernel's bfloat16
  instance (interpret mode): num_valid exact; feat_const, x and vis within
  1 ulp of each output's scale (the kernel and the plain version round the
  same float32 values; a float32 ulp can flip a rounding);
- the gather's plain version against `fused_epipolar_gather` on bfloat16
  maps: within 1 ulp of each value (JAX returns the float32 blend, the port
  rounds it);
- modules: a few ulps of the output's scale, at each test;
- the whole path: the volume within the gap measured between the JAX
  package's own two bfloat16 paths (default and Pallas kernel: max 0.023,
  mean 0.003 on test_bf16.py's volume), and the port's bfloat16 volume
  against its float32 one within test_bf16.py's bounds (max < 0.15, mean
  < 0.05).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from graspnerf_tpu import config as JC
from graspnerf_tpu import models as M
from graspnerf_tpu.models import nn_blocks as JB
from graspnerf_tpu.ops.fused_gather import (fused_epipolar_gather,
                                            pack_feature_maps)
from graspnerf_tpu.ops.pallas.ibrnet_fuse import view_fuse as jax_view_fuse

from graspnerf_tpu_torch import config as TC
from graspnerf_tpu_torch import models as TM
from graspnerf_tpu_torch import train as TT
from graspnerf_tpu_torch.convert import flax_to_state_dict
from graspnerf_tpu_torch.models import nn_blocks as TB
from graspnerf_tpu_torch.ops import geometry as TG
from graspnerf_tpu_torch.ops.epipolar_gather import (epipolar_gather,
                                                     epipolar_gather_plain)
from graspnerf_tpu_torch.ops.view_fuse import (BF16_BIAS_N,
                                               pack_weights_bf16, view_fuse,
                                               view_fuse_plain)

from ref_harness import rand_cameras
from test_fused_gather import _mk
from test_torch_models import (V, _fuse_inputs, graspnerf_params,
                               read_bf16_pack, sub)
from _torch_util import one_thread  # noqa: F401  (autouse)

BF = torch.bfloat16
JBF = jnp.bfloat16
H, W = 32, 64
RN, DN, FDN, RES = 8, 8, 8, 8
CFG = {"depth_sample_num": DN, "fine_depth_sample_num": FDN,
       "volume_resolution": RES, "use_depth_loss": False}
FUSE_OUT = ("feat_const", "num_valid", "x", "vis")


def ulp(scale: float) -> float:
    """One bfloat16 ulp at the magnitude `scale`: 2^-7 of its binade."""
    return 2.0 ** (np.floor(np.log2(scale)) - 7)


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def within(got, want, ulps: float, what: str = ""):
    """|got - want| <= ulps bfloat16 ulps of want's largest magnitude."""
    got, want = f32(got), f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= ulps * ulp(scale), (what, err, ulps * ulp(scale), scale)


def _params():
    """graspnerf_params() copied, with fine_agg_net's SDF output kernel
    scaled as agg_net's is there (test_torch_render.py)."""
    params = jax.tree_util.tree_map(np.array, graspnerf_params())
    params["nr_net"]["fine_agg_net"]["agg_impl"]["out_geometry_fc.1"][
        "kernel"] *= 0.05
    return params


def _torch(tree):
    return {k: _torch(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


# ------------------------------------------------------------- kernels
def _fuse_weights_jax(agg):
    names = ("ray_dir_fc", "neuray_fc", "base_fc", "vis_fc", "vis_fc2")
    return tuple((agg[n][i]["kernel"], agg[n][i]["bias"])
                 for n in names for i in ("0", "2"))


@pytest.fixture(scope="module")
def fuse_run():
    """The Pallas kernel's bfloat16 instance (interpret mode, jitted) and
    the port's bfloat16 plain version (and wrapper) on N = 512 rows."""
    agg = sub(graspnerf_params(), "nr_net", "agg_net", "agg_impl")
    wj = _fuse_weights_jax(agg)
    inputs = _fuse_inputs(np.random.RandomState(3), 512)
    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(lambda ins, w: jax_view_fuse(*ins, w, JBF))(
            tuple(jnp.asarray(x, JBF) for x in inputs), wj)
    wt = [(torch.from_numpy(k.T.copy()), torch.from_numpy(b)) for k, b in wj]
    ins = [torch.from_numpy(x).to(BF) for x in inputs]
    return {"want": want, "plain": view_fuse_plain(*ins, wt, BF),
            "wrapper": view_fuse(*ins, wt, BF),
            "split": fuse_from_pack_bf16(*ins, pack_weights_bf16(wt))}


def fuse_from_pack_bf16(rgbf, neur, rdiff, mask, pack):
    """The bfloat16 view fuse computed as csrc/view_fuse_bf16.cu computes
    it, in plain PyTorch from the kernel's weight pack: each operand rounded
    to bfloat16 and zero-padded to its block's K, float32 products and
    bias; base_fc.0 as its gf block once per row (plus the bias) plus the
    per-view block on [rf | 0 | neur]."""
    blocks, bias = read_bf16_pack(pack)
    bias = torch.split(bias, BF16_BIAS_N)

    def lin(x, block, layer):
        k = blocks[block].shape[0]
        x = torch.nn.functional.pad(x.to(BF).float(), (0, k - x.shape[-1]))
        return x @ blocks[block] + bias[layer]

    def mean_var(x, w):
        mean = (x * w).sum(0)
        return mean, (w * (x - mean) ** 2).sum(0)

    elu = torch.nn.functional.elu
    rgbf, neur, rdiff, mask = (t.float() for t in (rgbf, neur, rdiff, mask))
    nv = mask.sum(0)
    weight = mask / (nv + 1e-8)
    rf = rgbf + elu(lin(elu(lin(rdiff, 0, 0)), 1, 1))[..., :35]
    w0 = torch.sigmoid(lin(elu(lin(neur, 2, 2)), 3, 3)[..., :1]) * weight
    gf = torch.cat([*mean_var(rf, w0), *mean_var(rf, weight)], -1)
    per_view = torch.cat([rf, rf.new_zeros(*rf.shape[:2], 13), neur], -1)
    h = lin(gf, 4, 4)[None] + per_view.to(BF).float() @ blocks[5]
    x = elu(lin(elu(h), 6, 5))
    xv = elu(lin(elu(lin(x * weight, 7, 6)), 8, 7))
    x = x + xv[..., :32]
    vis = torch.sigmoid(xv[..., 32:33]) * mask
    vis = torch.sigmoid(lin(elu(lin(x * vis, 9, 8)), 10, 9)[..., :1]) * mask
    w2 = vis / (vis.sum(0, keepdim=True) + 1e-8)
    fc = torch.cat([*mean_var(x, w2), w2.mean(0)], -1)
    return fc.to(BF), nv, x.to(BF), vis.to(BF)


@pytest.mark.parametrize("i", range(4), ids=FUSE_OUT)
def test_view_fuse_bf16_plain_matches_pallas_kernel(fuse_run, i):
    """num_valid exact; feat_const, x and vis within 1 ulp of each
    output's scale; their dtypes the kernel's (bfloat16, num_valid
    float32). On CPU tensors the wrapper is the plain version."""
    got, want = fuse_run["plain"][i], fuse_run["want"][i]
    assert torch.equal(got, fuse_run["wrapper"][i])
    if FUSE_OUT[i] == "num_valid":
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(f32(got), f32(want))
        return
    assert got.dtype == BF and want.dtype == JBF
    within(got, want, 1, FUSE_OUT[i])


@pytest.mark.parametrize("i", range(4), ids=FUSE_OUT)
def test_view_fuse_bf16_kernel_split_matches(fuse_run, i):
    """The kernel's way of computing (its weight pack, padded operands,
    base_fc.0 split into a gf block per row and a per-view block), in plain
    PyTorch: num_valid exact; feat_const, x and vis within 1 ulp of each
    output's scale of the plain version and of the Pallas kernel (the split
    changes only float32 summation order, which can flip one operand's
    bfloat16 rounding, as between the plain version and the kernel)."""
    got = fuse_run["split"][i]
    for ref in (fuse_run["plain"][i], fuse_run["want"][i]):
        if FUSE_OUT[i] == "num_valid":
            np.testing.assert_array_equal(f32(got), f32(ref))
        else:
            within(got, ref, 1, FUSE_OUT[i])


@pytest.mark.parametrize("case", ["border", "all_valid"])
def test_gather_bf16_plain_matches_fused_gather(case):
    """The gather's plain version on bfloat16 maps == `fused_epipolar_gather`
    on `pack_feature_maps(..., bfloat16)`: rgb_feats rounded to bfloat16,
    ray_feats the float32 blend, as JAX returns it; within 1 bfloat16 ulp
    of each value, zero where invalid (test_fused_gather.py's border
    cases: taps across the edge, the half-pixel band, points far outside)."""
    imgs, img_f, ray_f, xy, valid = _mk(np.random.RandomState(4), V=3, C=8)
    if case == "all_valid":
        valid = np.ones_like(valid)
    h, w = imgs.shape[1:3]
    packed = pack_feature_maps(jnp.asarray(imgs), jnp.asarray(img_f),
                               jnp.asarray(ray_f), JBF)
    rgb, gi, gr = jax.jit(lambda p, c, v: fused_epipolar_gather(
        p, c, v, h, w))(packed, jnp.asarray(xy), jnp.asarray(valid))
    maps = [torch.from_numpy(m).to(BF) for m in (imgs, img_f, ray_f)]
    args = (*maps, torch.from_numpy(xy), torch.from_numpy(valid > 0))
    got = epipolar_gather_plain(*args)
    for g, k, dtype in zip(got, epipolar_gather(*args), (BF, torch.float32)):
        assert g.dtype == dtype and torch.equal(g, k)
    want = (np.concatenate([f32(rgb), f32(gi)], -1), f32(gr))
    for g, w_ in zip(got, want):
        g = f32(g)
        tol = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w_), 1e-30))) - 7)
        assert (np.abs(g - w_) <= tol).all(), float(np.abs(g - w_).max())
        assert (g[valid == 0] == 0).all()


# ------------------------------------------------------------- modules
def _imgs(seed=1):
    return np.random.RandomState(seed).rand(V, H, W, 3).astype(np.float32)


def _blocks():
    """(name, flax params, JAX block, port block, input channels, h, w):
    one block of each kind of the encoders, on the shipped weights' paths."""
    nr = graspnerf_params()["nr_net"]
    enc = nr["image_encoder"]
    return (
        ("basic_block", enc["layer1.0"], JB.BasicBlock(32, 2, True, dtype=JBF),
         TB.BasicBlock(16, 32, 2, True, BF), 16, 16, 32),
        ("residual_block", nr["init_net"]["out_conv.1"],
         JB.ResidualBlock(32, dtype=JBF), TB.ResidualBlock(32, 32, BF), 32, 8,
         16),
        ("conv_in_elu", enc["iconv3"], JB.ConvINElu(64, 3, dtype=JBF),
         TB.ConvINElu(128, 64, 3, dtype=BF), 128, 8, 16),
        ("upconv", enc["upconv3"], JB.UpConv(64, 3, dtype=JBF),
         TB.UpConv(128, 64, dtype=BF), 128, 4, 8))


@pytest.mark.parametrize("i", range(4), ids=(
    "basic_block", "residual_block", "conv_in_elu", "upconv"))
def test_encoder_blocks_bf16_match_jax(i):
    """One block of each kind (conv, InstanceNorm with float32 statistics,
    ReLU / ELU, the downsample and residual adds, the float32 upsampling)
    in bfloat16: within 4 ulps of the output's scale (measured 1-2)."""
    name, params, jm, tm, cin, h, w = _blocks()[i]
    x = np.random.RandomState(i).randn(V, h, w, cin).astype(np.float32)
    want = jax.jit(lambda p, x: jm.apply({"params": p}, x))(params,
                                                            jnp.asarray(x))
    tm.load_state_dict(flax_to_state_dict(params), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.dtype == BF and want.dtype == JBF
    within(got, want, 4, name)


@pytest.fixture(scope="module")
def encoders():
    """encode_views of JAX (jitted) and of the port, each in float32 and in
    bfloat16: {(side, dtype): (img_feats, ray_feats)}."""
    params = sub(graspnerf_params(), "nr_net")
    imgs = _imgs()
    out = {}
    for dtype in ("float32", "bfloat16"):
        fm = M.NeuralRayRenderer(compute_dtype=dtype)
        out["jax", dtype] = jax.jit(lambda p, x: fm.apply(
            {"params": p}, {"imgs": x},
            method=lambda m, r: m.encode_views(r)))(params, jnp.asarray(imgs))
        tm = TM.NeuralRayRenderer(compute_dtype=dtype)
        tm.load_state_dict(flax_to_state_dict(params), strict=True)
        with torch.no_grad():
            out["port", dtype] = tm.eval().encode_views(
                torch.from_numpy(imgs))
    return out


@pytest.mark.parametrize("i", range(2), ids=("img_feats", "ray_feats"))
def test_encoders_bf16_match_jax(encoders, i):
    """The three encoders in bfloat16, outputs cast back to float32. With
    random weights ~20 layers of InstanceNorm over a few pixels magnify one
    rounding into ~10 % of the scale in either library, so the port's
    bfloat16 output is held to JAX's statistically: its max and mean
    distance from JAX's bfloat16 output at most 1.5 x JAX's own distance
    from float32 (the blocks above hold each layer to a few ulps)."""
    got = f32(encoders["port", "bfloat16"][i])
    want = f32(encoders["jax", "bfloat16"][i])
    ref = f32(encoders["jax", "float32"][i])
    assert encoders["port", "bfloat16"][i].dtype == torch.float32
    np.testing.assert_allclose(f32(encoders["port", "float32"][i]), ref,
                               atol=1e-4)
    gap, own = np.abs(got - want), np.abs(want - ref)
    assert gap.max() <= 1.5 * own.max(), (gap.max(), own.max())
    assert gap.mean() <= 1.5 * own.mean(), (gap.mean(), own.mean())


def test_dist_decoder_bf16_matches_jax():
    """The three heads and predict_mean in bfloat16 Linears, softplus and
    sigmoid in float32: within 2 ulps of each output's scale."""
    params = sub(graspnerf_params(), "nr_net", "dist_decoder")
    feats = np.random.RandomState(5).randn(V, 1, 5, 7, 32).astype(np.float32)
    fm = M.MixtureLogisticsDistDecoder(dtype=JBF)
    mean, var, _, aw = fm.apply({"params": params}, jnp.asarray(feats))
    mean_only = fm.apply({"params": params}, jnp.asarray(feats),
                         method=fm.predict_mean)
    tm = TM.MixtureLogisticsDistDecoder(dtype=BF)
    tm.load_state_dict(flax_to_state_dict(params), strict=True)
    with torch.no_grad():
        got = (*tm(torch.from_numpy(feats)),
               tm.predict_mean(torch.from_numpy(feats)))
    for g, w_ in zip(got, (mean, var, aw, mean_only)):
        assert g.dtype == torch.float32
        within(g, w_, 2)


def _agg_inputs(rng, R=5, D=8):
    prj = {"ray_feats": rng.randn(V, 1, R, D, 32),
           "hit_prob": rng.rand(V, 1, R, D, 1),
           "vis": rng.rand(V, 1, R, D, 1),
           "dir": rng.randn(V, 1, R, D, 3) * 0.3,
           "rgb": rng.rand(V, 1, R, D, 3),
           "img_feats": rng.randn(V, 1, R, D, 32)}
    mask = (rng.rand(V, 1, R, D, 1) > 0.3)
    mask[:, 0, 0, :3] = False        # samples seen by no view
    mask[1:, 0, 1, :3] = False       # by one view
    prj["mask"] = mask
    prj = {k: v.astype(np.float32) for k, v in prj.items()}
    que_dir = rng.randn(1, R, D, 3)
    que_dir /= np.linalg.norm(que_dir, axis=-1, keepdims=True)
    pts = (rng.rand(1, R, D, 3) - 0.5) * 0.4
    dists = rng.uniform(0.005, 0.02, (1, R, D))
    return prj, *(x.astype(np.float32) for x in (que_dir, pts, dists))


@pytest.fixture(scope="module")
def aggregator():
    """NeusAggregationNet in bfloat16, render path (∇sdf, colours, alpha)
    and volume path (SDF alone): JAX with the Pallas kernel (interpret
    mode; the view fuse computes what its bfloat16 instance computes) and
    the port."""
    params = sub(_params(), "nr_net", "agg_net")
    prj, que_dir, pts, dists = _agg_inputs(np.random.RandomState(6))
    fm = M.NeusAggregationNet(dtype=JBF, use_pallas=True)

    def run(p, prj, que_dir, pts, dists):
        out = fm.apply({"params": p}, prj, que_dir, pts, dists)
        vol = fm.apply({"params": p}, prj, que_dir, pts, None)
        return out, vol["sdf"]

    with pltpu.force_tpu_interpret_mode():
        want, want_vol = jax.jit(run)(params, jax.tree_util.tree_map(
            jnp.asarray, prj), *map(jnp.asarray, (que_dir, pts, dists)))
    tm = TM.NeusAggregationNet(dtype=BF)
    tm.load_state_dict(flax_to_state_dict(params), strict=True)
    tprj = _torch(prj)
    tprj["rgb_feats"] = torch.cat([tprj.pop("rgb"), tprj.pop("img_feats")],
                                  -1).to(BF)
    tprj["ray_feats"] = tprj["ray_feats"].to(BF)
    tprj["mask"] = tprj["mask"].float()
    args = [torch.from_numpy(x) for x in (que_dir, pts)]
    with torch.no_grad():
        got = tm.eval()(tprj, *args, torch.from_numpy(dists))
        got_vol = tm.sdf(tprj, *args)
    return got, want, got_vol, want_vol


# (key, ulps of its scale): ∇sdf and alpha go through the geometry head's
# backward and the NeuS sigmoid (inv_s = e^3), each a few more roundings
AGG_KEYS = (("sdf", 4), ("colors", 2), ("grad", 4), ("alpha", 4))


@pytest.mark.parametrize("key,ulps", AGG_KEYS, ids=[k for k, _ in AGG_KEYS])
def test_aggregator_bf16_matches_jax(aggregator, key, ulps):
    """The prob embedding, the view fuse, the geometry head with the
    attention and its ∇sdf, the colour blend, the NeuS alpha, in bfloat16
    against JAX's with the Pallas kernel; float32 outputs."""
    got, want = aggregator[0][key], aggregator[1][key]
    assert got.dtype == torch.float32
    within(got, want, ulps, key)


def test_aggregator_bf16_volume_path_matches_jax(aggregator):
    """The volume path's SDF (no ∇sdf), within 4 ulps of its scale; unseen
    samples exactly 1."""
    got, want = aggregator[2], aggregator[3]
    within(got, want, 4)
    assert (f32(got)[0, 0, :3] == 1.0).all()


def test_vgn_head_bf16_matches_jax():
    """Grasp head at res 16 in bfloat16 Conv3d (JAX sums k z-shifted 2D
    convolutions, each rounded, the port one 3D convolution); qual, rot and
    width float32, within 4 ulps of each one's scale."""
    params = sub(graspnerf_params(), "vgn_net")
    vol = np.random.RandomState(7).uniform(-1, 1, (1, 16, 16, 16, 1)).astype(
        np.float32)
    want = jax.jit(lambda p, v: M.VGNConvNet(dtype=JBF).apply(
        {"params": p}, v))(params, jnp.asarray(vol))
    tm = TM.VGNConvNet(BF)
    tm.load_state_dict(flax_to_state_dict(params), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(vol))
    for g, w_, name in zip(got, want, ("qual", "rot", "width")):
        assert g.dtype == torch.float32
        within(g, w_, 4, name)


# ------------------------------------------------------------ the path
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
           "Ks": Ks[V:], "depth_range": dr}
    return {"ref": ref, "que": que}


def _jax_forward(params, data, fine_depth, dtype):
    """The JAX GraspNeRF forward in `dtype` (default path) and its fine pass
    again at `fine_depth` (the port's fine samples)."""
    cfg = dict(CFG, compute_dtype=dtype)
    jm = M.GraspNeRF(renderer_cfg=cfg)
    out = jm.apply({"params": params}, data, train=False)
    ref, que = data["ref"], data["que"]

    def fine_pass(m):
        feats = m.nr_net.encode_views(ref)
        packed = pack_feature_maps(ref["imgs"], *feats, jnp.dtype(dtype))
        return m.nr_net.render_by_depth(fine_depth, que, ref, *feats, True,
                                        False, packed)

    return out, jm.apply({"params": params}, method=fine_pass)


@pytest.fixture(scope="module")
def path():
    """GraspNeRF.forward in bfloat16 (render and volume), JAX's default
    path and the port's, and the port's float32 volume."""
    params = _params()
    data = _scene()
    sd = flax_to_state_dict(params)
    model = TM.load_graspnerf(sd, "cpu", dict(CFG, compute_dtype="bfloat16"))
    with torch.no_grad():
        got = model(_torch(data))
        got32 = TM.load_graspnerf(sd, "cpu", CFG)(_torch(data))["volume"]
    dr = torch.from_numpy(data["que"]["depth_range"])
    fine_depth = torch.sort(TG.sample_fine_depth(
        TG.sample_depth(dr, RN, DN), got["hit_prob_nr"], dr, FDN), -1).values
    want, want_fine = jax.jit(_jax_forward, static_argnums=3)(
        params, jax.tree_util.tree_map(jnp.asarray, data),
        jnp.asarray(fine_depth.numpy()), "bfloat16")
    return {"got": got, "got32": got32, "want": want,
            "want_fine": want_fine}


def test_bf16_volume_matches_jax(path):
    """The port's bfloat16 volume against JAX's bfloat16 default path:
    within the gap between JAX's own two bfloat16 paths (max 0.023, mean
    0.003 on test_bf16.py's volume)."""
    got, want = f32(path["got"]["volume"]), f32(path["want"]["volume"])
    assert path["got"]["volume"].dtype == torch.float32
    err = np.abs(got - want)
    assert err.max() < 0.023, err.max()
    assert err.mean() < 0.003, err.mean()


RENDER_KEYS = ("colors_nr", "pixel_colors_nr", "sdf_values", "alpha_values",
               "hit_prob_nr", "render_depth")


@pytest.mark.parametrize("key", RENDER_KEYS)
def test_bf16_render_matches_jax(path, key):
    """A render's coarse pass, and its fine pass at equal fine samples,
    against JAX's bfloat16 default path: within the two JAX paths' volume
    gap (max 0.023). JAX's default path rounds every layer's output of the
    view fuse, the port the Pallas kernel's operands; ray masks exact."""
    got, want = path["got"], path["want"]
    for g, w_ in ((got[key], want[key]), (got[key + "_fine"],
                                          path["want_fine"][key])):
        assert g.dtype == torch.float32
        err = np.abs(f32(g) - f32(w_))
        assert err.max() < 0.023, (key, err.max())
    np.testing.assert_array_equal(got["ray_mask"].numpy(),
                                  np.asarray(want["ray_mask"]))


def test_bf16_volume_tracks_fp32(path):
    """The port's bfloat16 volume against its float32 one on the same
    weights, within test_bf16.py's bounds."""
    diff = np.abs(f32(path["got"]["volume"]) - f32(path["got32"]))
    assert diff.max() < 0.15, diff.max()
    assert diff.mean() < 0.05, diff.mean()


# ------------------------------------------------------- configuration
def test_one_state_dict_serves_both_dtypes():
    """Parameters stay float32: the same state dict loads strictly into a
    float32 and a bfloat16 GraspNeRF, and both give it back unchanged."""
    sd = flax_to_state_dict(graspnerf_params())
    for dtype in ("float32", "bfloat16"):
        model = TM.GraspNeRF({"compute_dtype": dtype})
        model.load_state_dict(sd, strict=True)
        back = model.state_dict()
        assert set(back) == set(sd)
        assert all(back[k].dtype == torch.float32 and torch.equal(back[k],
                                                                  sd[k])
                   for k in sd)


def test_config_maps_compute_dtype_as_jax():
    """compute_dtype maps as graspnerf_tpu.config maps it; the renderer
    refuses other dtypes; the train step takes bfloat16 (since its
    backward was ported) and refuses other dtypes."""
    for dtype in ("float32", "bfloat16"):
        cfg = {"compute_dtype": dtype, "volume_resolution": 8}
        assert TC.renderer_cfg_from(cfg) == JC.renderer_cfg_from(cfg)
        assert TM.NeuralRayRenderer(**TC.renderer_cfg_from(cfg)).dtype == {
            "float32": torch.float32, "bfloat16": BF}[dtype]
    with pytest.raises(ValueError, match="float16"):
        TM.NeuralRayRenderer(compute_dtype="float16")
    state = TT.create_train_state(
        TM.GraspNeRF({"compute_dtype": "bfloat16"}), device="cpu")
    TT.make_train_step(state)
    with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
        TT.check_trainable("float16")
