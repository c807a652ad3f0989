"""The gather's gradient with respect to xy (B'-xy) on the CPU: the plain
version `epipolar_gather_backward_xy_plain` against JAX's VJP of
`fused_epipolar_gather` with respect to xy (the xy cotangent of `_feg_bwd`,
graspnerf_tpu/ops/fused_gather.py:268) on float32 and
`pack_feature_maps(..., bfloat16)` maps, against autograd through the plain
gather on float32 maps, and `torch.autograd.grad` through
`epipolar_gather` on the CPU in both dtypes. The CUDA kernel that
`epipolar_gather_backward_xy` launches on the card is held to the same
plain version by chip_smoke.py.

Layouts (one shape, so JAX compiles once per dtype): random points, a
third of them outside the image; taps clamped at every border (xi = -1,
w-1; yi = -1, h-1, and past them) on both maps, where an axis' derivative
is 0; invalid points, some far outside; points on the full-res and
quarter-res pixel grids, where floor takes the right-hand taps.

Tolerance: 1e-5 of each layout's largest |d_xy| against JAX (the sums over
channels and taps run in another order, and XLA's CPU backend divides by
the constant extent through its reciprocal); 1e-6 of it against autograd,
which adds the same products in another order. On the grid layout the
derivative has a kink at each point: floor picks one side of it, and XLA
computes the tap coordinates in another order (it folds `x / (w - 1) * 2`,
the `- 1 + 1` and the map's extent into one constant factor, and contracts
a product and a sum into one FMA), which picks the other side at some
points. There JAX's value is the port's one-sided derivative from the other
side: the port's at xy moved at most KINK_ULPS float32 ulps, where its taps
change (ROADMAP Queue 3 item 8). Every other point is held to JAX within
1e-5 of the scale.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graspnerf_tpu.ops.fused_gather import (fused_epipolar_gather,
                                            pack_feature_maps)
from graspnerf_tpu_torch.ops import epipolar_gather as EG
from _torch_util import one_thread  # noqa: F401  (autouse)

V, H, W, C, P = 2, 64, 96, 8, 400
FH, FW = H // 4, W // 4
F32 = np.float32
JAX_RTOL, AUTOGRAD_RTOL = 1e-5, 1e-6
KINK_ULPS = 8
LAYOUTS = ("random", "border", "invalid")   # and "grid", at kinks apart


def layout(name, rng):
    xy = np.stack([rng.uniform(-20, W + 12, (V, P)),
                   rng.uniform(-12, H + 8, (V, P))], -1).astype(F32)
    valid = rng.rand(V, P) > 0.1
    if name == "border":
        xs = [-3.0, -1.9, -0.2, 0.0, 0.7, W - 1.3, W - 0.7, W + 0.4, W + 3.0]
        ys = [-3.0, -1.9, -0.2, 0.0, 0.6, H - 1.2, H - 0.7, H + 0.4, H + 3.0]
        pts = [(x, y) for x in xs for y in ys]
        xy[:, :len(pts)] = pts
        xy[:, 100:140, 1] = -5.0        # above the top row
        xy[:, 140:180, 0] = W + 9.0     # right of the last column
        valid[:, :180] = True
    elif name == "invalid":
        valid = rng.rand(V, P) > 0.4
        xy[:, ::7] = [-500.0, 900.0]
    elif name == "grid":
        # full-res pixel centres, and coordinates on the quarter-res grid
        # (q an integer: x = (2k + 1) / (2 fw) * (w - 1))
        xy[:, :100] = np.stack([rng.randint(0, W, (V, 100)),
                                rng.randint(0, H, (V, 100))], -1)
        k = rng.randint(0, FW, (V, 100))
        xy[:, 100:200, 0] = (2 * k + 1) / (2 * FW) * (W - 1)
    return xy.astype(F32), valid


def inputs(name, seed=0):
    rng = np.random.RandomState(seed)
    imgs = rng.rand(V, H, W, 3).astype(F32)
    f1 = rng.randn(V, FH, FW, C).astype(F32)
    f2 = rng.randn(V, FH, FW, C).astype(F32)
    xy, valid = layout(name, rng)
    d_rgb = rng.randn(V, P, 3 + C).astype(F32)
    d_ray = rng.randn(V, P, C).astype(F32)
    return imgs, f1, f2, xy, valid, d_rgb, d_ray


def _jax_vjp_xy(dtype):
    """JAX's VJP of the fused gather with respect to xy, on maps packed in
    `dtype`, jitted (once for each dtype)."""
    def vjp(a, b, c, xy, valid, cot):
        packed = pack_feature_maps(a, b, c, dtype)
        return jax.vjp(lambda p: fused_epipolar_gather(
            packed, p, valid.astype(jnp.float32), H, W), xy)[1](cot)[0]
    return jax.jit(vjp)


@pytest.fixture(scope="module")
def jax_vjps():
    return {"float32": _jax_vjp_xy(jnp.float32),
            "bfloat16": _jax_vjp_xy(jnp.bfloat16)}


def port(args, dtype):
    """The port's tensors: maps in `dtype`, d_rgb in it too (the dtype of
    rgb_feats), d_ray float32."""
    imgs, f1, f2, xy, valid, d_rgb, d_ray = (torch.from_numpy(a)
                                             for a in args)
    dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return (imgs.to(dt), f1.to(dt), f2.to(dt), xy, valid, d_rgb.to(dt),
            d_ray)


def jax_d_xy(jax_vjps, args, dtype):
    """JAX's d_xy on the same values: the bfloat16 case's d_rgb rounded to
    bfloat16 as the port's gather output's gradient is."""
    imgs, f1, f2, xy, valid, d_rgb, d_ray = args
    if dtype == "bfloat16":
        d_rgb = torch.from_numpy(d_rgb).bfloat16().float().numpy()
    cot = (d_rgb[..., :3], d_rgb[..., 3:], d_ray)
    return np.asarray(jax_vjps[dtype](imgs, f1, f2, xy, valid, cot))


def assert_close(got, want, rtol, what):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), what)
    ok = ~np.isnan(want)
    scale = np.abs(want[ok]).max()
    err = np.abs(got[ok] - want[ok]).max()
    assert err <= rtol * scale, (what, err, scale)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("name", LAYOUTS)
def test_plain_matches_jax_vjp(name, dtype, jax_vjps):
    args = inputs(name)
    got = EG.epipolar_gather_backward_xy_plain(*port(args, dtype))
    assert got.dtype == torch.float32 and got.shape == (V, P, 2)
    want = jax_d_xy(jax_vjps, args, dtype)
    assert np.isfinite(want).all()
    assert_close(got.numpy(), want, JAX_RTOL, f"{name} {dtype}")
    if name == "border":   # both taps of an axis clamped: exactly 0
        clamped = got[:, 100:180].numpy()
        assert (clamped[:, :40, 1] == 0).all()   # y above the top row
        assert (clamped[:, 40:, 0] == 0).all()   # x right of the image
        assert (clamped[:, :40, 0] != 0).any()   # x free


def taps(xy):
    """The tap floors of the plain version's arithmetic at xy [..., 2]: the
    quarter-res x and y, the full-res x and y."""
    t = torch.from_numpy(xy)
    xn = t[..., 0] / t.new_tensor(W - 1) * 2 - 1
    yn = t[..., 1] / t.new_tensor(H - 1) * 2 - 1
    return torch.stack([((xn + 1.0) * FW - 1.0) * 0.5,
                        ((yn + 1.0) * FH - 1.0) * 0.5,
                        (xn + 1.0) * 0.5 * (W - 1),
                        (yn + 1.0) * 0.5 * (H - 1)], -1).floor().numpy()


def moved(a, k):
    """a (float32) moved k ulps."""
    for _ in range(abs(k)):
        a = np.nextafter(a, np.float32(np.inf if k > 0 else -np.inf))
    return a


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_grid_matches_jax_but_at_kinks(dtype, jax_vjps):
    """The grid layout against JAX's VJP: within JAX_RTOL of the scale at
    every point but those on a kink, and there JAX's value is the port's
    taken with the other tap pair: at xy moved (kx, ky) ulps, |k| <=
    KINK_ULPS, where a tap floor changes."""
    args = inputs("grid")
    imgs, f1, f2, xy, valid, d_rgb, d_ray = port(args, dtype)
    got = EG.epipolar_gather_backward_xy_plain(imgs, f1, f2, xy, valid,
                                               d_rgb, d_ray).numpy()
    want = jax_d_xy(jax_vjps, args, dtype)
    scale = np.abs(want).max()
    off = (np.abs(got - want) > JAX_RTOL * scale).any(-1)
    assert not off[:, 200:].any(), "a point off the grids differs"
    ks = range(-KINK_ULPS, KINK_ULPS + 1)
    pairs = [(kx, ky) for kx in ks for ky in ks if kx or ky]
    for v in range(V):
        pts = np.nonzero(off[v])[0]
        if not len(pts):
            continue
        base = args[3][v, pts]
        cand = np.stack([np.stack([moved(base[:, 0], kx),
                                   moved(base[:, 1], ky)], -1)
                         for kx, ky in pairs], 1)        # [n, pairs, 2]
        n, m = cand.shape[:2]
        rep = torch.from_numpy(np.repeat(pts, m))
        at = EG.epipolar_gather_backward_xy_plain(
            imgs[v:v + 1], f1[v:v + 1], f2[v:v + 1],
            torch.from_numpy(cand.reshape(1, n * m, 2)), valid[v:v + 1, rep],
            d_rgb[v:v + 1, rep], d_ray[v:v + 1, rep]).numpy().reshape(n, m, 2)
        agrees = (np.abs(at - want[v, pts][:, None]) <= JAX_RTOL * scale
                  ).all(-1)
        kink = (taps(cand) != taps(base)[:, None]).any(-1)
        assert (agrees & kink).any(1).all(), (
            f"{dtype} view {v}: points {pts[~(agrees & kink).any(1)]} differ "
            f"from JAX and not at a kink")


@pytest.mark.parametrize("name", LAYOUTS + ("grid",))
def test_plain_matches_autograd_through_plain_gather(name):
    imgs, f1, f2, xy, valid, d_rgb, d_ray = port(inputs(name), "float32")
    xy = xy.clone().requires_grad_()
    outs = EG._plain(imgs, f1, f2, xy, valid)
    want, = torch.autograd.grad(outs, xy, (d_rgb, d_ray))
    got = EG.epipolar_gather_backward_xy_plain(imgs, f1, f2, xy, valid,
                                               d_rgb, d_ray)
    assert_close(got, want, AUTOGRAD_RTOL, name)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_non_finite_upstream_at_invalid_points(dtype, jax_vjps):
    """inf or NaN upstream at an invalid point: NaN in both of that point's
    coordinates (JAX's g * 0), finite everywhere else."""
    args = list(inputs("invalid", seed=1))
    valid, d_rgb, d_ray = args[4], args[5].copy(), args[6].copy()
    bad = np.argwhere(~valid)[:6]
    d_rgb[bad[0, 0], bad[0, 1], 1] = np.inf      # an image channel
    d_rgb[bad[1, 0], bad[1, 1], 5] = -np.inf     # img_feats
    d_ray[bad[2, 0], bad[2, 1], 2] = np.nan      # ray_feats
    args[5], args[6] = d_rgb, d_ray
    got = EG.epipolar_gather_backward_xy_plain(*port(args, dtype)).numpy()
    want = jax_d_xy(jax_vjps, args, dtype)
    nan = np.zeros((V, P), bool)
    nan[bad[:3, 0], bad[:3, 1]] = True
    assert (np.isnan(want).all(-1) == nan).all()
    assert_close(got, want, JAX_RTOL, dtype)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_autograd_grad_through_epipolar_gather(dtype):
    """`torch.autograd.grad(outputs, xy)` through the wrapper on the CPU,
    with no map requiring a gradient and with all three: xy's gradient is
    the plain version's (autograd through the plain gather in float32, the
    plain backward in bfloat16), the maps' as before."""
    imgs, f1, f2, xy, valid, d_rgb, d_ray = port(inputs("random", 2), dtype)
    want = EG.epipolar_gather_backward_xy_plain(imgs, f1, f2, xy, valid,
                                                d_rgb, d_ray)
    rtol = 0.0 if dtype == "bfloat16" else AUTOGRAD_RTOL
    xy = xy.clone().requires_grad_()
    got, = torch.autograd.grad(EG.epipolar_gather(imgs, f1, f2, xy, valid),
                               xy, (d_rgb, d_ray))
    assert_close(got, want, rtol, f"{dtype} xy alone")
    maps = [t.clone().requires_grad_() for t in (imgs, f1, f2)]
    grads = torch.autograd.grad(EG.epipolar_gather(*maps, xy, valid),
                                [*maps, xy], (d_rgb, d_ray))
    assert_close(grads[3], want, rtol, f"{dtype} with the maps")
    shapes = (imgs.shape, f1.shape)
    maps_want = EG.epipolar_gather_backward_plain(
        *shapes, xy, valid, d_rgb, d_ray, True, imgs.dtype)
    for g, w in zip(grads[:3], maps_want):
        assert_close(g.float(), w.float(), AUTOGRAD_RTOL, f"{dtype} maps")
