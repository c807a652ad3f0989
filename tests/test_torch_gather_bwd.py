"""The gather's backward kernel (csrc/epipolar_gather.cu, the pull) as an
algorithm, on the CPU: a numpy model of what its launches do, held against
the backward's plain version (autograd through the plain gather) and
against JAX's custom VJP of `fused_epipolar_gather` (`_feg_bwd` with
`_splat_windows`).

The model follows the kernel step by step, with the kernel's sizes read
from its source:
- the index: each point's anchor cell and tap steps as the forward's phase
  1 computes them (float32, IEEE division), the tiles of kTileY x kTileX
  cells its taps reach, and each tile's list in the order of the stable
  counting sort (rounds of 32 consecutive points, then slot, then lane);
- the pull: each tile's list in chunks of kChunk entries, each chunk sorted
  stably by anchor cell in the tile's region (the tile and its top and left
  halo), each cell's sum over the four anchor cells that can reach it,
  (y-1,x-1), (y-1,x), (y,x-1), (y,x), each tap attributed by its computed
  target, in `splat`'s order of multiplies, accumulated in float32;
- invalid points left out of the lists (their contribution g * 0 is zero),
  except that a non-finite upstream value at one makes the cells its taps
  reach NaN in that channel (the kernel flags the view and sets those
  NaNs; the model keeps such a point in its lists and sums its g * 0, which
  gives the same NaNs);
- every cell written once (cells no tap reaches are 0).
It runs at the kernel's chunk size and at a small one, so that long lists
go through several chunks.

Layouts (one shape, so JAX compiles once): random points; 40 points on one
cell at a tile corner; a planner-like z-column of consecutive points along
a short line; taps at the clamped borders (xi = -1, w-1; yi = -1, h-1);
invalid points, far outside too; a ragged tail (P = 333, not a multiple of
a round, its last points on tile edges).

Tolerance: 1e-5, as tests/test_torch_train.py's VJP test: the sums over a
map cell run in another order than autograd's and XLA's. Against JAX also
1e-5 of each cell's sum of |contributions| (chip_smoke.py's scale on the
card): where many border-clamped points pile onto one cell (sums up to ~6
here) the plain version itself differs from JAX's VJP by up to 1.3e-5,
and the model by 1e-6 from the plain version.
"""
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graspnerf_tpu.ops.fused_gather import (fused_epipolar_gather,
                                            pack_feature_maps)
from graspnerf_tpu_torch.ops import epipolar_gather as EG

SRC = (pathlib.Path(EG.__file__).resolve().parents[1] / "csrc"
       / "epipolar_gather.cu").read_text()


def _const(name):
    return int(re.search(rf"\b{name} = (\d+)", SRC).group(1))


TILE_Y, TILE_X = _const("kTileY"), _const("kTileX")
CHUNK = _const("kChunk")
V, H, W, C, P = 2, 64, 96, 8, 333
FH, FW = H // 4, W // 4
F32 = np.float32


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread (see test_torch_loop.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- the model
def anchors(xy, valid):
    """Per point of one view: anchor (y0, x0), tap steps (ddy, ddx), weights
    (wx, owx, wy, owy) and mask, as `anchor_of` computes them."""
    x, y = xy[:, 0], xy[:, 1]
    xn = x / F32(W - 1) * F32(2) - F32(1)
    yn = y / F32(H - 1) * F32(2) - F32(1)
    out = {}
    for n, size, k in ((xn, FW, "x"), (yn, FH, "y")):
        q = ((n + F32(1)) * F32(size) - F32(1)) * F32(0.5)
        f = np.floor(q)
        i = np.clip(f.astype(np.int64), -1, size - 1)
        i0 = np.maximum(i, 0)
        out[k] = i0
        out["d" + k] = np.minimum(i + 1, size - 1) - i0
        out["w" + k] = (q - f).astype(F32)
        out["ow" + k] = (F32(1) - out["w" + k]).astype(F32)
    out["m"] = valid.astype(F32)
    return out


def tile_lists(a, rows=None):
    """{tile (ty, tx): point indices}, each list in the fill pass's order;
    invalid points whose upstream rows are all finite left out."""
    entries = []
    for p in range(len(a["x"])):
        if rows is not None and not a["m"][p] and all(
                np.isfinite(r[p]).all() for r in rows):
            continue
        y0, x0 = a["y"][p], a["x"][p]
        ty, tx = y0 // TILE_Y, x0 // TILE_X
        ty1, tx1 = (y0 + a["dy"][p]) // TILE_Y, (x0 + a["dx"][p]) // TILE_X
        slots = [(ty, tx), (ty, tx1) if tx1 != tx else None,
                 (ty1, tx) if ty1 != ty else None,
                 (ty1, tx1) if tx1 != tx and ty1 != ty else None]
        for s, tile in enumerate(slots):
            if tile is not None:   # round, then slot, then lane
                entries.append((tile, (p // 32, s, p % 32), p))
    lists = {}
    for tile, _, p in sorted(entries, key=lambda e: (e[0], e[1])):
        lists.setdefault(tile, []).append(p)
    return lists


def pull_add(acc, g, a, p, kY, kX):
    """`pull_entry`: one entry's contributions to a cell, in splat's
    order."""
    with np.errstate(invalid="ignore"):   # inf * 0, as on the card
        gm = g * a["m"][p]
    for hit, wr in ((kY == 0, a["owy"][p]), (a["dy"][p] == kY, a["wy"][p])):
        if hit:
            r = gm * wr
            if kX == 0:
                acc += r * a["owx"][p]
            if a["dx"][p] == kX:
                acc += r * a["wx"][p]


def model_backward(xy, valid, d_rgb, d_ray, chunk=CHUNK):
    """(d_img_feats, d_ray_feats) [V,FH,FW,C] as the kernel computes them."""
    out = np.full((2, V, FH, FW, C), np.nan, F32)
    for v in range(V):
        a = anchors(xy[v], valid[v])
        rows = (d_rgb[v, :, 3:], d_ray[v])
        lists = tile_lists(a, rows)
        for ty in range(-(-FH // TILE_Y)):
            for tx in range(-(-FW // TILE_X)):
                ty0, tx0 = ty * TILE_Y, tx * TILE_X
                acc = np.zeros((2, TILE_Y, TILE_X, C), F32)
                lst = lists.get((ty, tx), [])
                for b in range(0, len(lst), chunk):
                    ent = np.asarray(lst[b:b + chunk])
                    key = ((a["y"][ent] - ty0 + 1) * (TILE_X + 1)
                           + a["x"][ent] - tx0 + 1)
                    assert ((0 <= key) & (key < (TILE_Y + 1) * (TILE_X + 1))
                            ).all()
                    seg = {}   # the chunk sorted stably by anchor key
                    for k, p in zip(key, ent):
                        seg.setdefault(int(k), []).append(int(p))
                    for ly in range(TILE_Y):
                        for lx in range(TILE_X):
                            for s in range(4):
                                kY, kX = int(s < 2), int(s % 2 == 0)
                                k = (ly + s // 2) * (TILE_X + 1) + lx + s % 2
                                for p in seg.get(k, ()):
                                    for m in range(2):
                                        pull_add(acc[m, ly, lx], rows[m][p],
                                                 a, p, kY, kX)
                hy, hx = min(TILE_Y, FH - ty0), min(TILE_X, FW - tx0)
                out[:, v, ty0:ty0 + hy, tx0:tx0 + hx] = acc[:, :hy, :hx]
    assert not np.isnan(out).all(axis=-1).any()   # every cell written
    return out[0], out[1]


# ------------------------------------------------------------ the layouts
def _pixel(cx, cy):
    """Full-res (x, y) that samples the quarter-res map at the centre of
    the square between cells (cx, cy) and (cx + 1, cy + 1)."""
    return (cx + 1.0) / FW * (W - 1), (cy + 1.0) / FH * (H - 1)


def layout(name, rng):
    xy = np.stack([rng.uniform(-6, W + 5, (V, P)),
                   rng.uniform(-6, H + 5, (V, P))], -1).astype(F32)
    valid = rng.rand(V, P) > 0.1
    if name == "one_cell":   # 40 points on cell (7, 7), a tile corner
        x, y = _pixel(TILE_X - 1, TILE_Y - 1)
        xy[:, 50:90] = np.stack([x + rng.uniform(-0.4, 0.4, (V, 40)),
                                 y + rng.uniform(-0.4, 0.4, (V, 40))], -1)
    elif name == "z_column":   # consecutive points creeping along a line
        k = np.arange(120)
        for v in range(V):
            xy[v, 100:220] = np.stack([30.3 + 0.11 * k + v,
                                       12.7 + 0.29 * k], -1)
    elif name == "border":   # xi = -1 and w-1, yi = -1 and h-1, and past
        xs = [-3.0, -1.9, -0.2, 0.0, W - 1.0, W - 0.7, W + 0.4, W + 3.0]
        ys = [-3.0, -1.9, -0.2, 0.0, H - 1.0, H - 0.7, H + 0.4, H + 3.0]
        pts = [(x, y) for x in xs for y in ys]
        xy[:, :len(pts)] = pts
        xy[:, 64:96] = np.stack([rng.uniform(-8, W + 8, (V, 32)),
                                 np.full((V, 32), -5.0)], -1)   # top row
        valid[:, :96] = True
    elif name == "invalid":   # 40 % invalid, some far outside
        valid = rng.rand(V, P) > 0.4
        xy[:, ::7] = [-500.0, 900.0]
    elif name == "ragged":   # the last partial round on tile edges
        x, y = _pixel(TILE_X - 1, TILE_Y)
        xy[:, P - P % 32:] = [x, y]
    return xy.astype(F32), valid


LAYOUTS = ("random", "one_cell", "z_column", "border", "invalid", "ragged")


@pytest.fixture(scope="module")
def jax_vjp():
    """JAX's VJP of the fused gather with respect to the three maps, jitted
    once for the layouts' common shape."""
    def gather(a, b, c, xy, valid):
        return fused_epipolar_gather(pack_feature_maps(a, b, c), xy,
                                     valid.astype(jnp.float32), H, W)

    def vjp(maps, xy, valid, cot):
        return jax.vjp(lambda *m: gather(*m, xy, valid), *maps)[1](cot)
    return jax.jit(vjp)


@pytest.mark.parametrize("name", LAYOUTS)
def test_pull_model_matches_plain_and_jax_vjp(name, jax_vjp):
    """The kernel's algorithm (the model, at the kernel's chunk and at a
    chunk of 16) against the plain backward and JAX's VJP, 1e-5; the lists
    hold every (point, tile) pair its taps make, once."""
    rng = np.random.RandomState(LAYOUTS.index(name))
    xy, valid = layout(name, rng)
    d_rgb = rng.randn(V, P, 3 + C).astype(F32)
    d_ray = rng.randn(V, P, C).astype(F32)
    shapes = ((V, H, W, 3), (V, FH, FW, C))
    plain, scale = (EG.epipolar_gather_backward_plain(
        *shapes, torch.from_numpy(xy), torch.from_numpy(valid),
        torch.from_numpy(r), torch.from_numpy(a))[1:]
        for r, a in ((d_rgb, d_ray), (np.abs(d_rgb), np.abs(d_ray))))
    maps = (jnp.zeros(shapes[0]), jnp.zeros(shapes[1]), jnp.zeros(shapes[1]))
    want = jax_vjp(maps, jnp.asarray(xy), jnp.asarray(valid),
                   (jnp.asarray(d_rgb[..., :3]), jnp.asarray(d_rgb[..., 3:]),
                    jnp.asarray(d_ray)))[1:]
    for chunk in (CHUNK, 16):
        got = model_backward(xy, valid, d_rgb, d_ray, chunk)
        for g, p, w, a in zip(got, plain, want, scale):
            np.testing.assert_allclose(g, p.numpy(), atol=1e-5, rtol=0)
            assert (np.abs(g - np.asarray(w)) <= 1e-5 + 1e-5 * a.numpy()).all()
    # every point is in the list of each tile its taps reach, once
    a = anchors(xy[0], valid[0])
    lists = tile_lists(a)
    for p in range(P):
        cells = {(a["y"][p] + dy, a["x"][p] + dx)
                 for dy in (0, a["dy"][p]) for dx in (0, a["dx"][p])}
        tiles = {(y // TILE_Y, x // TILE_X) for y, x in cells}
        assert tiles == {t for t, lst in lists.items() if p in lst}
        assert all(lists[t].count(p) == 1 for t in tiles)


def test_pull_model_keeps_non_finite_upstream_like_plain():
    """Invalid points stay in the lists: an infinite upstream value at an
    invalid point gives g * 0 = NaN at its taps' cells, as in the plain
    version, and only there."""
    rng = np.random.RandomState(7)
    xy, valid = layout("invalid", rng)
    d_rgb = rng.randn(V, P, 3 + C).astype(F32)
    d_ray = rng.randn(V, P, C).astype(F32)
    p = int(np.flatnonzero(~valid[1])[3])
    d_rgb[1, p, 5] = np.inf
    d_ray[1, p, 2] = -np.inf
    plain = EG.epipolar_gather_backward_plain(
        (V, H, W, 3), (V, FH, FW, C), torch.from_numpy(xy),
        torch.from_numpy(valid), torch.from_numpy(d_rgb),
        torch.from_numpy(d_ray))[1:]
    got = model_backward(xy, valid, d_rgb, d_ray)
    for g, w in zip(got, plain):
        assert np.isnan(g).any()
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w.numpy()))
        np.testing.assert_allclose(g, w.numpy(), atol=1e-5, rtol=0)
