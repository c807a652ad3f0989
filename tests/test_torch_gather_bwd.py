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
- the pull: each tile's list in chunks (the bfloat16 instance's pipelined
  pull: chunks of kChunk entries, the list cut into ranges of at most
  kSplit chunks, a work item each; the float32 instance's block-synchronous
  pull: chunks of kSyncChunk, the whole list), each chunk sorted stably by
  anchor cell in the tile's region (the tile and its top and left halo),
  each cell's sum over the four anchor cells that can reach it, (y-1,x-1),
  (y-1,x), (y,x-1), (y,x), each tap attributed by its computed target, in
  `splat`'s order of multiplies, accumulated in float32 from 0 in each
  range; the ranges' sums added in range order (0, 1, ...);
- invalid points left out of the lists (their contribution g * 0 is zero),
  except that a non-finite upstream value at one makes the cells its taps
  reach NaN in that channel (the kernel flags the view and sets those
  NaNs; the model keeps such a point in its lists and sums its g * 0, which
  gives the same NaNs);
- every cell written once (cells no tap reaches are 0).
It runs at the instance's chunk and split sizes, at a small chunk, and at a
small chunk with ranges of one chunk, so that long lists go through
several chunks and several ranges.

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

bfloat16 maps (`_feg_bwd` on `pack_feature_maps(..., bfloat16)`): each
point's contribution to a cell is its upstream value times the cell's
folded tap weight, rounded to bfloat16; a cell sums them in float32 and is
rounded once. The plain bfloat16 backward, the model of the kernel's
bfloat16 instance and JAX's VJP are held to each other bit for bit, but
for at most BF16_ULP_SHARE of the values, which may differ by one
bfloat16 ulp of the cell's sum of |contributions| where a float32 sum of
bfloat16 values runs in another order, and against JAX by two: XLA's CPU
backend divides by the constant extent (w - 1) through its reciprocal,
the port and the kernel in IEEE division, so some coordinates differ by a
float32 ulp; 1 - w turns that into a larger relative error of a small tap
weight, and now and then a contribution rounds to the neighbouring
bfloat16 value, one of them in a higher binade than the cell's sum (2
ulps measured on the ragged layout). Upstream: d_rgb bfloat16-valued (the
gather's bfloat16 output), d_ray float32 (the ray features' two consumers
add their gradients in float32).
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
from _torch_util import one_thread  # noqa: F401  (autouse)

SRC = (pathlib.Path(EG.__file__).resolve().parents[1] / "csrc"
       / "epipolar_gather.cu").read_text()


def _const(name):
    return int(re.search(rf"\b{name} = (\d+)", SRC).group(1))


TILE_Y, TILE_X = _const("kTileY"), _const("kTileX")
CHUNK, SPLIT = _const("kChunk"), _const("kSplit")
SYNC_CHUNK, WHOLE = _const("kSyncChunk"), 1 << 20   # float32: whole lists
V, H, W, C, P = 2, 64, 96, 8, 333
FH, FW = H // 4, W // 4
F32 = np.float32
BF16_ULP_SHARE, JAX_ULPS = 5e-3, 2


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


def bf16(x):
    """float32 values rounded to the nearest bfloat16, as float32."""
    return torch.from_numpy(np.asarray(x, F32)).to(torch.bfloat16).float(
        ).numpy()


def pull_add_bf16(acc, g, a, p, kY, kX):
    """`pull_entry_bf16`: one entry's contribution to a cell its taps land
    on, g*m times the cell's folded weight, rounded to bfloat16."""
    dy, dx = a["dy"][p], a["dx"][p]
    if kY > dy or kX > dx:
        return
    rw = (a["owy"][p] if dy else a["owy"][p] + a["wy"][p]) if kY == 0 \
        else a["wy"][p]
    cw = (a["owx"][p] if dx else a["owx"][p] + a["wx"][p]) if kX == 0 \
        else a["wx"][p]
    with np.errstate(invalid="ignore"):
        acc += bf16(g * a["m"][p] * (rw * cw))


def model_backward(xy, valid, d_rgb, d_ray, chunk=None, dtype="float32",
                   split=None):
    """(d_img_feats, d_ray_feats) [V,FH,FW,C] as the kernel computes them,
    a tile's list in ranges of `split` chunks of `chunk` entries (by
    default the instance's own); dtype "bfloat16": as its bfloat16 instance
    does, rounded to bfloat16 (an invalid point with a non-finite upstream
    value makes its whole window NaN in that channel)."""
    bf = dtype == "bfloat16"
    chunk = chunk or (CHUNK if bf else SYNC_CHUNK)
    split = split or (SPLIT if bf else WHOLE)
    add = pull_add_bf16 if dtype == "bfloat16" else pull_add
    out = np.full((2, V, FH, FW, C), np.nan, F32)
    for v in range(V):
        a = anchors(xy[v], valid[v])
        rows = (d_rgb[v, :, 3:], d_ray[v])
        lists = tile_lists(a, rows)
        for ty in range(-(-FH // TILE_Y)):
            for tx in range(-(-FW // TILE_X)):
                ty0, tx0 = ty * TILE_Y, tx * TILE_X
                lst = lists.get((ty, tx), [])
                step = chunk * split
                total = None
                for r0 in range(0, max(len(lst), 1), step):   # the ranges
                    acc = np.zeros((2, TILE_Y, TILE_X, C), F32)
                    _pull_range(acc, lst[r0:r0 + step], chunk, a, rows,
                                ty0, tx0, add)
                    total = acc if total is None else total + acc
                hy, hx = min(TILE_Y, FH - ty0), min(TILE_X, FW - tx0)
                out[:, v, ty0:ty0 + hy, tx0:tx0 + hx] = total[:, :hy, :hx]
        if dtype == "bfloat16":   # the NaN path's windows
            for p in np.flatnonzero(a["m"] == 0):
                y0, x0 = min(a["y"][p], FH - 2), min(a["x"][p], FW - 2)
                for m in range(2):
                    bad = ~np.isfinite(rows[m][p])
                    out[m, v, y0:y0 + 2, x0:x0 + 2, bad] = np.nan
    assert not np.isnan(out).all(axis=-1).any()   # every cell written
    if dtype == "bfloat16":
        out = bf16(out)
    return out[0], out[1]


def _pull_range(acc, lst, chunk, a, rows, ty0, tx0, add):
    """One work item: its entries chunk by chunk into acc."""
    for b in range(0, len(lst), chunk):
        ent = np.asarray(lst[b:b + chunk])
        key = (a["y"][ent] - ty0 + 1) * (TILE_X + 1) + a["x"][ent] - tx0 + 1
        assert ((0 <= key) & (key < (TILE_Y + 1) * (TILE_X + 1))).all()
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
                            add(acc[m, ly, lx], rows[m][p], a, p, kY, kX)


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


def _jax_vjp(dtype, h=H, w=W):
    """JAX's VJP of the fused gather with respect to the three maps, packed
    in `dtype`, jitted (once for each shape): maps' gradients in float32."""
    def gather(a, b, c, xy, valid):
        return fused_epipolar_gather(pack_feature_maps(a, b, c, dtype), xy,
                                     valid.astype(jnp.float32), h, w)

    def vjp(maps, xy, valid, cot):
        return jax.vjp(lambda *m: gather(*m, xy, valid), *maps)[1](cot)
    return jax.jit(vjp)


@pytest.fixture(scope="module")
def jax_vjp():
    return _jax_vjp(jnp.float32)


@pytest.fixture(scope="module")
def jax_vjp_bf16():
    return _jax_vjp(jnp.bfloat16)


def assert_bf16_equal(got, want, scale, what="", ulps=1):
    """Bit for bit (NaN where the other is NaN), but for at most
    BF16_ULP_SHARE of the values, within `ulps` bfloat16 ulps of `scale`
    (each cell's sum of |contributions|) there."""
    got, want = np.asarray(got, F32), np.asarray(want, F32)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), what)
    ok = ~np.isnan(want)
    got, want, scale = got[ok], want[ok], np.asarray(scale, F32)[ok]
    big = np.maximum(np.maximum(np.abs(got), np.abs(want)), scale)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(big, 1e-38))) - 7)
    differ = got != want
    assert (np.abs(got - want)[differ] <= ulps * ulp[differ]).all(), (
        what, float((np.abs(got - want) / ulp).max()))
    assert differ.mean() <= BF16_ULP_SHARE, (what, differ.mean())


# (layout, split): the instance's own split (the layout's name alone), and
# ranges of one chunk of 16
SPLITS = ([(n, None) for n in LAYOUTS] + [(n, 1) for n in LAYOUTS])
SPLIT_IDS = [*LAYOUTS, *(f"{n}-S1" for n in LAYOUTS)]


def _chunks(split, chunk, own):
    """(chunk, split) pairs a model test runs: the instance's chunk and
    split `own`, and a chunk of 16 with it (split None); or ranges of
    `split` chunks of 16."""
    return ((chunk, own), (16, own)) if split is None else ((16, split),)


def _assert_ranges(name, xy, valid, split):
    """At one chunk of 16 a range, one_cell's longest list spans several."""
    if name == "one_cell" and split == 1:
        lists = tile_lists(anchors(xy[0], valid[0]))
        assert max(len(lst) for lst in lists.values()) > 2 * 16


@pytest.mark.parametrize("name,split", SPLITS, ids=SPLIT_IDS)
def test_pull_model_matches_plain_and_jax_vjp(name, split, jax_vjp):
    """The float32 instance's algorithm (the model, at its chunk, whole
    lists, and at a chunk of 16, or at ranges of one chunk of 16) against
    the plain backward and JAX's VJP, 1e-5; the lists hold every (point,
    tile) pair its taps make, once."""
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
    _assert_ranges(name, xy, valid, split)
    for chunk, s in _chunks(split, SYNC_CHUNK, WHOLE):
        got = model_backward(xy, valid, d_rgb, d_ray, chunk, split=s)
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


# ------------------------------------------------------- bfloat16 maps
def _bf16_upstream(rng, n=P, c=C):
    """d_rgb [V,n,3+c] bfloat16-valued, d_ray [V,n,c] float32."""
    return (bf16(rng.randn(V, n, 3 + c)),
            rng.randn(V, n, c).astype(F32))


def _plain_bf16(xy, valid, d_rgb, d_ray, h=H, w=W, c=C):
    return EG.epipolar_gather_backward_plain(
        (V, h, w, 3), (V, h // 4, w // 4, c), torch.from_numpy(xy),
        torch.from_numpy(valid), torch.from_numpy(d_rgb).to(torch.bfloat16),
        torch.from_numpy(d_ray), True, torch.bfloat16)


def _want_bf16(jax_vjp_bf16, xy, valid, d_rgb, d_ray, h=H, w=W, c=C):
    maps = (jnp.zeros((V, h, w, 3)), jnp.zeros((V, h // 4, w // 4, c)),
            jnp.zeros((V, h // 4, w // 4, c)))
    return [np.asarray(g) for g in jax_vjp_bf16(
        maps, jnp.asarray(xy), jnp.asarray(valid),
        (jnp.asarray(d_rgb[..., :3]), jnp.asarray(d_rgb[..., 3:]),
         jnp.asarray(d_ray)))]


@pytest.mark.parametrize("name,split", SPLITS, ids=SPLIT_IDS)
def test_pull_model_bf16_matches_plain_and_jax_vjp(name, split,
                                                    jax_vjp_bf16):
    """The bfloat16 instance's algorithm (the model, at its chunk and split
    and at a chunk of 16, or at ranges of one chunk of 16), the plain
    bfloat16 backward and JAX's VJP on
    bfloat16-packed maps agree bit for bit (or one bfloat16 ulp where a
    float32 sum runs in another order); the plain version's image
    gradient (8-slot full-res weights) too."""
    rng = np.random.RandomState(10 + LAYOUTS.index(name))
    xy, valid = layout(name, rng)
    d_rgb, d_ray = _bf16_upstream(rng)
    plain, scale = ([t.float().numpy() for t in _plain_bf16(xy, valid, r, a)]
                    for r, a in ((d_rgb, d_ray),
                                 (np.abs(d_rgb), np.abs(d_ray))))
    want = _want_bf16(jax_vjp_bf16, xy, valid, d_rgb, d_ray)
    for p, w, a, what in zip(plain, want, scale,
                             ("imgs", "img_feats", "ray_feats")):
        assert_bf16_equal(p, w, a, f"plain {what}", JAX_ULPS)
    _assert_ranges(name, xy, valid, split)
    for chunk, s in _chunks(split, CHUNK, SPLIT):
        got = model_backward(xy, valid, d_rgb, d_ray, chunk, "bfloat16", s)
        for g, p, a, what in zip(got, plain[1:], scale[1:],
                                 ("img_feats", "ray_feats")):
            assert_bf16_equal(g, p, a, f"model {what} chunk {chunk} "
                              f"split {s}")


def test_pull_model_bf16_non_finite_upstream_like_plain(jax_vjp_bf16):
    """Non-finite upstream at invalid points on bfloat16 maps: in the model
    and the plain version NaN in every cell of the point's window in that
    channel (`_interp_from_win`'s VJP multiplies g * 0 by the window's zero
    weights too), elsewhere as before. JAX's one-hot splat then spreads
    each NaN to every cell of that view and channel (0 x NaN in the
    product): its NaNs cover the port's, and the other values agree."""
    rng = np.random.RandomState(8)
    xy, valid = layout("invalid", rng)
    d_rgb, d_ray = _bf16_upstream(rng)
    p = int(np.flatnonzero(~valid[1])[3])
    d_rgb[1, p, 5] = np.inf
    d_ray[1, p, 2] = np.nan
    q = int(np.flatnonzero(~valid[0] & (xy[0, :, 0] < 0))[0])  # clamped
    d_ray[0, q, 0] = -np.inf
    plain = [t.float().numpy() for t in _plain_bf16(xy, valid, d_rgb, d_ray)]
    scale = [np.abs(t.float().numpy()) for t in _plain_bf16(
        xy, valid, np.abs(d_rgb), np.abs(d_ray))]
    want = _want_bf16(jax_vjp_bf16, xy, valid, d_rgb, d_ray)
    got = model_backward(xy, valid, d_rgb, d_ray, dtype="bfloat16")
    for g, pl, w, a, what in zip(got, plain[1:], want[1:], scale[1:],
                                 ("img_feats", "ray_feats")):
        assert np.isnan(g).any()
        assert not (np.isnan(pl) & ~np.isnan(w)).any()
        assert np.isnan(w).all(axis=(1, 2)).any()   # a whole view channel
        both = ~np.isnan(w)
        assert_bf16_equal(pl[both], w[both], a[both], f"plain {what}",
                          JAX_ULPS)
        assert_bf16_equal(g, pl, a, f"model {what}")
    assert np.isnan(got[1][0, :, :, 0]).sum() == 4   # the whole window


# Queue 3 item 1 (ROADMAP), the reproduction: 2 views of 6 x 8 maps, C = 8
RH, RW, RC = 24, 32, 8


def _repro_layout(name, rng):
    """A: 300 points uniform over the image +- 2 px (borders clamped); B:
    2,000 points in a 4 x 3-pixel patch (a pile on a few cells)."""
    if name == "A":
        n = 300
        xy = np.stack([rng.uniform(-2, RW + 1, (V, n)),
                       rng.uniform(-2, RH + 1, (V, n))], -1)
        valid = rng.rand(V, n) > 0.1
    else:
        n = 2000
        xy = np.stack([rng.uniform(13, 17, (V, n)),
                       rng.uniform(9, 12, (V, n))], -1)
        valid = np.ones((V, n), bool)
    return xy.astype(F32), valid


@pytest.mark.parametrize("name", ("A", "B"))
def test_bf16_gather_gradient_matches_feg_bwd(name):
    """The gather on bfloat16 maps that require a gradient (the CPU path,
    through autograd): the maps' gradients equal JAX's VJP of
    `fused_epipolar_gather` on `pack_feature_maps(..., bfloat16)` maps bit
    for bit, or within one bfloat16 ulp where a float32 sum runs in
    another order (torch.gather's backward used to add every tap into the
    bfloat16 map, 1.5-3 x JAX's own bfloat16-to-float32 gap)."""
    rng = np.random.RandomState(20 + (name == "B"))
    xy, valid = _repro_layout(name, rng)
    n = xy.shape[1]
    d_rgb, d_ray = _bf16_upstream(rng, n, RC)
    maps = [torch.from_numpy(rng.randn(V, *s).astype(F32)).to(
        torch.bfloat16).requires_grad_()
        for s in ((RH, RW, 3), (RH // 4, RW // 4, RC), (RH // 4, RW // 4, RC))]
    rgb, ray = EG.epipolar_gather(*maps, torch.from_numpy(xy),
                                  torch.from_numpy(valid))
    assert rgb.dtype == torch.bfloat16 and ray.dtype == torch.float32
    torch.autograd.backward(
        [rgb, ray], [torch.from_numpy(d_rgb).to(torch.bfloat16),
                     torch.from_numpy(d_ray)])
    want = _want_bf16(_jax_vjp(jnp.bfloat16, RH, RW), xy, valid, d_rgb,
                      d_ray, RH, RW, RC)
    scale = [t.float().numpy() for t in _plain_bf16(
        xy, valid, np.abs(d_rgb), np.abs(d_ray), RH, RW, RC)]
    for m, w, a, what in zip(maps, want, scale,
                             ("imgs", "img_feats", "ray_feats")):
        assert m.grad.dtype == torch.bfloat16
        assert_bf16_equal(m.grad.float().numpy(), w, a, what, JAX_ULPS)
