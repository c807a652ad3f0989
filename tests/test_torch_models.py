"""Port modules (graspnerf_tpu_torch.models, ops/view_fuse.py, convert.py)
against their JAX counterparts on the CPU, at small sizes.

Weights: one random flax param tree of the JAX GraspNeRF, made from a seeded
numpy generator over the tree's shapes (`jax.eval_shape`, no flax init run),
goes to JAX as is and to the port through `convert.flax_to_state_dict`.

Tolerances: both sides compute in float32 (JAX at matmul precision
'highest', see conftest.py). They differ only in summation order and in the
library's transcendental functions, which gives errors of a few float32 ulps
of the values' magnitude per layer. The stated atols allow for that growth
through the layers of each module; num_valid is a count and is held exactly.
"""
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from graspnerf_tpu import models as M
from graspnerf_tpu.ops.pallas.ibrnet_fuse import view_fuse_reference

from graspnerf_tpu_torch import models as TM
from graspnerf_tpu_torch.convert import flax_to_state_dict
from graspnerf_tpu_torch.ops.view_fuse import (BF16_BIAS_N, BF16_BLOCKS,
                                               LAYER_DIMS, PACK_BF16_ELEMS,
                                               PACK_FLOATS, _packed,
                                               pack_weights, pack_weights_bf16,
                                               view_fuse, view_fuse_plain)
from _torch_util import one_thread  # noqa: F401  (autouse)

V, H, W = 6, 64, 96


def _ref_shapes(h=H, w=W):
    f = jax.ShapeDtypeStruct
    ref = {"imgs": f((V, h, w, 3), jnp.float32), "poses": f((V, 3, 4), jnp.float32),
           "Ks": f((V, 3, 3), jnp.float32), "depth_range": f((V, 2), jnp.float32),
           "bbox3d_min": f((3,), jnp.float32)}
    que = {"coords": f((1, 4, 2), jnp.float32), "poses": f((1, 3, 4), jnp.float32),
           "Ks": f((1, 3, 3), jnp.float32), "depth_range": f((1, 2), jnp.float32)}
    return {"ref": ref, "que": que}


@functools.lru_cache(maxsize=1)
def graspnerf_params(seed: int = 0):
    """Random numpy param tree of the JAX GraspNeRF (render path included,
    so the tree is the full one a checkpoint holds). Kernels N(0, 1/fan_in),
    biases N(0, 0.1^2), norm scales 1 + N(0, 0.1^2); the grasp head's width
    bias is 4 so that widths fall in process()'s [1.33, 9.33] window."""
    model = M.GraspNeRF(renderer_cfg={"volume_resolution": 8,
                                      "use_depth_loss": False})
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), _ref_shapes())
    rng = np.random.RandomState(seed)

    def make(path, s):
        leaf = path[-1].key
        if leaf == "kernel":
            return (rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))
                    ).astype(np.float32)
        if leaf == "scale":
            return (1 + 0.1 * rng.randn(*s.shape)).astype(np.float32)
        if leaf == "variance":
            return np.asarray(0.3, np.float32)
        return (0.1 * rng.randn(*s.shape)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(make, shapes["params"])
    params = jax.tree_util.tree_map(np.asarray, params)
    params["vgn_net"]["conv_width"]["bias"] = np.full((1,), 4.0, np.float32)
    # keep the SDF inside (-1, 1) rather than clipped, so that the volume
    # carries the error of the whole chain and has voxels of both signs
    params["nr_net"]["agg_net"]["agg_impl"]["out_geometry_fc.1"]["kernel"] *= 0.05
    return params


def sub(tree, *path):
    for k in path:
        tree = tree[k]
    return tree


def load(module, params):
    module.load_state_dict(flax_to_state_dict(params), strict=True)
    return module.eval()


def close(got, want, atol, rtol=0.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


def test_convert_full_tree_loads_strict():
    """The JAX GraspNeRF tree converts to exactly the port's key set, with
    every tensor in torch layout."""
    params = graspnerf_params()
    sd = flax_to_state_dict(params)
    model = TM.GraspNeRF()
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    k = params["nr_net"]["image_encoder"]["conv1"]["kernel"]   # [kh,kw,I,O]
    close(model.nr_net.image_encoder.conv1.weight, k.transpose(3, 2, 0, 1), 0)
    k = params["vgn_net"]["encoder.conv1"]["kernel"]        # [kd,kh,kw,I,O]
    close(model.vgn_net.encoder.conv1.weight, k.transpose(4, 3, 0, 1, 2), 0)
    k = params["nr_net"]["agg_net"]["agg_impl"]["base_fc"]["0"]["kernel"]
    close(model.nr_net.agg_net.agg_impl.base_fc[0].weight, k.T, 0)


def test_encoders_match_jax(rng):
    """encode_views: ResUNetLight, RayFeatInitNet, VisEncoder. atol 1e-4:
    ~20 conv + InstanceNorm layers at unit scale."""
    params = sub(graspnerf_params(), "nr_net")
    imgs = rng.rand(V, H, W, 3).astype(np.float32)
    fm = M.NeuralRayRenderer()
    img_j, ray_j = jax.jit(lambda p, x: fm.apply(
        {"params": p}, {"imgs": x},
        method=lambda m, r: m.encode_views(r)))(params, jnp.asarray(imgs))
    tm = TM.NeuralRayRenderer()
    tm.load_state_dict(flax_to_state_dict(params), strict=True)
    with torch.no_grad():
        img_t, ray_t = tm.eval().encode_views(torch.from_numpy(imgs))
    assert img_t.shape == (V, H // 4, W // 4, 32)
    close(img_t, img_j, 1e-4)
    close(ray_t, ray_j, 1e-4)


def test_dist_decoder_and_compute_prob_match_jax(rng):
    params = sub(graspnerf_params(), "nr_net", "dist_decoder")
    feats = rng.randn(V, 1, 5, 7, 32).astype(np.float32)
    depth = rng.uniform(0.1, 1.0, (V, 1, 5, 7)).astype(np.float32)
    dr = np.tile(np.array([[0.2, 0.8]], np.float32), (V, 1))
    fm = M.MixtureLogisticsDistDecoder()
    mean, var, vis, aw = fm.apply({"params": params}, jnp.asarray(feats))
    want = M.compute_prob(jnp.asarray(depth), None, mean, var, vis, aw,
                          jnp.asarray(dr), fixed_interval=True)
    tm = load(TM.MixtureLogisticsDistDecoder(), params)
    with torch.no_grad():
        m_t, v_t, a_t = tm(torch.from_numpy(feats))
        got = TM.compute_prob(torch.from_numpy(depth), m_t, v_t, a_t,
                              torch.from_numpy(dr))
    for g, w in zip((m_t, v_t, a_t), (mean, var, aw)):
        close(g, w, 1e-5)
    close(got[1], want[1], 1e-5)   # visibility
    close(got[2], want[2], 1e-5)   # hit_prob
    # alpha = log(hit / (vis - hit + eps)): the difference of two CDFs near 1
    # cancels, so its error is relative to the log-odds, up to ~1e-4
    close(got[0], want[0], 1e-5, 1e-4)


def _fuse_inputs(rng, N):
    rgbf = rng.rand(V, N, 35).astype(np.float32)
    neur = rng.rand(V, N, 32).astype(np.float32)
    diff = (rng.rand(V, N, 4) - 0.5).astype(np.float32)
    mask = (rng.rand(V, N, 1) > 0.3).astype(np.float32)
    mask[:, :3] = 0.0    # rows seen by no view
    mask[1:, 3:6] = 0.0  # rows seen by one view
    return rgbf, neur, diff, mask


def test_view_fuse_plain_matches_reference(rng):
    """The kernel's plain version == view_fuse_reference (the Pallas
    kernel's oracle, held equal to it by test_pallas_fuse.py). The wrapper
    takes the plain path on CPU tensors."""
    agg = sub(graspnerf_params(), "nr_net", "agg_net", "agg_impl")
    inputs = _fuse_inputs(rng, 200)
    names = ("ray_dir_fc", "neuray_fc", "base_fc", "vis_fc", "vis_fc2")
    wj = tuple((agg[n][i]["kernel"], agg[n][i]["bias"])
               for n in names for i in ("0", "2"))
    want = view_fuse_reference(*map(jnp.asarray, inputs),
                               tuple((jnp.asarray(k), jnp.asarray(b))
                                     for k, b in wj))
    wt = [(torch.from_numpy(k.T.copy()), torch.from_numpy(b)) for k, b in wj]
    ins = [torch.from_numpy(x) for x in inputs]
    got = view_fuse(*ins, wt)
    for g, p in zip(got, view_fuse_plain(*ins, wt)):
        assert torch.equal(g, p)
    close(got[1], want[1], 0)          # num_valid: exact
    for i in (0, 2, 3):
        close(got[i], want[i], 2e-5)


def test_pack_weights_round_trip(rng):
    """pack_weights' buffer, unpacked by the LAYER_DIMS offsets, gives back
    every weight ([I][O4], transposed) and bias with zeros in the padding,
    and its length is the PACK_FLOATS the wrapper holds the kernel to."""
    pairs = [(torch.from_numpy(rng.randn(o, i).astype(np.float32)),
              torch.from_numpy(rng.randn(o).astype(np.float32)))
             for i, o in LAYER_DIMS]
    pack = pack_weights(pairs)
    assert pack.shape == (PACK_FLOATS,) and pack.dtype == torch.float32
    off = 0
    for (w, _), (i, o) in zip(pairs, LAYER_DIMS):
        o4 = -(-o // 4) * 4
        block = pack[off:off + i * o4].reshape(i, o4)
        assert torch.equal(block[:, :o], w.t())
        assert not block[:, o:].any()
        off += i * o4
    for (_, b), (i, o) in zip(pairs, LAYER_DIMS):
        o4 = -(-o // 4) * 4
        assert torch.equal(pack[off:off + o], b)
        assert not pack[off + o:off + o4].any()
        off += o4
    assert off == PACK_FLOATS


def test_pack_kept_until_weights_change(rng):
    """The wrapper keeps the packed weights between calls, and packs again
    when a weight changes in place or is another tensor."""
    pairs = [(torch.from_numpy(rng.randn(o, i).astype(np.float32)),
              torch.from_numpy(rng.randn(o).astype(np.float32)))
             for i, o in LAYER_DIMS]
    cpu = torch.device("cpu")
    first = _packed(pairs, cpu)
    assert _packed(pairs, cpu) is first
    with torch.no_grad():
        pairs[4][0].mul_(2.0)
    changed = _packed(pairs, cpu)
    assert changed is not first
    assert torch.equal(changed, pack_weights(pairs))
    copies = [(w.clone(), b.clone()) for w, b in pairs]
    again = _packed(copies, cpu)
    assert again is not changed and torch.equal(again, changed)


def read_bf16_pack(pack):
    """pack_weights_bf16's buffer read as csrc/view_fuse_bf16.cu reads it:
    in block b (K x N), element ((s * N/8 + j) * 32 + 4g + t) * 4 + e is
    the m16n8k16 B fragment's W[16s + 2t + e % 2 + 8 (e // 2)][8j + g].
    Returns the dense [K][N] blocks (float32) and the float32 biases."""
    blocks, off = [], 0
    for _, _, k, n in BF16_BLOCKS:
        s, j, g, t, e = np.meshgrid(np.arange(k // 16), np.arange(n // 8),
                                    np.arange(8), np.arange(4), np.arange(4),
                                    indexing="ij")
        rows = (16 * s + 2 * t + e % 2 + 8 * (e // 2)).ravel()
        dense = torch.zeros(k, n)
        dense[rows, (8 * j + g).ravel()] = pack[off:off + k * n].float()
        blocks.append(dense)
        off += k * n
    return blocks, pack[off:].view(torch.float32)


def test_pack_weights_bf16_round_trip(rng):
    """pack_weights_bf16's buffer, read in the kernel's fragment order,
    gives every weight rounded to bfloat16 bit for bit (transposed, K and N
    zero-padded; base_fc.0 as its gf block, input channels 0..139, and its
    per-view block, rf channels at k 0..34 and neur at k 48..79) and every
    bias in float32, and its length is the PACK_BF16_ELEMS the wrapper
    holds the kernel library to."""
    pairs = [(torch.from_numpy(rng.randn(o, i).astype(np.float32)),
              torch.from_numpy(rng.randn(o).astype(np.float32)))
             for i, o in LAYER_DIMS]
    pack = pack_weights_bf16(pairs)
    assert pack.shape == (PACK_BF16_ELEMS,) and pack.dtype == torch.bfloat16
    blocks, biases = read_bf16_pack(pack)
    wt = [w.to(torch.bfloat16).float().t() for w, _ in pairs]     # [I][O]
    (b0, b1, b2, b3, gf, per_view, b5, b6, b7, b8, b9) = blocks
    for blk, layer in zip((b0, b1, b2, b3, b5, b6, b7, b8, b9),
                          (0, 1, 2, 3, 5, 6, 7, 8, 9)):
        i, o = LAYER_DIMS[layer]
        assert torch.equal(blk[:i, :o], wt[layer])
        assert not blk[i:].any() and not blk[:, o:].any()
    assert torch.equal(torch.cat([gf[:140], per_view[:35], per_view[48:]]),
                       wt[4])
    assert not gf[140:].any() and not per_view[35:48].any()
    off = 0
    for (_, b), n in zip(pairs, BF16_BIAS_N):
        assert torch.equal(biases[off:off + b.numel()], b)
        assert not biases[off + b.numel():off + n].any()
        off += n
    assert off == biases.numel()


def test_pack_kept_per_dtype(rng):
    """The wrapper keeps one pack per dtype, each the packer's for its
    dtype, and packs both again when a weight changes in place."""
    pairs = [(torch.from_numpy(rng.randn(o, i).astype(np.float32)),
              torch.from_numpy(rng.randn(o).astype(np.float32)))
             for i, o in LAYER_DIMS]
    cpu, bf = torch.device("cpu"), torch.bfloat16

    def bits(t):   # the bf16 pack's bias bytes may read as NaNs
        return t.view(torch.int16) if t.dtype == bf else t

    first = {dt: _packed(pairs, cpu, dt) for dt in (torch.float32, bf)}
    assert torch.equal(bits(first[bf]), bits(pack_weights_bf16(pairs)))
    for dt in (torch.float32, bf):
        assert _packed(pairs, cpu, dt) is first[dt]
    with torch.no_grad():
        pairs[7][0].add_(1.0)
    for dt, packer in ((torch.float32, pack_weights),
                       (bf, pack_weights_bf16)):
        again = _packed(pairs, cpu, dt)
        assert again is not first[dt]
        assert torch.equal(bits(again), bits(packer(pairs)))
        assert _packed(pairs, cpu, dt) is again


def test_ibrnet_sdf_rgb_match_jax(rng):
    """IBRNetNeus sdf and rgb; its third output, ∇sdf, is held in
    test_torch_render.py."""
    params = sub(graspnerf_params(), "nr_net", "agg_net", "agg_impl")
    R, D = 5, 8
    rgbf, neur, diff, mask = _fuse_inputs(rng, R * D)
    pts = ((rng.rand(1, R, D, 3) - 0.5) * 0.4).astype(np.float32)
    args = (rgbf, neur, diff, mask, pts)
    rgb_j, sdf_j, _ = jax.jit(lambda p, *a: M.IBRNetNeus().apply(
        {"params": p}, *a, (R, D)))(params, *map(jnp.asarray, args))
    tm = load(TM.IBRNetNeus(), params)
    with torch.no_grad():
        rgb_t, sdf_t, _ = tm(*map(torch.from_numpy, args), (R, D))
    close(sdf_t, sdf_j, 2e-5)
    close(rgb_t, rgb_j, 2e-5)
    assert (sdf_t.reshape(-1)[:3] == 1.0).all()   # unseen rows: sdf = 1


def test_vgn_head_matches_jax(rng):
    """Grasp head at res 16 (encoder 16->8->4->2, nearest back to 4/8/16)."""
    params = sub(graspnerf_params(), "vgn_net")
    vol = rng.uniform(-1, 1, (1, 16, 16, 16, 1)).astype(np.float32)
    want = jax.jit(lambda p, v: M.VGNConvNet().apply({"params": p}, v))(
        params, jnp.asarray(vol))
    with torch.no_grad():
        got = load(TM.VGNConvNet(), params)(torch.from_numpy(vol))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        close(g, w, 2e-5)
