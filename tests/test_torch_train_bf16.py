"""The port's bfloat16 train step against the JAX package's on the CPU
(`compute_dtype="bfloat16"`; JAX with `use_pallas=True`, the Pallas view
fuse in interpret mode): the dtype of the gradients reaching JAX's gather,
the whole training loss and every parameter's gradient, the float32 state
and `check_trainable`. The backward of single layers is
tests/test_torch_bf16_grads.py's, the entry script's bfloat16 steps
tests/test_torch_loop.py's (their own files, so that each stays under a
minute: the one jitted JAX value_and_grad here takes 30-42 s).

Size: test_torch_train.py's scene, weights, labels and draws (6 views of
64 x 96, 24 rays, 16 + 16 samples, an 8^3 volume, 256 depth-loss pixels, 5
grasps).

Tolerances. XLA's CPU backend evaluates the bfloat16 elementwise chain of
a fusion in float32 (excess precision) and divides by constants through
their reciprocals; PyTorch rounds each op. So the port cannot meet JAX's
bfloat16 step bit for bit, and it is held in units of JAX's own distance
between its bfloat16 and float32 steps: each loss within LOSS_GAP x that
gap (or LOSS_RTOL); each parameter's gradient above GRAD_FLOOR within
GRAD_GAP_MAX x JAX's own gap on that parameter and each group's median
within GRAD_GAP_MEDIAN (the exception to "at most 1 x", stated at
test_bf16_gradients_match_jax and in ROADMAP Queue 3, its cause shown by
test_torch_train_bf16_exact.py), while each group's median moves from the
port's float32 step by GRAD_MOVE_MEDIAN and along JAX's move (median
cosine GRAD_COS_MEDIAN), which a float32 step fails. The float32 side
of that gap is the port's float32 step at the same inputs and samples:
test_torch_train.py holds it to JAX's float32 step within 1e-2 of each
gradient's scale (3.4e-3 measured), and a second JAX compile would take
this file past a minute.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from graspnerf_tpu import models as M
from graspnerf_tpu.models import renderer as JR
from graspnerf_tpu.ops import geometry as G
from graspnerf_tpu.train import losses as JL
from graspnerf_tpu.train import trainer as JT

from graspnerf_tpu_torch import models as TM
from graspnerf_tpu_torch import train as TT
from graspnerf_tpu_torch.convert import flax_to_state_dict
from graspnerf_tpu_torch.models import renderer as TR
from graspnerf_tpu_torch.ops import geometry as TG
from graspnerf_tpu_torch.train import losses as TL

from test_torch_bf16_grads import FAST
from test_torch_models import V
from test_torch_render import RES, RN, _params, _torch
from test_torch_train import GRAD_FLOOR, KEY, TRAIN_CFG, _batch, _jax_draws
from _torch_util import one_thread  # noqa: F401  (autouse)

BF = torch.bfloat16
JBF = jnp.bfloat16
BF16_CFG = dict(TRAIN_CFG, compute_dtype="bfloat16")
# the whole step against JAX's bfloat16 step, in units of JAX's own
# bfloat16-to-float32 distance on the same loss or parameter (the stated
# exception to "at most 1": test_bf16_gradients_match_jax)
LOSS_GAP, GRAD_GAP_MAX, GRAD_GAP_MEDIAN = 1.0, 4.5, 1.5
LOSS_RTOL = 2.0 ** -9
# ... and away from the port's own float32 step: each group's median of
# max |port bf16 - port f32| in those units at least GRAD_MOVE_MEDIAN
# (0.70-1.60 measured), and the median cosine between the port's and JAX's
# bfloat16-minus-float32 gradients at least GRAD_COS_MEDIAN (0.43-0.79
# measured): a port that trained in float32 reads 0 on both
GRAD_MOVE_MEDIAN, GRAD_COS_MEDIAN = 0.5, 0.25


# ----------------------------------------------------------- the step
def _probe_gather(probes, seen):
    """JAX's fused gather with each call's outputs plus a probe input
    (zeros; its gradient is the outputs' cotangent), the calls in order."""
    gather = JR.fused_epipolar_gather

    def probed(*args):
        outs = gather(*args)
        k = len(seen)
        seen.append(tuple(o.shape for o in outs))
        return tuple(o + p for o, p in zip(outs, probes[k]))
    return probed


def _probe_shapes():
    """The three gathers' output shapes of a bfloat16 training forward:
    coarse and fine passes, the volume (rgb, img_feats, ray_feats)."""
    C = 32
    return [((V, n, 3), (V, n, C), (V, n, C))
            for n in (RN * TRAIN_CFG["depth_sample_num"],
                      RN * TRAIN_CFG["fine_depth_sample_num"], RES ** 3)]


@pytest.fixture(scope="module")
def jax_run16():
    """One jitted value_and_grad of JAX's bfloat16 training loss with the
    Pallas view fuse (interpret mode) at KEY, the gathers' outputs probed:
    {params, batch, losses, grads, fine_depth, gather_cot [per call (rgb,
    img_feats, ray_feats) cotangents]}."""
    return _jax_step(FAST)


def _jax_step(compiler_options):
    """jax_run16's step, compiled with `compiler_options`."""
    params = _params()
    batch = _batch()
    jm = M.GraspNeRF(renderer_cfg=dict(BF16_CFG, use_pallas=True))
    seen, shapes = [], []
    probes = [tuple(jnp.zeros(s) for s in call) for call in _probe_shapes()]

    def record(*args, **kw):
        seen.append(sample_fine_depth(*args, **kw))
        return seen[-1]

    def loss_fn(p, probes, b, key):
        with pytest.MonkeyPatch.context() as mp:   # for the trace only
            mp.setattr(JR, "fused_epipolar_gather",
                       _probe_gather(probes, shapes))
            out = jm.apply({"params": p}, b["data"], train=True, key=key)
        ld = JT.compute_losses(out, b)
        ld["total"] = JL.total_loss(ld)
        return ld["total"], (ld, seen[-1])

    sample_fine_depth = G.sample_fine_depth
    with pytest.MonkeyPatch.context() as mp, \
            pltpu.force_tpu_interpret_mode():
        mp.setattr(G, "sample_fine_depth", record)
        (total, (ld, fine)), (grads, cot) = jax.jit(
            jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True),
            compiler_options=compiler_options)(
                params, probes, jax.tree_util.tree_map(jnp.asarray, batch),
                jax.random.PRNGKey(KEY))
    assert shapes == _probe_shapes()
    return {"params": params, "batch": batch, "losses": ld,
            "fine_depth": np.array(fine),
            "grads": jax.tree_util.tree_map(np.asarray, grads),
            "gather_cot": jax.tree_util.tree_map(np.asarray, cot)}


@pytest.fixture(scope="module")
def port_run16(jax_run16):
    """The port's bfloat16 training forward and gradients on the same
    weights and batch, with JAX's draws and its fine pass at JAX's
    bfloat16 fine samples: {losses, grads {name: tensor}, outputs}."""
    return _port_step(jax_run16, BF16_CFG)


def _port_step(jax_run16, cfg):
    u, idx = _jax_draws()

    def uniform(shape, generator, device):
        return torch.from_numpy(u.copy())

    def pixels(count, n, generator, device):
        return torch.from_numpy(idx)

    model = TM.load_graspnerf(flax_to_state_dict(jax_run16["params"]), "cpu",
                              cfg)
    batch = _torch(jax_run16["batch"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TG, "draw_uniform", uniform)
        mp.setattr(TR, "draw_pixels", pixels)
        mp.setattr(TG, "sample_fine_depth", lambda *a, **k: torch.from_numpy(
            jax_run16["fine_depth"]))
        outputs = model(batch["data"], train=True,
                        generator=torch.Generator())
    ld = TT.compute_losses(outputs, batch)
    total = TL.total_loss(ld)
    ld["total"] = total
    grads = torch.autograd.grad(total, list(model.parameters()),
                                allow_unused=True)
    names = [n for n, _ in model.named_parameters()]
    return {"losses": ld, "grads": dict(zip(names, grads)),
            "outputs": outputs}


PASSES = ("coarse", "fine", "volume")


@pytest.mark.parametrize("i", range(3), ids=PASSES)
def test_gathered_feature_gradients_in_jax(jax_run16, i):
    """Which dtype the gradients reaching JAX's gather have, in its bfloat16
    training step (the cotangents of its float32 outputs, taken by a zero
    probe added to them): the ray features' are not bfloat16-valued in any
    pass (their two consumers, the dist decoder and the prob embedding,
    each cast to bfloat16, and their gradients add in float32), so the
    port hands the gather's ray_feats to them in float32
    (models/renderer.project_to_views) and the backward reads that sum.
    The image features' are bfloat16-valued in the render passes (one cast
    before both uses, ibrnet.py:212); in the volume pass XLA's CPU backend
    drops that float32 -> bfloat16 -> float32 round trip (excess
    precision), and 44 % are (recorded in ROADMAP Queue 3)."""
    rgb, img, ray = jax_run16["gather_cot"][i]

    def bf16_share(c):
        b = np.asarray(jnp.asarray(c, JBF).astype(jnp.float32))
        return float((b == c).mean())
    assert np.abs(ray).max() > 0 and bf16_share(ray) < 0.9, bf16_share(ray)
    if PASSES[i] != "volume":
        assert bf16_share(img) == 1.0


LOSS_KEYS = ("loss_rgb_nr", "loss_rgb_nr_fine", "loss_depth",
             "loss_depth_fine", "loss_sdf", "loss_eikonal", "loss_vgn",
             "total")


@pytest.fixture(scope="module")
def port_run32(jax_run16):
    """The port's float32 step on the same weights, draws and fine samples:
    the float32 side of JAX's own bfloat16 gap (test_torch_train.py holds
    it to JAX's float32 step: every gradient within 1e-2 of its scale,
    3.4e-3 measured)."""
    return _port_step(jax_run16, TRAIN_CFG)


@pytest.mark.parametrize("key", LOSS_KEYS)
def test_bf16_losses_match_jax(jax_run16, port_run16, port_run32, key):
    """Each loss of the bfloat16 step, in float32 in both libraries, within
    JAX's own bfloat16-to-float32 gap of JAX's bfloat16 loss (the float32
    side: the port's float32 step), or LOSS_RTOL of it (half a bfloat16
    ulp: a float32 sum of bfloat16-derived terms)."""
    got = port_run16["losses"][key]
    assert got.dtype == torch.float32
    want = float(jax_run16["losses"][key])
    gap = abs(want - float(port_run32["losses"][key]))
    assert abs(float(got) - want) <= max(LOSS_GAP * gap,
                                         LOSS_RTOL * abs(want)), (
        key, float(got), want, gap)


GROUPS16 = ("nr_net.image_encoder", "nr_net.init_net", "nr_net.vis_encoder",
            "nr_net.dist_decoder", "nr_net.fine_dist_decoder",
            "nr_net.agg_net", "nr_net.fine_agg_net", "vgn_net")


def _grad_stats(jax_grads, got, ref, group):
    """Per parameter of `group` above GRAD_FLOOR, in units of JAX's own gap
    max |JAX bf16 - port f32| on it: (max |port bf16 - JAX bf16|, max
    |port bf16 - port f32|, the cosine between port bf16 - port f32 and
    JAX bf16 - port f32, name), sorted."""
    want = flax_to_state_dict(jax_grads)
    rows = []
    for name, g in got.items():
        if not name.startswith(group):
            continue
        w_ = want[name].numpy()
        g = np.zeros_like(w_) if g is None else g.numpy()
        assert g.dtype == np.float32
        if max(np.abs(w_).max(), np.abs(g).max()) < GRAD_FLOOR:
            continue
        dj = (w_ - ref[name].numpy()).ravel().astype(np.float64)
        dp = (g - ref[name].numpy()).ravel().astype(np.float64)
        gap = max(np.abs(dj).max(), 1e-30)
        cos = dp @ dj / max(np.linalg.norm(dp) * np.linalg.norm(dj), 1e-300)
        rows.append((np.abs(g - w_).max() / gap, np.abs(dp).max() / gap,
                     cos, name))
    assert rows
    return sorted(rows)


@pytest.mark.parametrize("group", GROUPS16)
def test_bf16_gradients_match_jax(jax_run16, port_run16, port_run32, group):
    """Every parameter's gradient of the bfloat16 training loss against
    JAX's bfloat16 step, in units of JAX's own distance between its
    bfloat16 gradient and the float32 one on that parameter (the float32
    side: the port's float32 step at the same samples). For each parameter
    above GRAD_FLOOR at most GRAD_GAP_MAX, and their median within each
    group at most GRAD_GAP_MEDIAN. So that this cannot pass a step that
    dropped bfloat16 arithmetic, each group's gradients also move from the
    port's float32 ones by GRAD_MOVE_MEDIAN x that distance (median), in
    the direction JAX's move (median cosine GRAD_COS_MEDIAN).

    The exception to "at most 1 x JAX's own distance": about half the
    parameters land a little further (per group medians 0.82-1.32 measured,
    the largest 4.14 x on agg_net's neuray_fc.2.bias, 3.42 x on
    dist_decoder's var_decoder.0.bias, 3.31 x on fine_agg_net's
    prob_embed.0.weight). XLA's CPU backend evaluates the bfloat16
    elementwise chains of a fusion in float32 (excess precision: it drops
    float32 -> bfloat16 -> float32 round trips), so JAX's bfloat16 step on
    the CPU sits nearer float32 than bfloat16 arithmetic that rounds each
    op, which is what PyTorch runs: the port lands about one such distance
    from JAX's, on the other side. test_torch_train_bf16_exact.py shows
    it: against JAX's step compiled without excess precision, 40 of the 345
    parameters above GRAD_FLOOR lie beyond 1 x instead of 171, and the
    three above lie at 0.26, 0.57 and 0.73 x. Recorded in ROADMAP Queue
    3."""
    rows = _grad_stats(jax_run16["grads"], port_run16["grads"],
                       port_run32["grads"], group)
    mid = len(rows) // 2
    assert rows[-1][0] <= GRAD_GAP_MAX, rows[-1]
    assert rows[mid][0] <= GRAD_GAP_MEDIAN, rows
    assert sorted(r[1] for r in rows)[mid] >= GRAD_MOVE_MEDIAN, rows
    assert sorted(r[2] for r in rows)[mid] >= GRAD_COS_MEDIAN, rows


def test_bf16_step_keeps_float32_state_and_losses(port_run16):
    """The losses and everything they read are float32 in the bfloat16
    step, as in JAX (the render's colours and depths, the volume, the
    grasp head's outputs, the depth-loss means), and so are the parameters'
    gradients."""
    for key, v in port_run16["losses"].items():
        assert v.dtype == torch.float32, key
    for key, v in port_run16["outputs"].items():
        for t in (v if isinstance(v, tuple) else (v,)):
            assert t.dtype in (torch.float32, torch.bool, torch.int64), key
    assert all(g is None or g.dtype == torch.float32
               for g in port_run16["grads"].values())


def test_check_trainable_takes_bfloat16():
    """The train step takes float32 and bfloat16 models, and refuses other
    compute dtypes with the trainable ones named."""
    for dtype in ("float32", "bfloat16"):
        TT.check_trainable(dtype)
    with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
        TT.check_trainable("float16")

