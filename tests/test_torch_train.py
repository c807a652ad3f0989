"""The port's train step against the JAX package on the CPU: the losses,
the rotation error, the learning-rate schedule, `predict_mean`, the
training forward (render, volume, grasp head, depth-loss means), the
gradient of the total loss for every parameter, the Adam update, the
finite guard, the gather's backward, and the repaired eval forward.

Size: the scene of test_torch_render.py (6 reference views of 64 x 96, one
query view with 24 rays, 16 coarse + 16 fine samples, an 8^3 volume) with
its weights, 256 depth-loss pixels and seeded labels (true depth, SDF with
20 % invalid voxels, 5 grasps). JAX runs once, one jitted value_and_grad of
the training loss with a fixed key; the port gets JAX's draws from that key
(the fine quantiles, then the depth-loss pixels) through its draw helpers.
The fine samples invert the coarse hit-probability CDF, which magnifies the
two libraries' ulp-level differences (test_torch_render.py,
test_fine_samples_match_jax): so the port's fine pass runs at JAX's fine
samples, recorded inside the jitted function, and its own samples are held
to JAX's at FINE_DEPTH_ATOL.

Tolerances (float32 on both sides; JAX at matmul precision 'highest'):
- loss functions on identical inputs: 1e-5 relative (float32 sums of a
  few hundred terms in another order);
- the training forward: 1e-4, as the eval forward in test_torch_render.py;
  the depth-loss means 2e-5 (one bilinear fetch and the dist decoder's
  mean head); losses 1e-5 relative;
- gradients: per parameter, max |port - JAX| <= GRAD_RTOL x the larger
  max |gradient| of the two. Parameters whose gradient is below GRAD_FLOOR
  on both sides are mathematically zero (conv biases before InstanceNorm,
  the softmax blend's last bias) and carry only rounding noise. The
  largest error seen was 3.4e-3 of the scale (fine_agg_net rgb_fc.2.bias,
  1.1e-6), everything else below 1.2e-3; no layer needs more, where
  tests/test_grad_parity.py allows 5 % (30 % on deep encoder layers)
  against the original PyTorch code;
- the Adam step, on the same gradients: 1e-7 absolute (lr 1e-4: 0.1 % of
  a first step's lr * sign(g)) plus 2 float32 ulps of the parameter, to
  which p + update rounds;
- the gather's backward against JAX's custom VJP: 1e-5 (the sum over a
  map cell in another order).
"""
import pathlib

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from graspnerf_tpu import config as JC
from graspnerf_tpu import models as M
from graspnerf_tpu.ops import geometry as G
from graspnerf_tpu.ops import quat as JQ
from graspnerf_tpu.ops.fused_gather import (fused_epipolar_gather,
                                            pack_feature_maps)
from graspnerf_tpu.train import losses as JL
from graspnerf_tpu.train import trainer as JT
from graspnerf_tpu.train.schedule import exp_decay_lr as jax_exp_decay_lr
from graspnerf_tpu.train.schedule import (
    warmup_exp_decay_lr as jax_warmup_exp_decay_lr)

from graspnerf_tpu_torch import config as TC
from graspnerf_tpu_torch import models as TM
from graspnerf_tpu_torch import train as TT
from graspnerf_tpu_torch.convert import flax_to_state_dict
from graspnerf_tpu_torch.models import renderer as TR
from graspnerf_tpu_torch.ops import epipolar_gather as EG
from graspnerf_tpu_torch.ops import geometry as TG
from graspnerf_tpu_torch.ops import quat as TQ
from graspnerf_tpu_torch.train import losses as TL

from test_torch_models import V, H, W, close, sub
from test_torch_render import (CFG, FDN, FINE_DEPTH_ATOL, FORWARD_ATOL,
                               RENDER_KEYS, RES, RN, _flat, _params, _scene,
                               _torch)

REPO = pathlib.Path(__file__).resolve().parents[1]
N_DEPTH, N_GRASPS = 256, 5
TRAIN_CFG = dict(CFG, depth_loss_coords_num=N_DEPTH)
KEY = 11
GRAD_RTOL, GRAD_FLOOR = 1e-2, 1e-7
MEAN_ATOL, LOSS_RTOL, ADAM_ATOL, ADAM_RTOL = 2e-5, 1e-5, 1e-7, 2.4e-7
DEPTH_KEYS = ("depth_coords", "depth_mean_all", "depth_mean", "depth_mean_2",
              "depth_mean_fine", "depth_mean_fine_2")
LOSS_KEYS = ("loss_rgb_nr", "loss_rgb_nr_fine", "loss_depth",
             "loss_depth_fine", "loss_sdf", "loss_eikonal", "variance",
             "sdf_mae", "loss_vgn", "vgn_total_loss", "vgn_qual_loss",
             "vgn_rot_loss", "vgn_width_loss", "vgn_qual_acc", "vgn_rot_err",
             "total")
GROUPS = ("nr_net.image_encoder", "nr_net.init_net", "nr_net.vis_encoder",
          "nr_net.dist_decoder", "nr_net.fine_dist_decoder", "nr_net.agg_net",
          "nr_net.fine_agg_net", "vgn_net")


def _labels(rng):
    sdf = rng.uniform(-1, 1, (RES,) * 3).astype(np.float32)
    sdf[rng.rand(RES, RES, RES) < 0.2] = -1.0
    q = rng.randn(N_GRASPS, 2, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return {"true_depth": rng.uniform(0.25, 0.75, (V, H, W, 1)).astype(
                np.float32),
            "sdf_gt": sdf,
            "grasp_label": rng.randint(0, 2, N_GRASPS).astype(np.float32),
            "grasp_rot": q,
            "grasp_width": rng.uniform(0.5, 9.0, N_GRASPS).astype(
                np.float32)}


def _batch():
    """The scene with seeded labels, as numpy (the trainer's contract)."""
    return dict(_labels(np.random.RandomState(7)), data=_scene())


def _jax_draws():
    """JAX's draws from KEY, as the renderer splits it (renderer.py:279):
    the fine quantiles u [1,RN,FDN] and the depth-loss pixel indices."""
    k_fine, k_depth = jax.random.split(jax.random.PRNGKey(KEY))
    u = jax.random.uniform(k_fine, (1, RN, FDN))
    idx = jax.random.choice(k_depth, H * W, (N_DEPTH,), replace=False)
    return np.asarray(u), np.asarray(idx).astype(np.int64)


def _port_model(params, **kw):
    return TM.load_graspnerf(flax_to_state_dict(params), "cpu", TRAIN_CFG,
                             **kw)


@pytest.fixture(scope="module")
def jax_run():
    """One jitted value_and_grad of JAX's training loss (make_loss_fn's
    body, trainer.py:64-70, with the outputs and the fine samples also
    returned) at KEY: {params, batch, total, losses, outputs, grads,
    fine_depth (unsorted, as sample_fine_depth returns them)}."""
    params = _params()
    batch = _batch()
    jm = M.GraspNeRF(renderer_cfg=TRAIN_CFG)
    seen = []

    def record(*args, **kw):
        seen.append(sample_fine_depth(*args, **kw))
        return seen[-1]

    def loss_fn(p, b, key):
        out = jm.apply({"params": p}, b["data"], train=True, key=key)
        ld = JT.compute_losses(out, b)
        ld["total"] = JL.total_loss(ld)
        return ld["total"], (ld, out, seen[-1])

    sample_fine_depth = G.sample_fine_depth
    with pytest.MonkeyPatch.context() as mp:   # for the trace only
        mp.setattr(G, "sample_fine_depth", record)
        (total, (ld, out, fine)), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(
                params, jax.tree_util.tree_map(jnp.asarray, batch),
                jax.random.PRNGKey(KEY))
    return {"params": params, "batch": batch, "total": float(total),
            "losses": ld, "outputs": out, "fine_depth": np.array(fine),
            "grads": jax.tree_util.tree_map(np.asarray, grads)}


@pytest.fixture(scope="module")
def port_run(jax_run):
    """The port's training forward and gradients on the same weights and
    batch, its draw helpers handing out JAX's draws and its fine pass at
    JAX's fine samples: {model, outputs, total, losses, grads {name:
    tensor}, draws (the helpers' calls in order), fine_depth (the port's
    own fine samples)}."""
    u, idx = _jax_draws()
    draws, own = [], []
    sample_fine_depth = TG.sample_fine_depth

    def fine_at_jax_samples(*args, **kw):
        own.append(sample_fine_depth(*args, **kw))
        return torch.from_numpy(jax_run["fine_depth"])

    def uniform(shape, generator, device):
        draws.append("uniform")
        assert tuple(shape) == u.shape
        return torch.from_numpy(u.copy())

    def pixels(count, n, generator, device):
        draws.append("pixels")
        assert (count, n) == (H * W, N_DEPTH)
        return torch.from_numpy(idx)

    model = _port_model(jax_run["params"])
    batch = _torch(jax_run["batch"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TG, "draw_uniform", uniform)
        mp.setattr(TR, "draw_pixels", pixels)
        mp.setattr(TG, "sample_fine_depth", fine_at_jax_samples)
        outputs = model(batch["data"], train=True,
                        generator=torch.Generator())
    ld = TT.compute_losses(outputs, batch)
    total = TL.total_loss(ld)
    ld["total"] = total
    grads = torch.autograd.grad(total, list(model.parameters()),
                                retain_graph=True, allow_unused=True)
    names = [n for n, _ in model.named_parameters()]
    return {"model": model, "outputs": outputs, "total": total,
            "losses": ld, "grads": dict(zip(names, grads)), "draws": draws,
            "fine_depth": own[0]}


# ------------------------------------------------------ cheap, no model
def _loss_inputs(rng):
    """Random outputs and labels for the loss functions alone."""
    qn, rn = 1, 24
    pc = {k: rng.rand(qn, rn, 3).astype(np.float32)
          for k in ("pixel_colors_nr", "pixel_colors_nr_fine",
                    "pixel_colors_gt")}
    out = dict(pc, ray_mask=rng.rand(qn, rn) > 0.3,
               ray_mask_fine=rng.rand(qn, rn) > 0.3,
               depth_coords=np.stack(
                   [rng.uniform(0, W - 1, (V, 50)),
                    rng.uniform(0, H - 1, (V, 50))], -1).astype(np.float32),
               depth_mean=rng.rand(V, 50).astype(np.float32),
               depth_mean_fine=rng.rand(V, 50).astype(np.float32),
               volume=rng.uniform(-1, 1, (RES,) * 3).astype(np.float32),
               sdf_gradient_error=rng.rand(1, 1).astype(np.float32),
               s=np.full((1, 1), 0.3, np.float32))
    q = rng.randn(N_GRASPS, 4).astype(np.float32)
    out["vgn_pred"] = (rng.rand(N_GRASPS).astype(np.float32),
                       q / np.linalg.norm(q, axis=-1, keepdims=True),
                       rng.uniform(0, 10, N_GRASPS).astype(np.float32))
    labels = _labels(rng)
    labels["depth_range"] = np.tile(np.array([[0.2, 0.8]], np.float32),
                                    (V, 1))
    return out, labels


def _loss_case(name, out, lab, lib):
    """One loss function of the JAX package (lib = JL) or of the port (TL)
    on the same outputs and labels."""
    if name == "render_loss":
        return lib.render_loss(out)
    if name == "depth_loss":
        return lib.depth_loss(out, lab["true_depth"], lab["depth_range"])
    if name == "sdf_loss":
        return lib.sdf_loss(out, lab["sdf_gt"])
    if name == "vgn_loss":
        return lib.vgn_loss(out, lab["grasp_label"], lab["grasp_rot"],
                            lab["grasp_width"])
    if name == "smooth_l1":
        return {"smooth_l1": lib.smooth_l1(out["volume"], lab["sdf_gt"])}
    if name == "psnr":
        return {"psnr": lib.psnr(out["pixel_colors_nr"],
                                 out["pixel_colors_gt"])}
    assert name == "total_loss"
    return {"total": lib.total_loss(lib.sdf_loss(out, lab["sdf_gt"]))}


@pytest.mark.parametrize("name", ["render_loss", "depth_loss", "sdf_loss",
                                  "vgn_loss", "smooth_l1", "psnr",
                                  "total_loss"])
def test_loss_function_matches_jax(name, rng):
    out, lab = _loss_inputs(rng)

    def j(x):
        return jax.tree_util.tree_map(jnp.asarray, x)

    def t(x):
        if isinstance(x, dict):
            return {k: t(v) for k, v in x.items()}
        if isinstance(x, tuple):
            return tuple(map(t, x))
        return torch.from_numpy(np.asarray(x))

    want = _loss_case(name, j(out), j(lab), JL)
    got = _loss_case(name, t(out), t(lab), TL)
    assert set(got) == set(want)
    for key in want:
        close(got[key], want[key], 0, 1e-5)


def test_rot_error_matches_jax(rng):
    q = rng.randn(7, 4).astype(np.float32)
    pair = rng.randn(7, 2, 4).astype(np.float32)
    pair[0, 1] = q[0] * -2.0        # the same rotation: the clip's floor
    close(TQ.quat_to_matrix(torch.from_numpy(q)),
          JQ.quat_to_matrix(jnp.asarray(q)), 1e-6)
    close(TQ.rot_error_deg_symmetric(torch.from_numpy(q),
                                     torch.from_numpy(pair)),
          JQ.rot_error_deg_symmetric(jnp.asarray(q), jnp.asarray(pair)),
          1e-3)   # degrees: arccos near +-1 amplifies ulps


@pytest.mark.parametrize("step", [0, 1, 99_999, 100_000, 250_000, 400_000])
def test_schedules_match_jax(step):
    for kw in ({}, {"lr_init": 3e-4, "decay_step": 1000, "decay_rate": 0.3}):
        assert TT.exp_decay_lr(**kw)(step) == pytest.approx(
            float(jax_exp_decay_lr(**kw)(step)), rel=1e-6)
    assert TT.warmup_exp_decay_lr(500)(step) == pytest.approx(
        float(jax_warmup_exp_decay_lr(500)(step)), rel=1e-6)


def test_predict_mean_matches_jax(rng):
    params = sub(_params(), "nr_net", "dist_decoder")
    feats = rng.randn(V, 40, 32).astype(np.float32)
    want = M.MixtureLogisticsDistDecoder().apply(
        {"params": params}, jnp.asarray(feats), method="predict_mean")
    tm = TM.MixtureLogisticsDistDecoder()
    tm.load_state_dict(flax_to_state_dict(params), strict=True)
    with torch.no_grad():
        got = tm.predict_mean(torch.from_numpy(feats))
    close(got, want, 1e-6)


def test_config_from_yaml_matches_jax():
    """The shipped config maps to the same renderer arguments (minus the
    JAX-only compute_dtype / use_pallas) and learning-rate arguments, and
    the port's renderer takes them."""
    cfg = TC.load_cfg(str(REPO / "configs" / "nrvgn_sdf.yaml"))
    want = JC.renderer_cfg_from(cfg)
    assert TC.renderer_cfg_from(cfg) == want
    assert TC.lr_cfg_from(cfg) == JC.trainer_cfg_from(cfg)["lr_cfg"]
    nr = TM.NeuralRayRenderer(**TC.renderer_cfg_from(cfg))
    assert (nr.use_depth_loss, nr.depth_loss_coords_num) == (True, 8192)
    with pytest.raises(ValueError, match="float32"):
        TC.renderer_cfg_from(dict(cfg, compute_dtype="bfloat16"))


# ----------------------------------------------- the training forward
@pytest.mark.parametrize("key", [
    *RENDER_KEYS, "ray_mask", *(k + "_fine" for k in RENDER_KEYS),
    "ray_mask_fine", "pixel_colors_gt", "volume", "vgn_pred_full",
    "vgn_pred", *DEPTH_KEYS])
def test_training_forward_matches_jax(jax_run, port_run, key):
    """Every output of the training forward, with JAX's draws (the fine
    pass at JAX's fine samples)."""
    got, want = port_run["outputs"], jax_run["outputs"]
    assert set(got) == set(want)
    g, w = got[key], want[key]
    if key.startswith("ray_mask"):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        return
    shapes = [tuple(t.shape) for t in (g if isinstance(g, tuple) else [g])]
    assert shapes == [t.shape for t in (w if isinstance(w, tuple) else [w])]
    atol = MEAN_ATOL if key.startswith("depth_mean") else FORWARD_ATOL
    np.testing.assert_allclose(_flat(g), _flat(w), atol=atol, rtol=0)


def test_fine_samples_match_jax(jax_run, port_run):
    """The port's own fine samples, from its coarse hit probabilities and
    JAX's quantiles, against JAX's (see test_torch_render.py)."""
    np.testing.assert_allclose(port_run["fine_depth"].numpy(),
                               jax_run["fine_depth"], atol=FINE_DEPTH_ATOL,
                               rtol=0)


def test_draws_follow_jax_order(port_run):
    """The fine quantiles are drawn before the depth-loss pixels, as JAX
    splits its key; the coarse samples draw nothing."""
    assert port_run["draws"] == ["uniform", "pixels"]


@pytest.mark.parametrize("key", LOSS_KEYS)
def test_losses_match_jax(jax_run, port_run, key):
    close(port_run["losses"][key], jax_run["losses"][key], 1e-7, LOSS_RTOL)


def test_losses_reach_geometry_head(port_run):
    """The fault repaired: with grad enabled, the SDF, the eikonal error and
    the NeuS alpha of both passes carry a graph to the geometry head's
    output layer."""
    model, out = port_run["model"], port_run["outputs"]
    for net in ("agg_net", "fine_agg_net"):
        weight = getattr(model.nr_net, net).agg_impl.out_geometry_fc[1].weight
        sfx = "" if net == "agg_net" else "_fine"
        for key in ("sdf_values", "sdf_gradient_error", "alpha_values"):
            y = out[key + sfx]
            assert y.requires_grad, key + sfx
            g, = torch.autograd.grad(y.sum(), weight, retain_graph=True,
                                     allow_unused=True)
            assert g is not None and bool(g.abs().sum() > 0), key + sfx


def test_eval_forward_unchanged_under_no_grad(jax_run):
    """Under no_grad the eval forward computes what the grad-enabled one
    does, bit for bit, and returns nothing attached; test_torch_render.py
    holds those outputs against JAX."""
    model = _port_model(jax_run["params"])
    data = _torch(jax_run["batch"])["data"]
    with torch.no_grad():
        quiet = model(data)
    loud = model(data)
    assert set(quiet) == set(loud)
    for key in quiet:
        for a, b in zip(*(v if isinstance(v, tuple) else (v,)
                          for v in (quiet[key], loud[key]))):
            assert not a.requires_grad, key
            assert torch.equal(a, b.detach()), key


# --------------------------------------------------------- gradients
@pytest.mark.parametrize("group", GROUPS)
def test_gradients_match_jax(jax_run, port_run, group):
    """d total / d parameter for every parameter of the group against
    jax.value_and_grad, at GRAD_RTOL of the gradient's scale (see the
    module docstring)."""
    want = flax_to_state_dict(jax_run["grads"])
    names = [n for n in port_run["grads"] if n.startswith(group + ".")]
    assert names and set(names) <= set(want)
    compared = 0
    for name in names:
        g = port_run["grads"][name]
        g = np.zeros(want[name].shape, np.float32) if g is None else g.numpy()
        w = want[name].numpy()
        scale = max(np.abs(g).max(), np.abs(w).max())
        if scale < GRAD_FLOOR:
            continue
        err = np.abs(g - w).max()
        assert err <= GRAD_RTOL * scale, (name, err, scale)
        compared += 1
    assert compared >= len(names) // 2, (compared, len(names))


def test_adam_step_matches_optax(jax_run):
    """Two port updates with exp_decay_lr against optax.adam on the same
    (JAX's) gradients: the optimizer alone, apart from the gradients'
    rounding (a first Adam step moves a parameter by ~lr * sign(g), even
    where g is rounding noise)."""
    params = jax_run["params"]
    grads = jax_run["grads"]
    tx = optax.adam(jax_exp_decay_lr())

    def two_steps(p, g):
        opt_state = tx.init(p)
        for _ in range(2):
            updates, opt_state = tx.update(g, opt_state, p)
            p = optax.apply_updates(p, updates)
        return p

    # Adam is elementwise: one flat vector compiles in a fraction of the
    # time the tree of ~300 leaves takes (flattened and split in numpy:
    # ravel_pytree's eager slicing took seconds)
    leaves, tree = jax.tree_util.tree_flatten(params)
    flat = [np.concatenate([np.ravel(a) for a in jax.tree_util.tree_leaves(t)])
            for t in (params, grads)]
    out = np.asarray(jax.jit(two_steps)(*flat))
    p_jax = tree.unflatten([
        a.reshape(leaf.shape) for a, leaf in zip(
            np.split(out, np.cumsum([a.size for a in leaves])[:-1]), leaves)])

    state = TT.create_train_state(_port_model(params), device="cpu")
    sd_grads = flax_to_state_dict(grads)
    for _ in range(2):
        assert TT.apply_gradients(state, [
            sd_grads[n].reshape(p.shape).clone()
            for n, p in state.model.named_parameters()])
    assert state.step == 2
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, p_jax))
    start = flax_to_state_dict(params)
    moved = 0
    for name, p in state.model.named_parameters():
        close(p, want[name], ADAM_ATOL, ADAM_RTOL)
        moved += int(not torch.equal(p, start[name].reshape(p.shape)))
    assert moved > len(want) // 2


def test_create_train_state(jax_run, monkeypatch):
    state = TT.create_train_state(_port_model(jax_run["params"]),
                                  {"lr_init": 3e-4}, device="cpu")
    assert state.model.training and state.step == 0
    group = state.optimizer.param_groups[0]
    assert (group["lr"], group["betas"], group["eps"]) == (3e-4, (0.9, 0.999),
                                                           1e-8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.create_train_state(state.model)


def test_finite_guard_then_training(jax_run):
    """A batch with NaN images leaves the parameters and the Adam state,
    its step count included, untouched and reports nonfinite_grad 1; a
    good batch then trains (tests/test_training.py:51-75)."""
    state = TT.create_train_state(_port_model(jax_run["params"]),
                                  device="cpu")
    step = TT.make_train_step(state)
    good = _torch(jax_run["batch"])
    bad = _torch(jax_run["batch"])
    bad["data"]["ref"]["imgs"] = bad["data"]["ref"]["imgs"] * float("nan")
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    metrics = step(bad, torch.Generator().manual_seed(0))
    assert float(metrics["nonfinite_grad"]) == 1.0
    assert state.step == 0 and not state.optimizer.state
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    metrics = step(good, torch.Generator().manual_seed(1))
    assert float(metrics["nonfinite_grad"]) == 0.0 and state.step == 1
    assert all(int(s["step"]) == 1 for s in state.optimizer.state.values())
    assert any(not torch.equal(v, before[k])
               for k, v in state.model.state_dict().items())


def test_steps_lower_the_loss(jax_run):
    """A few steps on one batch lower the total loss, each with its own
    draws (tests/test_training.py:35-48)."""
    state = TT.create_train_state(_port_model(jax_run["params"]),
                                  device="cpu")
    step = TT.make_train_step(state)
    batch = _torch(jax_run["batch"])
    gen = torch.Generator().manual_seed(0)
    totals = []
    for _ in range(4):
        metrics = step(batch, gen)
        assert float(metrics["nonfinite_grad"]) == 0.0
        assert set(LOSS_KEYS) <= set(metrics)
        totals.append(float(metrics["total"]))
    assert np.isfinite(totals).all() and totals[-1] < totals[0], totals


def test_eval_step(jax_run, port_run):
    """The eval step: the losses of the deterministic forward and psnr_nr,
    without gradients; its render loss equals the training forward's coarse
    one, whose samples are deterministic too."""
    state = TT.create_train_state(_port_model(jax_run["params"]),
                                  device="cpu")
    metrics = TT.make_eval_step(state)(_torch(jax_run["batch"]),
                                       torch.Generator().manual_seed(0))
    assert set(metrics) == set(LOSS_KEYS) - {"total"} | {"psnr_nr"}
    assert not any(v.requires_grad for v in metrics.values())
    close(metrics["loss_rgb_nr"], port_run["losses"]["loss_rgb_nr"].detach(),
          0)


# ------------------------------------------------- the gather's backward
def test_gather_backward_matches_jax_vjp(rng):
    """The backward's plain version (the wrapper on CPU tensors) against
    JAX's custom VJP of the fused gather (`_feg_bwd` with `_splat_windows`),
    for the image and both maps, on border, invalid and random points."""
    from test_torch_ops import _gather_case
    imgs, f1, f2, xy, valid = _gather_case(rng, V=2, C=8, P=300)
    Vg, Hg, Wg, _ = imgs.shape
    d_rgb = rng.randn(Vg, 300, 3 + 8).astype(np.float32)
    d_ray = rng.randn(Vg, 300, 8).astype(np.float32)

    def gather(a, b, c):
        return fused_epipolar_gather(pack_feature_maps(a, b, c),
                                     jnp.asarray(xy),
                                     jnp.asarray(valid, jnp.float32), Hg, Wg)

    want = jax.jit(lambda maps, cot: jax.vjp(gather, *maps)[1](cot))(
        tuple(map(jnp.asarray, (imgs, f1, f2))),
        (jnp.asarray(d_rgb[..., :3]), jnp.asarray(d_rgb[..., 3:]),
         jnp.asarray(d_ray)))
    got = EG.epipolar_gather_backward(
        torch.from_numpy(xy), torch.from_numpy(valid),
        torch.from_numpy(d_rgb), torch.from_numpy(d_ray), imgs.shape,
        f1.shape, need_imgs=True)
    for g, w in zip(got, want):
        close(g, w, 1e-5)
    _, *maps = EG.epipolar_gather_backward(
        torch.from_numpy(xy), torch.from_numpy(valid),
        torch.from_numpy(d_rgb), torch.from_numpy(d_ray), imgs.shape,
        f1.shape)
    assert _ is None and all(torch.equal(a, b) for a, b in zip(maps, got[1:]))
