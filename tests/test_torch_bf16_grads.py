"""The backward of the port's bfloat16 layers against the JAX package's on
the CPU: the view fuse's bfloat16 backward (the VJP of the jnp oracle's
bfloat16 arithmetic, `_vf_bwd`) and each module's bfloat16 parameter
gradients (tests/test_torch_train_bf16.py holds the whole bfloat16 train
step; the two share no fixture and run in separate processes under
pytest-xdist's workers).

Size: the view fuse at N = 512 rows; modules at test_torch_bf16.py's
sizes, the weights of test_torch_models.py's random flax tree.

Tolerances (bfloat16 keeps 8 significant bits: "1 ulp" is 2^-7 of a
value's binade, test_torch_bf16.ulp). XLA's CPU backend evaluates the
bfloat16 elementwise chain of a fusion in float32 (excess precision);
PyTorch rounds each op. So the port cannot meet JAX's bfloat16 bit for
bit, and each bound is stated at its test with what it measured:
- the view fuse's backward: FUSE_ULPS of each gradient's scale;
- one module's parameter gradients: MODULE_ULPS of each gradient's scale,
  or MODULE_GAP x JAX's own bfloat16-to-float32 distance there, the
  float32 side being the port's float32 module (test_torch_models.py and
  test_torch_train.py hold it to JAX's float32 modules).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from graspnerf_tpu import models as M
from graspnerf_tpu.ops.pallas.ibrnet_fuse import view_fuse as jax_view_fuse

from graspnerf_tpu_torch import models as TM
from graspnerf_tpu_torch.convert import flax_to_state_dict
from graspnerf_tpu_torch.ops.view_fuse import view_fuse

from test_torch_bf16 import _fuse_weights_jax, f32, ulp
from test_torch_models import V, _fuse_inputs, graspnerf_params, sub
from test_torch_render import _params
from _torch_util import one_thread  # noqa: F401  (autouse)

BF = torch.bfloat16
JBF = jnp.bfloat16
FUSE_ULPS = 4
# XLA's CPU compile at LLVM -O0: the same HLO, 40 % less compile time
FAST = {"xla_backend_optimization_level": 0}


def within_ulps(got, want, ulps, what=""):
    """max |got - want| <= ulps bfloat16 ulps of the larger scale of the
    two."""
    got, want = f32(got), f32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), float(np.abs(got).max()))
    err = float(np.abs(got - want).max())
    assert err <= ulps * ulp(scale), (what, err / ulp(scale), ulps)


# ------------------------------------------------------- the view fuse
def test_view_fuse_bf16_backward_matches_jax():
    """The gradients of the bfloat16 view fuse (inputs and the ten layers'
    weights) against jax.grad of `view_fuse(..., bfloat16)` (Pallas kernel
    forward in interpret mode, `_vf_bwd`: the VJP of the jnp oracle, which
    rounds every layer's output to bfloat16): within FUSE_ULPS of each
    gradient's scale (2.5 measured). Both recompute through the oracle's
    arithmetic, its layer outputs rounded to bfloat16; a sum of products
    can round one ulp apart, and through ten layers that moves a gradient
    by a few. The elementwise ops between stay float32 in the port, as
    XLA's fusions keep them."""
    agg = sub(graspnerf_params(), "nr_net", "agg_net", "agg_impl")
    wj = _fuse_weights_jax(agg)
    inputs = [np.array(jnp.asarray(x, JBF).astype(jnp.float32))
              for x in _fuse_inputs(np.random.RandomState(3), 512)]
    rng = np.random.RandomState(4)
    cot = [np.array(jnp.asarray(rng.randn(*s), JBF).astype(jnp.float32))
           for s in ((512, 65), (V, 512, 32), (V, 512, 1))]

    def jloss(ins, w):
        fc, _, x, vis = jax_view_fuse(*ins, w, JBF)
        return sum(jnp.sum(o.astype(jnp.float32) * c)
                   for o, c in zip((fc, x, vis), cot))

    with pltpu.force_tpu_interpret_mode():
        g_ins, g_w = jax.jit(jax.grad(jloss, argnums=(0, 1)),
                             compiler_options=FAST)(
            tuple(jnp.asarray(x, JBF) for x in inputs[:3])
            + (jnp.asarray(inputs[3], JBF),), wj)
    ins = [torch.from_numpy(x).to(BF).requires_grad_() for x in inputs]
    wt = [(torch.from_numpy(np.array(k).T.copy()).requires_grad_(),
           torch.from_numpy(np.array(b)).requires_grad_()) for k, b in wj]
    fc, _, x, vis = view_fuse(*ins, wt, BF)
    loss = sum(torch.sum(o.float() * torch.from_numpy(c))
               for o, c in zip((fc, x, vis), cot))
    flat_w = [t for pair in wt for t in pair]
    grads = torch.autograd.grad(loss, ins[:3] + flat_w)
    for g, w_, name in zip(grads[:3], g_ins[:3], ("rgbf", "neur", "rdiff")):
        assert g.dtype == BF
        within_ulps(g, w_, FUSE_ULPS, name)
    for i, (k, b) in enumerate(g_w):
        within_ulps(grads[3 + 2 * i].T, k, FUSE_ULPS, f"weight {i}")
        within_ulps(grads[4 + 2 * i], b, FUSE_ULPS, f"bias {i}")


# ------------------------------------------------------------- modules
class _Method:
    """A flax module's method as a module: apply(variables, *args)."""

    def __init__(self, module, method):
        self.module, self.method = module, method

    def apply(self, variables, *args):
        return self.module.apply(variables, *args, method=self.method)


def _geometry_and_grad(m, feat_const, pts, num_valid):
    """JAX IBRNetNeus's geometry section with its ∇sdf, as its __call__
    computes them (ibrnet.py:218-235)."""
    from graspnerf_tpu.models.ibrnet import positional_table
    pos_enc = jnp.asarray(positional_table(feat_const.shape[1])).astype(
        m.dtype)
    fc = feat_const.astype(m.dtype)
    sdf, vjp_fn = jax.vjp(lambda p: m._geometry(fc, p, num_valid, pos_enc),
                          pts)
    grad, = vjp_fn(jnp.ones_like(sdf))
    return sdf, grad


def _module_case(name):
    """(JAX module in bfloat16, its params, make(dtype) -> the port module,
    inputs [numpy], pick(outputs) -> the outputs held) of one module."""
    from graspnerf_tpu.models import nn_blocks as JB
    from graspnerf_tpu_torch.models import nn_blocks as TB
    rng = np.random.RandomState(30)
    if name == "dist_decoder":
        feats = rng.randn(V, 1, 5, 7, 32).astype(np.float32)
        return (M.MixtureLogisticsDistDecoder(dtype=JBF),
                sub(graspnerf_params(), "nr_net", "dist_decoder"),
                lambda d: TM.MixtureLogisticsDistDecoder(dtype=d), [feats],
                lambda out: (out[0], out[1], out[-1]))
    if name == "vgn_head":
        vol = rng.uniform(-1, 1, (1, 8, 8, 8, 1)).astype(np.float32)
        return (M.VGNConvNet(dtype=JBF), sub(graspnerf_params(), "vgn_net"),
                TM.VGNConvNet, [vol], lambda out: out)
    if name == "geometry":   # models/ibrnet.py geometry_and_grad
        R, D = 6, 8
        nv = rng.randint(0, 7, (R, D, 1)).astype(np.float32)
        nv[0, :3] = 0.0   # samples no view sees
        nv[1, :3] = 1.0   # one view
        inputs = [(rng.randn(R, D, 65) * 0.5).astype(np.float32),
                  ((rng.rand(1, R, D, 3) - 0.5) * 0.4).astype(np.float32),
                  nv]
        return (_Method(M.IBRNetNeus(dtype=JBF), _geometry_and_grad),
                sub(_params(), "nr_net", "agg_net", "agg_impl"),
                lambda d: TM.IBRNetNeus(dtype=d), inputs, lambda out: out)
    nr = graspnerf_params()["nr_net"]
    enc = nr["image_encoder"]
    jm, params, make, cin, h, w = {
        "basic_block": (JB.BasicBlock(32, 2, True, dtype=JBF),
                        enc["layer1.0"],
                        lambda d: TB.BasicBlock(16, 32, 2, True, d), 16, 16,
                        32),
        "residual_block": (JB.ResidualBlock(32, dtype=JBF),
                           nr["init_net"]["out_conv.1"],
                           lambda d: TB.ResidualBlock(32, 32, d), 32, 8, 16),
        "conv_in_elu": (JB.ConvINElu(64, 3, dtype=JBF), enc["iconv3"],
                        lambda d: TB.ConvINElu(128, 64, 3, dtype=d), 128, 8,
                        16),
        "upconv": (JB.UpConv(64, 3, dtype=JBF), enc["upconv3"],
                   lambda d: TB.UpConv(128, 64, dtype=d), 128, 4, 8)}[name]
    x = rng.randn(V, h, w, cin).astype(np.float32)
    return jm, params, make, [x], lambda out: (out,)


def _port_inputs(name, inputs, dtype):
    if name == "geometry":
        fc, pts, nv = (torch.from_numpy(x) for x in inputs)
        return [fc.to(dtype), pts, nv]
    x = torch.from_numpy(inputs[0])
    return [x.permute(0, 3, 1, 2) if name in MODULE_BLOCKS else x]


def _port_grads(name, make, params, inputs, pick, dtype, cots=None):
    """The port module's parameter gradients in `dtype` for the loss
    sum(output x cotangent), seeded cotangents when None: ({name:
    gradient}, cotangents)."""
    tm = make(dtype)
    tm.load_state_dict(flax_to_state_dict(params), strict=True)
    call = tm.geometry_and_grad if name == "geometry" else tm.train()
    outs = pick(call(*_port_inputs(name, inputs, dtype)))
    if name in MODULE_BLOCKS:
        outs = tuple(o.permute(0, 2, 3, 1) for o in outs)
    if cots is None:
        rng = np.random.RandomState(31)
        cots = [rng.randn(*o.shape).astype(np.float32) for o in outs]
    loss = sum(torch.sum(o.float() * torch.from_numpy(c))
               for o, c in zip(outs, cots))
    names = [n for n, _ in tm.named_parameters()]
    grads = torch.autograd.grad(loss, list(tm.parameters()),
                                allow_unused=True)
    return dict(zip(names, grads)), cots


MODULE_BLOCKS = ("basic_block", "residual_block", "conv_in_elu", "upconv")
MODULES = ("dist_decoder", "vgn_head", "geometry", *MODULE_BLOCKS)


@pytest.mark.parametrize("name", MODULES)
def test_module_bf16_parameter_gradients_match_jax(name):
    """Each module's parameter gradients in bfloat16 (autograd through the
    compute-dtype casts of models/layers.py; for IBRNet-NeuS's geometry
    head also the double backward of ∇sdf, which both libraries compute
    in the head's bfloat16 and hand back in the points' float32) against
    jax.grad of the JAX module in bfloat16, for the loss sum(output x a
    seeded cotangent): per parameter within MODULE_ULPS of its scale, or
    within MODULE_GAP x JAX's own distance between its bfloat16 and float32
    gradients. (The view fuse's backward: the test above.)

    Where the rounding sits: the two libraries round a layer's bfloat16
    output apart now and then (XLA's CPU backend keeps elementwise chains
    in float32 inside a fusion, PyTorch rounds each op), so a row's
    upstream gradient moves by an ulp; a weight's or a bias's gradient
    sums such rows, and where the rows cancel (biases, weights before
    InstanceNorm) the sum moves by many ulps of its own small scale (up to
    27 measured, a downsample conv; 222 on conv biases before
    InstanceNorm, whose gradient is mathematically 0). There bfloat16
    itself moves the gradient as far: the port lands at most 1.77 x JAX's
    own bfloat16-to-float32 distance (an encoder block's norm weight),
    rounding at more places than XLA's fusions do."""
    jm, params, make, inputs, pick = _module_case(name)
    got, cots = _port_grads(name, make, params, inputs, pick, BF)
    ref, _ = _port_grads(name, make, params, inputs, pick, torch.float32,
                         cots)

    def jloss(p):
        out = jm.apply({"params": p}, *jax.tree_util.tree_map(
            jnp.asarray, inputs))
        return sum(jnp.sum(o.astype(jnp.float32) * c)
                   for o, c in zip(pick(out), cots))

    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(jax.grad(jloss), compiler_options=FAST)(params)
    want = {k: v.numpy() for k, v in flax_to_state_dict(want).items()}
    assert set(got) <= set(want)
    for key, g in got.items():
        w_ = want[key]
        g = np.zeros_like(w_) if g is None else g.numpy()
        scale = max(np.abs(w_).max(), np.abs(g).max())
        err = np.abs(g - w_).max()
        r = ref[key]
        gap = np.abs(w_ - (0.0 if r is None else r.numpy())).max()
        assert err <= max(MODULE_ULPS * ulp(max(scale, 1e-30)),
                          MODULE_GAP * gap), (
            key, err / ulp(max(scale, 1e-30)), err / max(gap, 1e-30))


MODULE_ULPS, MODULE_GAP = 4, 2.0
