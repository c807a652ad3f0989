"""The fused InstanceNorm (graspnerf_tpu_torch/ops/instance_norm.py,
csrc/instance_norm.cu) and the encoders' fused path (models/nn_blocks.py).

On the CPU: the plain definition against the modules' own chain, bit-equal;
the encoders' fused wiring, run on the plain definition, against their
unchanged chain, bit-equal; the engage rule; the launch plan; the per-call
counter. Marked `card` (skipped without a CUDA card; on the card's machine,
which has no JAX, run them without tests/conftest.py: `python3 -m pytest
--noconftest tests/test_torch_instance_norm.py -m card`): the kernel
against the plain chain at the encoders' four plane shapes and each
variant, its reflect border against `F.pad` of its own interior, and one
encode's launches. No JAX here."""
import types

import pytest
import torch
import torch.nn.functional as F

from graspnerf_tpu_torch import tracing
from graspnerf_tpu_torch.models import nn_blocks
from graspnerf_tpu_torch.models.renderer import (NeuralRayRenderer,
                                                 init_parameters_)
from graspnerf_tpu_torch.ops import instance_norm as norm_op
from graspnerf_tpu_torch.ops.instance_norm import (
    instance_norm_act, instance_norm_act_plain, launch_plan)
from graspnerf_tpu_torch.ops.interpolate import resize_bilinear_align_corners

from _torch_util import card, one_thread  # noqa: F401  (fixtures)
from _torch_util import seeded_planner

ACTS = (None, "relu", "elu")
ACT_FNS = {None: lambda y: y, "relu": F.relu, "elu": F.elu}
SHORTCUTS = (None, "residual", "add")
# the encoders' norm planes at 6 views of 288 x 512: (views, channels, H, W)
PLANES = ((6, 32, 144, 256), (6, 32, 72, 128), (6, 64, 36, 64),
          (6, 128, 18, 32))


def seeded_norm(c, gen):
    norm = nn_blocks.InstanceNorm(c)
    with torch.no_grad():
        norm.weight.copy_(1 + 0.3 * torch.randn(c, generator=gen))
        norm.bias.copy_(0.3 * torch.randn(c, generator=gen))
    return norm


def inputs(shape, shortcut, gen, device="cpu"):
    x, other = (torch.randn(shape, generator=gen).to(device)
                for _ in range(2))
    return x, {shortcut: other} if shortcut else {}


def module_chain(x, norm, act, residual=None, add=None, pad=0, up=False):
    """The modules' ops: ResidualBlock's sum (shortcut + h), InstanceNorm,
    BasicBlock's add (bn2(...) + identity), the activation, UpConv's
    upsampling, Conv2d's reflect pad."""
    s = x if add is None else add + x
    y = norm(s)
    if residual is not None:
        y = y + residual
    y = ACT_FNS[act](y)
    h, w = y.shape[-2:]
    u = resize_bilinear_align_corners(y.float(), 2 * h, 2 * w) if up else y
    return s, y, (F.pad(u, (pad,) * 4, mode="reflect") if pad else None)


# ------------------------------------------------------------- on the CPU

@pytest.mark.parametrize("pad", [0, 1, 3])
@pytest.mark.parametrize("shortcut", SHORTCUTS)
@pytest.mark.parametrize("act", ACTS)
def test_plain_is_the_module_chain(act, shortcut, pad):
    gen = torch.Generator().manual_seed(3)
    norm = seeded_norm(5, gen)
    x, kw = inputs((2, 5, 7, 9), shortcut, gen)
    with torch.no_grad():
        s, y, yp = module_chain(x, norm, act, pad=pad, **kw)
        out = instance_norm_act_plain(x, norm.weight, norm.bias, act,
                                      pad=pad, eps=norm.eps, **kw)
        assert torch.equal(out.out, y)
        assert (out.padded is None) == (pad == 0)
        if pad:
            assert torch.equal(out.padded, yp)
        if shortcut == "add":
            assert torch.equal(out.sum, s)
        else:
            assert out.sum is None


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("act", ["relu", "elu"])
def test_plain_upsampled_is_the_module_chain(act, residual):
    gen = torch.Generator().manual_seed(11)
    norm = seeded_norm(4, gen)
    x, kw = inputs((2, 4, 5, 8), "residual" if residual else None, gen)
    with torch.no_grad():
        _, y, yp = module_chain(x, norm, act, pad=1, up=True, **kw)
        out = instance_norm_act_plain(x, norm.weight, norm.bias, act, pad=1,
                                      up=True, unpadded=False, **kw)
    assert out.out is None and out.padded.shape == (2, 4, 12, 18)
    assert torch.equal(out.padded, yp)


def test_cpu_wrapper_runs_the_plain_chain_into_a_slice():
    gen = torch.Generator().manual_seed(4)
    norm = seeded_norm(3, gen)
    x = torch.randn(2, 3, 6, 8, generator=gen)
    buf = torch.zeros(2, 5, 8, 10)
    before = instance_norm_act.launches
    with torch.no_grad():
        out = instance_norm_act(x, norm.weight, norm.bias, "elu", pad=1,
                                unpadded=False, padded=buf[:, :3])
        _, y, yp = module_chain(x, norm, "elu", pad=1)
    assert out.out is None and out.padded.data_ptr() == buf.data_ptr()
    assert torch.equal(buf[:, :3], yp) and not buf[:, 3:].any()
    assert instance_norm_act.launches == before


ENCODERS = ("image_encoder", "init_net", "vis_encoder")


def seeded_renderer(gen, **kw):
    nr = NeuralRayRenderer(**kw)
    init_parameters_(nr, gen)
    with torch.no_grad():                  # norms off their unit init
        for name, p in nr.named_parameters():
            if p.dim() == 1 and name.startswith(ENCODERS):
                p.add_(0.2 * torch.randn(p.shape, generator=gen))
    return nr


def chain_encode(nr, imgs):
    """The three encoders as their modules' chain runs them, written out."""
    def resunet(m, x):
        x = F.relu(m.bn1(m.conv1(x)))
        x1 = m.layer1(x)
        x2 = m.layer2(x1)
        x3 = m.layer3(x2)
        y = m.iconv3(torch.cat([m.upconv3(x3), x2], 1))
        y = m.iconv2(torch.cat([m.upconv2(y), x1], 1))
        return m.out_conv(y)
    x = imgs.permute(0, 3, 1, 2)
    img = resunet(nr.image_encoder, x).permute(0, 2, 3, 1).contiguous()
    init = nr.init_net.out_conv(resunet(nr.init_net.res_net, x))
    vis = torch.cat([img, init.permute(0, 2, 3, 1)], -1).permute(0, 3, 1, 2)
    ray = nr.vis_encoder.out_conv(vis).permute(0, 2, 3, 1)
    return img.float(), ray.contiguous().float()


@pytest.fixture(scope="module")
def imgs():
    return torch.rand(2, 32, 64, 3, generator=torch.Generator().manual_seed(5))


def test_fused_wiring_on_the_plain_norm_is_the_chain(imgs, monkeypatch):
    """The encoders' fused bodies (padded outputs, the decoder's padded
    concatenations, ResidualBlock's sums carried into the next norm, the
    unpadded 1x1 convolutions), run on the CPU where the wrapper takes the
    plain chain, give the chain's bits."""
    nr = seeded_renderer(torch.Generator().manual_seed(6))
    with torch.no_grad():
        expect = chain_encode(nr, imgs)
        monkeypatch.setattr(nn_blocks, "fused_norms", lambda *a: True)
        calls = []
        plain = nn_blocks.instance_norm_act
        monkeypatch.setattr(nn_blocks, "instance_norm_act",
                            lambda *a, **kw: calls.append(1) or plain(*a, **kw))
        got = nr._encode_views(imgs)
    assert len(calls) == 62
    for a, b in zip(got, expect):
        assert torch.equal(a, b)


@pytest.mark.parametrize("setting", ["cpu", "autograd", "bfloat16",
                                     "no_kernels"])
def test_other_calls_keep_the_chain(imgs, setting, monkeypatch):
    """On the CPU, with autograd on, in bfloat16 and with use_kernels
    False, the encoders never call the fused norm and give the chain's
    bits; the launch counter stays put."""
    kw = {"compute_dtype": "bfloat16"} if setting == "bfloat16" else {}
    if setting == "no_kernels":
        kw["use_kernels"] = False
    nr = seeded_renderer(torch.Generator().manual_seed(7), **kw)

    def refuse(*a, **k):
        raise AssertionError("the fused norm was called")
    monkeypatch.setattr(nn_blocks, "instance_norm_act", refuse)
    before = instance_norm_act.launches
    with torch.set_grad_enabled(setting == "autograd"):
        got = nr._encode_views(imgs)
        expect = chain_encode(nr, imgs)
    for a, b in zip(got, expect):
        assert torch.equal(a, b)
    assert instance_norm_act.launches == before


CUDA, CPU = torch.device("cuda", 0), torch.device("cpu")


@pytest.mark.parametrize("device,grad,x_dtype,dtype,use_kernels,hw,expect", [
    (CUDA, False, torch.float32, torch.float32, True, (144, 256), True),
    (CPU, False, torch.float32, torch.float32, True, (144, 256), False),
    (CUDA, True, torch.float32, torch.float32, True, (144, 256), False),
    (CUDA, False, torch.bfloat16, torch.float32, True, (144, 256), False),
    (CUDA, False, torch.float32, torch.bfloat16, True, (144, 256), False),
    (CUDA, False, torch.float32, torch.float32, False, (144, 256), False),
    (CUDA, False, torch.float32, torch.float32, True, (540, 960), "raises"),
])
def test_engage_rule(device, grad, x_dtype, dtype, use_kernels, hw, expect):
    """What the rule reads, on stand-ins: the input's device and dtype,
    autograd, the module's dtype and use_kernels. Not the planes' size:
    planes the kernel cannot take engage all the same, and the wrapper
    raises on them (no launch plan; on the card,
    test_kernel_refuses_planes_beyond_a_block)."""
    module = types.SimpleNamespace(use_kernels=use_kernels, dtype=dtype)
    x = types.SimpleNamespace(device=device, dtype=x_dtype)
    with torch.set_grad_enabled(grad):
        assert nn_blocks.fused_norms(module, x) is (expect is not False)
    assert (launch_plan(*hw) is None) is (expect == "raises")


@pytest.mark.parametrize("h,w,plan", [
    (144, 256, (1024, 4 * 36864)),    # the first norms at 288 x 512 images
    (72, 128, (512, 4 * 9216)),
    (36, 64, (256, 4 * 2304)),
    (18, 32, (128, 4 * 576)),
    (180, 320, (1024, 4 * 57600)),    # 360 x 640 images: the largest that fit
    (240, 320, None),                 # 480 x 640 images
])
def test_launch_plan_at_the_encoders_planes(h, w, plan):
    assert launch_plan(h, w) == plan


@pytest.mark.parametrize("h", [1, 4, 7, 33, 144, 287, 540, 1100])
@pytest.mark.parametrize("w", [9, 64, 256, 960])
def test_launch_plan_sizes(h, w):
    """A block a plane where the plane fits in its shared memory, with
    threads rising with the plane's size; else none."""
    plan = launch_plan(h, w)
    if 4 * h * w > norm_op.MAX_DYNAMIC_SMEM:
        assert plan is None
        return
    threads, smem = plan
    assert smem == 4 * h * w
    assert threads in (64, 128, 256, 512, 1024)
    assert threads == 1024 or threads >= norm_op.THREADS_PER_ROOT * (
        h * w) ** 0.5
    assert threads == 64 or threads < 2 * norm_op.THREADS_PER_ROOT * (
        h * w) ** 0.5


def test_norm_launches_count_inside_a_recording_root():
    """`norm_launches` counts the wrapper's launches while a root records,
    a replay's added launches included, and nowhere else."""
    key = "instance_norm_act.launches"
    tracing.reset()
    tracing.add_launches({key: 5})
    assert tracing.counters()["norm_launches"] == 0
    with torch.profiler.profile(), tracing.span("plan"):
        with tracing.span("encode"):
            tracing.add_launches({key: 62})
    assert tracing.counters()["norm_launches"] == 62
    tracing.reset()
    assert tracing.counters()["norm_launches"] == 0
    tracing.add_launches({key: -67})


# ------------------------------------------------------------- on the card

def assert_close(got, want):
    """Within 1e-5 of the output's scale."""
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * max(scale, 1.0), (err, scale)


@pytest.mark.card
@pytest.mark.parametrize("shortcut", SHORTCUTS)
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("shape", PLANES)
def test_kernel_against_the_chain(card, shape, act, shortcut):
    gen = torch.Generator().manual_seed(8)
    norm = seeded_norm(shape[1], gen).to(card)
    x, kw = inputs(shape, shortcut, gen, card)
    x = 3 * x + 0.5                          # off zero mean, off unit scale
    with torch.no_grad():
        for pad, up in ((0, False), (1, False), (3, False), (1, True),
                        (3, True)):
            want = module_chain(x, norm, act, pad=pad, up=up, **kw)
            got = instance_norm_act(x, norm.weight, norm.bias, act, pad=pad,
                                    up=up, eps=norm.eps, **kw)
            assert_close(got.out, want[1])
            if shortcut == "add":
                assert torch.equal(got.sum, want[0])
            if pad:
                assert_close(got.padded, want[2])
                interior = got.padded[..., pad:-pad, pad:-pad]
                if not up:
                    assert torch.equal(interior, got.out)
                assert torch.equal(got.padded, F.pad(interior, (pad,) * 4,
                                                     mode="reflect"))


@pytest.mark.card
@pytest.mark.parametrize("shape", [(2, 3, 37, 53), (1, 2, 5, 6),
                                   (1, 4, 180, 320), (3, 2, 21, 1000)])
def test_kernel_on_ragged_and_misaligned_planes(card, shape):
    """Rows that are no multiple of 4 floats and inputs off a 16-byte
    boundary (float loads), the largest plane a block takes."""
    gen = torch.Generator().manual_seed(9)
    norm = seeded_norm(shape[1], gen).to(card)
    n = torch.Size(shape).numel()
    raw = torch.randn(3 * n + 3, generator=gen).to(card)
    x, add, res = (raw[1 + i * n:1 + (i + 1) * n].view(shape)
                   for i in range(3))
    with torch.no_grad():
        for pad, up in ((1, False), (3, False), (1, True)):
            want = module_chain(x, norm, "relu", residual=res, pad=pad, up=up)
            got = instance_norm_act(x, norm.weight, norm.bias, "relu",
                                    residual=res, pad=pad, up=up)
            assert_close(got.padded, want[2])
            want = module_chain(x, norm, "elu", add=add, pad=pad)
            got = instance_norm_act(x, norm.weight, norm.bias, "elu",
                                    add=add, pad=pad)
            assert torch.equal(got.sum, want[0])
            assert_close(got.padded, want[2])


@pytest.mark.card
def test_kernel_into_a_concatenation_and_repeatable(card):
    gen = torch.Generator().manual_seed(10)
    norm = seeded_norm(64, gen).to(card)
    x = torch.randn(6, 64, 36, 64, generator=gen).to(card)
    skip = torch.randn(6, 64, 36, 64, generator=gen).to(card)
    with torch.no_grad():
        buf = torch.empty(6, 128, 38, 66, device=card)
        instance_norm_act(x, norm.weight, norm.bias, "elu", pad=1,
                          unpadded=False, padded=buf[:, :64])
        buf[:, 64:].copy_(F.pad(skip, (1,) * 4, mode="reflect"))
        want = F.pad(torch.cat([F.elu(norm(x)), skip], 1), (1,) * 4,
                     mode="reflect")
        assert_close(buf, want)
        again = instance_norm_act(x, norm.weight, norm.bias, "elu", pad=1)
        assert torch.equal(again.padded, buf[:, :64])


@pytest.mark.card
def test_kernel_refuses_planes_beyond_a_block(card):
    """A plane beyond one block's shared memory raises from the wrapper,
    and so does the fused encode of images that large: the card never
    falls back to the chain."""
    norm = seeded_norm(2, torch.Generator().manual_seed(12)).to(card)
    x = torch.randn(1, 2, 240, 320, device=card)
    nr = seeded_renderer(torch.Generator().manual_seed(13)).to(card)
    before = instance_norm_act.launches
    with torch.no_grad():
        with pytest.raises(ValueError, match="does not fit"):
            instance_norm_act(x, norm.weight, norm.bias, "relu", pad=1)
        with pytest.raises(ValueError, match="does not fit"):
            nr._encode_views(torch.rand(1, 480, 640, 3, device=card))
    assert instance_norm_act.launches == before


@pytest.mark.card
def test_one_encode_launches_62_norms(card):
    from bench_port import scenes
    planner = seeded_planner(card)
    nr = planner.model.nr_net
    s = scenes.plan_pool(7, 1, 6, 288, 512, [0.2, 0.8], CPU)[0]
    with torch.no_grad():
        ref = planner.scene(s["images"], s["extrinsics"], s["Ks"],
                            s["depth_range"])
        before = instance_norm_act.launches
        eager = nr._encode_views(ref["imgs"])
        assert instance_norm_act.launches == before + 62
        for _ in range(3):                     # warm-up, capture, replay
            replayed = nr.encode_views(ref["imgs"])
        assert instance_norm_act.launches == before + 4 * 62
    for a, b in zip(replayed, eager):
        assert torch.equal(a, b)
