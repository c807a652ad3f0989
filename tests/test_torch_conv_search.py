"""cuDNN's algorithm search over the encoders' convolutions
(`models/renderer.py` `searched_convolutions`, entered by
`NeuralRayRenderer._encode_views`).

On the CPU: the encode never enters the search, and leaves cuDNN's flags
and the `conv_search_calls` counter as they were; the search's flags are
set and restored as documented, and never set where autograd records.
Marked `card` (skipped without a CUDA card; on the card's machine, which
has no JAX, run them without tests/conftest.py: `python3 -m pytest
--noconftest tests/test_torch_conv_search.py -m card`): the planner at
the benchmark's size and seeded weights, the searched encode against
cuDNN's heuristic picks, the flags around a planning call, the capture
after one eager call, and the counter. No JAX here."""
import contextlib

import pytest
import torch

from graspnerf_tpu_torch import tracing
from graspnerf_tpu_torch.models import renderer

from _torch_util import card, one_thread  # noqa: F401  (fixtures)
from _torch_util import seeded_planner

cudnn = torch.backends.cudnn


def flags():
    """Every process-wide setting a convolution reads."""
    return (cudnn.benchmark, cudnn.benchmark_limit, cudnn.deterministic,
            cudnn.allow_tf32, cudnn.fp32_precision, cudnn.conv.fp32_precision,
            torch.backends.cuda.matmul.allow_tf32)


def searches():
    return tracing.counters()["conv_search_calls"]


# ------------------------------------------------------------- on the CPU

def test_cpu_encode_never_enters_the_search():
    nr = renderer.NeuralRayRenderer().eval()
    seen = []
    nr.image_encoder.conv1.register_forward_pre_hook(
        lambda *_: seen.append(flags()))
    imgs = torch.rand(2, 32, 64, 3, generator=torch.Generator().manual_seed(0))
    before, count = flags(), searches()
    with torch.no_grad():
        a = nr.encode_views(imgs)
        b = nr._encode_views(imgs)
    assert seen == [before, before]
    assert flags() == before and searches() == count
    for x, y in zip(a, b):
        assert x.shape == (2, 8, 16, 32) and torch.equal(x, y)


@pytest.mark.parametrize("raises", [False, True])
def test_search_sets_its_flags_and_restores_them(raises):
    """The block on a CUDA device (none is needed to set cuDNN's flags),
    autograd off: search on, `CONV_SEARCH_LIMIT` engines, the deterministic
    key; TF32 untouched; the flags as before afterwards, also when the
    block raises."""
    before, count = flags(), searches()
    with pytest.raises(RuntimeError) if raises else contextlib.nullcontext():
        with torch.no_grad(), renderer.searched_convolutions(
                torch.device("cuda", 0)):
            inside = flags()
            if raises:
                raise RuntimeError("inside")
    assert inside == (True, renderer.CONV_SEARCH_LIMIT, True) + before[3:]
    assert flags() == before
    assert searches() == count + 1


def test_no_search_where_autograd_records():
    """Training's calls (autograd on) keep cuDNN's heuristic, on a card
    too."""
    before, count = flags(), searches()
    with torch.enable_grad(), renderer.searched_convolutions(
            torch.device("cuda", 0)):
        assert flags() == before
    assert searches() == count


# ------------------------------------------------------------- on the card

def views(device, n=6, h=288, w=512, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.rand(n, h, w, 3, generator=g, device=device)


def heuristic_encode(nr, imgs):
    """`_encode_views`' body outside the search: cuDNN's heuristic picks,
    under their own cache keys."""
    img_feats = nr.image_encoder(imgs).contiguous()
    ray_feats = nr.vis_encoder(nr.init_net(imgs), img_feats)
    return img_feats.float(), ray_feats.contiguous().float()


def device_kernels(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA}


FFT = ("fft", "region_transform", "cf32")

# the searched encode against the heuristic one: the largest difference
# over the output's largest magnitude; float32's 2**-12 is ~2,000 float32
# ulps of the scale, bfloat16's 2**-3 16 bfloat16 ulps (InstanceNorm over a
# few pixels of the smallest maps magnifies one rounding)
TOLERANCE = {"graspnerf-fp32": 2.0 ** -12, "graspnerf-bf16": 2.0 ** -3}


@pytest.mark.card
@pytest.mark.parametrize("config", ["graspnerf-fp32", "graspnerf-bf16"])
def test_searched_encode_matches_heuristic_encode(card, config):
    nr = seeded_planner(card, config).model.nr_net
    imgs = views(card)
    with torch.no_grad():
        heuristic = heuristic_encode(nr, imgs)
        searched = nr._encode_views(imgs)
        searched_kernels = device_kernels(lambda: nr._encode_views(imgs))
        heuristic_kernels = device_kernels(lambda: heuristic_encode(nr, imgs))
    for s, h in zip(searched, heuristic):
        err = ((s - h).abs().max() / h.abs().max()).item()
        print(f"{config}: searched vs heuristic {err:.3e} of the scale")
        assert err <= TOLERANCE[config]
    if config == "graspnerf-fp32":   # the search leaves the FFT convolutions
        assert any(f in k for k in heuristic_kernels for f in FFT)
        assert not any(f in k for k in searched_kernels for f in FFT)


@pytest.mark.card
@pytest.mark.parametrize("preset", [None, (True, 3, False)])
def test_planning_call_leaves_the_flags(card, preset):
    from bench_port import scenes
    planner = seeded_planner(card)
    saved = flags()
    if preset is not None:
        cudnn.benchmark, cudnn.benchmark_limit, cudnn.deterministic = preset
    try:
        before = flags()
        s = scenes.plan_pool(7, 1, 6, 288, 512, [0.2, 0.8],
                             torch.device("cpu"))[0]
        for _ in range(3):                  # eager, capture, replay
            planner(s["images"], s["extrinsics"], s["Ks"], s["depth_range"])
            assert flags() == before
    finally:
        cudnn.benchmark, cudnn.benchmark_limit, cudnn.deterministic = saved[:3]


@pytest.mark.card
@pytest.mark.parametrize("config", ["graspnerf-fp32", "graspnerf-bf16"])
@pytest.mark.parametrize("shape", [(6, 288, 512), (4, 224, 320)])
def test_capture_after_one_eager_call_replays_it(card, config, shape):
    """The planner's views and another size: the first call searches, the
    capture after it finds every pick cached (a search under capture
    fails), and the replay gives the eager searched call's bits."""
    nr = seeded_planner(card, config).model.nr_net
    imgs = views(card, *shape)
    count = searches()
    with torch.no_grad():
        first = nr.encode_views(imgs)           # eager: searches
        captured = nr.encode_views(imgs)        # captures
        replayed = nr.encode_views(views(card, *shape, seed=1))
        assert searches() == count + 2
        again = nr._encode_views(imgs)
        eager = nr._encode_views(views(card, *shape, seed=1))
    for a, b, c in zip(first, captured, again):
        assert torch.equal(a, c) and torch.equal(b, c)
    for a, b in zip(replayed, eager):
        assert torch.equal(a, b)


@pytest.mark.card
def test_conv_search_calls_counts_eager_calls_and_captures(card):
    from bench_port import scenes
    planner = seeded_planner(card)
    pool = scenes.plan_pool(7, 2, 6, 288, 512, [0.2, 0.8],
                            torch.device("cpu"))
    count = searches()
    for s in pool * 2:                          # eager, capture, 2 replays
        planner(s["images"], s["extrinsics"], s["Ks"], s["depth_range"])
    assert searches() == count + 2
    nr = planner.model.nr_net
    with torch.no_grad():
        nr._encode_views(views(card))           # an eager body call
        heuristic_encode(nr, views(card))       # outside the search
    assert searches() == count + 3
    seen = []
    hook = nr.image_encoder.conv1.register_forward_pre_hook(
        lambda *_: seen.append(flags()))
    with torch.enable_grad():                   # training's forward
        feats = nr._encode_views(views(card))
    hook.remove()
    assert seen == [flags()] and feats[0].requires_grad
    assert searches() == count + 3
