"""CUDA graphs of the planning call's stages (graspnerf_tpu_torch/graphs.py)
and the device constants that make the stages capturable.

On the CPU: the cached constants against the per-call ones they replace,
the helper's decision, key and structures as plain functions, and the
eager fallback. Marked `card` (skipped without a CUDA card; on the card's
machine, which has no JAX, run them without tests/conftest.py:
`python3 -m pytest --noconftest tests/test_torch_graphs.py -m card`): the
planner at the benchmark's size and seeded weights, replayed against its
own stage bodies called eagerly. No JAX here."""
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from graspnerf_tpu_torch import graphs, tracing
from graspnerf_tpu_torch.detect.postprocess import GraspCandidates
from graspnerf_tpu_torch.models import ibrnet, renderer
from graspnerf_tpu_torch.ops import image, interpolate

from _torch_util import card, one_thread  # noqa: F401  (fixtures)
from _torch_util import seeded_planner
from torch.utils._pytree import tree_flatten

CPU = torch.device("cpu")


# ------------------------------------------------------- cached constants
# each the code it replaced, which made the constant on every call

def resize_nearest_3d_per_call(x, out_d, out_h, out_w):
    for dim, n_out in zip((-3, -2, -1), (out_d, out_h, out_w)):
        n_in = x.shape[dim]
        idx = [math.floor(i * (n_in / n_out)) for i in range(n_out)]
        x = x.index_select(dim, torch.tensor(idx, device=x.device))
    return x


def gaussian_filter_3d_per_call(vol, sigma=1.0, truncate=4.0):
    radius = int(truncate * sigma + 0.5)
    k = torch.from_numpy(image._gaussian_kernel1d(sigma, radius))
    x = vol[None, None]
    for ax in range(3):
        shape = [1, 1, 1, 1, 1]
        shape[2 + ax] = k.numel()
        pad = [0, 0, 0, 0, 0, 0]
        pad[2 * (2 - ax)] = pad[2 * (2 - ax) + 1] = radius
        x = F.conv3d(F.pad(x, pad, mode="replicate"), k.reshape(shape))
    return x[0, 0]


def maximum_filter_3d_per_call(vol, size=4):
    lo = size // 2
    hi = size - 1 - lo
    for dim in range(3):
        n = vol.shape[dim]
        idx = np.concatenate([np.arange(lo)[::-1], np.arange(n),
                              n - 1 - np.arange(hi)])
        vol = vol.index_select(dim, torch.from_numpy(idx))
    return F.max_pool3d(vol[None, None], size, stride=1)[0, 0]


@pytest.mark.parametrize("shape,out", [((5, 7, 9), (10, 10, 10)),
                                       ((9, 7, 5), (3, 5, 7)),
                                       ((10, 10, 10), (13, 11, 7)),
                                       ((5, 5, 5), (40, 20, 10))])
def test_resize_nearest_index_cached(shape, out):
    x = torch.randn((2, 3) + shape, generator=torch.Generator().manual_seed(0))
    assert torch.equal(interpolate.resize_nearest_3d(x, *out),
                       resize_nearest_3d_per_call(x, *out))
    for n_in, n_out in zip(shape, out):
        idx = interpolate.nearest_index(n_in, n_out, CPU)
        assert idx.tolist() == [math.floor(i * (n_in / n_out))
                                for i in range(n_out)]
        assert interpolate.nearest_index(n_in, n_out, CPU) is idx


@pytest.mark.parametrize("shape", [(8, 8, 8), (7, 9, 11), (40, 40, 40)])
def test_filters_constants_cached(shape):
    vol = torch.rand(shape, generator=torch.Generator().manual_seed(1))
    assert torch.equal(image.gaussian_filter_3d(vol),
                       gaussian_filter_3d_per_call(vol))
    assert torch.equal(image.maximum_filter_3d(vol),
                       maximum_filter_3d_per_call(vol))
    k = image.gaussian_weights(1.0, 4, CPU)
    assert torch.equal(k, torch.from_numpy(image._gaussian_kernel1d(1.0, 4)))
    assert image.gaussian_weights(1.0, 4, CPU) is k
    for n in shape:
        idx = image.reflect_index(n, 2, 1, CPU)
        assert idx.tolist() == [1, 0, *range(n), n - 1]
        assert image.reflect_index(n, 2, 1, CPU) is idx


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_positional_table_and_z_axis_cached(dtype):
    table = ibrnet.positional_table_on(40, CPU, dtype)
    assert torch.equal(table, torch.from_numpy(
        ibrnet.positional_table(40)).to(CPU, dtype))
    assert ibrnet.positional_table_on(40, CPU, dtype) is table
    pts = torch.zeros(2, 3, dtype=dtype)
    z = renderer.z_axis(dtype, CPU)
    assert torch.equal(z, pts.new_tensor([0.0, 0.0, 1.0]))
    assert z.dtype == dtype and renderer.z_axis(dtype, CPU) is z


# ------------------------------------------------- the helper's decisions

@pytest.mark.parametrize("device,grad,split,expect", [
    ("cuda", False, None, True),
    ("cpu", False, None, False),
    ("cuda", True, None, False),
    ("cuda", False, "a rank split", False),
    ("cpu", True, "a rank split", False)])
def test_engages_only_where_a_call_can_be_captured(device, grad, split,
                                                    expect):
    assert graphs.engages(torch.device(device), grad, split) is expect


def key_of(args, modules, extra=()):
    leaves, spec = tree_flatten(args)
    holders = [m for mod in modules for m in mod.modules() if m._parameters]
    return graphs.call_key(leaves, spec, extra, holders)


def test_key_follows_inputs_settings_and_parameters():
    net = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.ReLU(),
                              torch.nn.Linear(4, 2))
    x = torch.zeros(5, 3)
    ref = {"imgs": x, "poses": torch.zeros(2, 3, 4)}
    key = key_of((ref, None), [net], (0.9, 64))
    assert key_of((dict(ref), None), [net], (0.9, 64)) == key
    assert key_of(({**ref, "imgs": torch.ones(5, 3)}, None), [net],
                  (0.9, 64)) == key                       # values: no
    changed = [({**ref, "imgs": torch.zeros(6, 3)}, None),          # shape
               ({**ref, "imgs": x.double()}, None),                 # dtype
               ({"imgs": x}, None),                                 # keys
               (ref, (x, x, x))]                                    # maps
    for args in changed:
        assert key_of(args, [net], (0.9, 64)) != key
    assert key_of((ref, None), [net], (0.5, 64)) != key    # a setting
    with torch.no_grad():
        net[0].weight.mul_(1.0)                     # a version bump
    assert key_of((ref, None), [net], (0.9, 64)) != key
    key = key_of((ref, None), [net], (0.9, 64))
    net[2].bias = torch.nn.Parameter(net[2].bias.detach().clone())
    assert key_of((ref, None), [net], (0.9, 64)) != key     # replaced


def test_with_tensors_swaps_only_tensors():
    t = [torch.full((2,), float(i)) for i in range(6)]
    obj = (({"a": t[0], "b": None}, [t[1], 3]),
           GraspCandidates(t[2], t[3], t[4], t[5]))
    leaves, _ = tree_flatten(obj)
    assert [x is y for x, y in zip(graphs.tensors_of(leaves), t)] == [True] * 6
    new = [x + 1 for x in t]
    swapped = graphs.with_tensors(leaves, iter(new))
    assert [x for x in swapped if isinstance(x, torch.Tensor)] == new
    assert ([x for x in swapped if not isinstance(x, torch.Tensor)]
            == [x for x in leaves if not isinstance(x, torch.Tensor)])


def test_cpu_calls_run_eagerly():
    calls = []

    def body(x):
        calls.append(x)
        return x + 1
    owner = torch.nn.Linear(2, 2)
    x = torch.zeros(2)
    before = tracing.counters()
    for _ in range(3):
        assert torch.equal(graphs.run(owner, "s", body, (x,), [owner]),
                           x + 1)
    assert len(calls) == 3 and all(c is x for c in calls)
    after = tracing.counters()
    assert after["graph_captures"] == before["graph_captures"]
    assert after["graph_replays"] == before["graph_replays"]


def test_launch_counters_take_a_replays_launches():
    counts = tracing.launch_counts()
    assert "view_fuse.launches" in counts
    tracing.add_launches({"view_fuse.launches": 2,
                          "epipolar_gather.launches": 1})
    after = tracing.launch_counts()
    assert after["view_fuse.launches"] == counts["view_fuse.launches"] + 2
    assert (after["epipolar_gather.launches"]
            == counts["epipolar_gather.launches"] + 1)
    tracing.add_launches({"view_fuse.launches": -2,
                          "epipolar_gather.launches": -1})
    assert tracing.launch_counts() == counts


def test_replays_count_only_inside_a_recording_root():
    tracing.reset()
    tracing.count_recorded("graph_replays")
    assert tracing.counters()["graph_replays"] == 0
    with torch.profiler.profile(), tracing.span("plan"):
        tracing.count_recorded("graph_replays")
    assert tracing.counters()["graph_replays"] == 1
    tracing.reset()
    assert tracing.counters()["graph_replays"] == 0


class FakeGraph:
    """Stands in for `_Graph` on the CPU: records the graph each capture
    replaces, replays fn on the call's inputs."""
    captured = []

    def __init__(self, fn, leaves, spec, key, replaced=None):
        self.key, self.fn = key, fn
        FakeGraph.captured.append(replaced)

    def replay(self, tensors):
        return self.fn(*tensors)


@pytest.fixture
def as_if_on_a_card(monkeypatch):
    """graphs.run as on a card: every call engages, and `_Graph` is
    `FakeGraph`."""
    FakeGraph.captured = []
    monkeypatch.setattr(graphs, "engages", lambda *a: True)
    monkeypatch.setattr(graphs, "_Graph", FakeGraph)
    return FakeGraph.captured


def test_captures_on_the_second_call_with_one_key(as_if_on_a_card):
    calls = []

    def body(x):
        calls.append(x.shape)
        return x + 1
    owner = torch.nn.Linear(2, 2)
    small, large = torch.zeros(2), torch.zeros(3)

    def call(x):
        out = graphs.run(owner, "s", body, (x,), [owner])
        assert torch.equal(out, x + 1)
        return len(as_if_on_a_card)
    with torch.no_grad():
        assert [call(x) for x in (small, large, small, large)] == [0] * 4
        assert len(calls) == 4                      # keys alternate: eager
        assert call(large) == 1                     # twice in a row: capture
        assert [call(large) for _ in range(3)] == [1] * 3       # replays
        first = graphs._stages[owner]["s"].graph
        owner.weight.mul_(1.0)                      # a weight update
        assert call(large) == 1                     # eager, once
        assert call(large) == 2                     # then captured
        assert call(large) == 2
    # the recapture is handed the graph it replaces (its pool and stream)
    assert as_if_on_a_card == [None, first]


# ------------------------------------------------------------- on the card

@pytest.fixture(scope="module")
def pool():
    from bench_port import scenes
    return scenes.plan_pool(7, 3, 6, 288, 512, [0.2, 0.8], CPU)


def stages(planner, s):
    """(img_feats, ray_feats, vol, (qual, rot, width), cand) of one call
    through the planner's stages."""
    with torch.no_grad():
        ref = planner.scene(s["images"], s["extrinsics"], s["Ks"],
                            s["depth_range"])
        feats = planner.encode(ref["imgs"])
        vol, heads, cand = planner.volume(ref, *feats)
    return (*feats, vol, heads, cand)


def eager(planner, s):
    """The same call through the stage bodies, which never replay."""
    nr = planner.model.nr_net
    with torch.no_grad():
        ref = planner.scene(s["images"], s["extrinsics"], s["Ks"],
                            s["depth_range"])
        feats = nr._encode_views(ref["imgs"])
        vol = nr._sample_volume(ref, *feats, None)
        heads, cand = planner._detect(vol)
    return (*feats, vol, heads, cand)


def tensors_of(out):
    return graphs.tensors_of(tree_flatten(out)[0])


def assert_bit_equal(a, b):
    ta, tb = tensors_of(a), tensors_of(b)
    assert len(ta) == len(tb)
    for x, y in zip(ta, tb):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert torch.equal(x, y), (x - y).abs().max().item()


@pytest.mark.card
@pytest.mark.parametrize("config", ["graspnerf-fp32", "graspnerf-bf16"])
def test_replays_equal_eager_calls(card, pool, config):
    planner = seeded_planner(card, config)
    stages(planner, pool[0])
    stages(planner, pool[0])                    # capture
    before = tracing.counters()["graph_captures"]
    for s in pool:
        assert_bit_equal(stages(planner, s), eager(planner, s))
    assert tracing.counters()["graph_captures"] == before


@pytest.mark.card
def test_kept_outputs_survive_the_next_call(card, pool):
    planner = seeded_planner(card)
    stages(planner, pool[0])
    stages(planner, pool[0])                    # capture
    kept = stages(planner, pool[1])
    copy = [t.clone() for t in tensors_of(kept)]
    stages(planner, pool[2])
    torch.cuda.synchronize(card)
    for t, c in zip(tensors_of(kept), copy):
        assert torch.equal(t, c)


@pytest.mark.card
def test_launch_counters_advance_as_eagerly(card, pool):
    planner = seeded_planner(card)
    stages(planner, pool[0])
    stages(planner, pool[0])                    # capture

    def launches(fn):
        a = tracing.launch_counts()
        fn(planner, pool[1])
        b = tracing.launch_counts()
        return {k: b[k] - a[k] for k in a}
    replayed, eagerly = launches(stages), launches(eager)
    assert replayed == eagerly
    assert replayed["view_fuse.launches"] == 1
    assert replayed["epipolar_gather.launches"] == 1


@pytest.mark.card
def test_syncs_and_replays_a_call(card, pool):
    planner = seeded_planner(card)
    s = pool[0]
    for _ in range(2):                          # the second captures
        planner(s["images"], s["extrinsics"], s["Ks"], s["depth_range"])
    tracing.reset()
    with torch.profiler.profile():
        for s in pool:
            planner(s["images"], s["extrinsics"], s["Ks"], s["depth_range"])
    roots = [r for r in tracing.records() if r.parent is None]
    counts = tracing.counters()
    tracing.reset()
    assert len(roots) == len(pool)
    assert counts["host_syncs"] == 9 * len(pool)
    assert counts["graph_replays"] == 3 * len(pool)


@pytest.mark.card
def test_weight_update_recaptures(card, pool):
    planner = seeded_planner(card)
    stages(planner, pool[0])
    stages(planner, pool[0])                    # capture
    before = tracing.counters()["graph_captures"]
    agg = planner.model.nr_net.agg_net.agg_impl
    with torch.no_grad():                       # the view fuse's pack too
        agg.out_geometry_fc[1].weight.mul_(1.5)
        agg.fuse_weights()[0][0].mul_(1.5)
        planner.model.vgn_net.conv_qual.weight.mul_(1.5)
    first = stages(planner, pool[1])            # eager: a new key
    assert tracing.counters()["graph_captures"] == before
    second = stages(planner, pool[1])           # captures, then replays
    assert tracing.counters()["graph_captures"] == before + 2
    expect = eager(planner, pool[1])
    assert_bit_equal(stages(planner, pool[1]), expect)
    assert_bit_equal(first, expect)
    assert_bit_equal(second, expect)
