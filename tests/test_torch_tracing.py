"""The port's spans and counters (graspnerf_tpu_torch/tracing.py) on the
CPU: the planner on 6 views of 64 x 96, as in test_torch_planner.py, with
an 8^3 volume (16^3 there: at 8^3 a call takes ~0.12 s, and one test makes
20), on seeded weights of the port's own initialiser."""
import contextlib
import json
import signal
import warnings

import numpy as np
import pytest
import torch

from graspnerf_tpu_torch import build, tracing
from graspnerf_tpu_torch.detect.planner import GraspNeRFPlanner
from graspnerf_tpu_torch.models import GraspNeRF, init_parameters_
from graspnerf_tpu_torch.tools.scene import synthetic_views

from _torch_util import one_thread  # noqa: F401  (autouse)

CFG = {"volume_resolution": 8}
# each span of the planning call and its children
TREE = {"plan": {"upload", "encode", "volume", "head", "wait", "grasps"},
        "encode": {"encode.image", "encode.rayinit", "encode.vis"},
        "volume": {"volume.project", "volume.gather", "volume.decode",
                   "volume.fuse"},
        "head": {"head.cnn", "head.post"}}
SPANS = set(TREE).union(*TREE.values())


@contextlib.contextmanager
def time_limit(seconds: int):
    """Fails the block once it has run `seconds` (SIGALRM)."""
    def fail(signum, frame):
        raise TimeoutError(f"over its {seconds} s limit")
    old = signal.signal(signal.SIGALRM, fail)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


@pytest.fixture(scope="module")
def params():
    model = GraspNeRF(CFG)
    init_parameters_(model, torch.Generator().manual_seed(0))
    return model.state_dict()


@pytest.fixture(scope="module")
def planner(params):
    return GraspNeRFPlanner(params, device="cpu", renderer_cfg=CFG)


@pytest.fixture(scope="module")
def views():
    return synthetic_views(np.random.RandomState(0), 6, 64, 96)[:3]


@pytest.fixture(scope="module")
def traced(planner, views, tmp_path_factory):
    """One planning call under `tracing.trace`: (its records, the events of
    its Chrome trace)."""
    out = tmp_path_factory.mktemp("trace")
    tracing.reset()
    with tracing.trace(str(out)):
        planner(*views)
    recs = tracing.records()
    tracing.reset()
    with open(out / "trace.json") as f:
        return recs, json.load(f)["traceEvents"]


def test_profiler_off_records_nothing(planner, views):
    tracing.reset()
    syncs = tracing.counters()["host_syncs"]
    with time_limit(60):
        for _ in range(20):
            planner(*views)
    assert tracing.records() == []
    assert tracing.counters()["host_syncs"] == syncs


def test_a_call_records_one_plan_tree(traced):
    recs, _ = traced
    assert sorted(r.name for r in recs) == sorted(SPANS)   # each once
    (root,) = [r for r in recs if r.parent is None]
    assert root.name == "plan" and {r.root for r in recs} == {root.id}
    for name, children in TREE.items():
        (rec,) = [r for r in recs if r.name == name]
        assert {r.name for r in recs if r.parent is rec} == children
    for rec in recs:
        if rec.parent is not None:
            assert (rec.parent.start_ns <= rec.start_ns <= rec.end_ns
                    <= rec.parent.end_ns)
        covered = sum(r.ms for r in recs if r.parent is rec)
        assert tracing.self_ms(rec) == pytest.approx(rec.ms - covered,
                                                     abs=1e-9)


def test_chrome_trace_holds_the_spans(traced):
    _, events = traced
    xs = [e for e in events if e.get("ph") == "X"]
    (plan,) = [e for e in xs if e["name"] == "graspnerf.plan"]
    (gather,) = [e for e in xs if e["name"] == "graspnerf.volume.gather"]
    assert plan["ts"] <= gather["ts"]
    assert gather["ts"] + gather["dur"] <= plan["ts"] + plan["dur"]


def test_host_syncs_counts_sync_warnings_alone(monkeypatch):
    """A root span on a card counts the sync debug mode's warnings and
    shows the others; the card's three calls are stand-ins here."""
    modes = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    before = tracing.counters()["host_syncs"]
    with pytest.warns(UserWarning, match="another") as shown:
        with torch.profiler.profile(), tracing.span("plan"):
            for _ in range(3):
                warnings.warn(tracing.SYNC_WARNING
                              + " (Triggered internally at x.cpp:1.)")
            warnings.warn("another warning")
    assert tracing.counters()["host_syncs"] == before + 3
    assert modes == ["warn", 0] and len(shown) == 1
    tracing.reset()


def test_set_up_counters(params, tmp_path, monkeypatch):
    """model_load_s grows with each model loaded; kernels_built counts the
    libraries `build.build` compiles (here a stand-in compiler's), not
    those it finds built."""
    before = tracing.counters()["model_load_s"]
    GraspNeRFPlanner(params, device="cpu", renderer_cfg=CFG)
    assert tracing.counters()["model_load_s"] > before

    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do\n'
                    '  [ "$1" = -o ] && : > "$2"\n  shift\ndone\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    built = tracing.counters()["kernels_built"]
    build.build(["view_fuse", "epipolar_gather"])
    assert tracing.counters()["kernels_built"] == built + 2
    build.build(["view_fuse"])
    assert tracing.counters()["kernels_built"] == built + 2
