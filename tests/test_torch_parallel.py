"""The port's (data, space) mesh (graspnerf_tpu_torch/parallel/) on the CPU:
each rank's share of a batch against the JAX shard at its mesh position;
`make_mesh`'s defaults and assertion, `initialize`'s no-op; and two gloo
processes (tests/_torch_parallel_worker.py) taking one step at (2, 1) and
at (1, 2), held to the one-process step on the same scenes, with a NaN in
one rank's scene skipping the update on both; the entry script on a (1, 2)
mesh.

The one-process step is held to JAX's in tests/test_torch_train.py, and
JAX holds its sharded step to its one-process step
(tests/test_training.py), so no JAX train step is compiled here.

Size: the entry script's --small shapes (64 x 96 views, 24 rays, 16 + 16
samples, an 8^3 volume, 256 depth-loss pixels, 5 grasps; ~0.3 s a step).
"""
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import jax
import pytest
import torch

from graspnerf_tpu.parallel import host_local_batch_to_global
from graspnerf_tpu.parallel import make_mesh as j_make_mesh
from graspnerf_tpu.parallel import shard_batch as j_shard_batch

from graspnerf_tpu_torch.models import GraspNeRF, init_parameters_
from graspnerf_tpu_torch.parallel import (Mesh, SpaceSplit, initialize,
                                          make_mesh, shard_batch)
from graspnerf_tpu_torch.tools.scene import (pinned_fine_samples,
                                             training_batch)
from graspnerf_tpu_torch.train import (cli, create_train_state, gradients,
                                       make_batched_loss_fn,
                                       scene_generators)
from _torch_util import one_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).parent / "_torch_parallel_worker.py"
CFG = dict(cli.SMALL_RENDERER)
SEED = 0
# JAX's own parity bounds for its sharded step (tests/test_training.py:106)
LOSS_RTOL, LOSS_ATOL = 2e-3, 2e-4
# the all-reduced gradients against the one-process step's: only the sum
# order differs (the ranks' shares added by the all-reduce, a space rank's
# layers on fewer rows), held at GRAD_RTOL of each tensor's scale. Below
# GRAD_FLOOR a gradient is rounding noise on a mathematically zero one (the
# conv biases before InstanceNorm, the colour blend's last bias): both must
# stay below it. The NeuS variances' gradients are each one scalar, the
# sum of the alpha derivative of every sample of every ray, terms of both
# signs that largely cancel, so the last bits of the SDFs move them far more
# than any other gradient: they are held at VARIANCE_RTOL. On the CPU, over
# seeds 0-7 of this test's inputs, the sound (1, 2) step put them up to
# 1.7e-3 of their scale from the one-process step (this seed: 3.3e-5 and
# 3.2e-4; every other gradient at most 7.6e-6), and a split without the
# join's all-reduce in its backward, or without it for alpha alone, put
# them 0.50 away. The (1, 2) step runs its fine pass at the one-process
# step's fine samples: the inverse CDF magnifies an ulp in a coarse hit
# probability (ROADMAP Queue 3, fine-sample conditioning).
GRAD_RTOL, GRAD_FLOOR, VARIANCE_RTOL = 1e-5, 1e-7, 3e-3
# seconds each process may take: the two-process test takes ~16 s alone,
# several times that beside a loaded test run
TIMEOUT = 300


# --------------------------------------------------------------- placement
def port_mesh(n_data, n_space, d, s):
    """The port's mesh at position (d, s), its space split without a group
    (placement needs none)."""
    return Mesh(n_data, n_space, d * n_space + s, SpaceSplit(None, n_space, s))


def placement_batch(scene_axis):
    rng = np.random.RandomState(0)
    lead = (4,) if scene_axis else ()
    return {"data": {"que": {"coords": rng.rand(*lead, 1, 8, 2)
                             .astype(np.float32)},
                     "ref": {"imgs": rng.rand(*lead, 2, 3, 4, 3)
                             .astype(np.float32)}},
            "sdf_gt": rng.rand(*lead, 4, 4, 4).astype(np.float32),
            "step": np.float32(7.0)}


def leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, path + (k,))
    else:
        yield path, tree


def get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
@pytest.mark.parametrize("how", ["shard_batch", "shard_batch_scene_axis",
                                 "host_local_batch_to_global"])
def test_rank_share_matches_jax_shard(shape, how):
    """Each rank's share (its scenes, and the rays of coords that its
    renderer takes) equals the data of the JAX shard at its mesh
    position."""
    n_data, n_space = shape
    scene_axis = how != "shard_batch"
    batch = placement_batch(scene_axis)
    jmesh = j_make_mesh(n_data, n_space, jax.devices()[:n_data * n_space])
    placed = (host_local_batch_to_global(jmesh, batch)
              if how == "host_local_batch_to_global"
              else j_shard_batch(jmesh, batch, scene_axis=scene_axis))
    devices = jmesh.devices
    for d in range(n_data):
        for s in range(n_space):
            mesh = port_mesh(n_data, n_space, d, s)
            share = shard_batch(mesh, batch, scene_axis=scene_axis)
            for path, x in leaves(share):
                if path[-1] == "coords":   # [*, qn, rn, 2]: the rank's rays
                    rays = mesh.split.rows(x.shape[-2])
                    x = x[..., rays, :]
                arr = get(placed, path)
                shard = next(sh for sh in arr.addressable_shards
                             if sh.device == devices[d, s])
                np.testing.assert_array_equal(x, np.asarray(shard.data),
                                              err_msg=f"{path} at {(d, s)}")


def test_indivisible_scene_axis_raises():
    batch = placement_batch(True)
    batch["sdf_gt"] = batch["sdf_gt"][:3]
    with pytest.raises(ValueError, match="not divisible"):
        shard_batch(port_mesh(2, 1, 1, 0), batch)
    shard_batch(port_mesh(2, 1, 1, 0), batch, scene_axis=False)


def test_mesh_defaults_and_initialize_noop():
    """One process: initialize without an address is a no-op, make_mesh
    puts the one rank on both axes and asserts the shape; a split of n
    rows cuts contiguous shares that differ by at most one."""
    assert initialize(None, 1, 0, device="cpu") is None
    assert not torch.distributed.is_initialized()
    mesh = make_mesh()
    assert mesh.shape == {"data": 1, "space": 1} and mesh.split is None
    assert make_mesh(n_space=1).size == 1
    with pytest.raises(AssertionError):
        make_mesh(2, 1)
    for n, size in ((1600, 2), (24, 4), (7, 3)):
        rows = [SpaceSplit(None, size, i).rows(n) for i in range(size)]
        assert [r.start for r in rows[1:]] == [r.stop for r in rows[:-1]]
        assert rows[0].start == 0 and rows[-1].stop == n
        assert max(r.stop - r.start for r in rows) - min(
            r.stop - r.start for r in rows) <= 1
    with pytest.raises(ValueError):
        SpaceSplit(None, 4, 0).rows(3)


# ------------------------------------------------------- two gloo processes
def small_model():
    model = init_parameters_(GraspNeRF(CFG), torch.Generator().manual_seed(SEED))
    with torch.no_grad():   # the SDF inside (-1, 1), not clipped
        for net in (model.nr_net.agg_net, model.nr_net.fine_agg_net):
            net.agg_impl.out_geometry_fc[1].weight *= 0.1
    return model


def stack(trees):
    if isinstance(trees[0], dict):
        return {k: stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def first(tree):
    if isinstance(tree, dict):
        return {k: first(v) for k, v in tree.items()}
    return tree[:1]


def small_batch(n_scenes):
    """n_scenes seeded single-scene batches at the --small shapes, stacked."""
    rng = np.random.RandomState(SEED)
    return stack([training_batch(rng, "cpu", 6, 64, 96, 24, 8, 5)
                  for _ in range(n_scenes)])


def one_process_step(params, batch):
    """The one-process losses, gradients and fine samples (one tensor a
    scene) on the batch's scenes."""
    model = GraspNeRF(CFG)
    model.load_state_dict(params)
    state = create_train_state(model, device="cpu")
    n = batch["sdf_gt"].shape[0]
    (total, ld), fine = pinned_fine_samples(
        lambda: make_batched_loss_fn(model)(
            batch, scene_generators(SEED, 0, range(n), "cpu")))
    return ({k: float(v.detach()) for k, v in ld.items()},
            gradients(state, total), fine)


def check_losses(got, want, what):
    for k, w in want.items():
        assert abs(got[k] - w) <= LOSS_ATOL + LOSS_RTOL * abs(w), (
            what, k, got[k], w)


def check_grads(got, want, names, what):
    bad = []
    for name, g, w in zip(names, got, want):
        scale = float(w.abs().max())
        err = float((g - w).abs().max())
        rtol = VARIANCE_RTOL if name.endswith(".variance") else GRAD_RTOL
        if scale < GRAD_FLOOR:
            err, scale = float(g.abs().max()) - GRAD_FLOOR, 0.0
        if err > rtol * scale:
            bad.append((name, err / max(scale, 1e-30), scale))
    assert not bad, (what, bad)


def test_launcher_stops_ranks_when_one_fails():
    """The entry script's launcher returns as soon as any rank fails, with
    its exit code, and stops the others: here rank 1 exits with 3 while
    rank 0 would wait a minute (as in a collective)."""
    rank = ("import sys, time; r = int(sys.argv[-1]); "
            "time.sleep(0.5 if r else 60); sys.exit(3 if r else 0)")
    t0 = time.monotonic()
    assert cli.launch([sys.executable, "-c", rank], 2) == 3
    assert time.monotonic() - t0 < 30
    assert cli.launch([sys.executable, "-c", "pass"], 2) == 0


def same_tree(got, want):
    """The same nesting, and tensors of the same dtype, shape and values."""
    if isinstance(want, (dict, list)):
        pairs = (zip(got.values(), want.values()) if isinstance(want, dict)
                 else zip(got, want))
        return (type(got) is type(want) and len(got) == len(want)
                and (not isinstance(want, dict) or got.keys() == want.keys())
                and all(same_tree(g, w) for g, w in pairs))
    return (got.dtype == want.dtype and got.shape == want.shape
            and torch.equal(got, want))


TREES = [{"a": torch.arange(6.0).reshape(2, 3),
          "b": [torch.tensor([True, False]),
                torch.full((2, 2), 1.5, dtype=torch.bfloat16)],
          "c": torch.tensor(7)},
         []]


def test_two_gloo_processes(tmp_path, monkeypatch):
    """Two ranks (gloo, CPU), one step each at (2, 1) and (1, 2): the world-
    mean gradients within GRAD_RTOL of each tensor's scale of the one-
    process step's, the losses (the ranks' mean at (2, 1)) at JAX's bounds,
    every parameter bit-equal across the ranks after the update; NaN views
    in rank 1's scene skip the update on both ranks; rank 0's batches
    broadcast over the space group arrive whole. Meanwhile the entry script
    on a (1, 2) mesh: rank 0 alone writes the log, with the mesh in its
    run-config line, and one checkpoint."""
    model = small_model()
    params = model.state_dict()
    batch = small_batch(2)
    want_data = one_process_step(params, batch)
    want_space = one_process_step(params, first(batch))
    torch.save({"cfg": CFG, "params": params, "batch": batch, "seed": SEED,
                "fine": want_space[2], "trees": TREES},
               tmp_path / "inputs.pt")
    # one thread a rank, here and in the entry script's ranks: a share of
    # the cores each would oversubscribe a loaded test run
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    addr = f"file://{tmp_path / 'rendezvous'}"
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), addr, "2", str(r), str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    workdir = tmp_path / "cli"
    with open(tmp_path / "cli.log", "w") as log:
        # a session of its own: on a timeout its ranks are stopped with it
        entry = subprocess.Popen(
            [sys.executable, "-m", "graspnerf_tpu_torch.train.cli", "--mesh",
             "1,2", "--device", "cpu", "--small", "--steps", "2",
             "--workers", "0", "--workdir", str(workdir), "--no-tensorboard",
             "--log-every", "1", "--save-interval", "2", "--val-interval",
             "100"], cwd=REPO, stdout=log, stderr=subprocess.STDOUT,
            start_new_session=True)
    try:
        outs = [p.communicate(timeout=TIMEOUT) for p in procs]
        entry.wait(timeout=TIMEOUT)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        if entry.poll() is None:
            os.killpg(entry.pid, signal.SIGKILL)
            entry.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    assert entry.returncode == 0, (tmp_path / "cli.log").read_text()[-3000:]

    recs = [json.loads(line) for line in open(workdir / "metrics.jsonl")]
    cfgs = [r for r in recs if r.get("run_config")]
    assert len(cfgs) == 1 and cfgs[0]["mesh"] == {"data": 1, "space": 2}
    assert cfgs[0]["n_devices"] == 2 and cfgs[0]["dist_backend"] == "gloo"
    steps = [r for r in recs if "sec_per_step" in r]
    assert [r["step"] for r in steps] == [1, 2]
    assert all(r["nonfinite_grad"] == 0.0 for r in steps)
    assert sorted(os.listdir(workdir / "ckpt")) == ["latest", "step_2.pt"]

    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    for res in ranks:
        assert res["shapes"] == ({"data": 1, "space": 2},
                                 {"data": 2, "space": 1},
                                 {"data": 1, "space": 2})
    names = [n for n, _ in model.named_parameters()]
    for case, (want_ld, want_g, _) in (("data", want_data),
                                       ("space", want_space)):
        got = [r[case] for r in ranks]
        assert all(g["finite"] and g["updates"] == 1 for g in got)
        if case == "data":   # each rank's losses are its scene's
            mean = {k: (got[0]["metrics"][k] + got[1]["metrics"][k]) / 2
                    for k in want_ld}
            check_losses(mean, want_ld, case)
        else:
            for g in got:
                check_losses(g["metrics"], want_ld, case)
        for g in got:
            check_grads(g["grads"], want_g, names, case)
        for a, b in zip(got[0]["params"], got[1]["params"]):
            assert torch.equal(a, b), case
    assert all(same_tree(r["broadcast"], TREES) for r in ranks)
    nan = [r["nan"] for r in ranks]
    assert not nan[0]["finite"] and not nan[1]["finite"]
    for g in nan:
        assert g["updates"] == 0
        for a, b in zip(g["params"], model.parameters()):
            assert torch.equal(a, b)
