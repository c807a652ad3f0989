"""The reference-checkpoint import of the port
(`graspnerf_tpu_torch.convert.convert_reference_state_dict` and `python3
-m graspnerf_tpu_torch.convert`) against the JAX package's
`convert_state_dict` (graspnerf_tpu/models/convert.py), on a
reference-format model_best.pth built from the JAX model's seeded tree:
torch keys from JAX's `torch_key`, torch layouts, one dead buffer, a step
and an empty optimizer state, as the upstream trainer saves it (ref
trainer.py:199-218).

The planner on an imported checkpoint is held to JAX's planner in
tests/test_torch_planner.py::test_planner_on_imported_checkpoint_matches_jax,
beside the module's one JAX compile."""
import math

import jax
import numpy as np
import pytest
import torch

from graspnerf_tpu.models.convert import convert_state_dict, torch_key
from graspnerf_tpu_torch.convert import (convert_reference_state_dict,
                                         flax_to_state_dict, main)
from graspnerf_tpu_torch.train.checkpoint import load_params

from test_torch_models import graspnerf_params
from _torch_util import one_thread  # noqa: F401  (autouse)

DEAD = {"nr_net.init_net.bn.num_batches_tracked": torch.tensor(7),
        "vgn_net.conv1.running_mean": torch.zeros(16)}
# torch layout of a flax kernel: the inverse of JAX's _to_flax
TO_TORCH = {2: (1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}


def reference_state_dict(params):
    """The reference's network_state_dict of a flax tree: JAX's torch keys,
    torch layouts, and the DEAD buffers."""
    sd = {}

    def put(path, leaf):
        a = np.asarray(leaf)
        if path[-1].key == "kernel":
            a = a.transpose(TO_TORCH[a.ndim])
        sd[torch_key(path)] = torch.from_numpy(np.array(a, order="C"))
    jax.tree_util.tree_map_with_path(put, params)
    sd.update(DEAD)
    return sd


@pytest.fixture(scope="module")
def reference():
    """(flax params, the reference's network_state_dict of them)."""
    params = graspnerf_params()
    return params, reference_state_dict(params)


def test_import_matches_jax_convert_state_dict(reference):
    params, sd = reference
    got, unused = convert_reference_state_dict(sd)
    flax, jax_unused = convert_state_dict(params, sd)
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, flax))
    assert unused == jax_unused == sorted(DEAD)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32 and got[k].shape == v.shape, k
        assert torch.equal(got[k], v), k


def test_import_casts_to_float32(reference):
    _, sd = reference
    wide = {k: v.double() if v.is_floating_point() else v
            for k, v in sd.items()}
    got, _ = convert_reference_state_dict(wide)
    want, _ = convert_reference_state_dict(sd)
    for k in want:
        assert got[k].dtype == torch.float32 and torch.equal(got[k], want[k])


def test_import_refuses_missing_key_and_wrong_shape(reference):
    _, sd = reference
    key = "vgn_net.conv_qual.weight"
    with pytest.raises(KeyError, match=key):
        convert_reference_state_dict({k: v for k, v in sd.items()
                                      if k != key})
    bad = dict(sd, **{key: sd[key][:, :, :1]})
    with pytest.raises(ValueError, match=key):
        convert_reference_state_dict(bad)


def test_cli_writes_a_checkpoint_load_params_reads(reference, tmp_path,
                                                   capsys):
    """`python3 -m graspnerf_tpu_torch.convert model_best.pth out.pt`
    (its `main`): the dead buffers printed, a file `load_params` reads."""
    _, sd = reference
    pth = tmp_path / "model_best.pth"
    torch.save({"network_state_dict": sd, "step": 123,
                "optimizer_state_dict": {}}, pth)
    out = tmp_path / "port.pt"
    assert main([str(pth), str(out)]) == 0
    printed = capsys.readouterr().out
    assert "2 unused torch keys" in printed and all(k in printed
                                                   for k in DEAD)
    ckpt = torch.load(out, weights_only=True)
    assert ckpt["step"] == 123 and ckpt["best"] == math.inf
    sd_port = load_params(str(out))
    for k, v in convert_reference_state_dict(sd)[0].items():
        assert torch.equal(sd_port[k], v), k
