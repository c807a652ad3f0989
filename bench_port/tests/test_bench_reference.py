"""The plain reference agrees with the port's plain path at a tiny size:
the planning call's volumes and the training step's losses and
gradients, on the same seeded weights and draws."""
import numpy as np
import pytest
import torch

from bench_port import reference, scenes, weights
from bench_port.drivers import common
from bench_port.tests.tiny import tiny_cell


@pytest.fixture(scope="module")
def setup():
    torch.set_num_threads(1)
    from graspnerf_tpu_torch.models import GraspNeRF
    cell = tiny_cell("train-fp32")
    c = cell.config
    sd = weights.seeded(common.reference_cfg(c), 7, torch.device("cpu"))
    port = GraspNeRF(common.renderer_cfg(c), use_kernels=False)
    port.load_state_dict(sd)
    ref = common.reference_model(c, sd, torch.device("cpu"))
    pool = scenes.train_pool(7, 1, 6, c["image_height"], c["image_width"],
                             (0.2, 0.8), 24, c["volume_resolution"], 5,
                             torch.device("cpu"))
    batch = scenes.on_device(pool[0], "cpu")
    return port, ref, batch


def test_plan_volumes(setup):
    port, ref, batch = setup
    inputs = batch["data"]["ref"]
    with torch.no_grad():
        f1, f2 = port.nr_net.encode_views(inputs["imgs"])
        vol = port.nr_net.sample_volume(inputs, f1, f2)
        heads = port.vgn_net(vol[None, ..., None])
        rvol, rheads = ref.plan(inputs)
    assert torch.allclose(vol, rvol, atol=1e-5)
    for a, b in zip(heads, rheads):
        assert torch.allclose(a[0], b, atol=1e-5)


def test_train_losses_and_gradients(setup):
    from graspnerf_tpu_torch.train import (compute_losses, create_train_state,
                                           gradients)
    port, ref, batch = setup
    state = create_train_state(port, device="cpu")
    out = port(batch["data"], train=True,
               generator=torch.Generator().manual_seed(3))
    ld = compute_losses(out, batch)
    total = sum(v for k, v in ld.items() if k.startswith("loss"))
    grads = gradients(state, total)
    rout = ref.train_forward(batch["data"], torch.Generator().manual_seed(3))
    terms = reference.loss_terms(rout, batch)
    assert set(terms) == {k for k in ld if k.startswith("loss")}
    for k, v in terms.items():
        assert abs(float(ld[k].detach()) - float(v.detach())) <= \
            1e-5 * abs(float(v.detach()))
    rg = torch.autograd.grad(sum(terms.values()), list(ref.parameters()),
                             allow_unused=True)
    norms = [0.0 if g is None else float(g.norm()) for g in rg]
    med = float(np.median(norms))
    for (name, p), a, b, n in zip(port.named_parameters(), grads, rg, norms):
        b = torch.zeros_like(p) if b is None else b
        assert float((a - b).norm()) <= 1e-4 * max(n, med), name
