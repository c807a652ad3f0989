"""What the port's test modules share (tests/test_torch_*.py).

`one_thread`: imported into a module, an autouse fixture that pins torch to
one intra-op thread for the module, its module fixtures included. At these
shapes one thread is as fast as many, and it keeps the parallel test
workers from oversubscribing the shared cores (each torch op's threads spin
while they wait). `card`: the CUDA card for a test marked `card`.
`seeded_planner`: the planner at a benchmark configuration's settings on
its seeded weights."""
import json
import os

import pytest
import torch

CONFIGS = os.path.join(os.path.dirname(__file__), os.pardir, "bench_port",
                       "configs")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    """The CUDA card, decided here and never at import; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def seeded_planner(device, config="graspnerf-fp32"):
    from bench_port import weights
    from bench_port.drivers import common
    from graspnerf_tpu_torch.detect.planner import GraspNeRFPlanner
    with open(os.path.join(CONFIGS, config + ".json")) as f:
        config = json.load(f)
    common.build_kernels(device)
    params = weights.seeded(common.reference_cfg(config), 11, device)
    return GraspNeRFPlanner(params, device, common.renderer_cfg(config),
                            qual_threshold=0.5)
