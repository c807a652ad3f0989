"""The reference's FLOP count at a tiny shape: the grasp head's nine
convolutions at 8^3, counted by hand."""
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_port.reference.model import VGN


def conv(out_voxels, cout, cin, k):
    return 2 * out_voxels * cout * cin * k ** 3


def test_grasp_head_flops():
    head = VGN()
    with FlopCounterMode(display=False) as fc:
        head(torch.rand(8, 8, 8))
    want = (conv(4 ** 3, 16, 1, 5) + conv(2 ** 3, 32, 16, 3)
            + conv(1, 64, 32, 3) + conv(1, 64, 64, 3)
            + conv(2 ** 3, 32, 64, 3) + conv(4 ** 3, 16, 32, 5)
            + conv(8 ** 3, 1, 16, 5) + conv(8 ** 3, 4, 16, 5)
            + conv(8 ** 3, 1, 16, 5))
    assert fc.get_total_flops() == want == 22173696
