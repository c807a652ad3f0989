"""The gather's backward to the two feature maps (B', B'-bf16;
`ops/epipolar_gather.py`): a memset and three kernels a call (count and
fill of the tile index, then the pull). Each upstream gradient read once
(d_rgb in the maps' dtype, d_ray float32), xy and valid once, the two maps'
gradients written once a launch; per view, point and channel of both maps
the mask, two row and four tap weights and four adds (float32; bfloat16
rounds each contribution too), at the float32 rate."""
import re

from bench_port import peaks

PATTERN = re.compile(r"\b(index_kernel<|pull_kernel\b)")
COUNTER = ("graspnerf_tpu_torch.ops.epipolar_gather",
           "epipolar_gather_backward")
LEADING_MEMSET = True    # the count pass's tickets, zeroed just before


def cuda_launches() -> int:
    return 4


def cost(rows, launches, dtype, views, height, width, channels):
    es = 4 if dtype == "float32" else 2
    c = channels
    nbytes = (views * rows * (2 * 4 + 1 + (3 + c) * es + c * 4)
              + launches * 2 * views * (height // 4) * (width // 4) * c * es)
    flops = views * rows * 2 * c * (11 if dtype == "float32" else 12)
    return flops, nbytes, peaks.FLOPS["float32"]
