"""The epipolar gather's forward (B, B-bf16; `ops/epipolar_gather.py`):
per view and point, bilinear fetches of the RGB image (3 channels) and the
two quarter-resolution feature maps (`channels` each). Each map read once a
launch, xy (2 float32) and valid (1 byte) once, the outputs rgb_feats
(3 + channels, in the maps' dtype) and ray_feats (float32) written once;
4 taps x (multiply + add) a channel."""
import re

from bench_port import peaks

PATTERN = re.compile(r"\bgather_kernel<")
COUNTER = ("graspnerf_tpu_torch.ops.epipolar_gather", "epipolar_gather")
LEADING_MEMSET = False


def cuda_launches() -> int:
    return 1


def cost(rows, launches, dtype, views, height, width, channels):
    es = 4 if dtype == "float32" else 2
    c = channels
    maps = views * (height * width * 3
                    + 2 * (height // 4) * (width // 4) * c) * es
    nbytes = (launches * maps
              + views * rows * (2 * 4 + 1 + (3 + c) * es + c * 4))
    flops = views * rows * (3 + 2 * c) * 4 * 2
    return flops, nbytes, peaks.FLOPS[dtype]
