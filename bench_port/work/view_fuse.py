"""The view fuse (A, A-bf16; `ops/view_fuse.py`): the ten Linear layers of
the IBRNet-NeuS fusion over `views` views a row, the first base_fc layer's
view-independent block (140 inputs x 64 outputs) once a row. Each input
and output byte once, the layers' weights once a launch."""
import re

from bench_port import peaks

PATTERN = re.compile(r"\bview_fuse(_bf16)?_kernel\b")
COUNTER = ("graspnerf_tpu_torch.ops.view_fuse", "view_fuse")
LEADING_MEMSET = False
LAYERS = ((4, 16), (16, 35), (32, 8), (8, 1), (207, 64), (64, 32),
          (32, 32), (32, 33), (32, 32), (32, 1))


def cuda_launches() -> int:
    return 1


def cost(rows, launches, dtype, views, height, width, channels):
    """(FLOPs, bytes, peak FLOP/s) of `rows` rows over `launches` launches:
    inputs rgb|feats 35, prob embedding 32, direction 4, mask 1 a view;
    outputs feat_const 65 and num_valid (float32) a row, x 32 and vis 1 a
    view."""
    es = 4 if dtype == "float32" else 2
    macs = rows * (views * sum(i * o for i, o in LAYERS)
                   - (views - 1) * 140 * 64)
    nbytes = (es * (views * rows * (35 + 32 + 4 + 1) + rows * 65
                    + views * rows * 33) + 4 * rows
              + launches * es * sum(i * o + o for i, o in LAYERS))
    return 2 * macs, nbytes, peaks.FLOPS[dtype]
