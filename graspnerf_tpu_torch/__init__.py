"""graspnerf_tpu_torch — the PyTorch/CUDA port of graspnerf_tpu.

The JAX package `graspnerf_tpu` is the reference; this package mirrors its
layout (ops/, models/, detect/, train/, data/, sim/) in PyTorch and imports
nothing from it. The planner's volume path (6 views -> 40^3 TSDF -> grasp
candidates), the render path, the train step and the closed-loop evaluation's
planning calls run on an NVIDIA Hopper card through
hand-written CUDA kernels (csrc/): the IBRNet-NeuS view fuse
(ops/view_fuse.py) and the epipolar feature gather with its backward
(ops/epipolar_gather.py). On CPU tensors every kernel wrapper runs its plain
PyTorch version instead; on CUDA tensors it launches the kernel or raises.
"""

__version__ = "0.1.0"
