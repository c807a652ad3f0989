"""The plain reference of the benchmark: GraspNeRF's planning call and
training step in plain PyTorch and float32, written out here apart from
the program under test.

It is a frozen copy of the model's mathematics (the two view encoders, the
epipolar gather as three bilinear fetches, the distance decoder, the
IBRNet-NeuS aggregation with its view fuse as Linear layers, the NeuS
alpha and compositing, the 40^3 SDF volume, the VGN grasp head, the grasp
post-processing, the training losses and Adam). It imports neither `jax`
nor the JAX package nor anything of the PyTorch port, and takes only the
state dict and the inputs the benchmark makes. Every matrix product and
convolution reads its operands through a `Precision`: float32 for the
reference, TF32 or fp8 for the controls that must come out not correct,
bfloat16 for the yardstick of the bfloat16 configuration's gaps.
"""
from .precision import Precision
from .model import GraspNeRF, build
from .postprocess import candidates, peak_scores, process_quality
from .train import adam_step, loss_terms, train_step
