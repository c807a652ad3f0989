"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit): float32 on the CUDA cores (TF32 off), bfloat16
on the tensor cores, HBM3 bandwidth."""
FLOPS = {"float32": 67e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12
