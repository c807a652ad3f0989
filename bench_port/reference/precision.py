"""The arithmetic precision of the reference's matrix products and
convolutions.

`float32` leaves the operands as they are (the matmuls and cuDNN
convolutions run in full float32, TF32 off). `tf32` rounds both operands
to TF32's 10-bit mantissa, to nearest even, before a float32 product: what
the tensor cores' TF32 mode computes. `fp8` scales each operand by its
largest magnitude onto float8 e4m3's range (448), rounds it there and
scales it back, and rounds the product to bfloat16: what a per-tensor
scaled fp8 product with a bfloat16 output computes, one step below the
bfloat16 configuration's bfloat16 products. `bfloat16` rounds both
operands and the product to bfloat16, to nearest even: the bfloat16
configuration's own products, the yardstick its gaps are measured in
(`judge.plan_numbers`). The rounding passes the
gradient straight through, so a training step's backward uses the rounded
operands that the forward saved."""
from __future__ import annotations

import torch

NAMES = ("float32", "tf32", "fp8", "bfloat16")
E4M3_MAX = 448.0


def _tf32(t: torch.Tensor) -> torch.Tensor:
    bits = t.float().contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32).reshape(t.shape)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _fp8(t: torch.Tensor) -> torch.Tensor:
    t = t.float()
    scale = t.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class Precision:
    """A rounding of matrix-product operands, by name (`NAMES`)."""

    def __init__(self, name: str = "float32"):
        if name not in NAMES:
            raise ValueError(f"precision {name!r}: one of {NAMES}")
        self.name = name

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        if self.name == "float32":
            return t
        q = {"tf32": _tf32, "fp8": _fp8, "bfloat16": _bf16}[self.name](
            t.detach())
        return t + (q - t).detach()

    def out(self, t: torch.Tensor) -> torch.Tensor:
        """A product's result as this precision delivers it."""
        if self.name not in ("fp8", "bfloat16"):
            return t
        return t + (_bf16(t.detach()) - t).detach()

    def __repr__(self) -> str:
        return f"Precision({self.name!r})"
