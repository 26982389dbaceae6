"""The rounding of a product's operands, for the reference and its
control.

The reference multiplies float32 operands with TF32 off. Its control
computes every product as an fp8 training step does: each operand of the
forward product rounded to float8 e4m3, and the gradient arriving at the
product's output rounded to float8 e5m2 before the two backward products
use it, each at a per-tensor scale (the tensor's largest magnitude
mapped to the format's largest finite value, 448 and 57344); the sums
stay float32. A ``Rounding`` has ``operand(x)`` for the inputs of a
product and ``output(y)`` for its result."""

from __future__ import annotations

import torch

E4M3, E5M2 = torch.float8_e4m3fn, torch.float8_e5m2
FP8_MAX = {E4M3: 448.0, E5M2: 57344.0}


def fp32_strict() -> None:
    """Float32 products in float32: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def to_fp8(x: torch.Tensor, fmt) -> torch.Tensor:
    """``x`` rounded to ``fmt`` at a per-tensor scale, in ``x``'s type."""
    scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX[fmt]
    return (x / scale).to(fmt).to(x.dtype) * scale


class _Operand(torch.autograd.Function):
    """e4m3 forward; the gradient passes straight through."""

    @staticmethod
    def forward(ctx, x):
        return to_fp8(x, E4M3)

    @staticmethod
    def backward(ctx, g):
        return g


class _Output(torch.autograd.Function):
    """Identity forward; the arriving gradient rounded to e5m2."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return to_fp8(g, E5M2)


class Rounding:
    def __init__(self, operand=None, output=None):
        self.operand = operand or (lambda x: x)
        self.output = output or (lambda y: y)


ROUNDINGS = {"float32": Rounding(),
             "fp8": Rounding(_Operand.apply, _Output.apply)}
