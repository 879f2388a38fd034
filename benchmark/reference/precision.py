"""The arithmetic of the references: float32 with TF32 off, or, for the
control that ``correct`` must fail, the nearest precision below what a
configuration states (the step that would tempt a faster version).

``Precision.F32`` is the reference. ``Precision.LOW`` rounds every operand
of the DeepSDF network's matrix products to float8 e4m3 with a scale per
tensor (the configuration states bf16 operands, float32 accumulation) and
runs the critic in bfloat16 (the configuration states float32 with TF32
convolutions). ``Precision.CRITIC_LOW`` lowers the critic alone: the
DeepSDF network in float32, the critic in bfloat16, so that a critic run
below TF32 has a control of its own. Rounding of the network's operands is
in the forward pass only; gradients pass it unchanged."""

from __future__ import annotations

import contextlib
import enum

import torch

FP8_MAX = 448.0  # largest finite float8 e4m3fn


class Precision(enum.Enum):
    F32 = "f32"
    LOW = "low"
    CRITIC_LOW = "critic_low"

    @property
    def critic_bf16(self) -> bool:
        return self is not Precision.F32


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale that maps its
    largest magnitude onto the format's largest finite value."""
    if x.numel() == 0:
        return x
    amax = x.detach().abs().amax().clamp_min(1e-30)
    scale = FP8_MAX / amax
    q = (x.detach() * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale
    return x + (q - x).detach()


def mm(a: torch.Tensor, b: torch.Tensor, precision: Precision) -> torch.Tensor:
    if precision is Precision.LOW:
        a, b = fp8(a), fp8(b)
    return a @ b


@contextlib.contextmanager
def no_tf32():
    """TF32 off for matmuls and cuDNN inside, as it was after."""
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = matmul, cudnn
