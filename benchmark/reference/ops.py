"""The convolution the plain references call, in three precisions.

``Ops()`` is float32 (the caller turns TF32 off), ``Ops("fp8")`` rounds every
convolution's input and weight to float8 e4m3 with one scale a tensor (the
precision below the configurations' bfloat16, for the control), and
:class:`FlopCounter` counts 2 x the multiply-adds of each convolution from
the shapes alone (on the ``meta`` device, so no arithmetic runs).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

#: largest finite float8 e4m3 value
FP8_MAX = 448.0


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with a per-tensor scale that maps its
    largest magnitude to the format's largest value, returned in float32."""
    amax = x.abs().amax().clamp(min=1e-12)
    scale = FP8_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


class Ops:
    def __init__(self, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"precision must be 'fp32' or 'fp8', not {precision!r}")
        self.precision = precision

    def conv(self, x, w, b=None, stride: int = 1, padding: int = 0):
        if self.precision == "fp8":
            x, w = fp8_round(x), fp8_round(w)
        return F.conv2d(x, w, b, stride=stride, padding=padding)


class FlopCounter(Ops):
    """Counts ``flops`` (2 x multiply-adds) of every convolution called."""

    def __init__(self):
        super().__init__()
        self.flops = 0

    def conv(self, x, w, b=None, stride: int = 1, padding: int = 0):
        y = F.conv2d(x, w, b, stride=stride, padding=padding)
        n, cout, ho, wo = y.shape
        self.flops += 2 * n * cout * w.shape[1] * w.shape[2] * w.shape[3] * ho * wo
        return y
