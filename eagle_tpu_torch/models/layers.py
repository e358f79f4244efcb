"""Shared NCHW layers for the model zoo (inference semantics of the JAX
package's ``eagle_tpu/models/layers.py``: symmetric conv padding,
BatchNorm eps 1e-5 folded in float32, optional bfloat16 activations).

Parameter names mirror the JAX parameter pytrees so that the weight
bridge (:mod:`eagle_tpu_torch.models.bridge`) is a mechanical path map:
a conv weight ``w`` (OIHW here, HWIO there), a conv bias ``b``, and the
BatchNorm buffers ``bn.scale / bn.bias / bn.mean / bn.var``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-5  # torch BatchNorm2d default


def cached(module: nn.Module, name: str, dtype: torch.dtype, sources: tuple, make):
    """``make()`` made once and kept on ``module`` under (``name``,
    ``dtype``) while its ``sources`` tensors are the same tensors with the
    same storage and version: a weight cast to the activation dtype, a
    folded BatchNorm.  Each forward of a network would otherwise launch
    these small kernels again, and the host's launches are what the card
    waits for.  With autograd on, or while a CUDA graph is being
    captured, nothing is kept and ``make()`` runs as it is."""
    if torch.is_grad_enabled() or (torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()):
        return make()
    key = [(t.data_ptr(), t._version) for t in sources]
    store = module.__dict__.setdefault("_cached", {})
    hit = store.get((name, dtype))
    if hit is not None and hit[1] == key and all(a is b for a, b in zip(hit[0], sources)):
        return hit[2]
    value = make()
    store[(name, dtype)] = (sources, key, value)
    return value


def cast(module: nn.Module, name: str, t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t.to(dtype)``, kept on ``module`` (:func:`cached`)."""
    if t.dtype == dtype:
        return t
    return cached(module, name, dtype, (t,), lambda: t.to(dtype))


class BatchNorm(nn.Module):
    """Inference-mode BatchNorm2d; the scale/bias fold is computed in
    float32 and cast to the activation dtype (as the JAX package does),
    once (:func:`cached`)."""

    def __init__(self, c: int):
        super().__init__()
        self.register_buffer("scale", torch.ones(c))
        self.register_buffer("bias", torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def fold(self, dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
        """(scale, bias) of the fold in ``dtype``, shaped (C, 1, 1)."""

        def make():
            inv = torch.rsqrt(self.var.float() + BN_EPS)
            g = self.scale.float()
            scale = (g * inv).to(dtype)
            bias = (self.bias.float() - self.mean.float() * g * inv).to(dtype)
            return scale[:, None, None], bias[:, None, None]

        return cached(self, "fold", dtype, (self.scale, self.bias, self.mean, self.var), make)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale, bias = self.fold(x.dtype)
        return x * scale + bias


class ConvBN(nn.Module):
    """Conv (no bias) + BN + optional activation ('relu' | 'silu')."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: int | None = None, act: str | None = None):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.bn = BatchNorm(cout)
        self.stride = stride
        self.padding = k // 2 if padding is None else padding
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.bn(F.conv2d(x, cast(self, "w", self.w, x.dtype), stride=self.stride, padding=self.padding))
        if self.act == "relu":
            return F.relu(y)
        if self.act == "silu":
            return F.silu(y)
        return y


class Conv(nn.Module):
    """Conv with bias, no BN (the models' output heads)."""

    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.b = nn.Parameter(torch.zeros(cout))
        self.padding = k // 2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = cast(self, "w", self.w, x.dtype), cast(self, "b", self.b, x.dtype)
        return F.conv2d(x, w, padding=self.padding) + b[:, None, None]


def init_normal_(model: nn.Module, generator: torch.Generator, std_fn) -> nn.Module:
    """Seeded re-initialisation of every conv weight ``w`` with
    ``normal(0, std_fn(name, w))``; BN stays the identity."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".w") or name == "w":
                p.copy_(torch.randn(p.shape, generator=generator) * std_fn(name, p))
    return model
