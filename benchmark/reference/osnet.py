"""Plain OSNet re-identification network (Zhou et al., "Omni-Scale Feature
Learning for Person Re-Identification", ICCV 2019), read straight from a
torchreid ``osnet_x*`` state dict: the 7x7/2 stem ``conv1`` and a 3x3/2
max-pool; ``conv2`` .. ``conv4`` of two omni-scale blocks each, with a 1x1
transition and a 2x2 average pool at index 2 of ``conv2`` and ``conv3``;
the 1x1 ``conv5``, a global average pool and the ``fc`` head (``fc.0``
Linear, ``fc.1`` BatchNorm1d, ReLU); L2 normalisation, as the tracker
compares embeddings.  BatchNorm eps 1e-5 (torch's default).

An omni-scale block: a 1x1 conv to a quarter of its width; four streams of
1 to 4 stacked LightConv3x3 (a 1x1 conv, a depthwise 3x3 conv, BatchNorm,
ReLU); one channel gate (global average pool, 1x1 conv to a sixteenth,
ReLU, 1x1 conv back, sigmoid), shared by the four streams, scales each
stream before they are summed; a 1x1 conv with BatchNorm and no ReLU, and
the residual (through a 1x1 conv and BatchNorm where the width changes),
then ReLU.  The classifier of a training checkpoint is not part of the
embedding and is left out.

Written from the paper and torchreid's published module for the
benchmark's judge and FLOP count; it imports nothing of the program.
``layout`` gives the state dict's keys and shapes, from which the
benchmark draws its weights.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.ops import Ops
from benchmark.reference.yolov8 import set_statistics

BN_EPS = 1e-5
BLOCKS = 2
STREAMS = ("conv2a", "conv2b", "conv2c", "conv2d")
#: a block's inner width is its output's over this; its gate's over 16 more
BOTTLENECK, GATE_REDUCTION = 4, 16


def _bn(out: dict, name: str, c: int) -> None:
    for f in ("weight", "bias", "running_mean", "running_var"):
        out[f"{name}.{f}"] = (c,)


def _unit(out: dict, name: str, cin: int, cout: int, k: int) -> None:
    """torchreid's ConvLayer / Conv1x1 / Conv1x1Linear: ``conv`` + ``bn``."""
    out[f"{name}.conv.weight"] = (cout, cin, k, k)
    _bn(out, f"{name}.bn", cout)


def _light(out: dict, name: str, c: int) -> None:
    out[f"{name}.conv1.weight"] = (c, c, 1, 1)
    out[f"{name}.conv2.weight"] = (c, 1, 3, 3)
    _bn(out, f"{name}.bn", c)


def streams(name: str):
    """[(stream, [LightConv3x3 key prefix])] of block ``name``: stream t
    stacks t + 1 of them (the first is one module, the others sequences)."""
    return [(s, [f"{name}.{s}"] if t == 0 else [f"{name}.{s}.{j}" for j in range(t + 1)])
            for t, s in enumerate(STREAMS)]


def _block(out: dict, name: str, cin: int, cout: int) -> None:
    mid = cout // BOTTLENECK
    r = mid // GATE_REDUCTION
    _unit(out, f"{name}.conv1", cin, mid, 1)
    for _, lights in streams(name):
        for p in lights:
            _light(out, p, mid)
    out[f"{name}.gate.fc1.weight"] = (r, mid, 1, 1)
    out[f"{name}.gate.fc1.bias"] = (r,)
    out[f"{name}.gate.fc2.weight"] = (mid, r, 1, 1)
    out[f"{name}.gate.fc2.bias"] = (mid,)
    _unit(out, f"{name}.conv3", mid, cout, 1)
    if cin != cout:
        _unit(out, f"{name}.downsample", cin, cout, 1)


def layout(cfg: dict) -> dict:
    """{state-dict key: shape} of torchreid's OSNet of ``cfg["stage_widths"]``
    and ``cfg["feature_dim"]`` (BatchNorm's ``num_batches_tracked`` and the
    classifier aside)."""
    ch, dim = cfg["stage_widths"], cfg["feature_dim"]
    out: dict = {}
    _unit(out, "conv1", 3, ch[0], 7)
    for i, name in enumerate(("conv2", "conv3", "conv4")):
        for b in range(BLOCKS):
            _block(out, f"{name}.{b}", ch[i] if b == 0 else ch[i + 1], ch[i + 1])
        if name != "conv4":
            _unit(out, f"{name}.{BLOCKS}.0", ch[i + 1], ch[i + 1], 1)
    _unit(out, "conv5", ch[3], ch[3], 1)
    out["fc.0.weight"] = (dim, ch[3])
    out["fc.0.bias"] = (dim,)
    _bn(out, "fc.1", dim)
    return out


class OSNet:
    """``OSNet(sd, cfg, ops)(x)``: (N, 3, 256, 128) ImageNet-normalised RGB
    -> (N, feature_dim) L2-normalised embeddings."""

    def __init__(self, sd: dict, cfg: dict, ops: Ops | None = None):
        self.sd, self.ops = sd, ops or Ops()
        #: set BatchNorm's running statistics from the batch (``yolov8.calibrate``)
        self.calibrate = False

    def bn(self, y, name: str):
        if self.calibrate:
            if y.dim() == 2:
                self.sd[f"{name}.running_mean"], self.sd[f"{name}.running_var"] = y.mean(0), y.var(0)
            else:
                set_statistics(self.sd, name, y)
        g = lambda f: self.sd[f"{name}.{f}"]  # noqa: E731
        return F.batch_norm(y, g("running_mean"), g("running_var"), g("weight"), g("bias"), False, 0.0, BN_EPS)

    def unit(self, x, name: str, stride: int = 1, relu: bool = True):
        w = self.sd[f"{name}.conv.weight"]
        y = self.bn(self.ops.conv(x, w, stride=stride, padding=w.shape[-1] // 2), f"{name}.bn")
        return F.relu(y) if relu else y

    def light(self, x, name: str):
        y = self.ops.conv(x, self.sd[f"{name}.conv1.weight"])
        y = self.ops.conv(y, self.sd[f"{name}.conv2.weight"], padding=1, groups=y.shape[1])
        return F.relu(self.bn(y, f"{name}.bn"))

    def gate(self, x, name: str):
        g = lambda f: self.sd[f"{name}.{f}"]  # noqa: E731
        s = x.mean((2, 3), keepdim=True)
        s = F.relu(self.ops.conv(s, g("fc1.weight"), g("fc1.bias")))
        return x * torch.sigmoid(self.ops.conv(s, g("fc2.weight"), g("fc2.bias")))

    def block(self, x, name: str):
        x1 = self.unit(x, f"{name}.conv1")
        x2 = 0
        for _, lights in streams(name):
            y = x1
            for p in lights:
                y = self.light(y, p)
            x2 = x2 + self.gate(y, f"{name}.gate")
        x3 = self.unit(x2, f"{name}.conv3", relu=False)
        res = self.unit(x, f"{name}.downsample", relu=False) if f"{name}.downsample.conv.weight" in self.sd else x
        return F.relu(x3 + res)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x = F.max_pool2d(self.unit(x, "conv1", 2), 3, 2, 1)
        for name in ("conv2", "conv3", "conv4"):
            for b in range(BLOCKS):
                x = self.block(x, f"{name}.{b}")
            if name != "conv4":
                x = F.avg_pool2d(self.unit(x, f"{name}.{BLOCKS}.0"), 2, 2)
        v = self.unit(x, "conv5").mean((2, 3))
        v = F.relu(self.bn(self.ops.linear(v, self.sd["fc.0.weight"], self.sd["fc.0.bias"]), "fc.1"))
        return v / v.norm(dim=-1, keepdim=True).clamp(min=1e-12)
