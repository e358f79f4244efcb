"""Plain YOLOv8 detector (ultralytics ``yolov8.yaml``), read straight from an
ultralytics state dict: modules ``model.0`` .. ``model.22``, each ``Conv`` a
bias-free convolution, a BatchNorm with eps 1e-3 and SiLU, the ``Detect``
head's ``cv2`` box and ``cv3`` class branches and its DFL decode.

Written from the published architecture for the benchmark's judge and FLOP
count; it imports nothing of the program.  ``layout`` gives the state
dict's keys and shapes, from which the benchmark draws its weights.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference.ops import Ops

BN_EPS = 1e-3  # ultralytics Conv's BatchNorm2d
REG_MAX = 16
STRIDES = (8, 16, 32)


def widths(depth: float, width: float, max_channels: int):
    """(ch, n): the yaml's channel and repeat scaling (``make_divisible(min(c,
    max_channels) * width, 8)`` and ``max(round(n * depth), 1)``)."""

    def ch(c):
        return int(math.ceil(min(c, max_channels) * width / 8) * 8)

    def n(k):
        return max(round(k * depth), 1)

    return ch, n


def _conv(out: dict, name: str, cin: int, cout: int, k: int) -> None:
    out[f"{name}.conv.weight"] = (cout, cin, k, k)
    for f in ("weight", "bias", "running_mean", "running_var"):
        out[f"{name}.bn.{f}"] = (cout,)


def _c2f(out: dict, name: str, cin: int, cout: int, n: int) -> None:
    c = cout // 2
    _conv(out, f"{name}.cv1", cin, 2 * c, 1)
    _conv(out, f"{name}.cv2", (2 + n) * c, cout, 1)
    for i in range(n):
        _conv(out, f"{name}.m.{i}.cv1", c, c, 3)
        _conv(out, f"{name}.m.{i}.cv2", c, c, 3)


def layout(cfg: dict) -> dict:
    """{state-dict key: shape} of the ultralytics model (BatchNorm's
    ``num_batches_tracked`` and the DFL's fixed projection aside)."""
    ch, n = widths(cfg["depth_multiple"], cfg["width_multiple"], cfg["max_channels"])
    nc = cfg["num_classes"]
    c5 = ch(1024)
    out: dict = {}
    _conv(out, "model.0", 3, ch(64), 3)
    _conv(out, "model.1", ch(64), ch(128), 3)
    _c2f(out, "model.2", ch(128), ch(128), n(3))
    _conv(out, "model.3", ch(128), ch(256), 3)
    _c2f(out, "model.4", ch(256), ch(256), n(6))
    _conv(out, "model.5", ch(256), ch(512), 3)
    _c2f(out, "model.6", ch(512), ch(512), n(6))
    _conv(out, "model.7", ch(512), c5, 3)
    _c2f(out, "model.8", c5, c5, n(3))
    _conv(out, "model.9.cv1", c5, c5 // 2, 1)
    _conv(out, "model.9.cv2", c5 // 2 * 4, c5, 1)
    _c2f(out, "model.12", c5 + ch(512), ch(512), n(3))
    _c2f(out, "model.15", ch(512) + ch(256), ch(256), n(3))
    _conv(out, "model.16", ch(256), ch(256), 3)
    _c2f(out, "model.18", ch(256) + ch(512), ch(512), n(3))
    _conv(out, "model.19", ch(512), ch(512), 3)
    _c2f(out, "model.21", ch(512) + c5, c5, n(3))
    feats = (ch(256), ch(512), c5)
    c2, c3 = max(16, feats[0] // 4, REG_MAX * 4), max(feats[0], min(nc, 100))
    for i, cf in enumerate(feats):
        _conv(out, f"model.22.cv2.{i}.0", cf, c2, 3)
        _conv(out, f"model.22.cv2.{i}.1", c2, c2, 3)
        out[f"model.22.cv2.{i}.2.weight"] = (4 * REG_MAX, c2, 1, 1)
        out[f"model.22.cv2.{i}.2.bias"] = (4 * REG_MAX,)
        _conv(out, f"model.22.cv3.{i}.0", cf, c3, 3)
        _conv(out, f"model.22.cv3.{i}.1", c3, c3, 3)
        out[f"model.22.cv3.{i}.2.weight"] = (nc, c3, 1, 1)
        out[f"model.22.cv3.{i}.2.bias"] = (nc,)
    return out


class YOLOv8:
    """``YOLOv8(sd, cfg, ops)(x)``: (N, 3, H, W) RGB in [0, 1] -> (boxes (N,
    A, 4) xyxy input pixels, scores (N, A, nc) sigmoid), as ultralytics'
    ``Detect`` decodes them in inference."""

    def __init__(self, sd: dict, cfg: dict, ops: Ops | None = None):
        self.sd, self.ops = sd, ops or Ops()
        #: set BatchNorm's running statistics from the batch (see ``calibrate``)
        self.calibrate = False
        self.n = widths(cfg["depth_multiple"], cfg["width_multiple"], cfg["max_channels"])[1]

    def conv(self, x, name: str, stride: int = 1, act: bool = True):
        w = self.sd[f"{name}.conv.weight"]
        y = self.ops.conv(x, w, stride=stride, padding=w.shape[-1] // 2)
        if self.calibrate:
            set_statistics(self.sd, f"{name}.bn", y)
        g = lambda f: self.sd[f"{name}.bn.{f}"]  # noqa: E731
        y = F.batch_norm(y, g("running_mean"), g("running_var"), g("weight"), g("bias"), False, 0.0, BN_EPS)
        return F.silu(y) if act else y

    def c2f(self, x, name: str, n: int, shortcut: bool):
        y = self.conv(x, f"{name}.cv1")
        c = y.shape[1] // 2
        parts = [y[:, :c], y[:, c:]]
        for i in range(n):
            z = self.conv(self.conv(parts[-1], f"{name}.m.{i}.cv1"), f"{name}.m.{i}.cv2")
            parts.append(parts[-1] + z if shortcut else z)
        return self.conv(torch.cat(parts, 1), f"{name}.cv2")

    def sppf(self, x, name: str):
        outs = [self.conv(x, f"{name}.cv1")]
        for _ in range(3):
            outs.append(F.max_pool2d(outs[-1], 5, 1, 2))
        return self.conv(torch.cat(outs, 1), f"{name}.cv2")

    def __call__(self, x: torch.Tensor):
        n = self.n
        x = self.c2f(self.conv(self.conv(x, "model.0", 2), "model.1", 2), "model.2", n(3), True)
        p3 = self.c2f(self.conv(x, "model.3", 2), "model.4", n(6), True)
        p4 = self.c2f(self.conv(p3, "model.5", 2), "model.6", n(6), True)
        p5 = self.sppf(self.c2f(self.conv(p4, "model.7", 2), "model.8", n(3), True), "model.9")
        up = lambda t: F.interpolate(t, scale_factor=2.0, mode="nearest")  # noqa: E731
        t1 = self.c2f(torch.cat([up(p5), p4], 1), "model.12", n(3), False)
        o3 = self.c2f(torch.cat([up(t1), p3], 1), "model.15", n(3), False)
        o4 = self.c2f(torch.cat([self.conv(o3, "model.16", 2), t1], 1), "model.18", n(3), False)
        o5 = self.c2f(torch.cat([self.conv(o4, "model.19", 2), p5], 1), "model.21", n(3), False)
        return self.detect([o3, o4, o5])

    def detect(self, feats):
        boxes, scores = [], []
        for i, f in enumerate(feats):
            b = self.conv(self.conv(f, f"model.22.cv2.{i}.0"), f"model.22.cv2.{i}.1")
            b = self.ops.conv(b, self.sd[f"model.22.cv2.{i}.2.weight"], self.sd[f"model.22.cv2.{i}.2.bias"])
            c = self.conv(self.conv(f, f"model.22.cv3.{i}.0"), f"model.22.cv3.{i}.1")
            c = self.ops.conv(c, self.sd[f"model.22.cv3.{i}.2.weight"], self.sd[f"model.22.cv3.{i}.2.bias"])
            nb, _, h, w = b.shape
            dist = torch.softmax(b.view(nb, 4, REG_MAX, h * w), dim=2)
            dist = (dist * torch.arange(REG_MAX, dtype=dist.dtype, device=dist.device)[:, None]).sum(2)
            centres = anchor_centres(h, w, b.device, b.dtype)  # (hw, 2)
            lt, rb = dist[:, :2].transpose(1, 2), dist[:, 2:].transpose(1, 2)
            boxes.append(torch.cat([centres - lt, centres + rb], -1) * STRIDES[i])
            scores.append(torch.sigmoid(c.view(nb, c.shape[1], h * w).transpose(1, 2)))
        return torch.cat(boxes, 1), torch.cat(scores, 1)


def set_statistics(sd: dict, bn: str, y: torch.Tensor) -> None:
    """BatchNorm ``bn``'s running mean and variance set to those of ``y``
    over its batch and pixels, as training leaves them (in place)."""
    sd[f"{bn}.running_mean"] = y.mean((0, 2, 3))
    sd[f"{bn}.running_var"] = y.var((0, 2, 3))


def calibrate(net, x: torch.Tensor) -> dict:
    """``net``'s state dict with every BatchNorm's running statistics those
    of one forward over ``x`` (each layer normalised in turn, so that the
    seeded weights keep activations near unit scale at every depth)."""
    net.calibrate = True
    try:
        with torch.no_grad():
            net(x)
    finally:
        net.calibrate = False
    return net.sd


def anchor_centres(h: int, w: int, device, dtype=torch.float32) -> torch.Tensor:
    """(h*w, 2) grid-cell centres (x, y) in feature cells, row-major."""
    ys, xs = torch.meshgrid(torch.arange(h, device=device, dtype=dtype) + 0.5,
                            torch.arange(w, device=device, dtype=dtype) + 0.5, indexing="ij")
    return torch.stack([xs.reshape(-1), ys.reshape(-1)], -1)


def anchor_points(hw: tuple[int, int], device) -> torch.Tensor:
    """(A, 4) each anchor's centre in input pixels, repeated as (x, y, x,
    y): a box minus this is its four side offsets, the part the network
    computes."""
    h, w = hw
    out = [anchor_centres(-(-h // s), -(-w // s), device) * s for s in STRIDES]
    c = torch.cat(out)
    return torch.cat([c, c], -1)
