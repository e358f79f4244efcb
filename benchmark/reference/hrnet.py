"""Plain HRNet-W48 keypoint network as Eagle's ``KeypointModel`` holds it: the
backbone under ``unnormalized_model.0`` (stem, four Bottlenecks, three
multi-branch stages of BasicBlocks with summed fusion, the fusion's upsample
an align-corners bilinear resize), the 3x3 head conv under
``unnormalized_model.1`` and a sigmoid.  BatchNorm eps 1e-5.

Written from the published architecture for the benchmark's judge and FLOP
count; it imports nothing of the program.  ``layout`` gives the state
dict's keys and shapes, from which the benchmark draws its weights.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.ops import Ops
from benchmark.reference.yolov8 import set_statistics

BN_EPS = 1e-5
B = "unnormalized_model.0"


def _stages(cfg: dict):
    """[(stage name, modules, branches, blocks a branch, widths)]."""
    w = cfg["stage_widths"]
    return [(f"stage{s}", m, s, cfg["blocks"], w[:s]) for s, m in zip((2, 3, 4), cfg["stage_modules"])]


def _unit(out: dict, conv: str, bn: str, cin: int, cout: int, k: int) -> None:
    out[f"{conv}.weight"] = (cout, cin, k, k)
    for f in ("weight", "bias", "running_mean", "running_var"):
        out[f"{bn}.{f}"] = (cout,)


def layout(cfg: dict) -> dict:
    """{state-dict key: shape} of the ``KeypointModel`` (BatchNorm's
    ``num_batches_tracked`` aside)."""
    out: dict = {}
    _unit(out, f"{B}.conv1", f"{B}.bn1", 3, 64, 3)
    _unit(out, f"{B}.conv2", f"{B}.bn2", 64, 64, 3)
    for k in range(4):
        p, cin = f"{B}.layer1.{k}", 64 if k == 0 else 256
        _unit(out, f"{p}.conv1", f"{p}.bn1", cin, 64, 1)
        _unit(out, f"{p}.conv2", f"{p}.bn2", 64, 64, 3)
        _unit(out, f"{p}.conv3", f"{p}.bn3", 64, 256, 1)
        if k == 0:
            _unit(out, f"{p}.downsample.0", f"{p}.downsample.1", 64, 256, 1)
    w = cfg["stage_widths"]
    _unit(out, f"{B}.transition1.0.0", f"{B}.transition1.0.1", 256, w[0], 3)
    _unit(out, f"{B}.transition1.1.0.0", f"{B}.transition1.1.0.1", 256, w[1], 3)
    _unit(out, f"{B}.transition2.2.0.0", f"{B}.transition2.2.0.1", w[1], w[2], 3)
    _unit(out, f"{B}.transition3.3.0.0", f"{B}.transition3.3.0.1", w[2], w[3], 3)
    for stage, modules, nb, blocks, ch in _stages(cfg):
        for m in range(modules):
            S = f"{B}.{stage}.{m}"
            for b in range(nb):
                for k in range(blocks):
                    p = f"{S}.branches.{b}.{k}"
                    _unit(out, f"{p}.conv1", f"{p}.bn1", ch[b], ch[b], 3)
                    _unit(out, f"{p}.conv2", f"{p}.bn2", ch[b], ch[b], 3)
            rows = nb if not (stage == "stage4" and m == modules - 1) else 1
            for i in range(rows):
                for j in range(nb):
                    f = f"{S}.fuse_layers.{i}.{j}"
                    if j > i:
                        _unit(out, f"{f}.0", f"{f}.1", ch[j], ch[i], 1)
                    elif j < i:
                        for k in range(i - j):
                            co = ch[i] if k == i - j - 1 else ch[j]
                            _unit(out, f"{f}.{k}.0", f"{f}.{k}.1", ch[j], co, 3)
    out["unnormalized_model.1.weight"] = (cfg["num_keypoints"], w[0], 3, 3)
    out["unnormalized_model.1.bias"] = (cfg["num_keypoints"],)
    return out


class HRNet:
    """``HRNet(sd, cfg, ops)(x)``: (N, 3, H, W) ImageNet-normalised RGB ->
    (N, K, H/4, W/4) sigmoid heatmaps."""

    def __init__(self, sd: dict, cfg: dict, ops: Ops | None = None):
        self.sd, self.cfg, self.ops = sd, cfg, ops or Ops()
        #: set BatchNorm's running statistics from the batch (``yolov8.calibrate``)
        self.calibrate = False

    def unit(self, x, conv: str, bn: str, stride: int = 1, relu: bool = True):
        w = self.sd[f"{conv}.weight"]
        y = self.ops.conv(x, w, stride=stride, padding=w.shape[-1] // 2)
        if self.calibrate:
            set_statistics(self.sd, bn, y)
        g = lambda f: self.sd[f"{bn}.{f}"]  # noqa: E731
        y = F.batch_norm(y, g("running_mean"), g("running_var"), g("weight"), g("bias"), False, 0.0, BN_EPS)
        return F.relu(y) if relu else y

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x = self.unit(x, f"{B}.conv1", f"{B}.bn1", 2)
        x = self.unit(x, f"{B}.conv2", f"{B}.bn2", 2)
        for k in range(4):
            p = f"{B}.layer1.{k}"
            y = self.unit(x, f"{p}.conv1", f"{p}.bn1")
            y = self.unit(y, f"{p}.conv2", f"{p}.bn2")
            y = self.unit(y, f"{p}.conv3", f"{p}.bn3", relu=False)
            res = self.unit(x, f"{p}.downsample.0", f"{p}.downsample.1", relu=False) if k == 0 else x
            x = F.relu(y + res)
        xs = [self.unit(x, f"{B}.transition1.0.0", f"{B}.transition1.0.1"),
              self.unit(x, f"{B}.transition1.1.0.0", f"{B}.transition1.1.0.1", 2)]
        for s, (stage, modules, nb, blocks, _ch) in enumerate(_stages(self.cfg)):
            if s > 0:
                t = f"{B}.transition{s + 1}.{nb - 1}.0"
                xs = xs + [self.unit(xs[-1], f"{t}.0", f"{t}.1", 2)]
            for m in range(modules):
                xs = self.module(xs, f"{B}.{stage}.{m}", blocks, stage == "stage4" and m == modules - 1)
        return torch.sigmoid(self.ops.conv(xs[0], self.sd["unnormalized_model.1.weight"],
                                           self.sd["unnormalized_model.1.bias"], padding=1))

    def module(self, xs, S: str, blocks: int, last: bool):
        ys = []
        for b, y in enumerate(xs):
            for k in range(blocks):
                p = f"{S}.branches.{b}.{k}"
                z = self.unit(self.unit(y, f"{p}.conv1", f"{p}.bn1"), f"{p}.conv2", f"{p}.bn2", relu=False)
                y = F.relu(z + y)
            ys.append(y)
        fused = []
        for i in range(1 if last else len(ys)):
            acc = ys[i]
            for j in range(len(ys)):
                f = f"{S}.fuse_layers.{i}.{j}"
                if j > i:
                    t = self.unit(ys[j], f"{f}.0", f"{f}.1", relu=False)
                    acc = acc + F.interpolate(t, size=ys[i].shape[-2:], mode="bilinear", align_corners=True)
                elif j < i:
                    t = ys[j]
                    for k in range(i - j):
                        t = self.unit(t, f"{f}.{k}.0", f"{f}.{k}.1", 2, relu=k < i - j - 1)
                    acc = acc + t
            fused.append(F.relu(acc))
        return fused
