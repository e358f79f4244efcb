"""YOLOv8 detector as an ``nn.Module`` (NCHW).

PyTorch counterpart of ``eagle_tpu/models/yolov8.py``: C2f backbone, SPPF,
PAN-FPN neck and the anchor-free decoupled head with Distribution-Focal-
Loss box decode.  Sub-module names follow the JAX parameter pytree
(``backbone.c2f3.m.0.cv1``, ``head.levels.2.cls_out`` ...).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from eagle_tpu_torch.models.layers import Conv, ConvBN, init_normal_

#: depth multiple, width multiple, ratio (P5 channel multiplier)
VARIANTS = {
    "n": (1 / 3, 0.25, 2.0),
    "s": (1 / 3, 0.50, 2.0),
    "m": (2 / 3, 0.75, 1.5),
    "l": (1.0, 1.00, 1.0),
    "x": (1.0, 1.25, 1.0),
}

REG_MAX = 16  # DFL bins per box side
STRIDES = (8, 16, 32)

#: DetectorConfig.variant -> VARIANTS key
CONFIG_VARIANTS = {"medium": "m", "large": "l", "large_hd": "l"}


def _scaled(variant: str):
    d, w, r = VARIANTS[variant]

    def ch(c):  # width-scaled channel count (make_divisible by 8)
        return int(math.ceil(c * w / 8) * 8)

    def n(x):  # depth-scaled block count
        return max(1, round(x * d))

    return ch, n, r


class Bottleneck(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.cv1 = ConvBN(c, c, 3, act="silu")
        self.cv2 = ConvBN(c, c, 3, act="silu")

    def forward(self, x, shortcut: bool):
        y = self.cv2(self.cv1(x))
        return x + y if shortcut else y


class C2f(nn.Module):
    """Cross-stage partial block: split, n bottlenecks each appended to the
    concat list, 1x1 fuse."""

    def __init__(self, cin: int, cout: int, n: int, shortcut: bool):
        super().__init__()
        c = cout // 2
        self.cv1 = ConvBN(cin, 2 * c, 1, act="silu")
        self.cv2 = ConvBN((2 + n) * c, cout, 1, act="silu")
        self.m = nn.ModuleList(Bottleneck(c) for _ in range(n))
        self.shortcut = shortcut

    def forward(self, x):
        y = self.cv1(x)
        c = y.shape[1] // 2
        parts = [y[:, :c], y[:, c:]]
        for bp in self.m:
            parts.append(bp(parts[-1], self.shortcut))
        return self.cv2(torch.cat(parts, dim=1))


class SPPF(nn.Module):
    """Spatial pyramid pooling (fast): 3 chained 5x5 stride-1 maxpools."""

    def __init__(self, c: int):
        super().__init__()
        self.cv1 = ConvBN(c, c // 2, 1, act="silu")
        self.cv2 = ConvBN(c * 2, c, 1, act="silu")

    def forward(self, x):
        outs = [self.cv1(x)]
        for _ in range(3):
            outs.append(F.max_pool2d(outs[-1], 5, 1, 2))
        return self.cv2(torch.cat(outs, dim=1))


def _upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class DetectLevel(nn.Module):
    def __init__(self, cf: int, c2: int, c3: int, num_classes: int):
        super().__init__()
        self.box = nn.ModuleList([ConvBN(cf, c2, 3, act="silu"), ConvBN(c2, c2, 3, act="silu")])
        self.box_out = Conv(c2, 4 * REG_MAX, 1)
        self.cls = nn.ModuleList([ConvBN(cf, c3, 3, act="silu"), ConvBN(c3, c3, 3, act="silu")])
        self.cls_out = Conv(c3, num_classes, 1)

    def forward(self, f):
        b = self.box_out(self.box[1](self.box[0](f)))
        c = self.cls_out(self.cls[1](self.cls[0](f)))
        return b, c


class YOLOv8(nn.Module):
    """(N, 3, H, W) RGB in [0, 1] -> (boxes (N, A, 4) xyxy input pixels,
    scores (N, A, nc) sigmoid), A = sum over strides of (H/s)(W/s)."""

    def __init__(self, variant: str = "l", num_classes: int = 5, use_bf16: bool = False):
        super().__init__()
        self.variant = variant
        self.use_bf16 = use_bf16
        ch, n, r = _scaled(variant)
        c5 = int(ch(512) * r)
        self.backbone = nn.ModuleDict(dict(
            stem=ConvBN(3, ch(64), 3, stride=2, act="silu"),
            down2=ConvBN(ch(64), ch(128), 3, stride=2, act="silu"),
            c2f2=C2f(ch(128), ch(128), n(3), True),
            down3=ConvBN(ch(128), ch(256), 3, stride=2, act="silu"),
            c2f3=C2f(ch(256), ch(256), n(6), True),
            down4=ConvBN(ch(256), ch(512), 3, stride=2, act="silu"),
            c2f4=C2f(ch(512), ch(512), n(6), True),
            down5=ConvBN(ch(512), c5, 3, stride=2, act="silu"),
            c2f5=C2f(c5, c5, n(3), True),
            sppf=SPPF(c5),
        ))
        self.neck = nn.ModuleDict(dict(
            c2f_up4=C2f(c5 + ch(512), ch(512), n(3), False),
            c2f_up3=C2f(ch(512) + ch(256), ch(256), n(3), False),
            down34=ConvBN(ch(256), ch(256), 3, stride=2, act="silu"),
            c2f_down4=C2f(ch(256) + ch(512), ch(512), n(3), False),
            down45=ConvBN(ch(512), ch(512), 3, stride=2, act="silu"),
            c2f_down5=C2f(ch(512) + c5, c5, n(3), False),
        ))
        chans = (ch(256), ch(512), c5)
        c2 = max(16, chans[0] // 4, REG_MAX * 4)
        c3 = max(chans[0], min(num_classes, 100))
        self.head = nn.ModuleDict(dict(
            levels=nn.ModuleList(DetectLevel(cf, c2, c3, num_classes) for cf in chans)
        ))

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        if self.use_bf16:
            x = x.to(torch.bfloat16)
        B = self.backbone
        x = B["down2"](B["stem"](x))
        x = B["c2f2"](x)
        p3 = B["c2f3"](B["down3"](x))
        p4 = B["c2f4"](B["down4"](p3))
        p5 = B["sppf"](B["c2f5"](B["down5"](p4)))

        N = self.neck
        t1 = N["c2f_up4"](torch.cat([_upsample2x(p5), p4], dim=1))
        out3 = N["c2f_up3"](torch.cat([_upsample2x(t1), p3], dim=1))
        out4 = N["c2f_down4"](torch.cat([N["down34"](out3), t1], dim=1))
        out5 = N["c2f_down5"](torch.cat([N["down45"](out4), p5], dim=1))
        return self._decode([out3, out4, out5])

    def _decode(self, feats):
        """DFL decode: softmax expectation over REG_MAX bins per box side,
        anchors at feature-grid cell centres."""
        boxes_all, scores_all = [], []
        bins = None
        for i, f in enumerate(feats):
            b, c = self.head["levels"][i](f)
            n, _, h, w = b.shape
            stride = STRIDES[i]
            dist = b.reshape(n, 4, REG_MAX, h * w).permute(0, 3, 1, 2).float()
            if bins is None:
                bins = torch.arange(REG_MAX, dtype=torch.float32, device=b.device)
            dist = torch.softmax(dist, dim=-1) @ bins  # (n, hw, 4)
            ay, ax = torch.meshgrid(
                torch.arange(h, dtype=torch.float32, device=b.device) + 0.5,
                torch.arange(w, dtype=torch.float32, device=b.device) + 0.5,
                indexing="ij",
            )
            anchors = torch.stack([ax.reshape(-1), ay.reshape(-1)], dim=-1)  # (hw, 2)
            x1y1 = (anchors[None] - dist[..., :2]) * stride
            x2y2 = (anchors[None] + dist[..., 2:]) * stride
            boxes_all.append(torch.cat([x1y1, x2y2], dim=-1))
            scores_all.append(torch.sigmoid(c.reshape(n, c.shape[1], h * w).transpose(1, 2).float()))
        return torch.cat(boxes_all, dim=1), torch.cat(scores_all, dim=1)


def init_yolov8(
    seed: int = 1, variant: str = "l", num_classes: int = 5, use_bf16: bool = False
) -> YOLOv8:
    """Seeded random YOLOv8 with the JAX package's init distributions:
    conv weights normal(std sqrt(2 / fan_in)), identity BN, output convs
    normal(std 0.01) with box bias 1 and class bias -4 (small initial class
    probabilities), built on the CPU."""
    gen = torch.Generator().manual_seed(seed)
    model = YOLOv8(variant, num_classes, use_bf16)

    def std(name, p):
        if name.endswith(("box_out.w", "cls_out.w")):
            return 0.01
        return (2.0 / (p.shape[1] * p.shape[2] * p.shape[3])) ** 0.5

    init_normal_(model, gen, std)
    with torch.no_grad():
        for lvl in model.head["levels"]:
            lvl.box_out.b.fill_(1.0)
            lvl.cls_out.b.fill_(-4.0)
    return model
