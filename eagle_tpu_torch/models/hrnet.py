"""HRNet-W48 pitch-keypoint model as an ``nn.Module`` (NCHW).

PyTorch counterpart of ``eagle_tpu/models/hrnet.py``: stem -> Bottleneck
layer1 -> three multi-branch stages with SUM fusion, then a 3x3 head to 57
sigmoid heatmaps at input/4.  The fusion upsample is the align_corners
bilinear resize written as two interpolation products (the JAX package's
``_interp_matrix``).  ``use_bf16`` casts the input (and so every conv) to
bfloat16 and returns float32 heatmaps, as the JAX ``apply`` does.

Sub-module names follow the JAX parameter pytree (``stem.conv1``,
``layer1.0.down``, ``stage3.2.fuse.0.1`` ...); ``None`` entries of the
pytree are ``nn.Identity`` placeholders so list indices line up.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from eagle_tpu_torch.models.layers import Conv, ConvBN, init_normal_

# stage spec: (num_modules, num_branches, blocks_per_branch, channels)
STAGE2 = (1, 2, 4, (48, 96))
STAGE3 = (4, 3, 4, (48, 96, 192))
STAGE4 = (3, 4, 4, (48, 96, 192, 384))


@functools.lru_cache(maxsize=64)
def _interp_matrix(out_size: int, in_size: int) -> np.ndarray:
    """Dense 1-D align_corners=True linear interpolation matrix."""
    M = np.zeros((out_size, in_size), dtype=np.float32)
    if in_size == 1:
        M[:, 0] = 1.0
        return M
    scale = (in_size - 1) / (out_size - 1) if out_size > 1 else 0.0
    for o in range(out_size):
        pos = o * scale
        lo = int(np.floor(pos))
        hi = min(lo + 1, in_size - 1)
        frac = pos - lo
        M[o, lo] += 1.0 - frac
        M[o, hi] += frac
    return M


def upsample_align_corners(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear align_corners=True resize of NCHW via two interpolation
    products, computed in the activation dtype."""
    Ho, Wo = out_hw
    Hi, Wi = x.shape[-2:]
    if (Hi, Wi) == (Ho, Wo):
        return x
    Mh = torch.from_numpy(_interp_matrix(Ho, Hi)).to(x.device, x.dtype)
    Mw = torch.from_numpy(_interp_matrix(Wo, Wi)).to(x.device, x.dtype)
    return torch.matmul(torch.matmul(Mh, x), Mw.T)


class BasicBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv1 = ConvBN(c, c, 3, act="relu")
        self.conv2 = ConvBN(c, c, 3)

    def forward(self, x):
        return F.relu(self.conv2(self.conv1(x)) + x)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, planes: int, with_down: bool):
        super().__init__()
        self.conv1 = ConvBN(cin, planes, 1, padding=0, act="relu")
        self.conv2 = ConvBN(planes, planes, 3, act="relu")
        self.conv3 = ConvBN(planes, planes * 4, 1, padding=0)
        self.down = ConvBN(cin, planes * 4, 1, padding=0) if with_down else None

    def forward(self, x):
        out = self.conv3(self.conv2(self.conv1(x)))
        res = self.down(x) if self.down is not None else x
        return F.relu(out + res)


def _chain(cin: int, couts: list[int]) -> nn.ModuleList:
    """Stride-2 3x3 conv chain (ReLU between, none after the last)."""
    mods, c = [], cin
    for co in couts:
        mods.append(ConvBN(c, co, 3, stride=2))
        c = co
    return nn.ModuleList(mods)


class HRModule(nn.Module):
    def __init__(self, num_branches: int, channels, multi_scale: bool):
        super().__init__()
        self.branches = nn.ModuleList(
            nn.ModuleList(BasicBlock(channels[b]) for _ in range(4)) for b in range(num_branches)
        )
        n_out = num_branches if multi_scale else 1
        fuse = []
        for i in range(n_out):
            row = []
            for j in range(num_branches):
                if i == j:
                    row.append(nn.Identity())
                elif j > i:
                    row.append(ConvBN(channels[j], channels[i], 1, padding=0))
                else:
                    couts = [channels[i] if k == i - j - 1 else channels[j] for k in range(i - j)]
                    row.append(_chain(channels[j], couts))
            fuse.append(nn.ModuleList(row))
        self.fuse = nn.ModuleList(fuse)

    def forward(self, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        ys = []
        for b, blocks in enumerate(self.branches):
            y = xs[b]
            for blk in blocks:
                y = blk(y)
            ys.append(y)
        fused = []
        for i, row in enumerate(self.fuse):
            acc = None
            for j, fp in enumerate(row):
                if i == j:
                    t = ys[j]
                elif j > i:
                    t = upsample_align_corners(fp(ys[j]), tuple(ys[i].shape[-2:]))
                else:
                    t = ys[j]
                    for k, cp in enumerate(fp):
                        t = cp(t)
                        if k < len(fp) - 1:
                            t = F.relu(t)
                acc = t if acc is None else acc + t
            fused.append(F.relu(acc))
        return fused


def _transition_module(spec) -> nn.Module:
    """None -> Identity, (cin, cout) -> 3x3 ReLU conv, [(cin, cout)] ->
    stride-2 ReLU chain off the last branch."""
    if spec is None:
        return nn.Identity()
    if isinstance(spec, list):
        return nn.ModuleList(ConvBN(ci, co, 3, stride=2, act="relu") for ci, co in spec)
    return ConvBN(spec[0], spec[1], 3, act="relu")


def _apply_transition(xs: list[torch.Tensor], trans: nn.ModuleList) -> list[torch.Tensor]:
    out = []
    for i, t in enumerate(trans):
        if isinstance(t, nn.Identity):
            out.append(xs[i])
        elif isinstance(t, nn.ModuleList):
            y = xs[-1]
            for cp in t:
                y = cp(y)
            out.append(y)
        else:
            out.append(t(xs[i]))
    return out


class HRNet(nn.Module):
    """HRNet-W48 keypoint network: (N, 3, H, W) ImageNet-normalised RGB ->
    (N, K, H/4, W/4) float32 sigmoid heatmaps."""

    def __init__(self, num_keypoints: int = 57, use_bf16: bool = False):
        super().__init__()
        self.use_bf16 = use_bf16
        self.stem = nn.ModuleDict(dict(
            conv1=ConvBN(3, 64, 3, stride=2, act="relu"),
            conv2=ConvBN(64, 64, 3, stride=2, act="relu"),
        ))
        self.layer1 = nn.ModuleList(
            Bottleneck(64 if i == 0 else 256, 64, with_down=(i == 0)) for i in range(4)
        )
        c2, c3, c4 = STAGE2[3], STAGE3[3], STAGE4[3]
        self.transition1 = nn.ModuleList(
            [_transition_module((256, c2[0])), _transition_module([(256, c2[1])])]
        )
        self.stage2 = nn.ModuleList(HRModule(STAGE2[1], c2, True) for _ in range(STAGE2[0]))
        self.transition2 = nn.ModuleList(
            [nn.Identity(), nn.Identity(), _transition_module([(c2[1], c3[2])])]
        )
        self.stage3 = nn.ModuleList(HRModule(STAGE3[1], c3, True) for _ in range(STAGE3[0]))
        self.transition3 = nn.ModuleList(
            [nn.Identity(), nn.Identity(), nn.Identity(), _transition_module([(c3[2], c4[3])])]
        )
        self.stage4 = nn.ModuleList(
            HRModule(STAGE4[1], c4, multi_scale=(m < STAGE4[0] - 1)) for m in range(STAGE4[0])
        )
        self.head = Conv(c4[0], num_keypoints, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_bf16:
            x = x.to(torch.bfloat16)
        x = self.stem["conv2"](self.stem["conv1"](x))
        for blk in self.layer1:
            x = blk(x)
        xs = _apply_transition([x], self.transition1)
        for mod in self.stage2:
            xs = mod(xs)
        xs = _apply_transition(xs, self.transition2)
        for mod in self.stage3:
            xs = mod(xs)
        xs = _apply_transition(xs, self.transition3)
        for mod in self.stage4:
            xs = mod(xs)
        return torch.sigmoid(self.head(xs[0]).float())


def init_hrnet(seed: int = 0, num_keypoints: int = 57, use_bf16: bool = False) -> HRNet:
    """Seeded random HRNet (the reference init: conv weights normal(std
    0.001), identity BN, zero head bias), built on the CPU."""
    gen = torch.Generator().manual_seed(seed)
    return init_normal_(HRNet(num_keypoints, use_bf16), gen, lambda name, p: 0.001)
