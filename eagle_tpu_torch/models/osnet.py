"""OSNet re-identification network (omni-scale feature learning; PyTorch
counterpart of ``eagle_tpu/models/osnet.py``).

The reference's tracker scores appearance with OSNet-x0.25 embeddings
(``osnet_x0_25_msmt17.pt`` through boxmot).  The network: a 7x7/2 stem and a
3x3/2 max-pool; three stages of two omni-scale blocks, whose four streams
of 1-4 stacked LightConv3x3 (a 1x1 conv, a 3x3 depthwise conv, BN, ReLU)
are blended by one shared channel gate, with a 1x1 transition and a 2x2
average pool after stages 2 and 3; conv5, a global average pool, the fc
head (Linear, BN1d, ReLU) and L2 normalisation.

Parameter names mirror the JAX parameter pytree (``stem``, ``stage2``..
``stage4`` with ``blocks`` and ``transition``, ``conv5``, ``fc``), so that
:func:`eagle_tpu_torch.models.bridge.osnet_from_jax` is a mechanical path
map; :func:`osnet_from_torch` maps a torchreid state dict (the layout of
the reference's checkpoint) onto the same names.  bfloat16 activations as
:mod:`eagle_tpu_torch.models.layers` does them for HRNet and YOLOv8; the
head runs in float32.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch
import torch.nn as nn
import torch.nn.functional as F

from eagle_tpu_torch.models.layers import BN_EPS, BatchNorm, ConvBN, cast
from eagle_tpu_torch.ops.kmeans import gather_crops
from eagle_tpu_torch.ops.preprocess import normalize_imagenet

#: stage channels of the x-scaled variants (x1.0 = [64, 256, 384, 512])
VARIANTS = {
    "x1_0": (64, 256, 384, 512),
    "x0_75": (48, 192, 288, 384),
    "x0_5": (32, 128, 192, 256),
    "x0_25": (16, 64, 96, 128),
}
BLOCKS_PER_STAGE = 2
FEATURE_DIM = 512
#: the ReID input resolution (H, W) of boxmot / torchreid
INPUT_HW = (256, 128)


class LightConv3x3(nn.Module):
    """1x1 pointwise conv, 3x3 depthwise conv (``groups=C``), BN, ReLU."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.pw = nn.Parameter(torch.zeros(cout, cin, 1, 1))
        self.dw = nn.Parameter(torch.zeros(cout, 1, 3, 3))
        self.bn = BatchNorm(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x, cast(self, "pw", self.pw, x.dtype))
        y = F.conv2d(y, cast(self, "dw", self.dw, x.dtype), padding=1, groups=y.shape[1])
        return F.relu(self.bn(y))


class ChannelGate(nn.Module):
    """Squeeze-excite gate shared by a block's four streams; its hidden
    width is ``c // 16`` (1 at x0.25's stage 2)."""

    def __init__(self, c: int):
        super().__init__()
        r = c // 16
        self.fc1_w = nn.Parameter(torch.zeros(r, c, 1, 1))
        self.fc1_b = nn.Parameter(torch.zeros(r))
        self.fc2_w = nn.Parameter(torch.zeros(c, r, 1, 1))
        self.fc2_b = nn.Parameter(torch.zeros(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        s = x.mean(dim=(2, 3), keepdim=True)
        s = F.relu(F.conv2d(s, cast(self, "fc1_w", self.fc1_w, dt)) + cast(self, "fc1_b", self.fc1_b, dt)[:, None, None])
        s = torch.sigmoid(F.conv2d(s, cast(self, "fc2_w", self.fc2_w, dt)) + cast(self, "fc2_b", self.fc2_b, dt)[:, None, None])
        return x * s


class OSBlock(nn.Module):
    """Omni-scale residual block: stream t stacks t+1 LightConv3x3."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        mid = cout // 4
        self.conv1 = ConvBN(cin, mid, 1, padding=0, act="relu")
        self.streams = nn.ModuleList(
            nn.ModuleList(LightConv3x3(mid, mid) for _ in range(t + 1)) for t in range(4)
        )
        self.gate = ChannelGate(mid)
        self.conv3 = ConvBN(mid, cout, 1, padding=0)
        self.down = ConvBN(cin, cout, 1, padding=0) if cin != cout else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.conv1(x)
        acc = None
        for stream in self.streams:
            y = x1
            for lc in stream:
                y = lc(y)
            g = self.gate(y)
            acc = g if acc is None else acc + g
        res = x if self.down is None else self.down(x)
        return F.relu(self.conv3(acc) + res)


class Stage(nn.Module):
    def __init__(self, cin: int, cout: int, transition: bool):
        super().__init__()
        self.blocks = nn.ModuleList(OSBlock(cin if b == 0 else cout, cout) for b in range(BLOCKS_PER_STAGE))
        self.transition = ConvBN(cout, cout, 1, padding=0, act="relu") if transition else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for blk in self.blocks:
            x = blk(x)
        if self.transition is not None:
            x = F.avg_pool2d(self.transition(x), 2)
        return x


class Head(nn.Module):
    """The fc head: Linear (``w`` kept (in, out) as in the JAX pytree),
    BN1d, ReLU, all in float32."""

    def __init__(self, cin: int, dim: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(cin, dim))
        self.b = nn.Parameter(torch.zeros(dim))
        self.bn = BatchNorm(dim)

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        y = feat @ self.w + self.b
        bn = self.bn
        y = (y - bn.mean) * torch.rsqrt(bn.var + BN_EPS) * bn.scale + bn.bias
        return F.relu(y)


class OSNet(nn.Module):
    """(N, 3, 256, 128) ImageNet-normalised RGB -> (N, E) L2-normalised
    float32 embeddings."""

    def __init__(self, variant: str = "x0_25", feature_dim: int = FEATURE_DIM, use_bf16: bool = False):
        super().__init__()
        ch = VARIANTS[variant]
        self.use_bf16 = use_bf16
        self.stem = ConvBN(3, ch[0], 7, stride=2, padding=3, act="relu")
        self.stage2 = Stage(ch[0], ch[1], True)
        self.stage3 = Stage(ch[1], ch[2], True)
        self.stage4 = Stage(ch[2], ch[3], False)
        self.conv5 = ConvBN(ch[3], ch[3], 1, padding=0, act="relu")
        self.fc = Head(ch[3], feature_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_bf16:
            x = x.to(torch.bfloat16)
        x = F.max_pool2d(self.stem(x), 3, 2, 1)
        x = self.stage4(self.stage3(self.stage2(x)))
        feat = self.conv5(x).mean(dim=(2, 3)).float()
        y = self.fc(feat)
        return y / torch.clamp(torch.linalg.vector_norm(y, dim=-1, keepdim=True), min=1e-12)


def init_osnet(
    seed: int = 0, variant: str = "x0_25", feature_dim: int = FEATURE_DIM, use_bf16: bool = False
) -> OSNet:
    """Seeded random OSNet with the JAX package's init distributions: every
    weight normal(0, sqrt(2 / fan_in)), zero biases, identity BN; built on
    the CPU from an explicit ``torch.Generator``."""
    gen = torch.Generator().manual_seed(seed)
    model = OSNet(variant, feature_dim, use_bf16)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() == 4:
                fan_in = p.shape[1] * p.shape[2] * p.shape[3]
            elif name == "fc.w":
                fan_in = p.shape[0]
            else:
                continue
            p.copy_(torch.randn(p.shape, generator=gen) * (2.0 / fan_in) ** 0.5)
    return model


def _bn(sd: Mapping[str, Any], src: str, dst: str, out: dict) -> None:
    for a, b in (("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"), ("running_var", "var")):
        out[f"{dst}.{b}"] = sd[f"{src}.{a}"]


def _conv(sd, src: str, dst: str, out: dict) -> None:
    """torchreid ConvLayer / Conv1x1 (``conv`` + ``bn``) -> ConvBN."""
    out[f"{dst}.w"] = sd[f"{src}.conv.weight"]
    _bn(sd, f"{src}.bn", f"{dst}.bn", out)


def osnet_from_torch(state_dict: Mapping[str, Any], use_bf16: bool = False) -> OSNet:
    """OSNet holding the weights of a torchreid OSNet state dict (conv1;
    conv2..conv4 as two blocks and, for conv2 and conv3, a transition at
    index 2; conv5; fc as Linear + BatchNorm1d): the key map of the JAX
    package's ``osnet_from_torch`` onto this module.  The variant and the
    feature width are read from the weights."""
    sd = state_dict
    out: dict = {}
    _conv(sd, "conv1", "stem", out)
    streams = ("conv2a", "conv2b", "conv2c", "conv2d")
    for i, name in enumerate(("conv2", "conv3", "conv4")):
        stage = f"stage{i + 2}"
        for b in range(BLOCKS_PER_STAGE):
            src, dst = f"{name}.{b}", f"{stage}.blocks.{b}"
            _conv(sd, f"{src}.conv1", f"{dst}.conv1", out)
            _conv(sd, f"{src}.conv3", f"{dst}.conv3", out)
            if f"{src}.downsample.conv.weight" in sd:
                _conv(sd, f"{src}.downsample", f"{dst}.down", out)
            for k in ("fc1", "fc2"):
                out[f"{dst}.gate.{k}_w"] = sd[f"{src}.gate.{k}.weight"]
                out[f"{dst}.gate.{k}_b"] = sd[f"{src}.gate.{k}.bias"]
            for t, sname in enumerate(streams):
                for j in range(t + 1):
                    lsrc = f"{src}.{sname}" if t == 0 else f"{src}.{sname}.{j}"
                    ldst = f"{dst}.streams.{t}.{j}"
                    out[f"{ldst}.pw"] = sd[f"{lsrc}.conv1.weight"]
                    out[f"{ldst}.dw"] = sd[f"{lsrc}.conv2.weight"]
                    _bn(sd, f"{lsrc}.bn", f"{ldst}.bn", out)
        if f"{name}.{BLOCKS_PER_STAGE}.0.conv.weight" in sd:
            _conv(sd, f"{name}.{BLOCKS_PER_STAGE}.0", f"{stage}.transition", out)
    _conv(sd, "conv5", "conv5", out)
    out["fc.w"] = sd["fc.0.weight"].T
    out["fc.b"] = sd["fc.0.bias"]
    _bn(sd, "fc.1", "fc.bn", out)
    return from_state_dict({k: torch.as_tensor(v, dtype=torch.float32) for k, v in out.items()}, use_bf16)


def from_state_dict(sd: Mapping[str, torch.Tensor], use_bf16: bool = False) -> OSNet:
    """OSNet holding a state dict in this module's names; the variant and
    the feature width are read from the weights' shapes."""
    widths = tuple(sd[f"{s}.w"].shape[0] for s in ("stem", "stage2.blocks.0.conv3", "stage3.blocks.0.conv3",
                                                   "stage4.blocks.0.conv3"))
    variant = next((v for v, ch in VARIANTS.items() if ch == widths), None)
    if variant is None:
        raise ValueError(f"no OSNet variant has the stage widths {widths}")
    model = OSNet(variant, sd["fc.w"].shape[1], use_bf16)
    model.load_state_dict(sd, strict=True)
    return model


def embed_boxes(model: OSNet, frames: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """Per-frame ReID embeddings: frames (B, H, W, 3) uint8 BGR, boxes (B,
    K, 4) xyxy in the frames' pixels -> (B, K, E) L2-normalised float32.
    Each box is resampled to INPUT_HW by one bilinear gather
    (:func:`~eagle_tpu_torch.ops.kmeans.gather_crops`, the sample positions
    of the JAX package's ``matmul_crops``), rounded to bfloat16 when the
    model runs in bfloat16 (as the JAX package's crops are), turned to RGB
    and ImageNet-normalised."""
    b, k = boxes.shape[:2]
    frame_idx = torch.arange(b * k, device=frames.device) // k
    crops = gather_crops(frames, frame_idx, boxes.reshape(b * k, 4), grid_hw=INPUT_HW)  # BGR
    if model.use_bf16:
        crops = crops.to(torch.bfloat16)
    x = normalize_imagenet(crops.flip(-1).to(torch.float32))
    return model(x.permute(0, 3, 1, 2).contiguous()).reshape(b, k, -1)


class CapturedEmbed:
    """:func:`embed_boxes` of one model on one shape of frames and boxes,
    captured as a CUDA graph.  OSNet-x0.25 runs about 1,700 kernels a call,
    most shorter than their launch from the host; a call here is two copies
    into the static slots and one replay.  The same kernels run on the
    same inputs, so the embeddings are the eager call's.  The result is a
    static slot too: the next call overwrites it."""

    def __init__(self, model: OSNet, frames: torch.Tensor, boxes: torch.Tensor):
        dev = frames.device
        self.frames = torch.empty(frames.shape, dtype=frames.dtype, device=dev)
        self.boxes = torch.empty(boxes.shape, dtype=boxes.dtype, device=dev)
        self.frames.copy_(frames)
        self.boxes.copy_(boxes)
        # a warm-up on a side stream (cuDNN's handles and plans), then the
        # capture, which runs nothing; thread_local: another thread's work
        # on the card goes on meanwhile
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            embed_boxes(model, self.frames, self.boxes)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.out = embed_boxes(model, self.frames, self.boxes)

    def __call__(self, frames: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        self.frames.copy_(frames)
        self.boxes.copy_(boxes)
        self.graph.replay()
        return self.out
