"""The networks' inputs worked out again from the raw frames, as the program
derives them (plain PyTorch, imports nothing of the program).

- The working-canvas path (a detector size whose letterbox holds the
  keypoint input): each BGR frame converted to 4:2:0 planes with OpenCV's
  fixed-point BT.601 coefficients (chroma from the top-left pixel of each
  2x2 block), each plane halved by OpenCV's exact-2x area rule ((a + b + c
  + d + 2) >> 2), placed on canvases of the letterbox gray's 4:2:0 value,
  then decoded to BGR by the float BT.601 inverse with nearest chroma
  upsampling and its float32 rounding steps.  The detector reads the
  canvas, the keypoint network its image region.
- The raw path: the detector's square letterbox (half-pixel bilinear
  resize onto gray 114) and the keypoint network's half-pixel bilinear
  resize, both in float32 from the raw BGR frames.
- The appearance network's crops (:func:`reid_input`): each box of the
  frames it is given (the working canvas or the raw frames, with the boxes
  in their pixels) resampled to the network's input by bilinear samples at
  the positions the program documents, then RGB and ImageNet-normalised.

Only the geometries of the benchmark's cells are implemented: a frame
twice the canvas image in each axis on the working path.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
PAD_BGR, PAD_Y, PAD_UV = 114, 114, 128
# OpenCV's BGR -> YUV fixed-point coefficients (shift 20)
_SH = 20
_CRY, _CGY, _CBY = 269484, 528482, 102760
_CRU, _CGU, _CBU = -155188, -305135, 460324
_CGV, _CBV = -385875, -74448


def geometry(frame_hw, size: int, keypoint_hw, stride: int = 32) -> dict | None:
    """The rectangular letterbox of an (h, w) frame to ``size`` (ultralytics
    ``LetterBox(auto=True)``), or None when its image region is smaller than
    the keypoint input, as for a 640 detector on 540x960 keypoints."""
    h, w = frame_hw
    gain = min(size / h, size / w)
    ih, iw = round(h * gain), round(w * gain)
    if ih < keypoint_hw[0] or iw < keypoint_hw[1]:
        return None
    ph, pw = (-ih) % stride, (-iw) % stride
    return {"gain": gain, "img_h": ih, "img_w": iw, "pad_y": int(round(ph / 2 - 0.1)),
            "pad_x": int(round(pw / 2 - 0.1)), "canvas_h": ih + ph, "canvas_w": iw + pw}


def canvas_boxes(boxes: torch.Tensor, geom: dict | None) -> torch.Tensor:
    """xyxy ``boxes`` in original pixels -> the working canvas's (``x *
    gain + pad``, each step rounded to float32), or as they are without
    one (``geom`` None)."""
    if geom is None:
        return boxes
    gain = torch.tensor(geom["gain"], dtype=torch.float32, device=boxes.device)
    pad = torch.tensor([geom["pad_x"], geom["pad_y"]] * 2, dtype=torch.float32, device=boxes.device)
    return boxes * gain + pad


def _planes(bgr: torch.Tensor):
    """(N, H, W, 3) uint8 -> Y (N, H, W), U, V (N, H/2, W/2) int32, OpenCV's
    ``COLOR_BGR2YUV_I420``."""
    x = bgr.to(torch.int32)
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    half = 1 << (_SH - 1)
    y = (_CRY * r + _CGY * g + _CBY * b + half + (16 << _SH)) >> _SH
    b2, g2, r2 = b[:, ::2, ::2], g[:, ::2, ::2], r[:, ::2, ::2]
    u = (_CRU * r2 + _CGU * g2 + _CBU * b2 + half + (128 << _SH)) >> _SH
    v = (_CBU * r2 + _CGV * g2 + _CBV * b2 + half + (128 << _SH)) >> _SH
    return y, u, v


def _halve(p: torch.Tensor) -> torch.Tensor:
    return (p[:, ::2, ::2] + p[:, ::2, 1::2] + p[:, 1::2, ::2] + p[:, 1::2, 1::2] + 2) >> 2


def _decode(y, u, v) -> torch.Tensor:
    """4:2:0 planes (float32 holding bytes) -> BGR uint8, the float BT.601
    inverse: yv = 1.164 (y - 16); b = yv + 2.018 u; g = 1.164 (y - 16) -
    0.391 u - 0.813 v; r = yv + 1.596 v (u, v centred on 128), each step
    rounded to float32 as a fused multiply-add would, then to bytes."""
    n, h, w = y.shape
    up = lambda c: c[:, :, None, :, None].expand(n, h // 2, 2, w // 2, 2).reshape(n, h, w)  # noqa: E731
    f32, f64 = torch.float32, torch.float64
    k = {name: float(np.float32(c)) for name, c in
         (("y", 1.164), ("bu", 2.018), ("gu", 0.391), ("gv", 0.813), ("rv", 1.596))}
    u = (up(u) - 128.0).to(f64)
    v = (up(v) - 128.0).to(f64)
    ym = (y - 16.0).to(f64)
    yv = (ym * k["y"]).to(f32).to(f64)
    b = (yv + u * k["bu"]).to(f32)
    g = ((ym * k["y"] - (u * k["gu"]).to(f32).to(f64)).to(f32).to(f64) - v * k["gv"]).to(f32)
    r = (yv + v * k["rv"]).to(f32)
    return torch.clamp(torch.round(torch.stack([b, g, r], -1)), 0.0, 255.0).to(torch.uint8)


def working_canvas(bgr: torch.Tensor, geom: dict) -> torch.Tensor:
    """(N, H, W, 3) uint8 raw frames -> (N, canvas_h, canvas_w, 3) uint8 BGR
    working canvases through the 4:2:0 letterbox."""
    n, h, w, _ = bgr.shape
    ih, iw, py, px = geom["img_h"], geom["img_w"], geom["pad_y"], geom["pad_x"]
    if (h, w) != (2 * ih, 2 * iw) or py % 2 or px % 2:
        raise ValueError(f"the reference's 4:2:0 letterbox takes frames twice the canvas image, not {h}x{w}")
    y, u, v = _planes(bgr)
    ch, cw = geom["canvas_h"], geom["canvas_w"]
    yc = torch.full((n, ch, cw), float(PAD_Y), device=bgr.device)
    uc = torch.full((n, ch // 2, cw // 2), float(PAD_UV), device=bgr.device)
    vc = uc.clone()
    yc[:, py : py + ih, px : px + iw] = _halve(y).float()
    uc[:, py // 2 : py // 2 + ih // 2, px // 2 : px // 2 + iw // 2] = _halve(u).float()
    vc[:, py // 2 : py // 2 + ih // 2, px // 2 : px // 2 + iw // 2] = _halve(v).float()
    return _decode(yc, uc, vc)


def _resize(rgb: torch.Tensor, hw) -> torch.Tensor:
    """NHWC float -> NCHW float32, half-pixel bilinear (OpenCV INTER_LINEAR)."""
    x = rgb.permute(0, 3, 1, 2).float()
    return x if tuple(x.shape[-2:]) == tuple(hw) else F.interpolate(x, size=hw, mode="bilinear", align_corners=False)


def detector_input(bgr: torch.Tensor, size: int, geom: dict | None) -> torch.Tensor:
    """(N, 3, h, w) float32 RGB in [0, 1]: the working canvas, or the raw
    frames' square letterbox to ``size``."""
    if geom is not None:
        return working_canvas(bgr, geom).flip(-1).permute(0, 3, 1, 2).float() / 255.0
    n, h, w, _ = bgr.shape
    gain = min(size / h, size / w)
    nh, nw = round(h * gain), round(w * gain)
    top, left = int(round((size - nh) / 2 - 0.1)), int(round((size - nw) / 2 - 0.1))
    out = torch.full((n, 3, size, size), float(PAD_BGR), device=bgr.device)
    out[:, :, top : top + nh, left : left + nw] = _resize(bgr.flip(-1), (nh, nw))
    return out / 255.0


def keypoint_input(bgr: torch.Tensor, input_hw, geom: dict | None) -> torch.Tensor:
    """(N, 3, kh, kw) ImageNet-normalised RGB: the canvas's image region
    (resized when it differs from the input size), or the raw frames
    resized."""
    if geom is not None:
        c = working_canvas(bgr, geom)
        img = c[:, geom["pad_y"] : geom["pad_y"] + geom["img_h"], geom["pad_x"] : geom["pad_x"] + geom["img_w"]]
    else:
        img = bgr
    x = _resize(img.flip(-1), tuple(input_hw))
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)[:, None, None] * 255.0
    std = torch.tensor(IMAGENET_STD, device=x.device)[:, None, None] * 255.0
    return (x - mean) / std


def reid_input(frames: torch.Tensor, boxes: torch.Tensor, input_hw) -> torch.Tensor:
    """(N * K, 3, gh, gw) ImageNet-normalised RGB crops of (N, H, W, 3)
    uint8 BGR ``frames`` at (N, K, 4) xyxy ``boxes`` in their pixels, frame
    by frame, box by box.  Output pixel (i, j) of a box samples the source
    at ``y1 + (i + 0.5) / gh * (y2 - y1) - 0.5`` (likewise x), the product
    and sum rounded once to float32 (as slicing ``crop[y1:y2, x1:x2]`` and
    resizing half-pixel would), clipped to [0, H - 1.001] and [0, W -
    1.001], bilinear between the four pixels around it, in float32."""
    gh, gw = input_hw
    n, h, w, _ = frames.shape
    k = boxes.shape[1]
    dev = frames.device
    b = boxes.reshape(n * k, 4).to(torch.float32)

    def along(g, lo, hi, limit):
        t = (torch.arange(g, device=dev, dtype=torch.float32) + 0.5) / g
        pos = (t[None, :].double() * (hi - lo)[:, None].double() + lo[:, None].double()).to(torch.float32) - 0.5
        return torch.clamp(pos, 0.0, limit - 1.001)

    ys, xs = along(gh, b[:, 1], b[:, 3], h), along(gw, b[:, 0], b[:, 2], w)
    y0, x0 = torch.floor(ys).to(torch.int64), torch.floor(xs).to(torch.int64)
    fy, fx = (ys - y0)[:, :, None, None], (xs - x0)[:, None, :, None]
    f = torch.arange(n, device=dev).repeat_interleave(k)[:, None, None]
    yy, xx = y0[:, :, None], x0[:, None, :]
    img = frames.to(torch.float32)
    crop = (img[f, yy, xx] * (1 - fy) * (1 - fx) + img[f, yy, xx + 1] * (1 - fy) * fx
            + img[f, yy + 1, xx] * fy * (1 - fx) + img[f, yy + 1, xx + 1] * fy * fx)
    x = crop.flip(-1).permute(0, 3, 1, 2)
    mean = torch.tensor(IMAGENET_MEAN, device=dev)[:, None, None] * 255.0
    std = torch.tensor(IMAGENET_STD, device=dev)[:, None, None] * 255.0
    return (x - mean) / std
