"""Image preprocessing: working-canvas geometry, the host prescales (4:2:0
planes or BGR onto the working canvas, raw 4:2:0 planes), the device
letterbox of raw planes, the BT.601 inverse on the device (and OpenCV's
exact fixed-point one), and the keypoint model's resize + normalisation.

PyTorch counterpart of ``eagle_tpu/ops/preprocess.py``.  Frames are NHWC
uint8 BGR at every public function, as in the JAX package; resizes are two
dense interpolation products with the half-pixel (cv2 INTER_LINEAR)
convention.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from eagle_tpu_torch.config import WorkGeometry

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

#: cv2's I420 encoding (Y, U = V) of the BGR (114, 114, 114) letterbox gray
#: (cv2.cvtColor(COLOR_BGR2YUV_I420) of a gray-114 patch)
I420_PAD_Y = 114
I420_PAD_UV = 128


@functools.lru_cache(maxsize=64)
def _interp_matrix_half_pixel(out_size: int, in_size: int) -> np.ndarray:
    """1-D linear interpolation matrix with the half-pixel (OpenCV
    INTER_LINEAR / align_corners=False) convention, clamped at borders."""
    M = np.zeros((out_size, in_size), dtype=np.float32)
    if in_size == 1:
        M[:, 0] = 1.0
        return M
    scale = in_size / out_size
    for o in range(out_size):
        pos = (o + 0.5) * scale - 0.5
        pos = min(max(pos, 0.0), in_size - 1.0)
        lo = int(np.floor(pos))
        hi = min(lo + 1, in_size - 1)
        frac = pos - lo
        M[o, lo] += 1.0 - frac
        M[o, hi] += frac
    return M


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """cv2.INTER_LINEAR-compatible resize of an NHWC batch (any float or
    uint8 input; returns float32)."""
    Ho, Wo = out_hw
    _, Hi, Wi, _ = x.shape
    x = x.to(torch.float32)
    if (Hi, Wi) == (Ho, Wo):
        return x
    Mh = torch.from_numpy(_interp_matrix_half_pixel(Ho, Hi)).to(x.device)
    Mw = torch.from_numpy(_interp_matrix_half_pixel(Wo, Wi)).to(x.device)
    y = torch.einsum("oh,nhwc->nowc", Mh, x)
    return torch.einsum("ow,nhwc->nhoc", Mw, y)


def normalize_imagenet(rgb: torch.Tensor) -> torch.Tensor:
    """float RGB NHWC in [0, 255] -> (x - 255 mean) / (255 std)."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=rgb.device) * 255.0
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=rgb.device) * 255.0
    return (rgb - mean) / std


def preprocess_keypoint(
    frames: torch.Tensor, out_hw: tuple[int, int] = (540, 960), bgr_to_rgb: bool = True
) -> torch.Tensor:
    """uint8 BGR NHWC frames -> ImageNet-normalized float32 NHWC at
    ``out_hw``: BGR->RGB, bilinear resize, then (x - 255 mean) / (255 std)."""
    if bgr_to_rgb:
        frames = frames.flip(-1)
    return normalize_imagenet(resize_bilinear(frames, out_hw))


def compute_work_geometry(orig_hw: tuple[int, int], size: int, stride: int = 32) -> WorkGeometry:
    """Rectangular-letterbox geometry (ultralytics LetterBox(auto=True)):
    scale to fit ``size`` keeping aspect, pad each dimension up to the next
    ``stride`` multiple, centered with the +-0.1 rounding quirk."""
    h, w = orig_hw
    gain = min(size / h, size / w)
    img_h, img_w = round(h * gain), round(w * gain)
    pad_h = (-img_h) % stride
    pad_w = (-img_w) % stride
    top = int(round(pad_h / 2 - 0.1))
    left = int(round(pad_w / 2 - 0.1))
    return WorkGeometry(
        enabled=True,
        gain=gain,
        pad_x=left,
        pad_y=top,
        img_h=img_h,
        img_w=img_w,
        canvas_h=img_h + pad_h,
        canvas_w=img_w + pad_w,
        orig_h=h,
        orig_w=w,
    )


def letterbox(
    frames: torch.Tensor, size: int = 640, pad_value: float = 114.0, bgr_to_rgb: bool = True
) -> tuple[torch.Tensor, float, tuple[int, int]]:
    """Ultralytics-style square letterbox of NHWC uint8 frames.

    Returns (images (N, size, size, 3) float32 in [0, 1], gain, (left,
    top)) where ``boxes_orig = (boxes_letterboxed - pad) / gain``."""
    n, h, w, _ = frames.shape
    gain = min(size / h, size / w)
    new_h, new_w = round(h * gain), round(w * gain)
    top = int(round((size - new_h) / 2 - 0.1))
    left = int(round((size - new_w) / 2 - 0.1))
    if bgr_to_rgb:
        frames = frames.flip(-1)
    resized = resize_bilinear(frames, (new_h, new_w))
    canvas = torch.full((n, size, size, 3), pad_value, dtype=torch.float32, device=frames.device)
    canvas[:, top : top + new_h, left : left + new_w] = resized
    return canvas / 255.0, gain, (left, top)


def resolve_upload_format(fmt: str, geom_enabled: bool) -> str:
    """"auto" means 4:2:0 on the working-resolution path, raw BGR
    otherwise; unknown values raise."""
    if fmt == "auto":
        return "yuv420" if geom_enabled else "bgr"
    if fmt not in ("bgr", "yuv420"):
        raise ValueError(f"upload_format must be 'auto', 'bgr' or 'yuv420', got {fmt!r}")
    return fmt


def i420_geometry_ok(geom, frame_hw: tuple[int, int]) -> bool:
    """True when the 4:2:0 letterbox can place chroma exactly: every
    offset/extent even at half resolution, both heights multiples of 4."""
    h, w = frame_hw
    return (
        geom.enabled
        and h % 4 == 0
        and w % 2 == 0
        and geom.canvas_h % 4 == 0
        and geom.canvas_w % 2 == 0
        and geom.img_h % 2 == 0
        and geom.img_w % 2 == 0
        and geom.pad_y % 2 == 0
        and geom.pad_x % 2 == 0
    )


def native_prescale_ok(geom, frame_hw: tuple[int, int]) -> bool:
    """The native kernel's byte-identical envelope: downscale with
    ``img_w % 32 == 0`` plus the 4:2:0 placement gate."""
    h, w = frame_hw
    return (
        geom.img_w % 32 == 0
        and geom.img_h <= h
        and geom.img_w <= w
        and i420_geometry_ok(geom, (h, w))
    )


def host_letterbox_i420(frames_bgr: np.ndarray, geom) -> np.ndarray:
    """Prescale straight in 4:2:0 on the host: BGR uint8 (N, H, W, 3) ->
    packed I420 working canvas (N, canvas_h*3//2, canvas_w), byte for byte
    as the JAX package makes it (cv2's BGR->I420 conversion, then cv2
    INTER_LINEAR on each plane), in native C++ (native/prescale.cpp): the
    fused kernel inside its envelope (:func:`native_prescale_ok`: every
    downscaling working geometry, e.g. 1280x720 -> 544x960), the unfused
    one outside it (upscaling, e.g. 640x360 and 854x480 -> 540x960 in
    544x960, or ``img_w % 32 != 0``).  Needs :func:`i420_geometry_ok`."""
    n, h, w, _ = frames_bgr.shape
    if not i420_geometry_ok(geom, (h, w)):
        raise ValueError(
            f"the 4:2:0 letterbox needs even placement (i420_geometry_ok); got {h}x{w} -> image "
            f"{geom.img_h}x{geom.img_w} at ({geom.pad_y}, {geom.pad_x}) in canvas {geom.canvas_h}x{geom.canvas_w}"
        )
    from eagle_tpu_torch import native

    return native.letterbox_i420(
        np.ascontiguousarray(frames_bgr), geom, I420_PAD_Y, I420_PAD_UV, general=not native_prescale_ok(geom, (h, w))
    )


def host_letterbox(frames_bgr: np.ndarray, geom) -> np.ndarray:
    """The BGR working canvas on the host: (N, H, W, 3) uint8 -> (N,
    canvas_h, canvas_w, 3), each frame resized (cv2 INTER_LINEAR, byte for
    byte) onto 114-gray, as the JAX package's ``host_letterbox``; any
    geometry (native C++)."""
    from eagle_tpu_torch import native

    return native.letterbox_bgr(frames_bgr, geom, 114)


def host_to_i420(frames_bgr: np.ndarray) -> np.ndarray:
    """BGR uint8 (N, H, W, 3) -> packed I420 planes (N, H*3//2, W),
    byte for byte as ``cv2.cvtColor(COLOR_BGR2YUV_I420)`` (native C++).
    The packing stores each chroma plane as H/4 whole rows of W bytes, so
    H % 4 == 0 and W even are required."""
    n, h, w, _ = frames_bgr.shape
    if h % 4 or w % 2:
        raise ValueError(f"the packed I420 layout needs H % 4 == 0 and an even W, got {h}x{w}")
    from eagle_tpu_torch import native

    return native.bgr_to_i420(frames_bgr)


def _yuv_planes_to_bgr(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(N, H, W) Y + (N, H/2, W/2) U/V (float32 holding bytes) -> BGR uint8.
    BT.601 video-range inverse with nearest chroma upsampling:

        b = yv + 2.018 u,  g = yv - 0.391 u - 0.813 v,  r = yv + 1.596 v,
        yv = (y - 16) 1.164,  u, v centred on 128,

    rounded to the nearest byte.  The float32 rounding reproduces the JAX
    package's compiled CPU program, which fuses these into multiply-adds
    (b = fma(2.018, u, yv), r = fma(1.596, v, yv), g = fma(-0.813, v,
    fma(y - 16, 1.164, -(0.391 u)))): every fused step is computed exactly
    in float64 and rounded once to float32, so the bytes are bit-equal on
    every device."""
    n, h, w = y.shape

    def up2(c):
        return c[:, :, None, :, None].expand(n, h // 2, 2, w // 2, 2).reshape(n, h, w)

    f32, f64 = torch.float32, torch.float64
    c = {k: float(np.float32(v)) for k, v in (("y", 1.164), ("bu", 2.018), ("gu", 0.391), ("gv", 0.813), ("rv", 1.596))}
    u = (up2(u) - 128.0).to(f64)
    v = (up2(v) - 128.0).to(f64)
    ym = (y - 16.0).to(f64)
    yv = (ym * c["y"]).to(f32).to(f64)
    b = (yv + u * c["bu"]).to(f32)
    g1 = (ym * c["y"] - (u * c["gu"]).to(f32).to(f64)).to(f32).to(f64)
    g = (g1 - v * c["gv"]).to(f32)
    r = (yv + v * c["rv"]).to(f32)
    bgr = torch.stack([b, g, r], dim=-1)
    return torch.clamp(torch.round(bgr), 0.0, 255.0).to(torch.uint8)


def _split_i420(planes: torch.Tensor, dtype: torch.dtype):
    """Packed I420 (N, H*3//2, W) -> Y (N, H, W), U, V (N, H/2, W/2) as ``dtype``."""
    n, h15, w = planes.shape
    h = h15 * 2 // 3
    y = planes[:, :h].to(dtype)
    u = planes[:, h : h + h // 4].reshape(n, h // 2, w // 2).to(dtype)
    v = planes[:, h + h // 4 :].reshape(n, h // 2, w // 2).to(dtype)
    return y, u, v


def i420_to_bgr(planes: torch.Tensor) -> torch.Tensor:
    """Packed I420 planes (N, H*3//2, W) uint8 -> BGR uint8 (N, H, W, 3)."""
    return _yuv_planes_to_bgr(*_split_i420(planes, torch.float32))


#: OpenCV's fixed-point BT.601 coefficients (ITUR_BT_601_*, 20-bit shift)
_CV_CY, _CV_CUB, _CV_CUG, _CV_CVG, _CV_CVR = 1220542, 2116026, -409993, -852492, 1673527


def i420_to_bgr_exact(planes: torch.Tensor) -> torch.Tensor:
    """Packed I420 planes (N, H*3//2, W) uint8 -> BGR uint8 (N, H, W, 3),
    byte for byte as OpenCV's ``cvtColor(COLOR_YUV2BGR_I420)`` decodes
    them, on any device.  OpenCV's fixed-point formula in int32:

        y = max(0, Y - 16) * CY + 2^19,  u, v centred on 128,
        B = (y + CUB u) >> 20,  G = (y + CVG v + CUG u) >> 20,  R = (y + CVR v) >> 20,

    with nearest 2x2 chroma upsampling and each result saturated to
    [0, 255].  The largest intermediate, ~5.1e8, stays below 2^31."""
    y, u, v = _split_i420(planes, torch.int32)
    n, h, w = y.shape

    def up2(c):
        return (c - 128)[:, :, None, :, None].expand(n, h // 2, 2, w // 2, 2).reshape(n, h, w)

    u, v = up2(u), up2(v)
    yy = torch.clamp(y - 16, min=0) * _CV_CY + (1 << 19)
    bgr = torch.stack([yy + _CV_CUB * u, yy + _CV_CVG * v + _CV_CUG * u, yy + _CV_CVR * v], dim=-1)
    return torch.clamp(bgr >> 20, 0, 255).to(torch.uint8)


def device_letterbox_i420(planes: torch.Tensor, geom) -> torch.Tensor:
    """RAW-resolution packed I420 planes (N, H*3//2, W) uint8 -> the BGR
    working canvas (N, canvas_h, canvas_w, 3) uint8, on the planes' device
    (``PipelineConfig.prescale="device"``; counterpart of the JAX
    package's ``device_letterbox_i420``): each plane resized with the
    half-pixel INTER_LINEAR convention as two float32 interpolation
    products, rounded onto its canvas plane of the letterbox gray's I420
    value, then the BT.601 inverse.  Within a few LSB of the host path
    (cv2's fixed-point resize; the bounds are measured in
    ``tests/test_torch_prescale_paths.py``).  Needs
    :func:`i420_geometry_ok` on the raw frames."""
    y, u, v = _split_i420(planes, torch.float32)
    n = y.shape[0]
    ih, iw, py, px = geom.img_h, geom.img_w, geom.pad_y, geom.pad_x
    ch, cw = geom.canvas_h, geom.canvas_w

    def onto(p, canvas_hw, y0, x0, hw, val):
        c = torch.full((n, *canvas_hw), float(val), dtype=torch.float32, device=p.device)
        r = resize_bilinear(p[..., None], hw)[..., 0]
        c[:, y0 : y0 + hw[0], x0 : x0 + hw[1]] = torch.clamp(torch.round(r), 0.0, 255.0)
        return c

    yc = onto(y, (ch, cw), py, px, (ih, iw), I420_PAD_Y)
    uc = onto(u, (ch // 2, cw // 2), py // 2, px // 2, (ih // 2, iw // 2), I420_PAD_UV)
    vc = onto(v, (ch // 2, cw // 2), py // 2, px // 2, (ih // 2, iw // 2), I420_PAD_UV)
    return _yuv_planes_to_bgr(yc, uc, vc)
