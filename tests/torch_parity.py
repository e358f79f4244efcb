"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_*.py):
seeded parameter pytrees for the JAX models with signal-preserving
weights, small numpy <-> torch conversions, leaf-for-leaf pytree
comparison, and writers of checkpoints in the reference's and
ultralytics' state-dict layouts from the port's modules.

The checkpoint writers use torch and numpy only (``chip_smoke.py`` calls
them on the card's machine, which has no JAX)."""

from __future__ import annotations

import numpy as np
import torch


def spread_params(tree, rng: np.random.Generator, gain: float = 0.5, bn: bool = True):
    """Redraw every conv+BN bundle of a JAX parameter pytree with
    ``normal(0, gain / sqrt(fan_in))`` kernels and random BN statistics, so
    activations neither vanish (the reference init, std 0.001, makes every
    heatmap flat) nor explode through the residual sums.  Output convs
    (``w`` + ``b``) get the same kernels and small random biases.  The
    tree may hold ``jax.ShapeDtypeStruct`` leaves (``jax.eval_shape`` of an
    init): only shapes are read."""
    if isinstance(tree, dict):
        if "w" in tree and "bn" in tree:
            w_shape = tuple(tree["w"].shape)
            fan = w_shape[0] * w_shape[1] * w_shape[2]
            c = w_shape[-1]
            out = dict(tree)
            out["w"] = rng.normal(0.0, gain / fan**0.5, w_shape).astype(np.float32)
            if bn:
                out["bn"] = {
                    "scale": rng.uniform(0.8, 1.2, c).astype(np.float32),
                    "bias": rng.normal(0.0, 0.05, c).astype(np.float32),
                    "mean": rng.normal(0.0, 0.05, c).astype(np.float32),
                    "var": rng.uniform(0.8, 1.2, c).astype(np.float32),
                }
            return out
        if "w" in tree and "b" in tree:  # output conv with bias
            w_shape = tuple(tree["w"].shape)
            fan = w_shape[0] * w_shape[1] * w_shape[2]
            return {
                "w": rng.normal(0.0, gain / fan**0.5, w_shape).astype(np.float32),
                "b": rng.normal(0.0, 0.1, tuple(tree["b"].shape)).astype(np.float32),
            }
        return {k: spread_params(v, rng, gain, bn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [spread_params(v, rng, gain, bn) for v in tree]
    return tree


def t(a) -> torch.Tensor:
    """numpy (or JAX) array -> CPU tensor (copied)."""
    return torch.from_numpy(np.array(a))


def n(x) -> np.ndarray:
    """tensor or JAX array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def osnet_params(seed: int, feature_dim: int = 512, variant: str = "x0_25"):
    """A JAX OSNet parameter pytree drawn with numpy (the shapes of
    ``eagle_tpu.models.osnet.init_params``, no eager JAX work): kernels
    normal(0, sqrt(2 / fan_in)), small random biases and random BatchNorm
    statistics (so that a bridge that drops or swaps them fails)."""
    import jax

    from eagle_tpu.models import osnet

    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: osnet.init_params(jax.random.key(0), variant, feature_dim=feature_dim))

    def draw(tree):
        if isinstance(tree, dict):
            if set(tree) == {"scale", "bias", "mean", "var"}:
                c = tuple(tree["scale"].shape)
                return {
                    "scale": rng.uniform(0.8, 1.2, c).astype(np.float32),
                    "bias": rng.normal(0.0, 0.05, c).astype(np.float32),
                    "mean": rng.normal(0.0, 0.05, c).astype(np.float32),
                    "var": rng.uniform(0.8, 1.2, c).astype(np.float32),
                }
            return {k: draw(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [draw(v) for v in tree]
        shape = tuple(tree.shape)
        if len(shape) == 1:
            return rng.normal(0.0, 0.05, shape).astype(np.float32)
        fan_in = int(np.prod(shape[:-1]))
        return rng.normal(0.0, (2.0 / fan_in) ** 0.5, shape).astype(np.float32)

    return draw(shapes)


def flat_tree(tree, prefix: str = "") -> dict:
    """A parameter tree -> {dotted path: numpy leaf or None}: dict keys and
    list / tuple indices join with "." (so a list and flax's map keyed
    "0", "1", ... flatten alike); ``None`` leaves are kept."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat_tree(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flat_tree(v, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: None if tree is None else np.asarray(tree)}


def assert_trees_bit_equal(got, want) -> int:
    """Two parameter trees with the same paths, ``None`` where the other
    has ``None``, and leaves of equal dtype, shape and bytes.  Returns the
    number of array leaves."""
    g, w = flat_tree(got), flat_tree(want)
    assert sorted(g) == sorted(w), sorted(set(g) ^ set(w))[:10]
    n = 0
    for k, wv in w.items():
        gv = g[k]
        assert (gv is None) == (wv is None), k
        if wv is None:
            continue
        assert gv.dtype == wv.dtype and gv.shape == wv.shape, (k, gv.dtype, gv.shape, wv.dtype, wv.shape)
        assert np.ascontiguousarray(gv).tobytes() == np.ascontiguousarray(wv).tobytes(), k
        n += 1
    return n


_BN_REF = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}


def _hrnet_ref_unit(p: str) -> tuple[str, str]:
    """A port HRNet conv+BN path -> the reference's (conv, BN) module
    names (the inverse of ``convert.hrnet_from_torch``)."""
    B = "unnormalized_model.0"
    parts = p.split(".")
    if parts[0] == "stem":  # stem.conv1 -> conv1 / bn1
        return f"{B}.{parts[1]}", f"{B}.bn{parts[1][-1]}"
    if parts[0] == "layer1":
        k, c = parts[1], parts[2]
        if c == "down":
            return f"{B}.layer1.{k}.downsample.0", f"{B}.layer1.{k}.downsample.1"
        return f"{B}.layer1.{k}.{c}", f"{B}.layer1.{k}.bn{c[-1]}"
    if parts[0].startswith("transition") or parts[2] == "fuse":
        p = p.replace(".fuse.", ".fuse_layers.")
        return f"{B}.{p}.0", f"{B}.{p}.1"
    # stageS.m.branches.b.k.convI
    return f"{B}.{p}", f"{B}.{'.'.join(parts[:-1])}.bn{parts[-1][-1]}"


def hrnet_reference_state_dict(model) -> dict[str, torch.Tensor]:
    """A port HRNet module's weights as the reference's ``KeypointModel``
    state dict (``unnormalized_model.0`` the backbone, ``.1`` the head
    conv), as its ``keypoints_main.pth`` holds them."""
    out = {}
    for name, v in model.state_dict().items():
        v = v.detach().cpu().float().clone()
        if name.startswith("head."):
            out[f"unnormalized_model.1.{'weight' if name.endswith('.w') else 'bias'}"] = v
        elif name.endswith(".w"):
            conv, bn = _hrnet_ref_unit(name[:-2])
            out[f"{conv}.weight"] = v
            out[f"{bn}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)
        else:
            unit, field = name.rsplit(".bn.", 1)
            out[f"{_hrnet_ref_unit(unit)[1]}.{_BN_REF[field]}"] = v
    return out


def _ultralytics_var(var: torch.Tensor) -> torch.Tensor:
    """The ultralytics running variance (BatchNorm eps 1e-3) that the
    converters turn back into ``var`` exactly: they add 1e-3 - 1e-5 in
    float32, so the nearest float32 to var - (1e-3 - 1e-5) is nudged until
    that sum rounds to ``var``."""
    from eagle_tpu_torch.models.convert import _ULTRALYTICS_BN_EPS
    from eagle_tpu_torch.models.layers import BN_EPS

    d = _ULTRALYTICS_BN_EPS - BN_EPS
    want = var.detach().cpu().numpy().astype(np.float32)
    r = (want - d).astype(np.float32)
    for _ in range(64):
        back = (r + d).astype(np.float32)
        if (back == want).all():
            return torch.from_numpy(r)
        r = np.where(back < want, np.nextafter(r, np.float32(np.inf)), r)
        r = np.where(back > want, np.nextafter(r, np.float32(-np.inf)), r).astype(np.float32)
    raise AssertionError("no float32 ultralytics variance maps back to the port's")


def _ultralytics_unit(unit: str) -> str:
    """A port YOLOv8 module path -> its ultralytics module name."""
    from eagle_tpu_torch.models.convert import _BACKBONE_MAP, _NECK_MAP

    parts = unit.split(".")
    if parts[0] == "head":  # head.levels.i.{box,cls}.j or .{box,cls}_out
        i, branch = parts[2], parts[3]
        cv = "cv2" if branch.startswith("box") else "cv3"
        return f"model.22.{cv}.{i}.{2 if branch.endswith('_out') else parts[4]}"
    index = dict(_BACKBONE_MAP) if parts[0] == "backbone" else dict(_NECK_MAP)
    return ".".join([f"model.{index[parts[1]]}", *parts[2:]])


def yolov8_ultralytics_state_dict(model) -> dict[str, torch.Tensor]:
    """A port YOLOv8 module's weights as an ultralytics state dict
    (``model.0`` .. ``model.22``, the head's ``cv2`` box and ``cv3`` class
    branches, the DFL projection), the inverse of
    ``convert.yolov8_from_torch``."""
    out = {}
    for name, v in model.state_dict().items():
        v = v.detach().cpu().float().clone()
        if ".bn." in name:
            unit, field = name.rsplit(".bn.", 1)
            ref = f"{_ultralytics_unit(unit)}.bn"
            out[f"{ref}.{_BN_REF[field]}"] = _ultralytics_var(v) if field == "var" else v
            if field == "var":
                out[f"{ref}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)
            continue
        unit, field = name.rsplit(".", 1)
        ref = _ultralytics_unit(unit)
        if unit.endswith("_out"):  # the head's output convs carry a bias
            out[f"{ref}.{'weight' if field == 'w' else 'bias'}"] = v
        else:
            out[f"{ref}.conv.weight"] = v
    out["model.22.dfl.conv.weight"] = torch.arange(16, dtype=torch.float32).view(1, 16, 1, 1)
    return out
