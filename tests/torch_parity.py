"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_*.py):
seeded parameter pytrees for the JAX models with signal-preserving
weights, and small numpy <-> torch conversions."""

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
