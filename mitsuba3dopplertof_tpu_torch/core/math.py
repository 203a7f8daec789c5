"""Scalar constants and small helpers shared across the renderer (port of
the JAX package's ``core/math.py``, the parts the main path uses)."""

from __future__ import annotations

import numpy as np
import torch

# float32-rounded, as the JAX package's jnp.float32 constants
INV_PI = float(np.float32(0.31830988618379067154))
PI = float(np.float32(3.14159265358979323846))
TWO_PI = float(np.float32(6.28318530717958647692))


def safe_sqrt(x):
    return torch.sqrt(torch.clamp(x, min=0.0))


def sqrt_rn(x):
    """The correctly rounded square root of a float32 tensor. PyTorch's
    CPU kernel is one ulp off on some 0.7% of inputs; the card's sqrtf,
    and XLA's, are correctly rounded. On the CPU the root is taken in
    float64 and rounded once to float32 (exact for a square root)."""
    if x.device.type == "cpu" and x.dtype == torch.float32:
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def mod(x, y: float):
    """Floored float modulus with the sign of ``y`` (jnp.mod): an exact
    fmod, shifted by ``y`` where the signs differ. torch.remainder computes
    x - y*floor(x/y), which rounds; this does not."""
    r = torch.fmod(x, y)
    return torch.where((r != 0.0) & ((r < 0.0) != (y < 0.0)), r + y, r)


def interp(x, xp, fp, left=None, right=None):
    """Piecewise-linear interpolation of (xp, fp) at x, as jnp.interp
    computes it: the end values (or ``left`` / ``right``) outside
    [xp[0], xp[-1]], and the left node where a segment has no width."""
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1,
                    xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    dx0 = torch.abs(dx) <= float(np.spacing(np.finfo(np.float32).eps))
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0] if left is None else left, f)
    return torch.where(x > xp[-1], fp[-1] if right is None else right, f)


__all__ = ["INV_PI", "PI", "TWO_PI", "safe_sqrt", "sqrt_rn", "mod",
           "interp"]
