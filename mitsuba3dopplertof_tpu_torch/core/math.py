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


def mod(x, y: float):
    """Floored float modulus with the sign of ``y`` (jnp.mod): an exact
    fmod, shifted by ``y`` where the signs differ. torch.remainder computes
    x - y*floor(x/y), which rounds; this does not."""
    r = torch.fmod(x, y)
    return torch.where((r != 0.0) & ((r < 0.0) != (y < 0.0)), r + y, r)


__all__ = ["INV_PI", "PI", "TWO_PI", "safe_sqrt", "mod"]
