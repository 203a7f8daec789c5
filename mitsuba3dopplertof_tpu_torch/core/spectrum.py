"""Colour helpers (port of the JAX package's ``core/spectrum.py``): BT.709
luminance (reference include/mitsuba/core/spectrum.h) and the sRGB
transfer curves, on tensors and, for the host, numpy arrays."""

from __future__ import annotations

import numpy as np
import torch

_LUM_W = (0.212671, 0.715160, 0.072169)


def luminance(rgb):
    """ITU-R BT.709 luminance of the last axis of ``rgb`` (float32)."""
    w = torch.tensor(_LUM_W, dtype=torch.float32, device=rgb.device)
    return torch.sum(rgb * w, dim=-1)


def luminance_np(rgb: np.ndarray) -> np.ndarray:
    return rgb @ np.asarray(_LUM_W, dtype=np.float64)


def srgb_to_linear(c):
    c = torch.as_tensor(c)
    return torch.where(c <= 0.04045, c / 12.92,
                       ((c + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(c):
    c = torch.as_tensor(c)
    return torch.where(c <= 0.0031308, c * 12.92,
                       1.055 * torch.clamp(c, min=1e-8) ** (1.0 / 2.4)
                       - 0.055)


__all__ = ["luminance", "luminance_np", "srgb_to_linear", "linear_to_srgb"]
