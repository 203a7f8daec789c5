"""ToF modulation waveforms (port of the JAX package's ``core/waveform.py``;
reference include/mitsuba/render/waveform_utils.h:24-62).

  g(t)/s(t)  — illumination / sensor modulation, period 2*pi
  L(t)       — low-pass of s*g (the correlation waveform)
"""

from __future__ import annotations

import torch

from .math import PI, TWO_PI, mod

WAVE_SINUSOIDAL = 0
WAVE_RECTANGULAR = 1
WAVE_TRIANGULAR = 2
WAVE_TRAPEZOIDAL = 3

WAVEFORM_TYPES = {
    "sinusoidal": WAVE_SINUSOIDAL,
    "rectangular": WAVE_RECTANGULAR,
    "triangular": WAVE_TRIANGULAR,
    "trapezoidal": WAVE_TRAPEZOIDAL,
}


def eval_modulation(t, wave_type: int):
    """g(t) or s(t) — reference waveform_utils.h:24-33."""
    t = mod(t, TWO_PI)
    if wave_type == WAVE_RECTANGULAR:
        return torch.where(torch.abs(t - PI) > 0.5 * PI, 1.0, -1.0)
    if wave_type == WAVE_TRIANGULAR:
        return torch.where(t < PI, 1.0 - 2.0 * t / PI, -3.0 + 2.0 * t / PI)
    # sinusoidal; trapezoidal has no direct g/s in the reference and falls
    # back to cos
    return torch.cos(t)


def eval_modulation_low_pass(t, wave_type: int):
    """L(t) = lowpass(s*g) — reference waveform_utils.h:36-62."""
    t = mod(t, TWO_PI)
    if wave_type == WAVE_SINUSOIDAL:
        return torch.cos(t)
    a = t / PI
    c = torch.minimum(a, 2.0 - a)
    if wave_type == WAVE_RECTANGULAR:
        return 2.0 - 4.0 * c
    if wave_type == WAVE_TRIANGULAR:
        return (4.0 * c * c * c - 6.0 * c * c + 1.0) * (2.0 / 3.0)
    return torch.clamp(2.0 * (2.0 - 4.0 * c), -2.0, 2.0)


__all__ = [
    "WAVE_SINUSOIDAL", "WAVE_RECTANGULAR", "WAVE_TRIANGULAR",
    "WAVE_TRAPEZOIDAL", "WAVEFORM_TYPES",
    "eval_modulation", "eval_modulation_low_pass",
]
