"""Reconstruction filters (port of the JAX package's ``rfilters``: box,
tent and gaussian; reference src/rfilters/*.cpp). ``eval`` is continuous, as
the reference's JIT image-block path evaluates it
(src/render/imageblock.cpp:306-312)."""

from __future__ import annotations

import math

import torch

from ..core.properties import Properties, register_plugin


class ReconstructionFilter:
    radius = 1.0
    is_box = False

    def __init__(self, props: Properties):
        pass

    def eval(self, x):
        raise NotImplementedError


@register_plugin("rfilter", "box")
class BoxFilter(ReconstructionFilter):
    is_box = True

    def __init__(self, props: Properties):
        super().__init__(props)
        self.radius = props.get_float("radius", 0.5)

    def eval(self, x):
        return torch.where(torch.abs(x) <= self.radius, 1.0, 0.0)


@register_plugin("rfilter", "tent")
class TentFilter(ReconstructionFilter):
    """reference src/rfilters/tent.cpp: max(0, 1 - |x| / radius)."""

    def __init__(self, props: Properties):
        super().__init__(props)
        self.radius = props.get_float("radius", 1.0)

    def eval(self, x):
        return torch.clamp(1.0 - torch.abs(x / self.radius), min=0.0)


@register_plugin("rfilter", "gaussian")
class GaussianFilter(ReconstructionFilter):
    """reference src/rfilters/gaussian.cpp: clamped Gaussian, default
    sigma 0.5, radius 4 sigma."""

    def __init__(self, props: Properties):
        super().__init__(props)
        self.stddev = props.get_float("stddev", 0.5)
        self.radius = 4.0 * self.stddev

    def eval(self, x):
        alpha = -1.0 / (2.0 * self.stddev ** 2)
        bound = math.exp(alpha * self.radius ** 2)
        return torch.clamp(torch.exp(alpha * x * x) - bound, min=0.0)


__all__ = ["ReconstructionFilter", "BoxFilter", "TentFilter",
           "GaussianFilter"]
