"""Reconstruction filters (port of the JAX package's ``rfilters``: box,
tent, gaussian, mitchell, catmullrom and lanczos; reference
src/rfilters/*.cpp). ``eval`` is continuous, as
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


@register_plugin("rfilter", "mitchell")
class MitchellFilter(ReconstructionFilter):
    """reference src/rfilters/mitchell.cpp (B = C = 1/3): a cubic with
    negative lobes, so a pixel's weight can come out at or below zero."""

    def __init__(self, props: Properties):
        super().__init__(props)
        self.b = props.get_float("B", 1.0 / 3.0)
        self.c = props.get_float("C", 1.0 / 3.0)
        self.radius = 2.0

    def eval(self, x):
        x = torch.abs(x)
        x2 = x * x
        x3 = x2 * x
        b, c = self.b, self.c
        p1 = ((12.0 - 9.0 * b - 6.0 * c) * x3
              + (-18.0 + 12.0 * b + 6.0 * c) * x2 + (6.0 - 2.0 * b)) / 6.0
        p2 = ((-b - 6.0 * c) * x3 + (6.0 * b + 30.0 * c) * x2
              + (-12.0 * b - 48.0 * c) * x + (8.0 * b + 24.0 * c)) / 6.0
        return torch.where(x < 1.0, p1, torch.where(x < 2.0, p2, 0.0))


@register_plugin("rfilter", "catmullrom")
class CatmullRomFilter(MitchellFilter):
    """Mitchell with B = 0, C = 0.5 (reference
    src/rfilters/catmullrom.cpp)."""

    def __init__(self, props: Properties):
        ReconstructionFilter.__init__(self, props)
        self.b = 0.0
        self.c = 0.5
        self.radius = 2.0


@register_plugin("rfilter", "lanczos")
class LanczosFilter(ReconstructionFilter):
    """reference src/rfilters/lanczos.cpp: sinc(x) sinc(x / lobes)."""

    def __init__(self, props: Properties):
        super().__init__(props)
        self.lobes = props.get_int("lobes", 3)
        self.radius = float(self.lobes)

    @staticmethod
    def _sinc(x):
        small = torch.abs(x) < 1e-5
        return torch.where(small, 1.0,
                           torch.sin(x) / torch.where(small, 1.0, x))

    def eval(self, x):
        pix = math.pi * x
        return torch.where(torch.abs(x) < self.radius,
                           self._sinc(pix) * self._sinc(pix / self.lobes),
                           0.0)


__all__ = ["ReconstructionFilter", "BoxFilter", "TentFilter",
           "GaussianFilter", "MitchellFilter", "CatmullRomFilter",
           "LanczosFilter"]
