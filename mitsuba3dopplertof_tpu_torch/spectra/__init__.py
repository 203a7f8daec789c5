"""Spectrum plugins (port of the JAX package's ``spectra/__init__.py``;
reference src/spectra/*.cpp): ``uniform``, ``d65``, ``srgb``,
``blackbody``, ``regular`` and ``irregular``.

As in the JAX package, every spectrum reduces to an rgb triple when the
scene loads, in every variant: the spectral variant then upsamples that
triple where the plugin it feeds is upsampled (render/scene.py).
``regular`` and ``irregular`` also keep their (wavelength, value) table,
which ``specfilm`` bins hero-wavelength samples with.
"""

from __future__ import annotations

import numpy as np

from ..core.properties import Properties, register_plugin


class Spectrum:
    """Host-side spectrum that evaluates to an rgb triple."""

    def __init__(self, props: Properties):
        self.id = props.id

    def mean_rgb(self) -> np.ndarray:
        return np.array([1.0, 1.0, 1.0])

    # texture-protocol compatibility (constant over uv)
    def params_row(self):
        from ..textures import N_TEX_PARAMS, T_COLOR0, T_COLOR1
        p = np.zeros(N_TEX_PARAMS)
        rgb = self.mean_rgb()
        p[T_COLOR0:T_COLOR0 + 3] = rgb
        p[T_COLOR1:T_COLOR1 + 3] = rgb
        return p


@register_plugin("spectrum", "uniform")
class UniformSpectrum(Spectrum):
    """reference src/spectra/uniform.cpp — constant value across wavelengths."""

    def __init__(self, props: Properties):
        super().__init__(props)
        self.value = props.get_float("value", 1.0)
        props.get_float("lambda_min", 360.0)
        props.get_float("lambda_max", 830.0)

    def mean_rgb(self):
        return np.full(3, self.value)


@register_plugin("spectrum", "d65")
class D65Spectrum(Spectrum):
    """reference src/spectra/d65.cpp — CIE D65 illuminant; normalizes to
    unit luminance in RGB mode, scaled by `scale`."""

    def __init__(self, props: Properties):
        super().__init__(props)
        self.scale = props.get_float("scale", 1.0)

    def mean_rgb(self):
        return np.full(3, self.scale)


@register_plugin("spectrum", "srgb")
class SRGBSpectrum(Spectrum):
    """reference src/spectra/srgb.cpp — sRGB-upsampled reflectance; in RGB
    mode the round trip is the identity on the color."""

    def __init__(self, props: Properties):
        super().__init__(props)
        v = props.get("color", [1.0, 1.0, 1.0])
        if isinstance(v, dict):
            v = v.get("value")
        self.color = np.asarray(v, np.float64).reshape(-1)[:3]

    def mean_rgb(self):
        return self.color


@register_plugin("spectrum", "blackbody")
class BlackbodySpectrum(Spectrum):
    """reference src/spectra/blackbody.cpp — Planck radiator, reduced to its
    CIE-integrated rgb."""

    def __init__(self, props: Properties):
        super().__init__(props)
        self.temperature = props.get_float("temperature", 5000.0)

    def mean_rgb(self):
        # Planckian locus approximation (Krystek / CIE fit) -> xy -> linear sRGB
        t = np.clip(self.temperature, 1667.0, 25000.0)
        if t <= 4000.0:
            x = (-0.2661239e9 / t ** 3 - 0.2343589e6 / t ** 2
                 + 0.8776956e3 / t + 0.179910)
        else:
            x = (-3.0258469e9 / t ** 3 + 2.1070379e6 / t ** 2
                 + 0.2226347e3 / t + 0.240390)
        if t <= 2222.0:
            y = (-1.1063814 * x ** 3 - 1.34811020 * x ** 2
                 + 2.18555832 * x - 0.20219683)
        elif t <= 4000.0:
            y = (-0.9549476 * x ** 3 - 1.37418593 * x ** 2
                 + 2.09137015 * x - 0.16748867)
        else:
            y = (3.0817580 * x ** 3 - 5.87338670 * x ** 2
                 + 3.75112997 * x - 0.37001483)
        X = x / y
        Z = (1 - x - y) / y
        M = np.array([[3.2406, -1.5372, -0.4986],
                      [-0.9689, 1.8758, 0.0415],
                      [0.0557, -0.2040, 1.0570]])
        rgb = M @ np.array([X, 1.0, Z])
        return np.clip(rgb, 0.0, None)


@register_plugin("spectrum", "regular")
class RegularSpectrum(Spectrum):
    """reference src/spectra/regular.cpp — regularly sampled SPD, reduced to
    its mean (flat-observer approximation in RGB mode)."""

    def __init__(self, props: Properties):
        super().__init__(props)
        vals = props.get("values", [1.0])
        if isinstance(vals, str):
            vals = [float(x) for x in vals.replace(",", " ").split()]
        self.values = np.asarray(vals, np.float64)
        lmin = props.get_float("lambda_min", 360.0)
        lmax = props.get_float("lambda_max", 830.0)
        if props.has_property("range"):
            rng = props.get("range")
            if isinstance(rng, str):
                rng = [float(x) for x in rng.replace(",", " ").split()]
            lmin, lmax = float(rng[0]), float(rng[1])
        props.mark_queried("range")
        self.wavelengths = np.linspace(lmin, lmax, len(self.values))

    def mean_rgb(self):
        return np.full(3, float(self.values.mean()))

    def srf_table(self):
        """(wavelengths, values) for per-wavelength evaluation
        (tpu_spectral specfilm binning)."""
        return self.wavelengths, self.values


@register_plugin("spectrum", "irregular")
class IrregularSpectrum(Spectrum):
    """reference src/spectra/irregular.cpp — (wavelength, value) pairs."""

    def __init__(self, props: Properties):
        super().__init__(props)
        pairs = props.get("wavelengths", None)
        props.mark_queried("wavelengths")
        vals = props.get("values", [1.0])
        if isinstance(vals, str):
            vals = [float(x) for x in vals.replace(",", " ").split()]
        self.values = np.asarray(vals, np.float64)
        if isinstance(pairs, str):
            pairs = [float(x) for x in pairs.replace(",", " ").split()]
        self.wavelengths = (np.asarray(pairs, np.float64) if pairs is not None
                            else np.linspace(360.0, 830.0,
                                             len(self.values)))

    def mean_rgb(self):
        return np.full(3, float(self.values.mean()))

    def srf_table(self):
        return self.wavelengths, self.values


__all__ = ["Spectrum", "UniformSpectrum", "D65Spectrum", "SRGBSpectrum",
           "BlackbodySpectrum", "RegularSpectrum", "IrregularSpectrum"]
