"""Participating media and phase functions (port of the JAX package's
``media/__init__.py``: ``homogeneous`` and ``heterogeneous`` media with the
``isotropic`` and ``hg`` phases; reference src/media/{homogeneous,
heterogeneous}.cpp, src/phase/{isotropic,hg}.cpp).

A medium compiles to one row of the medium table (the ``M_*`` columns,
the JAX package's layout); a heterogeneous medium's density grid rides a
flat atlas (``render/scene.py``), which ``integrators/volpath.py`` samples
with delta and ratio tracking. The ``rayleigh``, ``blendphase``,
``tabphase`` and ``sggx`` phases are ROADMAP Queue A item 10.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.math import PI, TWO_PI
from ..core.properties import Properties, register_plugin
from ..core.vec import Vec3, coordinate_system

PHASE_ISOTROPIC = 0
PHASE_HG = 1

N_MED_PARAMS = 27
M_SIGMA_T = 0    # rgb extinction (heterogeneous: gray base, the grid scales)
M_ALBEDO = 3     # rgb single-scattering albedo
M_G = 6          # HG asymmetry
M_SCALE = 7
M_MAXD = 8       # heterogeneous: majorant scale * max(grid); 0 = homogeneous
M_GRID_OFF = 9   # heterogeneous: offset into the flat grid atlas
M_NX = 10        # grid resolution
M_NY = 11
M_NZ = 12
M_PHASE = 13     # phase kernel: 0 = isotropic / HG (M_G)
M_FILTER = 25    # grid interpolation: 0 = trilinear, 1 = nearest
M_SAMPLE_EM = 26  # 1 = NEE from medium events (medium.h sample_emitters)


def _get_rgb(props, key, default):
    v = props.get(key, default)
    from ..volumes import Volume
    if isinstance(v, Volume):
        return np.asarray(v.mean_rgb())
    if isinstance(v, dict):
        v = v.get("value")
    a = np.asarray(v, dtype=np.float64).reshape(-1)
    if a.size == 1:
        a = np.repeat(a, 3)
    return a[:3]


class PhaseFunction:
    type_id = PHASE_ISOTROPIC
    g = 0.0

    def __init__(self, props: Properties):
        self.id = props.id


@register_plugin("phase", "isotropic")
class IsotropicPhase(PhaseFunction):
    """reference src/phase/isotropic.cpp."""
    type_id = PHASE_ISOTROPIC


@register_plugin("phase", "hg")
class HGPhase(PhaseFunction):
    """Henyey-Greenstein (reference src/phase/hg.cpp)."""
    type_id = PHASE_HG

    def __init__(self, props: Properties):
        super().__init__(props)
        self.g = props.get_float("g", 0.8)


class Medium:
    def __init__(self, props: Properties):
        self.id = props.id
        self.phase = None
        for key, v in props.objects():
            if isinstance(v, PhaseFunction):
                self.phase = v
        if self.phase is None:
            self.phase = IsotropicPhase(Properties("isotropic"))

    def params_row(self) -> np.ndarray:
        return np.zeros(N_MED_PARAMS)


@register_plugin("medium", "homogeneous")
class HomogeneousMedium(Medium):
    """reference src/media/homogeneous.cpp — constant sigma_t and albedo
    (or sigma_s and sigma_a), times ``scale``."""

    def __init__(self, props: Properties):
        super().__init__(props)
        self.scale = props.get_float("scale", 1.0)
        if props.has_property("sigma_t"):
            self.sigma_t = _get_rgb(props, "sigma_t", [1, 1, 1]) * self.scale
            self.albedo = _get_rgb(props, "albedo", [0.75, 0.75, 0.75])
        else:
            sigma_s = _get_rgb(props, "sigma_s", [1, 1, 1]) * self.scale
            sigma_a = _get_rgb(props, "sigma_a", [0.5, 0.5, 0.5]) * self.scale
            self.sigma_t = sigma_s + sigma_a
            self.albedo = sigma_s / np.maximum(self.sigma_t, 1e-9)
        self.sample_emitters = props.get_bool("sample_emitters", True)

    def params_row(self):
        p = np.zeros(N_MED_PARAMS)
        p[M_SIGMA_T:M_SIGMA_T + 3] = self.sigma_t
        p[M_ALBEDO:M_ALBEDO + 3] = self.albedo
        p[M_G] = getattr(self.phase, "g", 0.0)
        p[M_SCALE] = self.scale
        p[M_SAMPLE_EM] = 1.0 if self.sample_emitters else 0.0
        return p


@register_plugin("medium", "heterogeneous")
class HeterogeneousMedium(HomogeneousMedium):
    """reference src/media/heterogeneous.cpp: sigma_t(x) = scale * grid(x)
    for a ``gridvolume`` sigma_t, sampled by delta tracking and shadowed
    by ratio tracking against the majorant scale * max(grid)
    (integrators/volpath.py). Extinction is gray (the grid's first
    channel); albedo stays rgb. Any other sigma_t volume reduces to the
    homogeneous medium of its mean."""

    def __init__(self, props: Properties):
        from ..volumes import GridVolume, Volume
        self.grid = None
        sigma_t_vol = None
        for key, v in props.objects():
            if isinstance(v, Volume) and key == "sigma_t":
                sigma_t_vol = v
        if isinstance(sigma_t_vol, GridVolume):
            self.grid = sigma_t_vol
            # gray base; the grid carries the spatial variation
            props["sigma_t"] = {"type": "rgb", "value": [1.0, 1.0, 1.0]}
        elif sigma_t_vol is not None:
            props["sigma_t"] = {"type": "rgb",
                                "value": list(sigma_t_vol.mean_rgb())}
        super().__init__(props)

    def params_row(self):
        p = super().params_row()
        if self.grid is not None:
            p[M_MAXD] = self.scale * self.grid.max()
            g = self.grid.scalar_grid()
            p[M_NX], p[M_NY], p[M_NZ] = g.shape[2], g.shape[1], g.shape[0]
            p[M_FILTER] = 1.0 if self.grid.filter_type == "nearest" else 0.0
        return p


# ---------------------------------------------------------------------------
# Device-side phase sampling and eval (component-wise)
# ---------------------------------------------------------------------------

def hg_sample(wi: Vec3, g, s1, s2):
    """Sample HG around -wi (forward convention: wo distributed about the
    propagation direction d = -wi). Returns (wo, pdf)."""
    d = -wi
    g_safe = torch.where(torch.abs(g) < 1e-3, 1e-3, g)
    sqr_term = (1.0 - g * g) / (1.0 - g + 2.0 * g * s1)
    cos_theta = torch.where(
        torch.abs(g) < 1e-3,
        1.0 - 2.0 * s1,
        (1.0 + g * g - sqr_term * sqr_term) / (2.0 * g_safe))
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    phi = TWO_PI * s2
    t1, t2 = coordinate_system(d)
    wo = (t1 * (sin_theta * torch.cos(phi)) + t2 * (sin_theta * torch.sin(phi))
          + d * cos_theta)
    return wo, hg_eval(cos_theta, g)


def hg_eval(cos_forward, g):
    """HG phase, forward convention: cos_forward = dot(propagation, wo);
    peaks at +1 for g > 0 (reference hg.cpp's 1 + g^2 + 2g dot(wi, wo)
    with wi toward the source)."""
    denom = 1.0 + g * g - 2.0 * g * cos_forward
    return (1.0 / (4.0 * PI)) * (1.0 - g * g) / torch.clamp(
        denom * torch.sqrt(torch.clamp(denom, min=1e-12)), min=1e-12)


__all__ = ["PhaseFunction", "IsotropicPhase", "HGPhase", "Medium",
           "HomogeneousMedium", "HeterogeneousMedium", "hg_sample",
           "hg_eval", "N_MED_PARAMS", "M_SIGMA_T", "M_ALBEDO", "M_G",
           "M_SCALE", "M_MAXD", "M_GRID_OFF", "M_NX", "M_NY", "M_NZ",
           "M_PHASE", "M_FILTER", "M_SAMPLE_EM"]
