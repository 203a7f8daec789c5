"""BSDF plugins and the masked type dispatch (port of the JAX package's
``bsdfs/__init__.py``: diffuse, with a constant or textured reflectance,
twosided, null, conductor, roughconductor, dielectric, thindielectric,
roughdielectric, plastic, roughplastic, pplastic, principled,
principledthin, mask, blendbsdf, measured, the polarizing elements
polarizer, retarder and circular, and measured_polarized; the principled
lobes are in ``bsdfs/principled_impl.py``, the measured BSDF's warps in
``bsdfs/measured_impl.py``, the measured pBRDF's tables in
``bsdfs/measured_polarized_impl.py``).

In every variant this dispatch is the scalar (intensity) BSDF: the
polarizing elements transmit 0.5, 1 and 0.5 times their transmittance and
measured_polarized reflects its M00. The polarized variants' Mueller
factors are in ``integrators/polarized.py``.

Each BSDF compiles to one row of a parameter table (type id + float
params); ``eval_pdf_sample`` evaluates every type present in the scene over
the whole wavefront and selects by mask. Directions are in the local
shading frame (z = normal), as in the reference. The rows are the JAX
package's, column for column, quirks included: a plastic row writes its
specular sampling weight over the first specular-reflectance column and
leaves the texture column at 0 (ROADMAP Queue C).

``mask`` and ``blendbsdf`` rows name two nested rows and a mix weight:
before the type dispatch, ``remap_wrapper_rows`` sends each of their lanes
to one nested row, chosen by the lobe sample, and rescales that sample for
the nested BSDF (the JAX package's stochastic row remapping). The scene
compiler adds the nested rows and, for ``mask``, one shared plain ``null``
row.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..core import microfacet as mf
from ..core import warp
from ..core.fresnel import (fresnel_conductor, fresnel_dielectric, reflect,
                            refract)
from ..core.cie import eval_reflectance_spectrum
from ..core.math import INV_PI, interp
from ..core.properties import Properties, register_plugin
from ..core.vec import Vec3, dot, normalize, where3
from .ior_data import CONDUCTOR_IOR, CONDUCTOR_SPECTRA

# type ids (the JAX package's numbering)
BSDF_DIFFUSE = 0
BSDF_NULL = 1
BSDF_CONDUCTOR = 2
BSDF_DIELECTRIC = 3
BSDF_ROUGHCONDUCTOR = 4
BSDF_PLASTIC = 5
BSDF_ROUGHPLASTIC = 6
BSDF_ROUGHDIELECTRIC = 7
BSDF_THINDIELECTRIC = 8
BSDF_BLEND = 9
BSDF_MASK = 10
BSDF_PRINCIPLED = 11
BSDF_POLARIZER = 12
BSDF_RETARDER = 13
BSDF_CIRCULAR = 14
BSDF_MEASURED = 15
BSDF_MEASURED_POL = 16
BSDF_PRINCIPLED_THIN = 17

N_BSDF_PARAMS = 24
# param columns (meaning depends on type)
P_REFL = 0            # rgb reflectance / specular reflectance
P_TWOSIDED = 3        # 1.0 if wrapped in `twosided`
P_ETA = 4             # relative ior (plastic, dielectrics); rgb eta
                      # (conductors 4:7)
P_K = 7               # rgb k (conductors 7:10); plastic: fdr_int, nonlinear
P_ALPHA = 10          # roughness alpha (alpha_u); 11: roughconductor's
                      # alpha_v, plastic's specular weight
P_SPEC_TRANS = 11     # rgb transmittance 11:14 (dielectrics); plastic
                      # specular reflectance (11 overwritten)
P_MF_DIST = 12        # roughconductor: 1.0 = beckmann, 0.0 = ggx
P_REFL_TEX = 14       # texture id driving the reflectance (-1 = constant)
P_NMAP_TEX = 15       # normal- or height-map texture id (-1 = none)
P_BMAP_SCALE = 16     # > 0: the P_NMAP_TEX texture is a height map
P_MEASURED_IDX = 17   # measured / measured_polarized: its entry in the
                      # scene's measured (measured_pol) tables
P_ALPHA_SAMPLE = 16   # measured_polarized: GGX alpha of its sampling
# polarizer / retarder / circular rows
P_POL_THETA = 4       # the element's rotation angle (radians)
P_POL_DELTA = 5       # the retarder's phase difference (radians)
# mask / blendbsdf rows: the nested rows and the probability of row 1
P_NESTED0 = 4
P_NESTED1 = 5
P_MIX = 6
# principled / principledthin columns (the JAX package's slot reuse)
P_PR_AX = 5           # GGX alpha_x (anisotropic-corrected)
P_PR_AY = 6           # GGX alpha_y
P_METALLIC = 7        # metallic
P_SPECTUNE = 8        # spec_tint
P_PR_SHEEN = 9        # sheen
P_PR_SHEENTINT = 11   # sheen_tint
P_PR_FLAT = 12        # flatness (fake subsurface blend)
P_PR_CC = 13          # clearcoat (thin: diff_trans)
P_PR_CCGLOSS = 18     # clearcoat_gloss (thin: diffuse transmittance rate)
P_PR_STRANS = 19      # spec_trans
P_PR_DSRATE = 20      # diffuse_reflectance_sampling_rate
P_PR_SSRATE = 21      # main_specular_sampling_rate (thin: spec reflectance)
P_PR_CSRATE = 22      # clearcoat_sampling_rate (thin: spec transmittance)
P_PR_ROUGH = 23       # raw roughness (retro / fake subsurface term)

# lobe flags (static per row, mirrors reference BSDFFlags)
FLAG_SMOOTH = 1       # has a smooth (non-delta) lobe => NEE applies
FLAG_DELTA = 2        # sampling may return a delta lobe
FLAG_NULL = 4         # null transmission lobe

# types whose eval takes the (tex_refl, tex_mask) reflectance override;
# the spectral variant stores their P_REFL triple as sigmoid-polynomial
# coefficients (diffuse albedo, plastic diffuse, principled base colour)
# and evaluates it at the hero wavelengths through the same override
TEXTURED_TYPES = (BSDF_DIFFUSE, BSDF_PLASTIC, BSDF_ROUGHPLASTIC,
                  BSDF_PRINCIPLED, BSDF_PRINCIPLED_THIN)

# named IORs (reference src/render/ior.h subset)
IOR_NAMES = {
    "vacuum": 1.0, "air": 1.000277, "water": 1.3330, "water ice": 1.31,
    "fused quartz": 1.458, "pyrex": 1.470, "acrylic glass": 1.49,
    "polypropylene": 1.49, "bk7": 1.5046, "sodium chloride": 1.544,
    "amber": 1.55, "pet": 1.5750, "diamond": 2.419, "bromine": 1.661,
}


class BSDF:
    """Host-side plugin base: compiles to (type_id, flags, params row).
    Subclasses must set ``type_id``; the base has none, so a BSDF without
    a type cannot compile as diffuse by accident."""
    type_id: int
    flags: int

    def __init__(self, props: Properties):
        self.id = props.id
        self.two_sided = False

    def params_row(self) -> np.ndarray:
        return np.zeros(N_BSDF_PARAMS)


def _get_rgb(props, key, default):
    """An rgb triple from a float, a list, an ``rgb`` or ``spectrum`` dict
    (its value), or a texture or spectrum plugin (its mean rgb)."""
    v = props.get(key, default)
    from ..spectra import Spectrum
    from ..textures import Texture
    if isinstance(v, (Texture, Spectrum)):
        return np.asarray(v.mean_rgb())
    if isinstance(v, dict):   # {'type':'rgb','value':[...]} from the parser
        v = v.get("value")
    if hasattr(v, "plugin_category"):
        raise RuntimeError(
            f"'{key}' cannot be given by a {v.plugin_category}")
    a = np.asarray(v, dtype=np.float64).reshape(-1)
    if a.size == 1:
        a = np.repeat(a, 3)
    return a[:3]


def _get_texture(props, key):
    """The Texture object if the property is texture-driven, else None."""
    from ..textures import Texture
    if props.has_property(key):
        v = props.get(key)
        if isinstance(v, Texture):
            return v
    return None


def _parse_ior(props, key, default):
    v = props.get(key, default)
    if isinstance(v, str):
        if v not in IOR_NAMES:
            raise RuntimeError(f"Unknown IOR material '{v}'")
        return IOR_NAMES[v]
    if isinstance(v, dict):
        v = v.get("value")
        if isinstance(v, (list, tuple)):
            v = v[0]
    return float(v)


def fdr_approx(eta: float) -> float:
    """Average Fresnel diffuse reflectance (d'Eon's rational fit)."""
    if eta < 1.0:
        return float(-0.4399 + 0.7099 / eta - 0.3319 / eta ** 2
                     + 0.0636 / eta ** 3)
    return float(-1.4399 / eta ** 2 + 0.7099 / eta + 0.6681 + 0.0636 * eta)


@register_plugin("bsdf", "diffuse")
class Diffuse(BSDF):
    """Lambertian (reference src/bsdfs/diffuse.cpp); a texture child gives
    the reflectance per hit."""
    type_id = BSDF_DIFFUSE
    flags = FLAG_SMOOTH

    def __init__(self, props: Properties):
        super().__init__(props)
        self.reflectance = _get_rgb(props, "reflectance", [0.5, 0.5, 0.5])
        self.reflectance_tex = _get_texture(props, "reflectance")
        self.tex_index = -1   # assigned at scene compile

    def params_row(self):
        p = np.zeros(N_BSDF_PARAMS)
        p[P_REFL:P_REFL + 3] = self.reflectance
        p[P_TWOSIDED] = 1.0 if self.two_sided else 0.0
        p[P_REFL_TEX] = float(self.tex_index)
        return p


@register_plugin("bsdf", "twosided")
class TwoSided(BSDF):
    """Makes the nested BSDF two-sided (reference src/bsdfs/twosided.cpp):
    compiles to the nested row with the TWOSIDED flag set."""

    def __init__(self, props: Properties):
        super().__init__(props)
        nested = None
        for key, v in props.objects():
            if isinstance(v, BSDF):
                nested = v
        if nested is None:
            raise RuntimeError("twosided: requires a nested BSDF")
        self.nested = nested
        self.nested.two_sided = True
        self.type_id = nested.type_id
        self.flags = nested.flags
        self.two_sided = True

    def params_row(self):
        row = self.nested.params_row()
        row[P_TWOSIDED] = 1.0
        return row


class _FrameAdapter(BSDF):
    """normalmap / bumpmap: the nested BSDF's row plus the id of the
    texture that perturbs the shading frame at the hit
    (``integrators._apply_normal_maps``, right after the intersection)."""

    def __init__(self, props: Properties):
        super().__init__(props)
        from ..textures import Texture
        self.nested = None
        self.normalmap_tex = None     # the compile assigns nmap_index
        for key, v in props.objects():
            if isinstance(v, BSDF):
                self.nested = v
            elif isinstance(v, Texture):
                self.normalmap_tex = v
        self.type_id = getattr(self.nested, "type_id", None)
        self.flags = getattr(self.nested, "flags", 0)
        self.nmap_index = -1
        # the nested BSDF's texture-driven reflectance
        self.reflectance_tex = getattr(self.nested, "reflectance_tex", None)

    def params_row(self):
        row = self.nested.params_row()
        row[P_NMAP_TEX] = float(self.nmap_index)
        return row


@register_plugin("bsdf", "normalmap")
class NormalMap(_FrameAdapter):
    """Normal mapping (reference src/bsdfs/normalmap.cpp): the shading
    normal from a tangent-space normal texture, then the nested BSDF."""

    def __init__(self, props: Properties):
        super().__init__(props)
        if self.nested is None or self.normalmap_tex is None:
            raise RuntimeError("normalmap: requires a nested BSDF and a "
                               "normal texture")


@register_plugin("bsdf", "bumpmap")
class BumpMap(_FrameAdapter):
    """Bump mapping (reference src/bsdfs/bumpmap.cpp): the shading frame
    perturbed by the height texture's uv gradient (central differences at
    the hit) times ``scale``, then the nested BSDF."""

    def __init__(self, props: Properties):
        super().__init__(props)
        self.scale = props.get_float("scale", 1.0)
        if self.nested is None:
            raise RuntimeError("bumpmap: requires a nested BSDF")
        if self.normalmap_tex is None:
            raise RuntimeError("bumpmap: requires a height texture")

    def params_row(self):
        row = super().params_row()
        row[P_BMAP_SCALE] = self.scale
        return row


@register_plugin("bsdf", "null")
class Null(BSDF):
    """Pass-through (reference src/bsdfs/null.cpp)."""
    type_id = BSDF_NULL
    flags = FLAG_NULL | FLAG_DELTA


@register_plugin("bsdf", "conductor")
class Conductor(BSDF):
    """Smooth conductor (reference src/bsdfs/conductor.cpp): a perfect
    mirror with the complex-ior Fresnel weight; the default material
    "none" reflects everything."""
    type_id = BSDF_CONDUCTOR
    flags = FLAG_DELTA

    def __init__(self, props: Properties):
        super().__init__(props)
        mat = props.get_string("material", "none")
        eta_d, k_d = CONDUCTOR_IOR.get(mat, CONDUCTOR_IOR["none"])
        # the named material's eta / k spectra, which the spectral
        # variant interpolates at the hero wavelengths
        self.material = (mat if (mat in CONDUCTOR_SPECTRA
                                 and not props.has_property("eta")
                                 and not props.has_property("k"))
                         else None)
        self.eta = _get_rgb(props, "eta", list(eta_d))
        self.k = _get_rgb(props, "k", list(k_d))
        self.specular_reflectance = _get_rgb(
            props, "specular_reflectance", [1.0, 1.0, 1.0])

    def params_row(self):
        p = np.zeros(N_BSDF_PARAMS)
        p[P_REFL:P_REFL + 3] = self.specular_reflectance
        p[P_TWOSIDED] = 1.0 if self.two_sided else 0.0
        p[P_ETA:P_ETA + 3] = self.eta
        p[P_K:P_K + 3] = self.k
        return p


@register_plugin("bsdf", "roughconductor")
class RoughConductor(Conductor):
    """Microfacet conductor (reference src/bsdfs/roughconductor.cpp): GGX
    with visible-normal sampling, or Beckmann, anisotropic through
    ``alpha_u`` / ``alpha_v``."""
    type_id = BSDF_ROUGHCONDUCTOR
    flags = FLAG_SMOOTH

    def __init__(self, props: Properties):
        super().__init__(props)
        dist = props.get_string("distribution", "ggx")
        if dist not in ("ggx", "beckmann"):
            raise RuntimeError(
                f"roughconductor: unknown distribution '{dist}'")
        self.distribution = dist
        alpha = props.get_float("alpha", 0.1)
        self.alpha_u = props.get_float("alpha_u", alpha)
        self.alpha_v = props.get_float("alpha_v", alpha)

    def params_row(self):
        p = super().params_row()
        p[P_ALPHA] = self.alpha_u
        p[P_ALPHA + 1] = self.alpha_v
        p[P_MF_DIST] = 1.0 if self.distribution == "beckmann" else 0.0
        return p


@register_plugin("bsdf", "dielectric")
class Dielectric(BSDF):
    """Smooth dielectric (reference src/bsdfs/dielectric.cpp). As in the
    JAX package its row leaves the twosided column at 0."""
    type_id = BSDF_DIELECTRIC
    flags = FLAG_DELTA

    def __init__(self, props: Properties):
        super().__init__(props)
        int_ior = _parse_ior(props, "int_ior", "bk7")
        ext_ior = _parse_ior(props, "ext_ior", "air")
        self.eta = int_ior / ext_ior
        self.specular_reflectance = _get_rgb(
            props, "specular_reflectance", [1.0, 1.0, 1.0])
        self.specular_transmittance = _get_rgb(
            props, "specular_transmittance", [1.0, 1.0, 1.0])

    def params_row(self):
        p = np.zeros(N_BSDF_PARAMS)
        p[P_REFL:P_REFL + 3] = self.specular_reflectance
        p[P_ETA] = self.eta
        p[P_SPEC_TRANS:P_SPEC_TRANS + 3] = self.specular_transmittance
        return p


@register_plugin("bsdf", "thindielectric")
class ThinDielectric(Dielectric):
    """Thin dielectric slab (reference src/bsdfs/thindielectric.cpp)."""
    type_id = BSDF_THINDIELECTRIC
    flags = FLAG_DELTA | FLAG_NULL


@register_plugin("bsdf", "roughdielectric")
class RoughDielectric(Dielectric):
    """GGX rough dielectric (reference src/bsdfs/roughdielectric.cpp);
    the ``distribution`` is read and GGX used, as in the JAX package."""
    type_id = BSDF_ROUGHDIELECTRIC
    flags = FLAG_SMOOTH

    def __init__(self, props: Properties):
        props.mark_queried("distribution")
        alpha = props.get_float("alpha", 0.1)
        super().__init__(props)
        self.alpha = alpha

    def params_row(self):
        p = super().params_row()
        p[P_ALPHA] = self.alpha
        return p


def _scalar_weight(props, key, default):
    """A mix weight from a float, an ``rgb`` dict or a texture: its
    mean, as the JAX package takes it (not the texture's per-hit
    value)."""
    w = props.get(key, default)
    if isinstance(w, dict):
        w = float(np.mean(w.get("value")))
    from ..textures import Texture
    if isinstance(w, Texture):
        w = float(np.mean(w.mean_rgb()))
    return float(w)


@register_plugin("bsdf", "mask")
class Mask(BSDF):
    """Opacity mask (reference src/bsdfs/mask.cpp): with probability
    ``opacity`` the nested BSDF, else a pass-through null."""
    type_id = BSDF_MASK
    flags = FLAG_SMOOTH | FLAG_NULL | FLAG_DELTA

    def __init__(self, props: Properties):
        super().__init__(props)
        self.nested_bsdf = None
        for _, v in props.objects():
            if isinstance(v, BSDF):
                self.nested_bsdf = v
        if self.nested_bsdf is None:
            raise RuntimeError("mask: requires a nested BSDF")
        self.opacity = _scalar_weight(props, "opacity", 0.5)
        self.flags = self.nested_bsdf.flags | FLAG_NULL | FLAG_DELTA
        self.nested_index = -1      # assigned at scene compile
        self.null_index = -1

    def params_row(self):
        p = np.zeros(N_BSDF_PARAMS)
        p[P_NESTED0] = float(self.nested_index)
        p[P_NESTED1] = float(self.null_index)
        p[P_MIX] = 1.0 - self.opacity    # probability of the null row
        return p


@register_plugin("bsdf", "blendbsdf")
class BlendBSDF(BSDF):
    """Blend of two BSDFs (reference src/bsdfs/blendbsdf.cpp): the second
    with probability ``weight``, else the first."""
    type_id = BSDF_BLEND
    flags = FLAG_SMOOTH

    def __init__(self, props: Properties):
        super().__init__(props)
        nested = [v for _, v in props.objects() if isinstance(v, BSDF)]
        if len(nested) != 2:
            raise RuntimeError("blendbsdf: requires exactly two nested BSDFs")
        self.nested = nested
        self.weight = _scalar_weight(props, "weight", 0.5)
        self.flags = nested[0].flags | nested[1].flags
        self.nested_indices = (-1, -1)

    def params_row(self):
        p = np.zeros(N_BSDF_PARAMS)
        p[P_NESTED0] = float(self.nested_indices[0])
        p[P_NESTED1] = float(self.nested_indices[1])
        p[P_MIX] = self.weight      # probability of row 1
        return p


@register_plugin("bsdf", "plastic")
class Plastic(BSDF):
    """Smooth plastic: a delta dielectric coat over a diffuse base
    (reference src/bsdfs/plastic.cpp)."""
    type_id = BSDF_PLASTIC
    flags = FLAG_SMOOTH | FLAG_DELTA

    def __init__(self, props: Properties):
        super().__init__(props)
        int_ior = _parse_ior(props, "int_ior", "polypropylene")
        ext_ior = _parse_ior(props, "ext_ior", "air")
        self.eta = int_ior / ext_ior
        self.diffuse_reflectance = _get_rgb(
            props, "diffuse_reflectance", [0.5, 0.5, 0.5])
        self.specular_reflectance = _get_rgb(
            props, "specular_reflectance", [1.0, 1.0, 1.0])
        self.nonlinear = props.get_bool("nonlinear", False)
        # internal diffuse Fresnel reflectance (the reference precomputes
        # fdr_int by quadrature; d'Eon's fit is within ~1e-3 for eta in
        # [1, 3])
        e = self.eta
        self.fdr_int = fdr_approx(1.0 / e)
        self.fdr_ext = fdr_approx(e)
        # average specular sampling weight
        self.spec_weight_avg = float(np.mean(self.specular_reflectance))
        self.diff_weight_avg = float(np.mean(self.diffuse_reflectance))

    def params_row(self):
        p = np.zeros(N_BSDF_PARAMS)
        p[P_REFL:P_REFL + 3] = self.diffuse_reflectance
        p[P_TWOSIDED] = 1.0 if self.two_sided else 0.0
        p[P_ETA] = self.eta
        p[P_K] = self.fdr_int
        p[P_K + 1] = 1.0 if self.nonlinear else 0.0
        p[P_SPEC_TRANS:P_SPEC_TRANS + 3] = self.specular_reflectance
        # probability of picking the specular component (reference
        # plastic.cpp m_specular_sampling_weight); the JAX package's column
        # 11, over the first specular-reflectance column
        sw = self.spec_weight_avg / max(
            self.spec_weight_avg + self.diff_weight_avg, 1e-6)
        p[P_ALPHA + 1] = sw
        return p


@register_plugin("bsdf", "roughplastic")
class RoughPlastic(Plastic):
    """GGX rough plastic (reference src/bsdfs/roughplastic.cpp): a
    microfacet specular coat over a diffuse base with internal
    scattering."""
    type_id = BSDF_ROUGHPLASTIC
    flags = FLAG_SMOOTH

    def __init__(self, props: Properties):
        props.mark_queried("distribution")
        alpha = props.get_float("alpha", 0.1)
        super().__init__(props)
        self.alpha = alpha

    def params_row(self):
        p = super().params_row()
        p[P_ALPHA] = self.alpha
        return p


@register_plugin("bsdf", "pplastic")
class PPlastic(RoughPlastic):
    """Polarized plastic (reference src/bsdfs/pplastic.cpp): in the rgb
    variant the lobes of roughplastic, a GGX coat built from ``alpha``
    (pplastic.cpp:170-175) over the diffuse base, and its row."""


@register_plugin("bsdf", "principled")
class Principled(BSDF):
    """Principled BSDF (reference src/bsdfs/principled.cpp, Burley 2012 /
    2015): diffuse + retro-reflection + fake subsurface (flatness), sheen
    with tint, anisotropic GGX main specular with the metallic / spec_tint
    Schlick blend, GTR1 clearcoat and the rough-dielectric transmission
    lobe (spec_trans), with the one-to-one eta <-> specular mapping
    (principled.cpp:224-239). ``base_color`` may be a texture."""
    type_id = BSDF_PRINCIPLED
    flags = FLAG_SMOOTH
    thin = False

    def __init__(self, props: Properties):
        super().__init__(props)
        self.base_color = _get_rgb(props, "base_color", [0.5, 0.5, 0.5])
        self.reflectance_tex = _get_texture(props, "base_color")
        self.tex_index = -1
        self.roughness = props.get_float("roughness", 0.5)
        self.metallic = props.get_float("metallic", 0.0)
        self.anisotropic = props.get_float("anisotropic", 0.0)
        self.spec_tint = props.get_float("spec_tint", 0.0)
        self.sheen = props.get_float("sheen", 0.0)
        self.sheen_tint = props.get_float("sheen_tint", 0.0)
        self.flatness = props.get_float("flatness", 0.0)
        self.clearcoat = props.get_float("clearcoat", 0.0)
        self.clearcoat_gloss = props.get_float("clearcoat_gloss", 0.0)
        self.spec_trans = props.get_float("spec_trans", 0.0)
        self.diff_srate = props.get_float(
            "diffuse_reflectance_sampling_rate", 1.0)
        self.spec_srate = props.get_float(
            "main_specular_sampling_rate", 1.0)
        self.cc_srate = props.get_float("clearcoat_sampling_rate", 1.0)
        # eta and specular are one-to-one (principled.cpp:222-239)
        if props.has_property("eta") and props.has_property("specular"):
            raise ValueError(
                "principled: specify either 'eta' or 'specular', not both")
        if props.has_property("eta"):
            eta = props.get_float("eta")
            if self.spec_trans > 0.0 and eta == 1.0:
                eta = 1.001        # eta = 1 cannot transmit
        elif self.thin:
            eta = 1.5              # thin: no specular mapping
        else:
            spec = props.get_float("specular", 0.5)
            if self.spec_trans > 0.0 and spec == 0.0:
                spec = 1e-3
            eta = 2.0 / (1.0 - np.sqrt(0.08 * spec)) - 1.0
        self.eta = float(eta)

    def params_row(self):
        r2 = self.roughness * self.roughness
        if self.anisotropic > 0.0:
            aspect = float(np.sqrt(1.0 - 0.9 * self.anisotropic))
            ax, ay = max(1e-3, r2 / aspect), max(1e-3, r2 * aspect)
        else:
            ax = ay = max(1e-3, r2)
        p = np.zeros(N_BSDF_PARAMS)
        p[P_REFL:P_REFL + 3] = self.base_color
        p[P_TWOSIDED] = 1.0 if self.two_sided else 0.0
        p[P_ETA] = self.eta
        p[P_PR_AX] = ax
        p[P_PR_AY] = ay
        p[P_METALLIC] = self.metallic
        p[P_SPECTUNE] = self.spec_tint
        p[P_PR_SHEEN] = self.sheen
        p[P_ALPHA] = max(r2, 1e-3)
        p[P_PR_SHEENTINT] = self.sheen_tint
        p[P_PR_FLAT] = self.flatness
        p[P_PR_CC] = self.clearcoat
        p[P_PR_CCGLOSS] = self.clearcoat_gloss
        p[P_PR_STRANS] = self.spec_trans
        p[P_PR_DSRATE] = self.diff_srate
        p[P_PR_SSRATE] = self.spec_srate
        p[P_PR_CSRATE] = self.cc_srate
        p[P_PR_ROUGH] = self.roughness
        p[P_REFL_TEX] = float(self.tex_index)
        return p


@register_plugin("bsdf", "principledthin")
class PrincipledThin(Principled):
    """reference src/bsdfs/principledthin.cpp: the thin-sheet variant,
    with GGX specular reflection, specular "transmission" (reflect and
    flip with the Burley-2015 scaled roughness, :360-380), diffuse
    reflection (+retro, fake subsurface, sheen) and diffuse transmission
    (diff_trans in [0, 2]); no metallic or clearcoat, two-sided by
    nature."""
    type_id = BSDF_PRINCIPLED_THIN
    thin = True

    def __init__(self, props: Properties):
        self.diff_trans = props.get_float("diff_trans", 0.0)
        self.dt_srate = props.get_float(
            "diffuse_transmittance_sampling_rate", 1.0)
        self.sr_srate = props.get_float(
            "specular_reflectance_sampling_rate", 1.0)
        self.st_srate = props.get_float(
            "specular_transmittance_sampling_rate", 1.0)
        super().__init__(props)

    def params_row(self):
        p = super().params_row()
        # column reuse: clearcoat = diff_trans, its gloss = that lobe's
        # rate, the clearcoat rate = spec transmittance's, the main
        # specular rate = spec reflectance's
        p[P_PR_CC] = self.diff_trans
        p[P_PR_CCGLOSS] = self.dt_srate
        p[P_PR_SSRATE] = self.sr_srate
        p[P_PR_CSRATE] = self.st_srate
        p[P_TWOSIDED] = 0.0          # symmetric by construction
        return p


class BSDFSampleResult(NamedTuple):
    val_nee: Vec3             # f(wi, wo_nee) * cos(wo_nee)   (rgb)
    pdf_nee: torch.Tensor
    wo: Vec3                  # sampled direction (local)
    weight: Vec3              # f*cos/pdf for the sampled direction (rgb)
    pdf: torch.Tensor
    eta: torch.Tensor
    sampled_delta: torch.Tensor
    sampled_null: torch.Tensor


def _zero3(like) -> Vec3:
    z = torch.zeros_like(like)
    return Vec3(z, z, z)


def _diffuse_eval_pdf_sample(param, wi: Vec3, wo_nee: Vec3, s1, s2x, s2y,
                             tex_refl=None, tex_mask=None):
    """Reference src/bsdfs/diffuse.cpp eval/pdf/sample; ``s1`` is drawn by
    the caller but unused. ``param(j)`` gives column j per lane;
    ``tex_refl``/``tex_mask`` override the reflectance on textured
    lanes."""
    refl = Vec3(param(P_REFL), param(P_REFL + 1), param(P_REFL + 2))
    if tex_refl is not None:
        refl = where3(tex_mask, tex_refl, refl)
    two_sided = param(P_TWOSIDED) > 0.5
    sgn = torch.where(two_sided & (wi.z < 0.0), -1.0, 1.0)
    cos_i = wi.z * sgn
    cos_o_nee = wo_nee.z * sgn

    front = (cos_i > 0.0) & (cos_o_nee > 0.0)
    fcos = torch.where(front, INV_PI * cos_o_nee, 0.0)
    val_nee = refl * fcos

    wo_local = warp.cosine_hemisphere_c(s2x, s2y)
    ok = cos_i > 0.0
    pdf = torch.where(ok, INV_PI * wo_local.z, 0.0)
    wo = Vec3(wo_local.x, wo_local.y, wo_local.z * sgn)
    weight = where3(ok, refl, _zero3(pdf))
    false_ = torch.zeros_like(pdf, dtype=torch.bool)
    return BSDFSampleResult(val_nee, fcos, wo, weight, pdf,
                            torch.ones_like(pdf), false_, false_)


def _null_eval_pdf_sample(param, wi: Vec3, wo_nee: Vec3, s1, s2x, s2y):
    """Reference src/bsdfs/null.cpp: continue straight through, weight 1
    (a nonzero P_REFL tints it, as the JAX package's polarizer rows do)."""
    z = torch.zeros_like(wi.z)
    ones = torch.ones_like(wi.z)
    true_ = ones > 0.0
    w = Vec3(torch.where(param(P_REFL) > 0.0, param(P_REFL), 1.0),
             torch.where(param(P_REFL + 1) > 0.0, param(P_REFL + 1), 1.0),
             torch.where(param(P_REFL + 2) > 0.0, param(P_REFL + 2), 1.0))
    return BSDFSampleResult(Vec3(z, z, z), z, -wi, w, ones, ones, true_,
                            true_)


def _conductor_eval_pdf_sample(param, wi: Vec3, wo_nee: Vec3, s1, s2x, s2y):
    """Delta mirror (reference conductor.cpp): NEE cannot reach it."""
    z = torch.zeros_like(wi.z)
    ok = wi.z > 0.0
    wo = reflect(wi)
    F = Vec3(
        fresnel_conductor(wi.z, param(P_ETA), param(P_K)),
        fresnel_conductor(wi.z, param(P_ETA + 1), param(P_K + 1)),
        fresnel_conductor(wi.z, param(P_ETA + 2), param(P_K + 2)))
    refl = Vec3(param(P_REFL), param(P_REFL + 1), param(P_REFL + 2))
    weight = where3(ok, F * refl, Vec3(z, z, z))
    pdf = torch.where(ok, 1.0, 0.0)
    true_ = torch.ones_like(ok)
    return BSDFSampleResult(Vec3(z, z, z), z, wo, weight, pdf,
                            torch.ones_like(z), true_, ~true_)


def _roughconductor_eval_pdf_sample(param, wi, wo_nee, s1, s2x, s2y):
    """Microfacet conductor (reference roughconductor.cpp): GGX with VNDF
    sampling, or on rows that set P_MF_DIST Beckmann with D(m) cos
    sampling (the reference's sample_visible=false: the same estimator,
    another variance)."""
    ax = param(P_ALPHA)
    ay = param(P_ALPHA + 1)
    is_beck = param(P_MF_DIST) > 0.5
    refl = Vec3(param(P_REFL), param(P_REFL + 1), param(P_REFL + 2))

    def F_of(cos_im):
        return Vec3(
            fresnel_conductor(cos_im, param(P_ETA), param(P_K)),
            fresnel_conductor(cos_im, param(P_ETA + 1), param(P_K + 1)),
            fresnel_conductor(cos_im, param(P_ETA + 2), param(P_K + 2)))

    cos_i = wi.z
    ok = cos_i > 0.0

    # NEE eval / pdf: f cos_o = D F G / (4 cos_i), the cos_o cancels
    cos_o = wo_nee.z
    both = ok & (cos_o > 0.0)
    h = normalize(wi + wo_nee)
    D = torch.where(is_beck, mf.beckmann_D(h, ax, ay), mf.ggx_D(h, ax, ay))
    G = torch.where(is_beck, mf.beckmann_G(wi, wo_nee, h, ax, ay),
                    mf.ggx_G(wi, wo_nee, h, ax, ay))
    val_scalar = torch.where(
        both, D * G / torch.clamp(4.0 * cos_i, min=1e-12), 0.0)
    val_nee = F_of(dot(wi, h)) * refl * val_scalar
    pdf_m_nee = torch.where(is_beck, mf.beckmann_pdf(h, ax, ay),
                            mf.ggx_pdf_visible(wi, h, ax, ay))
    pdf_nee = torch.where(
        both, pdf_m_nee / torch.clamp(4.0 * torch.abs(dot(wo_nee, h)),
                                      min=1e-12), 0.0)

    # sample
    m_g, pdf_g = mf.ggx_sample_vndf(wi, ax, ay, s2x, s2y)
    m_b, pdf_b = mf.beckmann_sample(ax, ay, s2x, s2y)
    m = where3(is_beck, m_b, m_g)
    pdf_m = torch.where(is_beck, pdf_b, pdf_g)
    wo = Vec3(2.0 * dot(wi, m) * m.x - wi.x,
              2.0 * dot(wi, m) * m.y - wi.y,
              2.0 * dot(wi, m) * m.z - wi.z)
    valid = ok & (wo.z > 0.0) & (pdf_m > 0.0)
    pdf = torch.where(valid, pdf_m / torch.clamp(
        4.0 * torch.abs(dot(wo, m)), min=1e-12), 0.0)
    # f cos / pdf: F G2 / G1 for GGX's visible normals; Walter's
    # F G |wi.m| / (cos_i m.z) for Beckmann's D cos sampling
    w_ggx = mf.ggx_G(wi, wo, m, ax, ay) / torch.clamp(
        mf.ggx_smith_g1(wi, m, ax, ay), min=1e-12)
    w_beck = (mf.beckmann_G(wi, wo, m, ax, ay) * torch.abs(dot(wi, m))
              / torch.clamp(cos_i * m.z, min=1e-12))
    wscale = torch.where(valid, torch.where(is_beck, w_beck, w_ggx), 0.0)
    weight = F_of(dot(wi, m)) * refl * wscale
    false_ = torch.zeros_like(ok)
    return BSDFSampleResult(val_nee, pdf_nee, wo, weight, pdf,
                            torch.ones_like(cos_i), false_, false_)


def _dielectric_eval_pdf_sample(param, wi, wo_nee, s1, s2x, s2y):
    """Smooth dielectric (reference dielectric.cpp): reflect or refract by
    Fresnel; a refraction carries the radiance factor eta_ti^2 and returns
    the relative ior eta_it that the path loop multiplies into eta."""
    eta = param(P_ETA)
    F, cos_t, eta_it, eta_ti = fresnel_dielectric(wi.z, eta)
    pick_reflect = s1 <= F
    wo = where3(pick_reflect, reflect(wi), refract(wi, cos_t, eta_ti))
    pdf = torch.where(pick_reflect, F, 1.0 - F)
    refl = Vec3(param(P_REFL), param(P_REFL + 1), param(P_REFL + 2))
    trans = Vec3(param(P_SPEC_TRANS), param(P_SPEC_TRANS + 1),
                 param(P_SPEC_TRANS + 2))
    weight = where3(pick_reflect, refl, trans * (eta_ti * eta_ti))
    out_eta = torch.where(pick_reflect, torch.ones_like(F), eta_it)
    z = torch.zeros_like(F)
    true_ = torch.ones_like(pick_reflect)
    return BSDFSampleResult(Vec3(z, z, z), z, wo, weight, pdf, out_eta,
                            true_, ~true_)


def _thindielectric_eval_pdf_sample(param, wi, wo_nee, s1, s2x, s2y):
    """Thin slab (reference thindielectric.cpp): both interfaces folded
    in (R' = 2R / (1 + R)); the transmitted ray goes straight on."""
    eta = param(P_ETA)
    F, _, _, _ = fresnel_dielectric(torch.abs(wi.z), eta)
    R = torch.clamp(2.0 * F / (1.0 + F), max=1.0)
    T = 1.0 - R
    pick_reflect = s1 <= R
    wo = where3(pick_reflect, reflect(wi), -wi)
    pdf = torch.where(pick_reflect, R, T)
    refl = Vec3(param(P_REFL), param(P_REFL + 1), param(P_REFL + 2))
    trans = Vec3(param(P_SPEC_TRANS), param(P_SPEC_TRANS + 1),
                 param(P_SPEC_TRANS + 2))
    weight = where3(pick_reflect, refl, trans)
    z = torch.zeros_like(F)
    true_ = torch.ones_like(pick_reflect)
    return BSDFSampleResult(Vec3(z, z, z), z, wo, weight, pdf,
                            torch.ones_like(F), true_, ~true_)


def _roughdielectric_eval_pdf_sample(param, wi, wo_nee, s1, s2x, s2y):
    """Reference roughdielectric.cpp: GGX reflection and refraction with
    visible-normal sampling, the weight by the G2 / G1 identity; the
    directions are worked in the frame of the side wi lies on."""
    eta = param(P_ETA)
    alpha = param(P_ALPHA)
    refl_c = Vec3(param(P_REFL), param(P_REFL + 1), param(P_REFL + 2))
    trans_c = Vec3(param(P_SPEC_TRANS), param(P_SPEC_TRANS + 1),
                   param(P_SPEC_TRANS + 2))

    out_side = wi.z >= 0.0
    sgn = torch.where(out_side, 1.0, -1.0)
    wi_u = Vec3(wi.x, wi.y, wi.z * sgn)

    # sampling
    m_u, pdf_m = mf.ggx_sample_vndf(wi_u, alpha, alpha, s2x, s2y)
    cos_im = dot(wi_u, m_u)
    F, cos_t, eta_it, eta_ti = fresnel_dielectric(
        torch.where(out_side, cos_im, -cos_im), eta)
    pick_reflect = s1 <= F
    wo_r = Vec3(2.0 * cos_im * m_u.x - wi_u.x,
                2.0 * cos_im * m_u.y - wi_u.y,
                2.0 * cos_im * m_u.z - wi_u.z)
    # refraction through m: -eta_ti wi + (eta_ti c - cos_t') m
    c = cos_im
    scale = eta_ti
    cos_tm = torch.sqrt(torch.clamp(1.0 - scale * scale * (1.0 - c * c),
                                    min=0.0))
    wo_t = Vec3(-scale * wi_u.x + (scale * c - cos_tm) * m_u.x,
                -scale * wi_u.y + (scale * c - cos_tm) * m_u.y,
                -scale * wi_u.z + (scale * c - cos_tm) * m_u.z)
    wo_u = where3(pick_reflect, wo_r, wo_t)
    valid = ((pick_reflect & (wo_u.z > 0.0))
             | ((~pick_reflect) & (wo_u.z < 0.0)))
    # G2 with the refracted wo as it is (its smith_g1 sign rule holds for
    # dot < 0, z < 0, as in the reference microfacet.h)
    g2 = mf.ggx_G(wi_u, wo_u, m_u, alpha, alpha)
    g1 = mf.ggx_smith_g1(wi_u, m_u, alpha, alpha)
    wscale = torch.where(valid, g2 / torch.clamp(g1, min=1e-12), 0.0)
    factor = torch.where(pick_reflect, 1.0, eta_ti * eta_ti)
    weight = where3(pick_reflect, refl_c, trans_c) * (wscale * factor)
    # refraction Jacobian |wo.m| eta_o^2 / (eta_i wi.m + eta_o wo.m)^2
    wo_m = dot(wo_u, m_u)
    denom_t = (cos_im + eta_it * wo_m)
    jac_t = torch.abs(wo_m) * (eta_it * eta_it) / torch.clamp(
        denom_t * denom_t, min=1e-12)
    pdf = torch.where(
        pick_reflect,
        F * pdf_m / torch.clamp(4.0 * torch.abs(cos_im), min=1e-12),
        (1.0 - F) * pdf_m * jac_t)
    pdf = torch.where(valid, pdf, 0.0)

    # NEE eval / pdf: reflection
    wo_nee_u = Vec3(wo_nee.x, wo_nee.y, wo_nee.z * sgn)
    same_hemi = wo_nee_u.z > 0.0
    h_r = normalize(wi_u + wo_nee_u)
    D_r = mf.ggx_D(h_r, alpha, alpha)
    G_r = mf.ggx_G(wi_u, wo_nee_u, h_r, alpha, alpha)
    F_r, _, _, _ = fresnel_dielectric(
        torch.where(out_side, dot(wi_u, h_r), -dot(wi_u, h_r)), eta)
    refl_scalar = torch.where(same_hemi & (wi_u.z > 0.0),
                              F_r * D_r * G_r
                              / torch.clamp(4.0 * wi_u.z, min=1e-12), 0.0)
    pdf_nee_r = torch.where(
        same_hemi,
        F_r * mf.ggx_pdf_visible(wi_u, h_r, alpha, alpha)
        / torch.clamp(4.0 * torch.abs(dot(wo_nee_u, h_r)), min=1e-12), 0.0)
    # transmission: m = normalize(wi + eta wo) turned upward, the Jacobian
    # eta^2 |wo.m| / (wi.m + eta wo.m)^2
    h_t = normalize(Vec3(wi_u.x + eta_it * wo_nee_u.x,
                         wi_u.y + eta_it * wo_nee_u.y,
                         wi_u.z + eta_it * wo_nee_u.z))
    h_t = where3(h_t.z < 0.0, Vec3(-h_t.x, -h_t.y, -h_t.z), h_t)
    wi_m = dot(wi_u, h_t)
    wo_m = dot(wo_nee_u, h_t)
    t_ok = (~same_hemi) & (wi_u.z > 0.0) & (wi_m > 0.0) & (wo_m < 0.0)
    F_t, _, _, _ = fresnel_dielectric(
        torch.where(out_side, wi_m, -wi_m), eta)
    D_t = mf.ggx_D(h_t, alpha, alpha)
    G_t = mf.ggx_G(wi_u, wo_nee_u, h_t, alpha, alpha)
    denom_nee = wi_m + eta_it * wo_m
    inv_d2 = 1.0 / torch.clamp(denom_nee * denom_nee, min=1e-12)
    trans_scalar = torch.where(
        t_ok,
        (1.0 - F_t) * D_t * G_t * torch.abs(wi_m * wo_m) * inv_d2
        / torch.clamp(wi_u.z, min=1e-12), 0.0)
    dwh_dwo = (eta_it * eta_it) * torch.abs(wo_m) * inv_d2
    pdf_nee_t = torch.where(
        t_ok,
        (1.0 - F_t) * mf.ggx_pdf_visible(wi_u, h_t, alpha, alpha) * dwh_dwo,
        0.0)
    val_nee = refl_c * refl_scalar + trans_c * trans_scalar
    pdf_nee = pdf_nee_r + pdf_nee_t

    false_ = torch.zeros_like(pick_reflect)
    out_eta = torch.where(pick_reflect, torch.ones_like(F), eta_it)
    return BSDFSampleResult(val_nee, pdf_nee,
                            Vec3(wo_u.x, wo_u.y, wo_u.z * sgn),
                            weight, pdf, out_eta, false_, false_)


def _plastic_diffuse(diff: Vec3, fdr_int, nonlinear, F_i, inv_eta_2):
    """The internally scattered diffuse base of (rough)plastic, as a
    function of (cos_o, F_o)."""
    def term(cos_o, F_o):
        scale = (1.0 - F_i) * (1.0 - F_o) * inv_eta_2 * INV_PI * cos_o
        denom_lin = 1.0 - fdr_int
        return Vec3(
            diff.x / torch.where(nonlinear, 1.0 - diff.x * fdr_int,
                                 denom_lin),
            diff.y / torch.where(nonlinear, 1.0 - diff.y * fdr_int,
                                 denom_lin),
            diff.z / torch.where(nonlinear, 1.0 - diff.z * fdr_int,
                                 denom_lin)) * scale
    return term


def _plastic_eval_pdf_sample(param, wi, wo_nee, s1, s2x, s2y,
                             tex_refl=None, tex_mask=None):
    """Smooth plastic (reference plastic.cpp): delta specular + diffuse
    with internal-scattering compensation."""
    eta = param(P_ETA)
    fdr_int = param(P_K)
    nonlinear = param(P_K + 1) > 0.5
    spec_prob_w = param(P_ALPHA + 1)
    diff = Vec3(param(P_REFL), param(P_REFL + 1), param(P_REFL + 2))
    if tex_refl is not None:
        diff = where3(tex_mask, tex_refl, diff)
    spec = Vec3(param(P_SPEC_TRANS), param(P_SPEC_TRANS + 1),
                param(P_SPEC_TRANS + 2))
    two_sided = param(P_TWOSIDED) > 0.5
    sgn = torch.where(two_sided & (wi.z < 0.0), -1.0, 1.0)
    cos_i = wi.z * sgn
    ok = cos_i > 0.0

    F_i, _, _, eta_ti = fresnel_dielectric(cos_i, eta)
    inv_eta_2 = eta_ti * eta_ti

    # probability of the specular component (reference plastic.cpp sample)
    prob_spec = F_i * spec_prob_w / torch.clamp(
        F_i * spec_prob_w + (1.0 - F_i) * (1.0 - spec_prob_w), min=1e-12)

    # diffuse eval for NEE (the specular lobe is delta: it adds 0)
    cos_o_nee = wo_nee.z * sgn
    both = ok & (cos_o_nee > 0.0)
    F_o_nee, _, _, _ = fresnel_dielectric(cos_o_nee, eta)
    diffuse_term = _plastic_diffuse(diff, fdr_int, nonlinear, F_i, inv_eta_2)

    val_nee = where3(both, diffuse_term(cos_o_nee, F_o_nee), _zero3(F_i))
    pdf_nee = torch.where(both, (1.0 - prob_spec) * INV_PI * cos_o_nee, 0.0)

    # sample
    pick_spec = s1 < prob_spec
    wo_d = warp.cosine_hemisphere_c(s2x, s2y)
    wo = where3(pick_spec, reflect(Vec3(wi.x, wi.y, cos_i)), wo_d)
    F_o_s, _, _, _ = fresnel_dielectric(wo.z, eta)
    pdf_d = (1.0 - prob_spec) * INV_PI * wo.z
    pdf = torch.where(pick_spec, prob_spec, pdf_d)
    w_spec = spec * (F_i / torch.clamp(prob_spec, min=1e-12))
    w_diff = diffuse_term(wo.z, F_o_s) * (
        1.0 / torch.clamp(pdf_d, min=1e-12))
    weight = where3(pick_spec, w_spec, w_diff)
    weight = where3(ok, weight, _zero3(F_i))
    pdf = torch.where(ok, pdf, 0.0)
    wo = Vec3(wo.x, wo.y, wo.z * sgn)
    return BSDFSampleResult(val_nee, pdf_nee, wo, weight, pdf,
                            torch.ones_like(F_i), pick_spec,
                            torch.zeros_like(pick_spec))


def _roughplastic_eval_pdf_sample(param, wi, wo_nee, s1, s2x, s2y,
                                  tex_refl=None, tex_mask=None):
    """Reference roughplastic.cpp: GGX specular + internally scattered
    diffuse; both lobes are smooth, so NEE evaluates both."""
    eta = param(P_ETA)
    fdr_int = param(P_K)
    nonlinear = param(P_K + 1) > 0.5
    spec_prob_w = param(P_ALPHA + 1)
    alpha = param(P_ALPHA)
    diff = Vec3(param(P_REFL), param(P_REFL + 1), param(P_REFL + 2))
    if tex_refl is not None:
        diff = where3(tex_mask, tex_refl, diff)
    spec = Vec3(param(P_SPEC_TRANS), param(P_SPEC_TRANS + 1),
                param(P_SPEC_TRANS + 2))
    two_sided = param(P_TWOSIDED) > 0.5
    sgn = torch.where(two_sided & (wi.z < 0.0), -1.0, 1.0)
    wi_l = Vec3(wi.x, wi.y, wi.z * sgn)
    cos_i = wi_l.z
    ok = cos_i > 0.0

    F_i, _, _, eta_ti = fresnel_dielectric(cos_i, eta)
    inv_eta_2 = eta_ti * eta_ti
    prob_spec = F_i * spec_prob_w / torch.clamp(
        F_i * spec_prob_w + (1.0 - F_i) * (1.0 - spec_prob_w), min=1e-12)
    prob_diff = 1.0 - prob_spec
    diffuse_term = _plastic_diffuse(diff, fdr_int, nonlinear, F_i, inv_eta_2)

    def eval_both(wo):
        cos_o = wo.z
        both = ok & (cos_o > 0.0)
        h = normalize(wi_l + wo)
        D = mf.ggx_D(h, alpha, alpha)
        G = mf.ggx_G(wi_l, wo, h, alpha, alpha)
        F_h, _, _, _ = fresnel_dielectric(dot(wi_l, h), eta)
        spec_scalar = torch.where(
            both, F_h * D * G / torch.clamp(4.0 * cos_i, min=1e-12), 0.0)
        F_o, _, _, _ = fresnel_dielectric(cos_o, eta)
        val = spec * spec_scalar + where3(both, diffuse_term(cos_o, F_o),
                                          _zero3(cos_o))
        pdf_spec = torch.where(
            both, mf.ggx_pdf_visible(wi_l, h, alpha, alpha)
            / torch.clamp(4.0 * torch.abs(dot(wo, h)), min=1e-12), 0.0)
        pdf = prob_spec * pdf_spec + prob_diff * torch.where(
            both, INV_PI * cos_o, 0.0)
        return val, pdf

    wo_nee_l = Vec3(wo_nee.x, wo_nee.y, wo_nee.z * sgn)
    val_nee, pdf_nee = eval_both(wo_nee_l)

    pick_spec = s1 < prob_spec
    m, _ = mf.ggx_sample_vndf(wi_l, alpha, alpha, s2x, s2y)
    wo_spec = Vec3(2.0 * dot(wi_l, m) * m.x - wi_l.x,
                   2.0 * dot(wi_l, m) * m.y - wi_l.y,
                   2.0 * dot(wi_l, m) * m.z - wi_l.z)
    wo_diff = warp.cosine_hemisphere_c(s2x, s2y)
    wo = where3(pick_spec, wo_spec, wo_diff)
    val_s, pdf_s = eval_both(wo)
    valid = ok & (wo.z > 0.0) & (pdf_s > 1e-12)
    inv_pdf = torch.where(valid, 1.0 / torch.clamp(pdf_s, min=1e-12), 0.0)
    weight = val_s * inv_pdf
    pdf_out = torch.where(valid, pdf_s, 0.0)
    false_ = torch.zeros_like(cos_i, dtype=torch.bool)
    return BSDFSampleResult(val_nee, pdf_nee,
                            Vec3(wo.x, wo.y, wo.z * sgn), weight, pdf_out,
                            torch.ones_like(cos_i), false_, false_)


@register_plugin("bsdf", "measured")
class Measured(BSDF):
    """Data-driven BRDF in the RGL tensor format (reference
    src/bsdfs/measured.cpp; Dupuy & Jakob's adaptive parameterization),
    sampled and evaluated through the histogram warps of
    ``bsdfs/measured_impl.py``: at the three representative wavelengths
    ``RGB_WAVELENGTHS`` in the rgb variant, at the lane's hero
    wavelengths in the spectral one."""
    type_id = BSDF_MEASURED
    flags = FLAG_SMOOTH

    def __init__(self, props: Properties):
        super().__init__(props)
        from ..core.fresolver import resolve_filename
        from ..io.tensor_file import read_tensor_file
        from .measured_impl import build_tables
        fname = resolve_filename(props.get_string("filename"))
        self.tables = build_tables(read_tensor_file(fname))
        self.measured_index = -1     # the compile assigns it

    def params_row(self):
        p = np.zeros(N_BSDF_PARAMS)
        p[P_MEASURED_IDX] = float(self.measured_index)
        return p


@register_plugin("bsdf", "polarizer")
class Polarizer(Null):
    """Linear polarizer (reference src/bsdfs/polarizer.cpp): a delta
    transmission attenuated by the Malus average 0.5 in the scalar
    variants, the rotated linear-polarizer Mueller matrix in the
    polarized ones (``integrators/polarized.py``)."""
    type_id = BSDF_POLARIZER

    def __init__(self, props: Properties):
        super().__init__(props)
        self.theta = math.radians(props.get_float("theta", 0.0))
        t = props.get_float("transmittance", 1.0)
        self.transmittance = (t, t, t)

    def params_row(self):
        p = np.zeros(N_BSDF_PARAMS)
        p[P_REFL:P_REFL + 3] = self.transmittance
        p[P_POL_THETA] = self.theta
        return p


@register_plugin("bsdf", "retarder")
class Retarder(Null):
    """Wave retarder (reference src/bsdfs/retarder.cpp): the identity on
    intensity, a phase shift between its fast and slow axes in the
    polarized variants."""
    type_id = BSDF_RETARDER

    def __init__(self, props: Properties):
        super().__init__(props)
        self.theta = math.radians(props.get_float("theta", 0.0))
        self.delta = math.radians(props.get_float("delta", 90.0))

    def params_row(self):
        p = np.zeros(N_BSDF_PARAMS)
        p[P_REFL:P_REFL + 3] = 1.0
        p[P_POL_THETA] = self.theta
        p[P_POL_DELTA] = self.delta
        return p


@register_plugin("bsdf", "circular")
class CircularPolarizer(Polarizer):
    """Circular polarizer (reference src/bsdfs/circular.cpp)."""
    type_id = BSDF_CIRCULAR


@register_plugin("bsdf", "measured_polarized")
class MeasuredPolarized(BSDF):
    """Measured polarized pBRDF (reference src/bsdfs/
    measured_polarized.cpp): the 4x4 Mueller matrix interpolated over
    (phi_d, theta_d, theta_h, wavelength) with the reflection-plane Stokes
    rotations (``bsdfs/measured_polarized_impl.py``) in the polarized
    variants, its M00 in the others; sampled by a cosine / GGX mixture
    with ``alpha_sample``. The channels read the tables at three fixed
    wavelengths in every variant (``wavelength`` pins one), as the JAX
    package's do."""
    type_id = BSDF_MEASURED_POL
    flags = FLAG_SMOOTH

    def __init__(self, props: Properties):
        super().__init__(props)
        from ..core.fresolver import resolve_filename
        from ..io.tensor_file import read_tensor_file
        from .measured_polarized_impl import build_pbsdf_tables
        fname = resolve_filename(props.get_string("filename"))
        self.alpha_sample = props.get_float("alpha_sample", 0.1)
        self.wavelength = props.get_float("wavelength", -1.0)
        self.tables = build_pbsdf_tables(read_tensor_file(fname))
        self.measured_index = -1     # the compile assigns it

    def params_row(self):
        p = np.zeros(N_BSDF_PARAMS)
        p[P_MEASURED_IDX] = float(self.measured_index)
        p[P_ALPHA_SAMPLE] = self.alpha_sample
        return p

    def pol_wavelengths(self):
        from .measured_polarized_impl import RGB_WAVELENGTHS
        if self.wavelength > 0.0:
            return (self.wavelength,) * 3
        return RGB_WAVELENGTHS


def _polarizer_like_dispatch(factor):
    """The scalar variants' polarizing elements: a null-style delta
    transmission of ``factor`` times the P_REFL transmittance (reference
    polarizer.cpp's unpolarized branch: 0.5 transmittance)."""
    def fn(param, wi, wo_nee, s1, s2x, s2y):
        z = torch.zeros_like(wi.z)
        ones = torch.ones_like(wi.z)
        true_ = ones > 0.0
        w = Vec3(param(P_REFL) * factor, param(P_REFL + 1) * factor,
                 param(P_REFL + 2) * factor)
        return BSDFSampleResult(Vec3(z, z, z), z, -wi, w, ones, ones, true_,
                                true_)
    return fn


_DISPATCH = {
    BSDF_DIFFUSE: _diffuse_eval_pdf_sample,
    BSDF_NULL: _null_eval_pdf_sample,
    BSDF_CONDUCTOR: _conductor_eval_pdf_sample,
    BSDF_DIELECTRIC: _dielectric_eval_pdf_sample,
    BSDF_ROUGHCONDUCTOR: _roughconductor_eval_pdf_sample,
    BSDF_PLASTIC: _plastic_eval_pdf_sample,
    BSDF_ROUGHPLASTIC: _roughplastic_eval_pdf_sample,
    BSDF_ROUGHDIELECTRIC: _roughdielectric_eval_pdf_sample,
    BSDF_THINDIELECTRIC: _thindielectric_eval_pdf_sample,
    BSDF_POLARIZER: _polarizer_like_dispatch(0.5),
    BSDF_RETARDER: _polarizer_like_dispatch(1.0),
    BSDF_CIRCULAR: _polarizer_like_dispatch(0.5),
}


from .principled_impl import (principled_eval_pdf_sample,  # noqa: E402
                              principledthin_eval_pdf_sample)
_DISPATCH[BSDF_PRINCIPLED] = principled_eval_pdf_sample
_DISPATCH[BSDF_PRINCIPLED_THIN] = principledthin_eval_pdf_sample


def remap_wrapper_rows(sa, lane_bsdf, s1):
    """Lanes on a mask or blendbsdf row move to one of its nested rows,
    row 1 with probability P_MIX, and the lobe sample is rescaled for the
    nested BSDF (the choice does not depend on wo, so the estimator stays
    unbiased). Returns (rows, lobe samples)."""
    lane_bsdf = lane_bsdf.long()
    lane_type = sa.bsdf_type[lane_bsdf]
    is_wrap = (lane_type == BSDF_MASK) | (lane_type == BSDF_BLEND)
    mix = sa.bsdf_params[P_MIX][lane_bsdf]
    n0 = sa.bsdf_params[P_NESTED0][lane_bsdf].to(torch.int64)
    n1 = sa.bsdf_params[P_NESTED1][lane_bsdf].to(torch.int64)
    pick1 = s1 < mix
    new_bsdf = torch.where(is_wrap, torch.where(pick1, n1, n0), lane_bsdf)
    s1_re = torch.where(pick1, s1 / torch.clamp(mix, min=1e-8),
                        (s1 - mix) / torch.clamp(1.0 - mix, min=1e-8))
    new_s1 = torch.where(is_wrap, torch.clamp(s1_re, 0.0, 0.999999), s1)
    return new_bsdf, new_s1


def _select(m, a: BSDFSampleResult, b: BSDFSampleResult):
    """``a`` on the lanes of ``m``, else ``b``."""
    return BSDFSampleResult(*(
        where3(m, x, y) if isinstance(x, Vec3) else torch.where(m, x, y)
        for x, y in zip(a, b)))


def _conductor_spectra_param(sa, lane_bsdf, param, wavelengths):
    """``param`` with a named-material conductor's eta and k columns
    replaced by its tabulated eta(lambda) / k(lambda) at the lane's three
    hero wavelengths (reference ior.h complex_ior_from_file)."""
    lane_ior = torch.tensor(sa.bsdf_ior_host, dtype=torch.int32,
                            device=lane_bsdf.device)[lane_bsdf]
    lam3 = (wavelengths.x, wavelengths.y, wavelengths.z)

    def param_spec(j):
        base = param(j)
        if not (P_ETA <= j < P_ETA + 3 or P_K <= j < P_K + 3):
            return base
        which_k = j >= P_K
        lam = lam3[j - (P_K if which_k else P_ETA)]
        out = base
        for e_i, (wls_t, eta_t, k_t) in enumerate(sa.ior_spectra):
            f32 = dict(dtype=torch.float32, device=lam.device)
            v = interp(lam, torch.tensor(wls_t, **f32),
                       torch.tensor(k_t if which_k else eta_t, **f32))
            out = torch.where(lane_ior == e_i, v, out)
        return out
    return param_spec


def eval_pdf_sample(sa, lane_bsdf, wi: Vec3, wo_nee: Vec3, s1, s2x, s2y,
                    tex_refl=None, tex_mask=None,
                    wavelengths=None) -> BSDFSampleResult:
    """Masked multi-type dispatch of BSDF::eval_pdf_sample (reference
    src/render/bsdf.cpp:168): every type present in the scene runs over the
    whole wavefront and the lane's own type is selected. ``tex_refl`` /
    ``tex_mask``: the textured reflectance and the lanes it replaces the
    row's on, for the types in ``TEXTURED_TYPES``. Lanes on a mask or
    blendbsdf row first move to a nested row (``remap_wrapper_rows``).

    ``wavelengths`` (the spectral variant): the lanes' hero wavelengths.
    The upsampled types' P_REFL coefficients are then evaluated there and
    enter through the texture override (textured lanes arrive spectral
    already), named-material conductors read their eta / k spectra, and
    the measured BSDF its spectra at those wavelengths."""
    lane_bsdf = lane_bsdf.long()
    present = sa.bsdf_types_present
    if BSDF_MASK in present or BSDF_BLEND in present:
        lane_bsdf, s1 = remap_wrapper_rows(sa, lane_bsdf, s1)
    lane_type = sa.bsdf_type[lane_bsdf]

    def param(j):
        return sa.bsdf_params[j][lane_bsdf]

    if wavelengths is not None:
        c0, c1, c2 = param(P_REFL), param(P_REFL + 1), param(P_REFL + 2)
        srefl = Vec3(*(eval_reflectance_spectrum(c0, c1, c2, lam)
                       for lam in wavelengths))
        is_up = torch.zeros_like(lane_type, dtype=torch.bool)
        for t in TEXTURED_TYPES:
            is_up = is_up | (lane_type == t)
        if tex_refl is not None:
            srefl = where3(tex_mask, tex_refl, srefl)
            tex_mask = tex_mask | is_up
        else:
            tex_mask = is_up
        tex_refl = srefl

    result = None
    for tid in present:
        if tid in (BSDF_MASK, BSDF_BLEND):
            continue          # no lane carries these types after the remap
        if tid == BSDF_MEASURED:
            from .measured_impl import measured_eval_pdf_sample
            m_idx = param(P_MEASURED_IDX).to(torch.int32)
            r = None
            for k, tbl in enumerate(sa.measured):
                rk = measured_eval_pdf_sample(tbl, wi, wo_nee, s2x, s2y,
                                              wavelengths)
                r = rk if r is None else _select(m_idx == k, rk, r)
        elif tid == BSDF_MEASURED_POL:
            # the tables' own wavelengths in every variant (the JAX
            # package's measured_pol_wls)
            from .measured_polarized_impl import pbsdf_eval_pdf_sample
            m_idx = param(P_MEASURED_IDX).to(torch.int32)
            alpha = param(P_ALPHA_SAMPLE)
            r = None
            for k, (tbl, wls) in enumerate(zip(sa.measured_pol,
                                               sa.measured_pol_wls)):
                rk = pbsdf_eval_pdf_sample(tbl, alpha, wi, wo_nee, s1, s2x,
                                           s2y, wavelengths=wls)
                r = rk if r is None else _select(m_idx == k, rk, r)
        else:
            fn = _DISPATCH[int(tid)]
            if tid in TEXTURED_TYPES and tex_refl is not None:
                r = fn(param, wi, wo_nee, s1, s2x, s2y, tex_refl, tex_mask)
            elif (tid in (BSDF_CONDUCTOR, BSDF_ROUGHCONDUCTOR)
                    and wavelengths is not None and sa.ior_spectra):
                r = fn(_conductor_spectra_param(sa, lane_bsdf, param,
                                                wavelengths),
                       wi, wo_nee, s1, s2x, s2y)
            else:
                r = fn(param, wi, wo_nee, s1, s2x, s2y)
        result = r if result is None else _select(lane_type == tid, r,
                                                  result)
    return result


__all__ = [
    "BSDF", "Diffuse", "TwoSided", "NormalMap", "BumpMap", "Null", "Conductor", "RoughConductor",
    "Dielectric", "ThinDielectric", "RoughDielectric", "Plastic",
    "RoughPlastic", "PPlastic", "Principled", "PrincipledThin", "Mask",
    "BlendBSDF", "BSDFSampleResult",
    "eval_pdf_sample", "remap_wrapper_rows", "N_BSDF_PARAMS",
    "FLAG_SMOOTH", "FLAG_DELTA", "FLAG_NULL", "BSDF_DIFFUSE", "BSDF_NULL",
    "BSDF_CONDUCTOR", "BSDF_DIELECTRIC", "BSDF_ROUGHCONDUCTOR",
    "BSDF_PLASTIC", "BSDF_ROUGHPLASTIC", "BSDF_ROUGHDIELECTRIC",
    "BSDF_THINDIELECTRIC", "BSDF_BLEND", "BSDF_MASK", "BSDF_PRINCIPLED",
    "BSDF_PRINCIPLED_THIN", "BSDF_MEASURED", "Measured", "P_REFL",
    "P_TWOSIDED", "P_REFL_TEX", "P_NMAP_TEX", "P_BMAP_SCALE",
    "TEXTURED_TYPES", "P_MEASURED_IDX", "BSDF_POLARIZER", "BSDF_RETARDER",
    "BSDF_CIRCULAR", "BSDF_MEASURED_POL", "P_POL_THETA", "P_POL_DELTA",
    "P_ALPHA_SAMPLE", "Polarizer", "Retarder", "CircularPolarizer",
    "MeasuredPolarized",
]
