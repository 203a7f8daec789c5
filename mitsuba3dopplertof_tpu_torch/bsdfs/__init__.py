"""BSDF plugins and the masked type dispatch (port of the JAX package's
``bsdfs/__init__.py``: diffuse and twosided).

Each BSDF compiles to one row of a parameter table (type id + float
params); ``eval_pdf_sample`` evaluates every type present in the scene over
the whole wavefront and selects by mask. Directions are in the local
shading frame (z = normal), as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import warp
from ..core.math import INV_PI
from ..core.properties import Properties, register_plugin
from ..core.vec import Vec3, where3

# type ids (the JAX package's numbering)
BSDF_DIFFUSE = 0

N_BSDF_PARAMS = 24
P_REFL = 0            # rgb reflectance
P_TWOSIDED = 3        # 1.0 if wrapped in `twosided`
P_REFL_TEX = 14       # texture id driving the reflectance (-1 = constant)
P_NMAP_TEX = 15       # normal-map texture id (-1 = none)

# lobe flags (static per row, mirrors reference BSDFFlags)
FLAG_SMOOTH = 1       # has a smooth (non-delta) lobe => NEE applies


class BSDF:
    """Host-side plugin base: compiles to (type_id, flags, params row).
    Subclasses must set ``type_id``; the base has none, so a BSDF without
    a type cannot compile as diffuse by accident."""
    type_id: int
    flags: int

    def __init__(self, props: Properties):
        self.id = props.id
        self.two_sided = False


def _get_rgb(props, key, default):
    v = props.get(key, default)
    if isinstance(v, dict):   # {'type':'rgb','value':[...]} from the parser
        if v.get("type") != "rgb":
            raise NotImplementedError(
                f"'{key}' of type '{v.get('type')}' is not ported yet "
                "(ROADMAP Queue A item 11)")
        v = v.get("value")
    if hasattr(v, "plugin_category"):
        raise NotImplementedError(
            f"textured '{key}' is not ported yet (ROADMAP Queue A item 9)")
    a = np.asarray(v, dtype=np.float64).reshape(-1)
    if a.size == 1:
        a = np.repeat(a, 3)
    return a[:3]


@register_plugin("bsdf", "diffuse")
class Diffuse(BSDF):
    """Lambertian (reference src/bsdfs/diffuse.cpp)."""
    type_id = BSDF_DIFFUSE
    flags = FLAG_SMOOTH

    def __init__(self, props: Properties):
        super().__init__(props)
        self.reflectance = _get_rgb(props, "reflectance", [0.5, 0.5, 0.5])

    def params_row(self):
        p = np.zeros(N_BSDF_PARAMS)
        p[P_REFL:P_REFL + 3] = self.reflectance
        p[P_TWOSIDED] = 1.0 if self.two_sided else 0.0
        p[P_REFL_TEX] = -1.0
        p[P_NMAP_TEX] = -1.0
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


class BSDFSampleResult(NamedTuple):
    val_nee: Vec3             # f(wi, wo_nee) * cos(wo_nee)   (rgb)
    pdf_nee: torch.Tensor
    wo: Vec3                  # sampled direction (local)
    weight: Vec3              # f*cos/pdf for the sampled direction (rgb)
    pdf: torch.Tensor
    eta: torch.Tensor
    sampled_delta: torch.Tensor
    sampled_null: torch.Tensor


def _diffuse_eval_pdf_sample(param, wi: Vec3, wo_nee: Vec3, s1, s2x, s2y):
    """Reference src/bsdfs/diffuse.cpp eval/pdf/sample; ``s1`` is drawn by
    the caller but unused. ``param(j)`` gives column j per lane."""
    refl = Vec3(param(P_REFL), param(P_REFL + 1), param(P_REFL + 2))
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
    zero = torch.zeros_like(pdf)
    weight = where3(ok, refl, Vec3(zero, zero, zero))
    false_ = torch.zeros_like(pdf, dtype=torch.bool)
    return BSDFSampleResult(val_nee, fcos, wo, weight, pdf,
                            torch.ones_like(pdf), false_, false_)


_DISPATCH = {
    BSDF_DIFFUSE: _diffuse_eval_pdf_sample,
}


def eval_pdf_sample(sa, lane_bsdf, wi: Vec3, wo_nee: Vec3,
                    s1, s2x, s2y) -> BSDFSampleResult:
    """Masked multi-type dispatch of BSDF::eval_pdf_sample (reference
    src/render/bsdf.cpp:168): every type present in the scene runs over the
    whole wavefront and the lane's own type is selected."""
    lane_bsdf = lane_bsdf.long()
    lane_type = sa.bsdf_type[lane_bsdf]

    def param(j):
        return sa.bsdf_params[j][lane_bsdf]

    result = None
    for tid in sa.bsdf_types_present:
        fn = _DISPATCH.get(int(tid))
        if fn is None:
            raise NotImplementedError(
                f"BSDF type id {tid} is not ported yet "
                "(ROADMAP Queue A items 9-10)")
        r = fn(param, wi, wo_nee, s1, s2x, s2y)
        if result is None:
            result = r
        else:
            m = lane_type == tid
            result = BSDFSampleResult(*(
                where3(m, a, b) if isinstance(a, Vec3) else
                torch.where(m, a, b) for a, b in zip(r, result)))
    return result


__all__ = [
    "BSDF", "Diffuse", "TwoSided", "BSDFSampleResult", "eval_pdf_sample",
    "N_BSDF_PARAMS", "FLAG_SMOOTH", "BSDF_DIFFUSE", "P_REFL", "P_TWOSIDED",
]
