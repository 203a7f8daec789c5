"""Emitter plugins and emitter sampling (port of the JAX package's
``emitters/__init__.py``: the point, spot, directional and projector
emitters, the area emitter on rectangles, meshes and analytic spheres, the
directionalarea emitter, and the constant and envmap environments).

Sampling follows the masked type dispatch over the compiled emitter table;
the uniform emitter choice replicates reference src/render/scene.cpp:170-188
including the sample-reuse rescaling.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import warp
from ..core.math import mod
from ..core.properties import Properties, register_plugin
from ..core.vec import (Vec3, dot, cross, normalize, where3, cmat_lerp,
                        cmat_apply_point, cmat_apply_vector, cmat_inverse,
                        coordinate_system, spherical_uv)
from ..render.types import DirectionSample
from ..textures import eval_texture

# type ids (the JAX package's numbering)
EMITTER_POINT = 0         # point light (delta position)
EMITTER_AREA_RECT = 1     # area emitter on a static rectangle
EMITTER_CONSTANT = 2      # uniform environment
EMITTER_AREA_MESH = 3     # area emitter on any other mesh (CDF-sampled)
EMITTER_DIRECTIONAL = 4   # delta direction
EMITTER_SPOT = 5          # point light with an angular falloff
EMITTER_ENVMAP = 6        # image-based environment light
EMITTER_PROJECTOR = 7     # textured spot through a frustum (delta position)
EMITTER_DIRECTIONALAREA = 8   # area emitter along its normal only (delta
                              # direction): ptracer transports it
EMITTER_AREA_SPHERE = 9   # area emitter on an analytic sphere (cone-sampled)

N_EMITTER_PARAMS = 16
E_POS = 0          # point, spot: position / directional: direction /
                   # sphere: world center
E_INTENSITY = 3    # point, spot: rgb intensity / area, constant: rgb
                   # radiance / directional: rgb irradiance
E_AREA = 6         # total world-space surface area
E_CUTOFF = 7       # spot: cos cutoff / sphere: world radius /
                   # projector: tan of the half field of view
E_BEAM = 8         # spot: cos beam width / projector: texture id
E_RAD_TEX = 8      # area: radiance texture id (-1 = constant); the column
                   # of E_BEAM, which only spots use
E_SPH_SLOT = 9     # sphere: the animated sphere's slot in the sphere
                   # table (-1 = static)
E_AXIS = 9         # spot: its axis, 9:12


class Emitter:
    is_environment = False

    def __init__(self, props: Properties):
        self.id = props.id
        self.shape = None       # set for area emitters during assembly


@register_plugin("emitter", "point")
class PointEmitter(Emitter):
    """reference src/emitters/point.cpp — intensity / dist^2, a delta
    light: NEE always samples it and no ray hits it."""
    type_id = EMITTER_POINT

    def __init__(self, props: Properties):
        super().__init__(props)
        from ..bsdfs import _get_rgb
        if props.has_property("position"):
            self.position = props.get_vector("position")
        else:
            self.position = props.get_transform("to_world", np.eye(4))[:3, 3]
        self.intensity = _get_rgb(props, "intensity", [1.0, 1.0, 1.0])

    def params_row(self):
        p = np.zeros(N_EMITTER_PARAMS)
        p[E_POS:E_POS + 3] = self.position
        p[E_INTENSITY:E_INTENSITY + 3] = self.intensity
        return p


@register_plugin("emitter", "area")
class AreaEmitter(Emitter):
    """reference src/emitters/area.cpp — radiance over the host shape,
    emitted from its front side. A nested texture makes it vary over the
    surface: evaluated at the hit's uv, and at the sampled point's uv in
    NEE and in ptracer (a sphere's object-space spherical uv)."""
    type_id = EMITTER_AREA_RECT

    def __init__(self, props: Properties):
        super().__init__(props)
        from ..bsdfs import _get_rgb
        from ..spectra import Spectrum
        from ..textures import Texture
        self.irradiance_tex = None     # the compile assigns tex_index
        self.tex_index = -1
        for key, v in props.objects():
            if isinstance(v, Spectrum):
                continue               # its mean rgb is the radiance
            if not isinstance(v, Texture):
                raise RuntimeError(
                    f"area emitter child '{key}' of kind "
                    f"{v.plugin_category} is not a texture or spectrum")
            self.irradiance_tex = v
        # a texture's or spectrum's mean stands in the row's radiance
        # columns
        self.radiance = _get_rgb(props, "radiance", [1.0, 1.0, 1.0])

    def params_row(self):
        p = np.zeros(N_EMITTER_PARAMS)
        p[E_INTENSITY:E_INTENSITY + 3] = self.radiance
        p[E_RAD_TEX] = float(self.tex_index)
        return p


@register_plugin("emitter", "constant")
class ConstantEmitter(Emitter):
    """reference src/emitters/constant.cpp — uniform environment
    radiance, NEE-sampled uniformly over the sphere of directions."""
    type_id = EMITTER_CONSTANT
    is_environment = True

    def __init__(self, props: Properties):
        super().__init__(props)
        from ..bsdfs import _get_rgb
        self.radiance = _get_rgb(props, "radiance", [1.0, 1.0, 1.0])

    def params_row(self):
        p = np.zeros(N_EMITTER_PARAMS)
        p[E_INTENSITY:E_INTENSITY + 3] = self.radiance
        return p


@register_plugin("emitter", "directional")
class DirectionalEmitter(Emitter):
    """reference src/emitters/directional.cpp — irradiance from one
    direction, a delta light: NEE always samples it and no ray hits it."""
    type_id = EMITTER_DIRECTIONAL

    def __init__(self, props: Properties):
        super().__init__(props)
        from ..bsdfs import _get_rgb
        if props.has_property("direction"):
            d = props.get_vector("direction")
        else:
            d = props.get_transform("to_world", np.eye(4))[:3, 2]
        self.direction = d / np.linalg.norm(d)
        self.irradiance = _get_rgb(props, "irradiance", [1.0, 1.0, 1.0])

    def params_row(self):
        p = np.zeros(N_EMITTER_PARAMS)
        p[E_POS:E_POS + 3] = self.direction
        p[E_INTENSITY:E_INTENSITY + 3] = self.irradiance
        return p


@register_plugin("emitter", "spot")
class SpotEmitter(Emitter):
    """reference src/emitters/spot.cpp — a point light along its +z axis
    whose intensity falls off linearly in cos from the beam width to the
    cutoff angle (degrees; the beam defaults to 3/4 of the cutoff), a
    delta light."""
    type_id = EMITTER_SPOT

    def __init__(self, props: Properties):
        super().__init__(props)
        from ..bsdfs import _get_rgb
        m = props.get_transform("to_world", np.eye(4))
        self.position = m[:3, 3]
        self.direction = m[:3, 2] / np.linalg.norm(m[:3, 2])
        self.intensity = _get_rgb(props, "intensity", [1.0, 1.0, 1.0])
        cutoff = props.get_float("cutoff_angle", 20.0)
        beam = props.get_float("beam_width", cutoff * 0.75)
        self.cos_cutoff = float(np.cos(np.radians(cutoff)))
        self.cos_beam = float(np.cos(np.radians(beam)))

    def params_row(self):
        p = np.zeros(N_EMITTER_PARAMS)
        p[E_POS:E_POS + 3] = self.position
        p[E_INTENSITY:E_INTENSITY + 3] = self.intensity
        p[E_CUTOFF] = self.cos_cutoff
        p[E_BEAM] = self.cos_beam
        p[E_AXIS:E_AXIS + 3] = self.direction
        return p


@register_plugin("emitter", "projector")
class ProjectorEmitter(Emitter):
    """reference src/emitters/projector.cpp — a point light projecting an
    image (a bitmap texture, or a constant ``irradiance``) through a
    square perspective frustum of field of view ``fov`` along its +z axis;
    a delta light. Its row keeps the JAX package's column 9 (the first
    entry of the inverse rotation); the frustum's rotation is the
    emitter's matrix."""
    type_id = EMITTER_PROJECTOR

    def __init__(self, props: Properties):
        super().__init__(props)
        from ..bsdfs import _get_rgb
        from ..textures import Texture
        m = props.get_transform("to_world", np.eye(4))
        self.position = m[:3, 3]
        self.to_world = m
        self.scale = props.get_float("scale", 1.0)
        fov = props.get_float("fov", 45.0)
        self.tan_half = float(np.tan(np.radians(fov) * 0.5))
        self.irradiance_tex = None
        for _, v in props.objects():
            if isinstance(v, Texture):
                self.irradiance_tex = v
        if props.has_property("irradiance"):
            self.irradiance = _get_rgb(props, "irradiance", [1, 1, 1])
        elif self.irradiance_tex is not None:
            self.irradiance = np.asarray(self.irradiance_tex.mean_rgb())
        else:
            self.irradiance = np.ones(3)
        self.tex_index = -1   # assigned at scene compile

    def params_row(self):
        p = np.zeros(N_EMITTER_PARAMS)
        p[E_POS:E_POS + 3] = self.position
        p[E_INTENSITY:E_INTENSITY + 3] = self.irradiance * self.scale
        p[E_CUTOFF] = self.tan_half
        p[E_BEAM] = float(self.tex_index)
        p[9] = np.linalg.inv(self.to_world[:3, :3])[0, 0]
        return p


@register_plugin("emitter", "directionalarea")
class DirectionalAreaEmitter(AreaEmitter):
    """reference src/emitters/directionalarea.cpp — an area emitter that
    radiates only along its surface normal (delta in direction): a camera
    ray never sees it and NEE cannot sample it; ``ptracer`` transports it
    as a collimated source."""
    type_id = EMITTER_DIRECTIONALAREA


def _anim_matrix(sa, ii: int, time):
    """Per-lane keyframe lerp of instance ``ii`` at ``time``."""
    t0a, t1a = sa.inst_t0[ii], sa.inst_t1[ii]
    span = t1a - t0a
    uu = torch.clamp((time - t0a) / torch.where(span != 0.0, span, 1.0),
                     0.0, 1.0)
    return cmat_lerp(sa.inst_cmat(0, ii), sa.inst_cmat(1, ii), uu)


def _sphere_lerp(sa, param, time):
    """(animated, lerp) of the sphere emitters the lanes name: the lanes
    whose sphere is animated (E_SPH_SLOT >= 0), and ``lerp(j)``, entry j of
    their keyframe matrices lerped at ``time``; None where ``time`` is None
    or the scene has no sphere."""
    if time is None or int(sa.n_spheres) == 0:
        return None
    slot = param(E_SPH_SLOT).to(torch.int32)
    sl = torch.clamp(slot, min=0).long()
    t0s = sa.sph_t0[sl]
    span_s = sa.sph_t1[sl] - t0s
    uu = torch.clamp((time - t0s) / torch.where(span_s != 0.0, span_s, 1.0),
                     0.0, 1.0)

    def lerp(j):
        return (1.0 - uu) * sa.sph_m0c[j][sl] + uu * sa.sph_m1c[j][sl]
    return slot >= 0, lerp


def _sphere_center_radius(sa, param, time):
    """(world center, world radius) per lane of the sphere emitters the
    lanes name: the row's, or for an animated sphere the lerped keyframe
    position and the length of its first column at ``time`` (or the
    row's where ``time`` is None)."""
    c = Vec3(param(E_POS), param(E_POS + 1), param(E_POS + 2))
    r = param(E_CUTOFF)
    anim = _sphere_lerp(sa, param, time)
    if anim is None:
        return c, r
    s_anim, lerp = anim
    c = where3(s_anim, Vec3(lerp(3), lerp(7), lerp(11)), c)
    l0, l4, l8 = lerp(0), lerp(4), lerp(8)
    return c, torch.where(s_anim, torch.sqrt(l0 * l0 + l4 * l4 + l8 * l8), r)


def _sphere_matrix(sa, param, mrow, time):
    """The object-to-world matrices (12-tuple) of the lanes' sphere
    emitters: their rows' (``mrow``), the lerped keyframes where
    animated."""
    cm = tuple(mrow(j) for j in range(12))
    anim = _sphere_lerp(sa, param, time)
    if anim is None:
        return cm
    s_anim, lerp = anim
    return tuple(torch.where(s_anim, lerp(j), c) for j, c in enumerate(cm))


def sphere_uv(cm, p: Vec3):
    """The uv of world points ``p`` on spheres with object-to-world
    matrices ``cm``: their object-space spherical uv, as the sphere hits'
    payload has it."""
    return spherical_uv(cmat_apply_point(cmat_inverse(cm), p))


def textured_radiance(sa, param, inten, uv_u, uv_v, wavelengths=None):
    """The radiance of area-emitter lanes at (uv_u, uv_v): their texture's
    value where the row names one (E_RAD_TEX >= 0), else ``inten``. With
    ``wavelengths`` a bitmap gives its texel's upsampled reflectance
    spectrum there (no D65 factor, as in the JAX package)."""
    if int(sa.n_textures) == 0:
        return inten
    texid = param(E_RAD_TEX).to(torch.int32)
    return where3(texid >= 0, eval_texture(sa, torch.clamp(texid, min=0),
                                           uv_u, uv_v,
                                           wavelengths=wavelengths), inten)


def lane_intensity(param, wavelengths=None):
    """The lanes' emitter radiance / intensity: the rgb columns, or with
    ``wavelengths`` (the spectral variant) the emission spectrum
    scale * S(coeffs) * D65 / int D65 ybar at the three hero wavelengths,
    coefficients in columns 12:15 and scale in 15."""
    if wavelengths is None:
        return Vec3(param(E_INTENSITY), param(E_INTENSITY + 1),
                    param(E_INTENSITY + 2))
    from ..core.cie import d65_y_norm, eval_emission_spectrum
    c0, c1, c2, scale = param(12), param(13), param(14), param(15)
    inv_n = 1.0 / d65_y_norm()
    return Vec3(*(eval_emission_spectrum(c0, c1, c2, scale, lam, inv_n)
                  for lam in wavelengths))


def _tri_uv(sa, pre, tri, b0, b1):
    """The uv of the points ``b0``, ``b1`` (barycentrics of the second and
    third corner) on triangle slots ``tri`` of table ``pre``."""
    def col(c):
        return sa.tri(pre, c)[tri]
    b = 1.0 - b0 - b1
    return (col("uv0u") * b + col("uv1u") * b0 + col("uv2u") * b1,
            col("uv0v") * b + col("uv1v") * b0 + col("uv2v") * b1)


def sample_direction(sa, ref_p: Vec3, ref_time, s_x, s_y,
                     wavelengths=None):
    """Emitter sample_direction over the table (masked multi-type).
    Returns (DirectionSample, radiance / pdf) before visibility; the pdf
    includes the discrete emitter-selection probability. ``wavelengths``
    (the spectral variant): the radiance at the lanes' hero
    wavelengths."""
    n = ref_p.x.shape[0]
    dev = ref_p.x.device
    n_emitters = int(sa.n_emitters)
    if n_emitters == 1:
        index = torch.zeros((n,), dtype=torch.int64, device=dev)
    else:
        scaled = s_x * float(n_emitters)
        index = torch.clamp(scaled.to(torch.int32), max=n_emitters - 1)
        s_x = scaled - index.to(scaled.dtype)
        index = index.long()

    def param(j):
        return sa.emitter_params[j][index]

    def mrow(j):
        return sa.emitter_m[j][index]

    inten = lane_intensity(param, wavelengths)
    lane_type = sa.emitter_type[index]
    z = torch.zeros((n,), device=dev)
    false_ = torch.zeros((n,), dtype=torch.bool, device=dev)

    best = None
    for tid in sa.emitter_types_present:
        if tid == EMITTER_POINT:
            p = Vec3(param(E_POS), param(E_POS + 1), param(E_POS + 2))
            d = p - ref_p
            dist2 = torch.clamp(dot(d, d), min=1e-20)
            inv_dist = torch.rsqrt(dist2)
            dist = dist2 * inv_dist
            dirn = d * inv_dist
            spec = inten * (inv_dist * inv_dist)
            ds = DirectionSample(p, Vec3(z, z, z), dirn, dist,
                                 torch.ones((n,), device=dev), ~false_,
                                 index)
        elif tid == EMITTER_AREA_RECT:
            lx = 2.0 * s_x - 1.0
            ly = 2.0 * s_y - 1.0
            p = Vec3(mrow(0) * lx + mrow(1) * ly + mrow(3),
                     mrow(4) * lx + mrow(5) * ly + mrow(7),
                     mrow(8) * lx + mrow(9) * ly + mrow(11))
            col0 = Vec3(mrow(0), mrow(4), mrow(8))
            col1 = Vec3(mrow(1), mrow(5), mrow(9))
            nrm = normalize(cross(col0, col1))
            d = p - ref_p
            dist2 = torch.clamp(dot(d, d), min=1e-20)
            dist = torch.sqrt(dist2)
            dirn = d * (1.0 / dist)
            cos_theta = -dot(dirn, nrm)
            pdf = torch.where(cos_theta > 1e-6,
                              dist2 / (torch.abs(cos_theta) * param(E_AREA)),
                              0.0)
            w = torch.where(pdf > 0.0, 1.0 / torch.clamp(pdf, min=1e-20),
                            0.0)
            # uv follows the rectangle's [0, 1]^2 parameterization
            spec = textured_radiance(sa, param, inten, 0.5 * (lx + 1.0),
                                     0.5 * (ly + 1.0),
                                     wavelengths=wavelengths) * w
            ds = DirectionSample(p, nrm, dirn, dist, pdf, false_, index)
        elif tid == EMITTER_DIRECTIONAL:
            # a delta direction: the sample lies twice the scene's
            # bounding-sphere radius away
            dl = Vec3(param(E_POS), param(E_POS + 1), param(E_POS + 2))
            dirn = Vec3(-dl.x, -dl.y, -dl.z)
            dist = torch.full((n,), 2.0, device=dev) * sa.bsphere_radius
            spec = inten
            ds = DirectionSample(ref_p + dirn * dist, dl, dirn, dist,
                                 torch.ones((n,), device=dev), ~false_,
                                 index)
        elif tid == EMITTER_SPOT:
            pos = Vec3(param(E_POS), param(E_POS + 1), param(E_POS + 2))
            axis = Vec3(param(E_AXIS), param(E_AXIS + 1), param(E_AXIS + 2))
            d = pos - ref_p
            dist2 = torch.clamp(dot(d, d), min=1e-20)
            inv_dist = torch.rsqrt(dist2)
            dist = dist2 * inv_dist
            dirn = d * inv_dist
            # falloff (reference spot.cpp falloff_curve): 1 inside the
            # beam, linear in cos down to 0 at the cutoff
            cos_a = -dot(dirn, axis)
            cc = param(E_CUTOFF)
            cb = param(E_BEAM)
            fall = torch.clamp((cos_a - cc) / torch.clamp(cb - cc, min=1e-6),
                               0.0, 1.0)
            spec = inten * (inv_dist * inv_dist * fall)
            ds = DirectionSample(pos, Vec3(z, z, z), dirn, dist,
                                 torch.where(cos_a > cc, 1.0, 0.0), ~false_,
                                 index)
        elif tid == EMITTER_AREA_SPHERE:
            # uniform in the cone the sphere subtends (reference
            # src/shapes/sphere.cpp sample_direction), pdf 1 / (2 pi (1 -
            # cos_theta_max)); an animated sphere's cone is centred at its
            # lerped position at the ray's time
            c, r = _sphere_center_radius(sa, param, ref_time)
            dc = c - ref_p
            dc2 = torch.clamp(dot(dc, dc), min=1e-20)
            inv_dc = torch.rsqrt(dc2)
            dc_len = dc2 * inv_dc
            dcn = dc * inv_dc
            outside = dc_len > r * (1.0 + 1e-4)
            sin2_max = torch.clamp(r * r / dc2, 0.0, 1.0)
            cos_max = torch.sqrt(torch.clamp(1.0 - sin2_max, min=0.0))
            cos_t = (1.0 - s_y) + s_y * cos_max
            sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
            phi = 2.0 * np.pi * s_x
            bx, by = coordinate_system(dcn)
            dirn = (bx * (torch.cos(phi) * sin_t)
                    + by * (torch.sin(phi) * sin_t) + dcn * cos_t)
            # distance to the near side of the sphere along dirn
            under = r * r - dc2 * (1.0 - cos_t * cos_t)
            dist = dc_len * cos_t - torch.sqrt(torch.clamp(under, min=0.0))
            dist = torch.clamp(dist, min=1e-6)
            p = ref_p + dirn * dist
            nrm = (p - c) * (1.0 / torch.clamp(r, min=1e-9))
            pdf = torch.where(outside, 1.0 / torch.clamp(
                2.0 * np.pi * (1.0 - cos_max), min=1e-12), 0.0)
            w = torch.where(pdf > 0.0, 1.0 / torch.clamp(pdf, min=1e-20),
                            0.0)
            if int(sa.n_textures) > 0:
                # the texture at the sampled point's spherical uv, as a
                # hit there sees it
                spec = textured_radiance(sa, param, inten, *sphere_uv(
                    _sphere_matrix(sa, param, mrow, ref_time), p),
                    wavelengths=wavelengths) * w
            else:
                spec = inten * w
            ds = DirectionSample(p, nrm, dirn, dist, pdf, false_, index)
        elif tid == EMITTER_AREA_MESH:
            # triangle-CDF area sampling over the host mesh (reference
            # Mesh::sample_position). Animated emitter shapes sample their
            # object-space CDF and move the point with the lerped matrix at
            # the ray's time; the pdf uses that triangle's world area.
            p = Vec3(z, z, z)
            nrm = Vec3(z, z, z)
            pdf = z
            em_u, em_v = z, z
            su = torch.sqrt(torch.clamp(mod(s_x * 4096.0, 1.0), 0.0, 1.0))
            b0 = 1.0 - su
            b1 = s_y * su
            for (ei, start, cnt, cdf_off, anim, ii) in sa.mesh_em_meta:
                cdf = sa.em_tri_cdf[cdf_off:cdf_off + cnt]
                k = torch.clamp(torch.searchsorted(cdf, s_x, right=True),
                                0, cnt - 1)
                tri = start + k
                pre = "a" if anim else "s"

                def col(c):
                    return sa.tri(pre, c)[tri]
                v0 = Vec3(col("v0x"), col("v0y"), col("v0z"))
                e1 = Vec3(col("e1x"), col("e1y"), col("e1z"))
                e2 = Vec3(col("e2x"), col("e2y"), col("e2z"))
                pe = v0 + e1 * b0 + e2 * b1
                if anim:
                    c_t = _anim_matrix(sa, ii, ref_time)
                    pe = cmat_apply_point(c_t, pe)
                    e1 = cmat_apply_vector(c_t, e1)
                    e2 = cmat_apply_vector(c_t, e2)
                cr = cross(e1, e2)
                cr_len = torch.sqrt(torch.clamp(dot(cr, cr), min=1e-30))
                ne = cr * (1.0 / cr_len)
                if anim:
                    prob = cdf[k] - torch.where(
                        k > 0, cdf[torch.clamp(k - 1, min=0)], 0.0)
                    inv_area = prob / torch.clamp(0.5 * cr_len, min=1e-20)
                else:
                    inv_area = 1.0 / torch.clamp(param(E_AREA), min=1e-20)
                d = pe - ref_p
                dist2 = torch.clamp(dot(d, d), min=1e-20)
                dirn = d * torch.rsqrt(dist2)
                cos_theta = -dot(dirn, ne)
                pe_pdf = torch.where(
                    cos_theta > 1e-6,
                    dist2 * inv_area / torch.clamp(cos_theta, min=1e-6), 0.0)
                mask = index == ei
                p = where3(mask, pe, p)
                nrm = where3(mask, ne, nrm)
                pdf = torch.where(mask, pe_pdf, pdf)
                if int(sa.n_textures) > 0:
                    ue, ve = _tri_uv(sa, pre, tri, b0, b1)
                    em_u = torch.where(mask, ue, em_u)
                    em_v = torch.where(mask, ve, em_v)
            d = p - ref_p
            dist2 = torch.clamp(dot(d, d), min=1e-20)
            dist = torch.sqrt(dist2)
            dirn = d * (1.0 / dist)
            w = torch.where(pdf > 0.0, 1.0 / torch.clamp(pdf, min=1e-20),
                            0.0)
            spec = textured_radiance(sa, param, inten, em_u, em_v,
                                     wavelengths=wavelengths) * w
            ds = DirectionSample(p, nrm, dirn, dist, pdf, false_, index)
        elif tid == EMITTER_CONSTANT:
            dirn = warp.uniform_sphere_c(s_x, s_y)
            dist = torch.full((n,), 2.0, device=dev) * sa.bsphere_radius
            spec = inten * (4.0 * np.pi)
            ds = DirectionSample(ref_p + dirn * dist, -dirn, dirn, dist,
                                 torch.full((n,), 1.0 / (4.0 * np.pi),
                                            device=dev), false_, index)
        elif tid == EMITTER_ENVMAP:
            # its spec is already the radiance over the pdf
            ds, spec = envmap_sample_direction(sa, ref_p, s_x, s_y,
                                               wavelengths)
            ds = ds._replace(emitter=index)
        elif tid == EMITTER_PROJECTOR:
            pos = Vec3(param(E_POS), param(E_POS + 1), param(E_POS + 2))
            d = pos - ref_p
            dist2 = torch.clamp(dot(d, d), min=1e-20)
            inv_dist = torch.rsqrt(dist2)
            dist = dist2 * inv_dist
            dirn = d * inv_dist
            # the direction from the projector to the point, in its space
            lx = -(mrow(0) * dirn.x + mrow(4) * dirn.y + mrow(8) * dirn.z)
            ly = -(mrow(1) * dirn.x + mrow(5) * dirn.y + mrow(9) * dirn.z)
            lz = -(mrow(2) * dirn.x + mrow(6) * dirn.y + mrow(10) * dirn.z)
            th = param(E_CUTOFF)
            lzc = torch.clamp(lz, min=1e-6)
            u = 0.5 * (1.0 - lx / lzc / th)
            v = 0.5 * (1.0 - ly / lzc / th)
            inside = ((lz > 1e-6) & (u >= 0) & (u < 1) & (v >= 0)
                      & (v < 1))
            base = inten
            if int(sa.n_textures) > 0:
                texid = param(E_BEAM).to(torch.int32)
                base = where3(texid >= 0, eval_texture(sa, texid, u, v),
                              base)
            spec = base * (inv_dist * inv_dist
                           * torch.where(inside, 1.0, 0.0))
            ds = DirectionSample(pos, Vec3(z, z, z), dirn, dist,
                                 torch.where(inside, 1.0, 0.0), ~false_,
                                 index)
        elif tid == EMITTER_DIRECTIONALAREA:
            # a delta direction: NEE cannot sample it (directionalarea.cpp)
            spec = Vec3(z, z, z)
            ds = DirectionSample(spec, spec, spec, z, z, ~false_, index)
        else:
            raise ValueError(f"unknown emitter type {tid}")
        if best is None:
            best = (ds, spec)
        else:
            m = lane_type == tid
            pds, pspec = best
            best = (DirectionSample(*(
                where3(m, a, b) if isinstance(a, Vec3) else
                torch.where(m, a, b) for a, b in zip(ds, pds))),
                where3(m, spec, pspec))

    ds, spec = best
    # discrete selection probability (reference scene.cpp:259-263)
    if n_emitters > 1:
        ds = ds._replace(pdf=ds.pdf * (1.0 / float(n_emitters)))
        spec = spec * float(n_emitters)
    return ds, spec


def pdf_direction(sa, ds: DirectionSample, prim=None, time=None):
    """pdf of NEE sampling the direction ``ds`` (reference scene.cpp:296-303
    pdf_emitter_direction), for MIS on emitter hits. ``prim``/``time`` give
    animated mesh emitters their per-triangle world area."""
    n_emitters = int(sa.n_emitters)
    idx = torch.clamp(ds.emitter, min=0).long()
    lane_type = sa.emitter_type[idx]
    pdf = torch.zeros_like(ds.dist)
    for tid in sa.emitter_types_present:
        if tid in (EMITTER_POINT, EMITTER_SPOT, EMITTER_DIRECTIONAL,
                   EMITTER_PROJECTOR, EMITTER_DIRECTIONALAREA):
            # delta lights: a BSDF-sampled direction never reaches them
            pdf = torch.where(lane_type == tid, 0.0, pdf)
            continue
        if tid == EMITTER_ENVMAP:
            pdf = torch.where(lane_type == tid,
                              envmap_pdf_direction(sa, ds.d), pdf)
            continue
        if tid == EMITTER_CONSTANT:
            pdf = torch.where(lane_type == tid, 1.0 / (4.0 * np.pi), pdf)
            continue
        if tid == EMITTER_AREA_SPHERE:
            # the cone's pdf, seen from the reference point
            c, r = _sphere_center_radius(
                sa, lambda j: sa.emitter_params[j][idx], time)
            ref = ds.p - ds.d * ds.dist
            dcx, dcy, dcz = c.x - ref.x, c.y - ref.y, c.z - ref.z
            dc2 = torch.clamp(dcx * dcx + dcy * dcy + dcz * dcz, min=1e-20)
            sin2_max = torch.clamp(r * r / dc2, 0.0, 1.0)
            cos_max = torch.sqrt(torch.clamp(1.0 - sin2_max, min=0.0))
            outside = dc2 > (r * r) * (1.0 + 1e-4)
            p = torch.where(outside, 1.0 / torch.clamp(
                2.0 * np.pi * (1.0 - cos_max), min=1e-12), 0.0)
            pdf = torch.where(lane_type == tid, p, pdf)
            continue
        if tid not in (EMITTER_AREA_RECT, EMITTER_AREA_MESH):
            raise ValueError(f"unknown emitter type {tid}")
        area = sa.emitter_params[E_AREA][idx]
        dist2 = ds.dist * ds.dist
        cos_theta = -dot(ds.d, ds.n)
        p = torch.where(cos_theta > 1e-6,
                        dist2 / (torch.abs(cos_theta)
                                 * torch.clamp(area, min=1e-20)), 0.0)
        if prim is not None and time is not None:
            for (ei, start, cnt, cdf_off, anim, ii) in sa.mesh_em_meta:
                if not anim:
                    continue
                loc = prim.long() - sa.n_static_tris - start
                m = (ds.emitter == ei) & (loc >= 0) & (loc < cnt)
                locc = torch.clamp(loc, 0, cnt - 1)
                tri = start + locc
                e1 = Vec3(sa.a_e1x[tri], sa.a_e1y[tri], sa.a_e1z[tri])
                e2 = Vec3(sa.a_e2x[tri], sa.a_e2y[tri], sa.a_e2z[tri])
                c_t = _anim_matrix(sa, ii, time)
                cr = cross(cmat_apply_vector(c_t, e1),
                           cmat_apply_vector(c_t, e2))
                tri_area = 0.5 * torch.sqrt(torch.clamp(dot(cr, cr),
                                                        min=1e-30))
                cdf = sa.em_tri_cdf[cdf_off:cdf_off + cnt]
                prob = cdf[locc] - torch.where(
                    locc > 0, cdf[torch.clamp(locc - 1, min=0)], 0.0)
                p_anim = torch.where(
                    cos_theta > 1e-6,
                    dist2 * prob / (torch.abs(cos_theta)
                                    * torch.clamp(tri_area, min=1e-20)),
                    0.0)
                p = torch.where(m, p_anim, p)
        pdf = torch.where(lane_type == tid, p, pdf)
    pdf = torch.where(ds.emitter >= 0, pdf, 0.0)
    return pdf * (1.0 / float(n_emitters))


def eval_emitter_hit(sa, si_n: Vec3, towards: Vec3, lane_emitter,
                     uv_u=None, uv_v=None, wavelengths=None):
    """Radiance of an emitter hit by a ray (reference area.cpp eval:82-90):
    front side only. ``towards`` points from the surface to the viewer. A
    directionalarea emitter shows nothing to a ray (its emission is a
    delta in direction). With the hit's uv (``uv_u``, ``uv_v``) a textured
    area emitter on a rectangle, mesh or sphere shows its texture there
    (sphere hits carry object-space spherical uv). ``wavelengths`` (the
    spectral variant): the radiance at the lanes' hero wavelengths."""
    idx = torch.clamp(lane_emitter, min=0).long()
    ok = (lane_emitter >= 0) & (dot(si_n, towards) > 0.0)
    lane_type = sa.emitter_type[idx]
    if EMITTER_DIRECTIONALAREA in sa.emitter_types_present:
        ok = ok & (lane_type != EMITTER_DIRECTIONALAREA)

    def param(j):
        return sa.emitter_params[j][idx]
    inten = lane_intensity(param, wavelengths)
    if uv_u is not None and int(sa.n_textures) > 0:
        texid = param(E_RAD_TEX).to(torch.int32)
        use_tex = (texid >= 0) & ((lane_type == EMITTER_AREA_RECT)
                                  | (lane_type == EMITTER_AREA_MESH)
                                  | (lane_type == EMITTER_AREA_SPHERE))
        inten = where3(use_tex, eval_texture(
            sa, torch.clamp(texid, min=0), uv_u, uv_v,
            wavelengths=wavelengths), inten)
    return inten * torch.where(ok, 1.0, 0.0)


@register_plugin("emitter", "envmap")
class EnvmapEmitter(Emitter):
    """Image-based environment light (reference src/emitters/envmap.cpp).

    The reference's direction convention: in emitter space
    u = atan2(d.x, -d.z)/(2pi) (wrapped), v = acos(d.y)/pi. Importance
    sampling draws texels from the luminance * sin(theta) pmf through a
    Vose alias table (``build_alias``), built on the host with the JAX
    package's numpy code so that the tables are equal bit for bit."""
    type_id = EMITTER_ENVMAP
    is_environment = True

    def __init__(self, props: Properties):
        super().__init__(props)
        from ..bsdfs import _get_rgb
        self.scale = props.get_float("scale", 1.0)
        if props.has_property("filename"):
            from ..core.fresolver import resolve_filename
            from ..io.bitmap import read_exr_rgb
            filename = resolve_filename(props.get_string("filename"))
            if filename.lower().endswith(".exr"):
                img = read_exr_rgb(filename)
            else:
                import imageio.v3 as iio
                img = np.asarray(iio.imread(filename), np.float32)
                if img.dtype == np.uint8 or img.max() > 64:
                    img = img / 255.0
                if img.ndim == 2:
                    img = np.stack([img] * 3, axis=-1)
                img = img[..., :3]
            self.image = np.asarray(img, np.float32) * self.scale
        else:
            rad = _get_rgb(props, "radiance", [1.0, 1.0, 1.0])
            self.image = np.tile(np.asarray(rad, np.float32)[None, None, :],
                                 (2, 4, 1)) * self.scale
        self.to_world = props.get_transform("to_world", np.eye(4))
        # the texel pmf: luminance * sin(theta)
        h, w, _ = self.image.shape
        lum = (0.2126 * self.image[..., 0] + 0.7152 * self.image[..., 1]
               + 0.0722 * self.image[..., 2])
        theta = (np.arange(h) + 0.5) / h * np.pi
        weights = lum * np.sin(theta)[:, None]
        total = weights.sum()
        self.texel_pdf = (weights / max(total, 1e-20)).astype(np.float32)
        self.texel_cdf = np.cumsum(self.texel_pdf.reshape(-1)).astype(
            np.float32)
        self.texel_alias, self.texel_aprob = build_alias(
            self.texel_pdf.reshape(-1))

    @property
    def radiance(self):
        return self.image.reshape(-1, 3).mean(axis=0)

    def params_row(self):
        p = np.zeros(N_EMITTER_PARAMS)
        p[E_INTENSITY:E_INTENSITY + 3] = self.radiance
        return p


def build_alias(p: np.ndarray):
    """Vose alias table for the discrete pmf ``p`` (host-side, O(n)):
    sampling is then two gathers (probability and alias) per lane."""
    n = p.size
    scaled = p.astype(np.float64) * n
    alias = np.arange(n, dtype=np.int32)
    prob = np.ones(n, np.float32)
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    while small and large:
        s = small.pop()
        la = large.pop()
        prob[s] = scaled[s]
        alias[s] = la
        scaled[la] = scaled[la] - (1.0 - scaled[s])
        (small if scaled[la] < 1.0 else large).append(la)
    for i in small + large:
        prob[i] = 1.0
    return alias, prob


def _env_texel(sa, d: Vec3):
    """(flat texel index, v) of world directions ``d``."""
    m = sa.env_rot          # (9,) row-major inverse rotation
    ex = m[0] * d.x + m[1] * d.y + m[2] * d.z
    ey = m[3] * d.x + m[4] * d.y + m[5] * d.z
    ez = m[6] * d.x + m[7] * d.y + m[8] * d.z
    u = torch.atan2(ex, -ez) * (0.5 / np.pi)
    u = torch.where(u < 0.0, u + 1.0, u)
    v = torch.acos(torch.clamp(ey, -1.0, 1.0)) * (1.0 / np.pi)
    H, W = sa.env_shape
    xi = torch.clamp((u * W).to(torch.int32), 0, W - 1)
    yi = torch.clamp((v * H).to(torch.int32), 0, H - 1)
    return (yi * W + xi).long(), v


def _env_radiance(sa, flat, wavelengths):
    """Texels ``flat``'s radiance: rgb, or with ``wavelengths`` (the
    spectral variant) their emission spectra peak * S(coeffs) * D65 /
    int D65 ybar at the hero wavelengths (the envmap's counterpart of the
    atlas's per-texel upsampling)."""
    if wavelengths is None or not sa.spectral:
        return Vec3(sa.env_img_r[flat], sa.env_img_g[flat],
                    sa.env_img_b[flat])
    from ..core.cie import d65_y_norm, eval_emission_spectrum
    c0, c1, c2, pk = (sa.env_coeff[k][flat] for k in range(4))
    inv_n = 1.0 / d65_y_norm()
    return Vec3(*(eval_emission_spectrum(c0, c1, c2, pk, lam, inv_n)
                  for lam in wavelengths))


def envmap_eval(sa, d: Vec3, wavelengths=None) -> Vec3:
    """Environment radiance in world directions ``d`` (miss rays)."""
    flat, _ = _env_texel(sa, d)
    return _env_radiance(sa, flat, wavelengths)


def envmap_sample_direction(sa, ref_p: Vec3, s_x, s_y, wavelengths=None):
    """Draw a texel from the alias table and a direction inside it;
    returns (DirectionSample, radiance / pdf)."""
    H, W = sa.env_shape
    n = ref_p.x.shape[0]
    N = H * W
    j = torch.clamp((s_x * N).to(torch.int32), 0, N - 1).long()
    # a decorrelated uniform for the alias threshold, derived like the
    # in-texel jitters below
    t = mod(s_y * 15485863.0, 1.0)
    idx = torch.where(t < sa.env_aprob[j], j, sa.env_alias[j].long())
    yi = idx // W
    xi = idx - yi * W
    ju = mod(s_y * 7919.0, 1.0)
    jv = mod(s_y * 104729.0, 1.0)
    u = (xi.to(s_y.dtype) + ju) / W
    v = (yi.to(s_y.dtype) + jv) / H
    theta = v * np.pi
    # the inverse of the eval / pdf uv convention u = atan2(ex, -ez)/2pi
    phi = u * 2.0 * np.pi
    st = torch.sin(theta)
    ex = st * torch.sin(phi)
    ey = torch.cos(theta)
    ez = -st * torch.cos(phi)
    m = sa.env_rot_fwd
    d = Vec3(m[0] * ex + m[1] * ey + m[2] * ez,
             m[3] * ex + m[4] * ey + m[5] * ez,
             m[6] * ex + m[7] * ey + m[8] * ez)
    # solid-angle pdf: p(texel) * (W*H) / (2 pi^2 sin(theta))
    pdf = sa.env_pdf[idx] * (W * H) / torch.clamp(
        2.0 * np.pi * np.pi * st, min=1e-8)
    L = _env_radiance(sa, idx, wavelengths)
    w = torch.where(pdf > 0.0, 1.0 / torch.clamp(pdf, min=1e-20), 0.0)
    dist = torch.full((n,), 2.0, device=ref_p.x.device) * sa.bsphere_radius
    ds = DirectionSample(ref_p + d * dist, -d, d, dist, pdf,
                         torch.zeros((n,), dtype=torch.bool,
                                     device=ref_p.x.device),
                         torch.zeros((n,), dtype=torch.int32,
                                     device=ref_p.x.device))
    return ds, L * w


def environment_eval(sa, d: Vec3, wavelengths=None) -> Vec3:
    """Radiance of the scene's environment (envmap or constant) in world
    directions ``d``: what a ray that escapes sees. A constant
    environment shows its rgb radiance in every variant, as in the JAX
    package (its NEE samples read the row's emission spectrum)."""
    if sa.env_kind == "envmap":
        return envmap_eval(sa, d, wavelengths)
    r, g, b = sa.env_radiance
    return Vec3.full(d.x.shape[0], r, g, b, device=d.x.device)


def environment_pdf_direction(sa, d: Vec3):
    """Solid-angle pdf of the environment's own NEE sampling drawing
    ``d`` (before the emitter choice)."""
    if sa.env_kind == "envmap":
        return envmap_pdf_direction(sa, d)
    return torch.full_like(d.x, 1.0 / (4.0 * np.pi))


def envmap_pdf_direction(sa, d: Vec3):
    """Solid-angle pdf of ``envmap_sample_direction`` drawing ``d``."""
    flat, v = _env_texel(sa, d)
    H, W = sa.env_shape
    st = torch.sin(v * np.pi)
    return sa.env_pdf[flat] * (W * H) / torch.clamp(
        2.0 * np.pi * np.pi * st, min=1e-8)



__all__ = [
    "Emitter", "PointEmitter", "AreaEmitter", "ConstantEmitter",
    "DirectionalEmitter", "SpotEmitter", "EnvmapEmitter", "ProjectorEmitter",
    "DirectionalAreaEmitter",
    "sample_direction", "pdf_direction", "eval_emitter_hit", "envmap_eval",
    "environment_eval", "environment_pdf_direction",
    "envmap_sample_direction", "envmap_pdf_direction", "build_alias",
    "N_EMITTER_PARAMS", "EMITTER_POINT", "EMITTER_AREA_RECT",
    "EMITTER_CONSTANT", "EMITTER_AREA_MESH", "EMITTER_DIRECTIONAL",
    "EMITTER_SPOT", "EMITTER_ENVMAP", "EMITTER_AREA_SPHERE",
    "EMITTER_PROJECTOR", "EMITTER_DIRECTIONALAREA", "E_POS",
    "E_INTENSITY", "E_AREA", "E_CUTOFF", "E_BEAM", "E_RAD_TEX", "E_SPH_SLOT",
    "sphere_uv", "textured_radiance", "lane_intensity",
]
