"""Adjoint particle tracer (port of the JAX package's
``integrators/ptracer.py``, in every variant; reference
src/integrators/ptracer.cpp).

Light paths start on the emitters and every vertex connects to the sensor.
A connection lands in an arbitrary pixel, so the film takes the records
through ``films.block_splat_scatter`` (the camera-path integrators need no
scatter).

Emitters: point, spot, directional, projector, area lights on rectangles,
analytic spheres and meshes, directionalarea, and the constant and envmap
environments (these emit from the scene's bounding sphere, reference
constant.cpp / envmap.cpp sample_ray). Sensors: perspective (the
reference's importance W = (1/A) / cos^3(theta) / dist^2, perspective.cpp
:384), thinlens (one lens sample a light path) and orthographic / distant
(importance 1 / film area); other sensors are refused.

In the polarized variants a light path carries its Stokes vector (the
emitters are unpolarized, so the Mueller throughput's first column) and
takes the photon-order Mueller factors of ``integrators/polarized.py`` at
every interaction and connection; the film records S0, which no basis
rotation changes.
"""

from __future__ import annotations

import math

import torch

from ..core import mueller as mu
from ..core import warp
from ..core.cie import hero_to_srgb, hero_wavelengths
from ..core.properties import Properties, register_plugin
from ..core.vec import (Vec3, cmat_apply_point, cmat_apply_vector, cmat_lerp,
                        coordinate_system, cross, dot, normalize, vmax,
                        where3)
from ..render.scene import ray_intersect, ray_test
from ..render.types import Ray, SHADOW_EPSILON
from ..bsdfs import eval_pdf_sample as bsdf_eval_pdf_sample
from ..emitters import (EMITTER_POINT, EMITTER_AREA_RECT, EMITTER_CONSTANT,
                        EMITTER_AREA_MESH, EMITTER_DIRECTIONAL, EMITTER_SPOT,
                        EMITTER_ENVMAP, EMITTER_AREA_SPHERE,
                        EMITTER_PROJECTOR, EMITTER_DIRECTIONALAREA, E_POS,
                        E_AREA, E_CUTOFF, E_BEAM, E_AXIS, _tri_uv,
                        envmap_eval, lane_intensity, sphere_uv,
                        textured_radiance)
from ..films import block_splat_scatter
from ..textures import eval_texture
from . import SamplingIntegrator, DEFAULT_MAX_LANES, textured_reflectance

# emitters with a finite emitting surface have a direct emitter -> sensor
# term (the reference's sample_visible_emitters, ptracer.cpp:80-81); delta
# emitters reach the sensor only through a bounce (Endpoint::eval == 0)
_SURFACE_EMITTERS = (EMITTER_AREA_RECT, EMITTER_AREA_SPHERE,
                     EMITTER_AREA_MESH, EMITTER_CONSTANT, EMITTER_ENVMAP)


def _rect_point_normal(erow, lx, ly):
    """A point of the emitter's rectangle at local (lx, ly) in [-1, 1]^2
    and the rectangle's normal, from its 3x4 matrix rows."""
    o = Vec3(erow(0) * lx + erow(1) * ly + erow(3),
             erow(4) * lx + erow(5) * ly + erow(7),
             erow(8) * lx + erow(9) * ly + erow(11))
    nrm = normalize(Vec3(erow(4) * erow(9) - erow(8) * erow(5),
                         erow(8) * erow(1) - erow(0) * erow(9),
                         erow(0) * erow(5) - erow(4) * erow(1)))
    return o, nrm


def _frame_dir(nv: Vec3, lv: Vec3) -> Vec3:
    t1, t2 = coordinate_system(nv)
    return t1 * lv.x + t2 * lv.y + nv * lv.z


@register_plugin("integrator", "ptracer")
class PTracerIntegrator(SamplingIntegrator):
    """Particle tracer; samples per pixel means light paths per pixel
    (reference ptracer.cpp sample-count semantics). As in the JAX package,
    a render leaves the sensor's sampler at sample_count 1. In the
    spectral variant each light path carries three hero wavelengths (one
    more draw after the emitter's), and every splat is converted to
    linear sRGB."""
    spectral_mode = "hero"

    def __init__(self, props: Properties):
        super().__init__(props)
        md = props.get_int("max_depth", -1)
        self.max_depth = 2 ** 31 if md == -1 else md
        self.rr_depth = props.get_int("rr_depth", 5)

    @property
    def loop_iterations(self):
        return min(self.max_depth, 32)

    def render(self, scene, sensor=None, seed: int = 0, spp: int = 0,
               develop_film: bool = True, max_lanes: int = DEFAULT_MAX_LANES,
               device=None):
        """Render ``spp`` light paths per pixel in passes of at most
        ``max_lanes`` paths, all passes of one size; returns the (H, W, 3)
        image, or the (4, H, W) block when ``develop_film`` is False. No
        checkpoints: the camera-path integrators' ``checkpoint_path`` is
        not an argument here."""
        if sensor is None:
            sensor = scene.sensor
        film = sensor.film
        sampler = sensor.sampler
        if spp:
            sampler.set_sample_count(spp)
        spp = sampler.sample_count
        W, H = film.crop_size

        n_total = W * H * spp
        n_pass = min(n_total, max_lanes)
        n_passes = -(-n_total // n_pass)
        n_pass = -(-n_total // n_passes)

        sampler.set_samples_per_wavefront(1)
        sampler.sample_count = 1
        sa = scene.compile(device)
        state = sampler.seed(seed, n_pass, device=sa.device)

        sp = sensor.device_params()
        if sp.kind not in (0, 1, 2):
            raise RuntimeError(
                "ptracer: only perspective, thinlens and orthographic/"
                f"distant sensors are supported (got sensor kind "
                f"{sp.kind!r}); use a camera-path integrator for meters/"
                "batch sensors")
        light_pass = self._light_pass(sa, sensor, sp, sampler, W, H, n_pass)
        block = torch.zeros((4, H, W), device=sa.device)
        for _p in range(n_passes):
            block, state = light_pass(block, state)
            state = sampler.advance(state)

        # light-path splats average W*H / paths per pixel
        scale = float(W * H) / float(n_pass * n_passes)
        if develop_film:
            return (block[:3] * scale).permute(1, 2, 0)
        return block

    def _light_pass(self, sa, sensor, sp, sampler, W, H, n):
        """One pass of ``n`` light paths: ``light_pass(block, state) ->
        (block, state)``."""
        kind = sp.kind
        dev = sa.device
        # thinlens: one lens sample a light path; a vertex maps to the
        # film through the sampled lens point (thinlens.cpp
        # sample_direction), the importance unchanged
        lens = sensor.device_lens_params() if kind == 1 else None
        tan_x, tan_y = sp.tan_half_x, sp.tan_half_y
        pp_ox, pp_oy = sp.pp_ox, sp.pp_oy
        A_rect = 4.0 * tan_x * tan_y
        cam = sp.m
        if kind == 2:
            # orthographic / distant: the matrix columns carry the film's
            # extent; connections run along the view axis with importance
            # 1 / film area (orthographic.cpp sample_direction)
            s0sq = cam[0] ** 2 + cam[4] ** 2 + cam[8] ** 2
            s1sq = cam[1] ** 2 + cam[5] ** 2 + cam[9] ** 2
            view_len = math.sqrt(cam[2] ** 2 + cam[6] ** 2 + cam[10] ** 2)
            view = (cam[2] / view_len, cam[6] / view_len,
                    cam[10] / view_len)
            A_ortho = 4.0 * math.sqrt(s0sq * s1sq)
        integrator = self

        def light_pass(block, state):
            active = torch.ones((n,), dtype=torch.bool, device=dev)
            zero = torch.zeros((n,), device=dev)
            z3 = Vec3(zero, zero, zero)
            no = zero > 1.0

            # ---- an emitter ray (reference sample_emitter_ray) ---------
            s_sel, state = sampler.next_1d(state, active)
            pos2, state = sampler.next_2d(state, active)
            dir2, state = sampler.next_2d(state, active)
            s_tri, state = sampler.next_1d(state, active)
            if lens is not None:
                ap_r, focus_d = lens
                ap2, state = sampler.next_2d(state, active)
                lpx, lpy = warp.disk_concentric_c(ap2[0], ap2[1])
                lpx = lpx * ap_r
                lpy = lpy * ap_r
            else:
                lpx = lpy = zero
            wavelengths = None
            if sa.spectral:
                wls, state = sampler.next_1d(state, active)
                wavelengths = hero_wavelengths(wls)
            ne = max(sa.n_emitters, 1)
            idx = torch.clamp((s_sel * ne).to(torch.int32), max=ne - 1).long()

            def epar(j):
                return sa.emitter_params[j][idx]

            def erow(j):
                return sa.emitter_m[j][idx]

            etype = sa.emitter_type[idx]
            rad = lane_intensity(epar, wavelengths)
            loc = warp.cosine_hemisphere_c(dir2[0], dir2[1])
            # the world aperture point (the camera origin for a pinhole)
            lens_w = Vec3(cam[0] * lpx + cam[1] * lpy + cam[3],
                          cam[4] * lpx + cam[5] * lpy + cam[7],
                          cam[8] * lpx + cam[9] * lpy + cam[11])
            R_b = sa.bsphere_radius
            C_b = sa.bsphere_center
            area_b = 4.0 * math.pi * R_b * R_b

            # per type: (o, d, emit_n, w = L / p(o) / p(d) * cos,
            #            direct = L_cam / p(o), surface?)
            best = None
            for tid in sa.emitter_types_present:
                if tid == EMITTER_POINT:
                    d_c = warp.uniform_sphere_c(dir2[0], dir2[1])
                    o_c = Vec3(epar(E_POS), epar(E_POS + 1), epar(E_POS + 2))
                    cand = (o_c, d_c, d_c, rad * (4.0 * math.pi), z3, no)
                elif tid == EMITTER_SPOT:
                    # uniform in the cone within the cutoff; the intensity
                    # follows the falloff (spot.cpp sample_ray)
                    o_c = Vec3(epar(E_POS), epar(E_POS + 1), epar(E_POS + 2))
                    axis = Vec3(epar(E_AXIS), epar(E_AXIS + 1),
                                epar(E_AXIS + 2))
                    cc = epar(E_CUTOFF)
                    cb = epar(E_BEAM)
                    cos_t = (1.0 - dir2[1]) + dir2[1] * cc
                    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t,
                                                   min=0.0))
                    phi = 2.0 * math.pi * dir2[0]
                    t1a, t2a = coordinate_system(axis)
                    d_c = (t1a * (torch.cos(phi) * sin_t)
                           + t2a * (torch.sin(phi) * sin_t) + axis * cos_t)
                    fall = torch.clamp((cos_t - cc) / torch.clamp(
                        cb - cc, min=1e-6), 0.0, 1.0)
                    w_c = rad * (fall * 2.0 * math.pi * (1.0 - cc))
                    cand = (o_c, d_c, d_c, w_c, z3, no)
                elif tid == EMITTER_DIRECTIONAL:
                    # a disk covering the scene's bounding sphere on its
                    # far side (directional.cpp sample_ray)
                    dl = Vec3(epar(E_POS), epar(E_POS + 1), epar(E_POS + 2))
                    t1a, t2a = coordinate_system(dl)
                    px, py = warp.disk_concentric_c(pos2[0], pos2[1])
                    o_c = Vec3(C_b[0] - dl.x * R_b, C_b[1] - dl.y * R_b,
                               C_b[2] - dl.z * R_b)
                    o_c = o_c + (t1a * px + t2a * py) * R_b
                    w_c = rad * (math.pi * R_b * R_b)
                    cand = (o_c, dl, dl, w_c, z3, no)
                elif tid == EMITTER_AREA_RECT:
                    # uniform position (pdf 1/A), cosine direction; a
                    # texture at the point's uv in the rectangle's [0, 1]^2
                    lx = 2.0 * pos2[0] - 1.0
                    ly = 2.0 * pos2[1] - 1.0
                    o_c, nrm = _rect_point_normal(erow, lx, ly)
                    A = epar(E_AREA)
                    rad_loc = textured_radiance(sa, epar, rad,
                                                0.5 * (lx + 1.0),
                                                0.5 * (ly + 1.0), wavelengths)
                    cand = (o_c, _frame_dir(nrm, loc), nrm,
                            rad_loc * (A * math.pi), rad_loc * A, ~no)
                elif tid == EMITTER_AREA_SPHERE:
                    c_c = Vec3(epar(E_POS), epar(E_POS + 1), epar(E_POS + 2))
                    r_s = epar(E_CUTOFF)
                    nsp = warp.uniform_sphere_c(pos2[0], pos2[1])
                    o_c = c_c + nsp * r_s
                    A = 4.0 * math.pi * r_s * r_s
                    rad_loc = rad
                    if int(sa.n_textures) > 0:
                        # the point's object-space spherical uv, as the
                        # camera path's hits and NEE take it
                        rad_loc = textured_radiance(
                            sa, epar, rad, *sphere_uv(
                                tuple(erow(j) for j in range(12)), o_c),
                            wavelengths)
                    cand = (o_c, _frame_dir(nsp, loc), nsp,
                            rad_loc * (A * math.pi), rad_loc * A, ~no)
                elif tid == EMITTER_AREA_MESH:
                    # triangle-CDF area sampling (Mesh::sample_position);
                    # an animated emitter mesh at its t = 0 keyframe
                    # (light paths carry time 0)
                    o_m, n_m, invp = z3, z3, zero
                    uv_mu, uv_mv = zero, zero
                    su = torch.sqrt(torch.clamp(pos2[0], 0.0, 1.0))
                    b0 = 1.0 - su
                    b1 = pos2[1] * su
                    for (ei, start, cnt, cdf_off, anim, ii) in \
                            sa.mesh_em_meta:
                        cdf = sa.em_tri_cdf[cdf_off:cdf_off + cnt]
                        k = torch.clamp(torch.searchsorted(cdf, s_tri,
                                                           right=True),
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
                            c_t = cmat_lerp(sa.inst_cmat(0, ii),
                                            sa.inst_cmat(1, ii),
                                            torch.zeros((), device=dev))
                            pe = cmat_apply_point(c_t, pe)
                            e1 = cmat_apply_vector(c_t, e1)
                            e2 = cmat_apply_vector(c_t, e2)
                        cr = cross(e1, e2)
                        cr_len = torch.sqrt(torch.clamp(dot(cr, cr),
                                                        min=1e-30))
                        ne_v = cr * (1.0 / cr_len)
                        if anim:
                            prob = cdf[k] - torch.where(
                                k > 0, cdf[torch.clamp(k - 1, min=0)], 0.0)
                            ip = 0.5 * cr_len / torch.clamp(prob, min=1e-20)
                        else:
                            ip = epar(E_AREA)
                        mask = idx == ei
                        o_m = where3(mask, pe, o_m)
                        n_m = where3(mask, ne_v, n_m)
                        invp = torch.where(mask, ip, invp)
                        if int(sa.n_textures) > 0:
                            ue, ve = _tri_uv(sa, pre, tri, b0, b1)
                            uv_mu = torch.where(mask, ue, uv_mu)
                            uv_mv = torch.where(mask, ve, uv_mv)
                    rad_loc = textured_radiance(sa, epar, rad, uv_mu, uv_mv,
                                                wavelengths)
                    cand = (o_m, _frame_dir(n_m, loc), n_m,
                            rad_loc * (invp * math.pi), rad_loc * invp, ~no)
                elif tid == EMITTER_PROJECTOR:
                    # a delta position; the direction uniform over the
                    # image plane at z = 1 (pdf_A = 1 / (4 th^2)), so
                    # w = I(u, v) A_p / r^3 (projector.cpp sample_ray)
                    o_c = Vec3(epar(E_POS), epar(E_POS + 1), epar(E_POS + 2))
                    th = epar(E_CUTOFF)
                    lx = (1.0 - 2.0 * dir2[0]) * th
                    ly = (1.0 - 2.0 * dir2[1]) * th
                    inv_r = torch.rsqrt(1.0 + lx * lx + ly * ly)
                    d_c = Vec3(
                        (erow(0) * lx + erow(1) * ly + erow(2)) * inv_r,
                        (erow(4) * lx + erow(5) * ly + erow(6)) * inv_r,
                        (erow(8) * lx + erow(9) * ly + erow(10)) * inv_r)
                    base = rad
                    if int(sa.n_textures) > 0:
                        texid = epar(E_BEAM).to(torch.int32)
                        base = where3(texid >= 0, eval_texture(
                            sa, texid, dir2[0], dir2[1],
                            wavelengths=wavelengths), base)
                    A_p = 4.0 * th * th
                    w_c = base * (A_p * inv_r * inv_r * inv_r)
                    cand = (o_c, d_c, d_c, w_c, z3, no)
                elif tid == EMITTER_DIRECTIONALAREA:
                    # a collimated rectangle: uniform position, exactly
                    # the normal's direction, w = L A (directionalarea.cpp
                    # sample_ray)
                    o_c, nrm = _rect_point_normal(erow, 2.0 * pos2[0] - 1.0,
                                                  2.0 * pos2[1] - 1.0)
                    cand = (o_c, nrm, nrm, rad * epar(E_AREA), z3, no)
                elif tid in (EMITTER_CONSTANT, EMITTER_ENVMAP):
                    # emitted inward from the scene's bounding sphere
                    # (constant.cpp:59-76 sample_ray): position pdf
                    # 1 / (4 pi R^2), a cosine direction about the inward
                    # normal
                    outn = warp.uniform_sphere_c(pos2[0], pos2[1])
                    o_c = Vec3(C_b[0] + outn.x * R_b, C_b[1] + outn.y * R_b,
                               C_b[2] + outn.z * R_b)
                    n_in = Vec3(-outn.x, -outn.y, -outn.z)
                    d_c = _frame_dir(n_in, loc)
                    if tid == EMITTER_ENVMAP:
                        # the radiance along d is the texel seen looking
                        # back along it; toward the camera, the texel the
                        # camera sees through this point
                        L_ray = envmap_eval(sa, Vec3(-d_c.x, -d_c.y, -d_c.z),
                                            wavelengths)
                        if kind == 2:
                            v_cam = Vec3(torch.full((n,), view[0],
                                                    device=dev),
                                         torch.full((n,), view[1],
                                                    device=dev),
                                         torch.full((n,), view[2],
                                                    device=dev))
                        else:
                            v_cam = normalize(o_c - lens_w)
                        L_cam = envmap_eval(sa, v_cam, wavelengths)
                    else:
                        L_ray = L_cam = rad
                    cand = (o_c, d_c, n_in, L_ray * (area_b * math.pi),
                            L_cam * area_b, ~no)
                else:
                    raise NotImplementedError(
                        f"ptracer: emitter type {tid} not supported")
                if best is None:
                    best = cand
                else:
                    m = etype == tid
                    best = tuple(where3(m, a, b) if isinstance(a, Vec3)
                                 else torch.where(m, a, b)
                                 for a, b in zip(cand, best))

            o, d, emit_n, w_emit, direct_base, has_direct = best
            throughput = w_emit * float(ne)
            time = zero
            # leave the emitting surface
            o = o + emit_n * 1e-4
            ray = Ray(o, d, time, torch.full((n,), float("inf"), device=dev))

            def to_camera_const():
                return Vec3(torch.full((n,), -view[0], device=dev),
                            torch.full((n,), -view[1], device=dev),
                            torch.full((n,), -view[2], device=dev))

            def connect(block, p, n_s, contrib, active_c):
                """Connect the vertices ``p`` (normals ``n_s``) to the
                aperture point and add ``contrib`` times the sensor's
                importance into the pixels they land in."""
                rx = p.x - cam[3]
                ry = p.y - cam[7]
                rz = p.z - cam[11]
                cx = cam[0] * rx + cam[4] * ry + cam[8] * rz
                cy = cam[1] * rx + cam[5] * ry + cam[9] * rz
                cz = cam[2] * rx + cam[6] * ry + cam[10] * rz
                ok = active_c & (cz > 1e-4)
                czs = torch.clamp(cz, min=1e-8)
                if kind == 2:
                    # parallel projection: the lateral position is the film
                    # coordinate; importance 1 / A, no cos or distance
                    sx = 0.5 * (1.0 - cx / s0sq)
                    sy = 0.5 * (1.0 - cy / s1sq)
                    ok = ok & (sx >= 0) & (sx < 1) & (sy >= 0) & (sy < 1)
                    dist = torch.clamp(cz / view_len, min=1e-6)
                    wgt = torch.full((n,), 1.0 / A_ortho, device=dev)
                    to_cam = to_camera_const()
                else:
                    if lens is not None:
                        # through the lens: the vertex -> lens ray meets
                        # the focus plane, then the central projection
                        # (thinlens.cpp sample_ray) inverted
                        dcx = lpx / focus_d + (cx - lpx) / czs
                        dcy = lpy / focus_d + (cy - lpy) / czs
                    else:
                        dcx = cx / czs
                        dcy = cy / czs
                    sx = 0.5 * (1.0 - dcx / tan_x) - pp_ox
                    sy = 0.5 * (1.0 - dcy / tan_y) - pp_oy
                    ok = ok & (sx >= 0) & (sx < 1) & (sy >= 0) & (sy < 1)
                    ex = cx - lpx
                    ey = cy - lpy
                    dist2 = ex * ex + ey * ey + cz * cz
                    dist = torch.sqrt(torch.clamp(dist2, min=1e-20))
                    ct = cz / dist
                    importance = (1.0 / A_rect) / torch.clamp(ct * ct * ct,
                                                              min=1e-8)
                    wgt = importance / torch.clamp(dist2, min=1e-20)
                    to_cam = (lens_w - p) * (1.0 / dist)
                # visibility
                sh_o = p + n_s * torch.where(dot(n_s, to_cam) >= 0, 1e-4,
                                             -1e-4)
                shadow = Ray(sh_o, to_cam, time,
                             dist * (1.0 - SHADOW_EPSILON))
                ok = ok & ~ray_test(sa, shadow, ok)
                val = contrib * wgt
                if wavelengths is not None:
                    # the film holds linear sRGB; the conversion is linear,
                    # so converting each splat equals converting at develop
                    val = hero_to_srgb(val, wavelengths)
                px = torch.clamp((sx * W).to(torch.int32), 0, W - 1)
                py = torch.clamp((sy * H).to(torch.int32), 0, H - 1)
                return block_splat_scatter(block, px, py,
                                           [val.x, val.y, val.z], ok, W, H)

            # the direct emitter -> sensor term of surface emitters
            # (sample_visible_emitters, ptracer.cpp:80-81): L toward the
            # camera * cos(theta_emitter) / p(position)
            if (any(t in sa.emitter_types_present for t in _SURFACE_EMITTERS)
                    and not integrator.hide_emitters
                    and integrator.max_depth != 0):
                dd = (to_camera_const() if kind == 2
                      else normalize(lens_w - o))
                cos_e = dot(emit_n, dd)
                contrib = (direct_base * torch.clamp(cos_e, min=0.0)
                           * float(ne))
                block = connect(block, o, emit_n, contrib,
                                active & has_direct & (cos_e > 0))

            polarized = bool(sa.polarized)
            if polarized:
                from . import polarized as pol
                present = pol.polarizing_present(sa)
                S = (throughput, z3, z3, z3)

            # ---- the bounces ----------------------------------------------
            for depth_i in range(integrator.loop_iterations):
                if not bool(active.any()):
                    break
                si = ray_intersect(sa, ray, active)
                act = active & si.valid
                lane_bsdf = sa.inst_bsdf[
                    torch.clamp(si.inst, min=0).long()].long()
                to_cam = (to_camera_const() if kind == 2
                          else normalize(lens_w - si.p))
                wo_cam = si.to_local(to_cam)
                s1, state = sampler.next_1d(state, act)
                s2, state = sampler.next_2d(state, act)
                tex_refl, tex_mask = textured_reflectance(sa, lane_bsdf, si,
                                                          wavelengths)
                bs = bsdf_eval_pdf_sample(sa, lane_bsdf, si.wi, wo_cam, s1,
                                          s2[0], s2[1], tex_refl, tex_mask,
                                          wavelengths)
                # the vertex -> camera splat (bs.val_nee = f cos(wo_cam))
                if polarized:
                    # row 0 of the connection's Mueller matrix on the
                    # path's Stokes vector
                    lane_type = sa.bsdf_type[lane_bsdf]
                    M_c = pol.light_bounce_mueller(
                        sa, si, bs, lane_bsdf, lane_type, bs.val_nee,
                        present, out_local=wo_cam, wavelengths=wavelengths)
                    conn_val = (M_c[0] * S[0] + M_c[1] * S[1]
                                + M_c[2] * S[2] + M_c[3] * S[3])
                else:
                    conn_val = throughput * bs.val_nee
                block = connect(block, si.p, si.n, conn_val, act)

                # continue the light path
                wo_world = si.to_world(bs.wo)
                new_ray = si.spawn_ray(wo_world)
                throughput = where3(act, throughput * bs.weight, throughput)
                if polarized:
                    M_b = pol.light_bounce_mueller(
                        sa, si, bs, lane_bsdf, lane_type,
                        where3(act, bs.weight, Vec3.ones(n, device=dev)),
                        present, wavelengths=wavelengths)
                    S_new = mu.mm_apply_stokes(M_b, S)
                    S = tuple(where3(act, a, b) for a, b in zip(S_new, S))
                # Russian roulette after rr_depth bounces (ptracer.cpp)
                tm = vmax(throughput)
                rr, state = sampler.next_1d(state, act)
                rr_p = (torch.clamp(tm, max=0.95)
                        if depth_i >= integrator.rr_depth
                        else torch.ones_like(tm))
                cont = rr < rr_p
                rr_scale = torch.where(act, 1.0 / torch.clamp(rr_p, min=1e-8),
                                       1.0)
                throughput = throughput * rr_scale
                if polarized:
                    S = tuple(c * rr_scale for c in S)
                active = act & cont & (tm > 0.0)
                ray = Ray(where3(active, new_ray.o, ray.o),
                          where3(active, wo_world, ray.d), ray.time,
                          new_ray.maxt)
            return block, state

        return light_pass


__all__ = ["PTracerIntegrator"]
