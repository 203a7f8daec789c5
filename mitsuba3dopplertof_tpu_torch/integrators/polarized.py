"""Polarized light transport and the ``stokes`` integrator (port of the
JAX package's ``integrators/polarized.py``; reference
src/integrators/path.cpp:222,235 ``to_world_mueller``, stokes.cpp:88-131).

The bounce loop below makes the scalar loop's sampler draws, draw for
draw, and also carries a 4x4 Mueller throughput in SoA form (16 Vec3
columns). The Mueller factor of each bounce:

  * diffuse and the remaining rough fallbacks (plastic, roughplastic,
    pplastic, roughdielectric, principled, measured): the ideal
    depolarizer of the scalar weight (exact for diffuse, mueller.h:37);
  * roughconductor: the exact Fresnel Mueller matrix at the sampled
    micro-normal (roughconductor.cpp's polarized branch);
  * null: the identity times the weight;
  * conductor, dielectric, thindielectric: the exact Fresnel Mueller
    matrices with the in / out Stokes-basis rotations (conductor.cpp:
    273-297, dielectric.cpp's polarized branch);
  * polarizer, retarder, circular: the rotated ideal elements with the
    tilted-axis correction (polarizer.cpp; Korger et al. 2013);
  * measured_polarized: its tables' Mueller matrix.

Each factor is scaled so that its (0, 0) element equals the scalar
bounce weight (``renormalize``). Emitters are unpolarized, (I, 0, 0, 0):
picking up emission reads only the first column of the throughput.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bsdfs import (BSDF_CIRCULAR, BSDF_CONDUCTOR, BSDF_DIELECTRIC,
                     BSDF_MEASURED_POL, BSDF_NULL, BSDF_POLARIZER,
                     BSDF_RETARDER, BSDF_ROUGHCONDUCTOR, BSDF_THINDIELECTRIC,
                     FLAG_SMOOTH, P_ETA, P_K, P_MEASURED_IDX, P_POL_DELTA,
                     P_POL_THETA, eval_pdf_sample as bsdf_eval_pdf_sample)
from ..core import mueller as mu
from ..core.logger import profile_phase
from ..core.math import interp
from ..core.properties import Properties, register_plugin
from ..core.vec import Vec3, cross, dot, normalize, vmax, where3
from .. import emitters as em_mod
from ..render.scene import ray_intersect, ray_test
from ..render.types import DirectionSample, Ray
from . import Integrator, SamplingIntegrator, textured_reflectance

POLARIZING_TYPES = (BSDF_CONDUCTOR, BSDF_ROUGHCONDUCTOR, BSDF_DIELECTRIC,
                    BSDF_THINDIELECTRIC, BSDF_POLARIZER, BSDF_RETARDER,
                    BSDF_CIRCULAR, BSDF_MEASURED_POL)


def polarizing_present(sa):
    """The polarizing BSDF types of the scene, in its type order."""
    return [t for t in sa.bsdf_types_present if t in POLARIZING_TYPES]


def _mis_weight(pdf_a, pdf_b):
    """The power heuristic with the JAX package's polarized-loop guard."""
    a2 = pdf_a * pdf_a
    w = a2 / torch.clamp(a2 + pdf_b * pdf_b, min=1e-30)
    return torch.where(pdf_a > 0.0, w, 0.0)


def _safe_axis(v: Vec3, fallback: Vec3) -> Vec3:
    l2 = dot(v, v)
    ok = l2 > 1e-12
    inv = torch.rsqrt(torch.where(ok, l2, 1.0))
    return where3(ok, v * inv, fallback)


def _param(sa, j, lane_bsdf):
    return sa.bsdf_params[j][lane_bsdf.long()]


def _to_world_mueller(si, M, in_fwd_l: Vec3, out_fwd_l: Vec3):
    """interaction.h:387-409: a local-frame Mueller matrix in the world
    frame's implicit Stokes bases."""
    in_fw_w = si.to_world(in_fwd_l)
    out_fw_w = si.to_world(out_fwd_l)
    in_b_cur = si.to_world(mu.stokes_basis(in_fwd_l))
    in_b_tgt = mu.stokes_basis(in_fw_w)
    out_b_cur = si.to_world(mu.stokes_basis(out_fwd_l))
    out_b_tgt = mu.stokes_basis(out_fw_w)
    return mu.rotate_mueller_basis(M, in_fw_w, in_b_cur, in_b_tgt,
                                   out_fw_w, out_b_cur, out_b_tgt)


def renormalize(M, scalar_weight: Vec3):
    """M scaled so that its (0, 0) element equals the scalar bounce
    weight. Basis rotations keep M[0][0], so for conductors this is
    conductor.cpp:296's ``M * absorber(reflectance)``, and for dielectrics
    it folds in the scalar path's pdf division and eta^2 factor."""
    m00 = M[0]
    ok3 = [torch.abs(c) > 1e-12 for c in m00]
    scale = Vec3(*(w / torch.where(ok, c, 1.0)
                   for w, c, ok in zip(scalar_weight, m00, ok3)))
    zero = torch.zeros_like(scale.x)
    scale = where3(ok3[0], scale, Vec3(zero, zero, zero))
    return mu.mm_scale(M, scale)


def _specular_bounce_mueller(si, bs, eta_re: Vec3, eta_im: Vec3,
                             rough: bool = False):
    """The Fresnel Mueller matrix of the sampled specular event in the
    LOCAL frame with the plane-of-incidence basis rotations
    (conductor.cpp:273-295, dielectric.cpp's polarized branch; rough: the
    sampled micro-normal's plane, roughconductor.cpp). Light arrives along
    -bs.wo and leaves along si.wi."""
    wo_hat = bs.wo
    wi_hat = si.wi
    z = torch.zeros_like(wo_hat.z)
    if rough:
        # the micro-normal: the half vector; Fresnel at cos(wo_hat, m)
        n = normalize(wo_hat + wi_hat)
        cos_o = wo_hat.x * n.x + wo_hat.y * n.y + wo_hat.z * n.z
        selected_t = torch.zeros_like(cos_o, dtype=torch.bool)
    else:
        n = Vec3(z, z, torch.ones_like(z))
        cos_o = wo_hat.z
        selected_t = (wo_hat.z * wi_hat.z) < 0.0    # the refraction branch

    # reflection at eta (complex for conductors); transmission with a real
    # eta (dielectrics, the same in all channels)
    R = mu.specular_reflection_mueller(cos_o, tuple(eta_re), tuple(eta_im))
    T = mu.specular_transmission_mueller(cos_o, eta_re.x)
    M = mu.mm_where(selected_t, T, R)

    fb_in = mu.stokes_basis(-wo_hat)
    fb_out = mu.stokes_basis(wi_hat)
    s_axis_in = _safe_axis(cross(n, -wo_hat), fb_in)
    s_axis_out = _safe_axis(cross(n, wi_hat), fb_out)
    return mu.rotate_mueller_basis(M, -wo_hat, s_axis_in, fb_in,
                                   wi_hat, s_axis_out, fb_out)


def _measured_pol_mueller(sa, lane_bsdf, si, wo_local: Vec3):
    """The Mueller matrix of measured-pBRDF lanes at (si.wi, wo_local) in
    the local implicit Stokes bases, over the scene's tables."""
    from ..bsdfs.measured_polarized_impl import pbsdf_eval_mueller
    m_idx = _param(sa, P_MEASURED_IDX, lane_bsdf).to(torch.int32)
    M = None
    for k, (tbl, wls) in enumerate(zip(sa.measured_pol,
                                       sa.measured_pol_wls)):
        Mk = pbsdf_eval_mueller(tbl, si.wi, wo_local, wavelengths=wls)
        M = Mk if M is None else mu.mm_where(m_idx == k, Mk, M)
    if M is None:
        M = mu.mm_identity(torch.zeros_like(wo_local.z))
    return M


def _element_bounce_mueller(si, theta, delta, kind: int):
    """The rotated ideal polarizer, retarder or circular polarizer in the
    LOCAL frame (polarizer.cpp's polarized branch; the tilted element's
    effective axes of Korger et al. 2013). A transmission element:
    forward = si.wi."""
    forward = si.wi
    st, ct = torch.sin(theta), torch.cos(theta)
    a_axis = Vec3(st, ct, torch.zeros_like(theta))
    eff_a = _safe_axis(a_axis - forward * dot(a_axis, forward),
                       mu.stokes_basis(forward))
    eff_t = cross(forward, eff_a)
    if kind == BSDF_POLARIZER:
        M = mu.linear_polarizer(1.0, like=theta)
    elif kind == BSDF_RETARDER:
        M = mu.linear_retarder(delta)
    else:
        M = mu.right_circular_polarizer(theta)
    return mu.rotate_mueller_basis_collinear(M, forward, eff_t,
                                             mu.stokes_basis(forward))


def rayleigh_scatter_mueller(d_in: Vec3, d_out: Vec3):
    """The Rayleigh scattering Mueller matrix (reference rayleigh.cpp's
    polarized phase; Chandrasekhar), built in the scattering-plane frame,
    rotated to the world's implicit Stokes bases and scaled so that
    M[0][0] == 1 (the direction's weight: exact inverse-CDF sampling
    cancels the scalar phase). 90-degree scattering of unpolarized light
    is fully polarized perpendicular to the scattering plane."""
    c = dot(d_in, d_out)
    npl = cross(d_in, d_out)
    fb_in = mu.stokes_basis(d_in)
    fb_out = mu.stokes_basis(d_out)
    e_in = _safe_axis(npl, fb_in)
    e_out = _safe_axis(npl, fb_out)
    a = 1.0 + c * c
    inv_a = 1.0 / torch.clamp(a, min=1e-12)
    b = (1.0 - c * c) * inv_a
    d2 = 2.0 * c * inv_a
    z = torch.zeros_like(c)
    one = torch.ones_like(c)
    M = mu.mm_from_rows([one, b, z, z,
                         b, one, z, z,
                         z, z, d2, z,
                         z, z, z, d2])
    return mu.rotate_mueller_basis(M, d_in, e_in, fb_in,
                                   d_out, e_out, fb_out)


def conductor_eta_k(sa, lane_bsdf, wavelengths=None):
    """The lanes' conductor (eta, k) triplets: the rgb columns, or for
    named-material conductors in the spectral variant their eta(lambda) /
    k(lambda) tables at the hero wavelengths (the Mueller side of the
    BSDF dispatch's spectra)."""
    e_re = Vec3(*(_param(sa, P_ETA + c, lane_bsdf) for c in range(3)))
    e_im = Vec3(*(_param(sa, P_K + c, lane_bsdf) for c in range(3)))
    if wavelengths is not None and sa.ior_spectra:
        lane_ior = torch.tensor(sa.bsdf_ior_host, dtype=torch.int32,
                                device=lane_bsdf.device)[lane_bsdf.long()]

        def tabulated(tab_idx, base):
            outs = []
            for lam, out in zip(wavelengths, base):
                for e_i, (wls_t, eta_t, k_t) in enumerate(sa.ior_spectra):
                    f32 = dict(dtype=torch.float32, device=lam.device)
                    v = interp(lam, torch.tensor(wls_t, **f32),
                               torch.tensor((eta_t, k_t)[tab_idx], **f32))
                    out = torch.where(lane_ior == e_i, v, out)
                outs.append(out)
            return Vec3(*outs)
        e_re = tabulated(0, e_re)
        e_im = tabulated(1, e_im)
    return e_re, e_im


def first_column(T_mm, v: Vec3):
    """The Stokes vector T_mm (v, 0, 0, 0) of unpolarized light ``v``."""
    return tuple(T_mm[4 * i] * v for i in range(4))


def camera_nee_stokes_add(sa, si, bs, wo_nee, lane_bsdf, lane_type, T_mm,
                          v_nee, wavelengths=None):
    """The Stokes contribution of an NEE connection in camera order: the
    exact Mueller matrix on roughconductor and measured_polarized lanes
    (their polarized eval takes any direction pair), the depolarizer
    elsewhere (diffuse connections depolarize exactly; delta lobes have
    v_nee = 0). Shared by the path loop and volpath's."""
    S_add = first_column(T_mm, v_nee)
    for tid in (BSDF_ROUGHCONDUCTOR, BSDF_MEASURED_POL):
        if tid not in sa.bsdf_types_present:
            continue
        if tid == BSDF_ROUGHCONDUCTOR:
            e_re, e_im = conductor_eta_k(sa, lane_bsdf, wavelengths)
            M_nee = _specular_bounce_mueller(si, bs._replace(wo=wo_nee),
                                             e_re, e_im, rough=True)
        else:
            M_nee = _measured_pol_mueller(sa, lane_bsdf, si, wo_nee)
        M_nee = _to_world_mueller(si, M_nee, -wo_nee, si.wi)
        M_nee = renormalize(M_nee, v_nee)
        TM = mu.mm_mul(T_mm, M_nee)
        hit = lane_type == tid
        S_add = tuple(where3(hit, TM[4 * i], S_add[i]) for i in range(4))
    return S_add


def _dielectric_or_conductor(sa, lane_bsdf, tid, wavelengths):
    if tid in (BSDF_CONDUCTOR, BSDF_ROUGHCONDUCTOR):
        return conductor_eta_k(sa, lane_bsdf, wavelengths)
    er = _param(sa, P_ETA, lane_bsdf)
    z = torch.zeros_like(er)
    return Vec3(er, er, er), Vec3(z, z, z)


def _base_mueller(lane_type, wgt: Vec3):
    M = mu.depolarizer(wgt)
    z = torch.zeros_like(wgt.x)
    return mu.mm_where(lane_type == BSDF_NULL,
                       mu.mm_scale(mu.mm_identity(z), wgt), M)


def camera_bounce_mueller(sa, si, bs, lane_bsdf, lane_type, wgt,
                          present, wavelengths=None):
    """The Mueller factor of a sampled bounce in CAMERA order (light
    arrives along -bs.wo and leaves along si.wi) in the world's implicit
    bases, its M[0][0] the scalar weight ``wgt``. Shared by the path loop
    and volpath's."""
    M = _base_mueller(lane_type, wgt)
    for tid in present:
        if tid == BSDF_MEASURED_POL:
            M_t = _measured_pol_mueller(sa, lane_bsdf, si, bs.wo)
            M_t = _to_world_mueller(si, M_t, -bs.wo, si.wi)
        elif tid in (BSDF_POLARIZER, BSDF_RETARDER, BSDF_CIRCULAR):
            M_t = _element_bounce_mueller(
                si, _param(sa, P_POL_THETA, lane_bsdf),
                _param(sa, P_POL_DELTA, lane_bsdf), int(tid))
            M_t = _to_world_mueller(si, M_t, si.wi, si.wi)
        else:
            e_re, e_im = _dielectric_or_conductor(sa, lane_bsdf, tid,
                                                  wavelengths)
            M_t = _specular_bounce_mueller(
                si, bs, e_re, e_im, rough=(tid == BSDF_ROUGHCONDUCTOR))
            M_t = _to_world_mueller(si, M_t, -bs.wo, si.wi)
        M = mu.mm_where(lane_type == tid, renormalize(M_t, wgt), M)
    return M


def light_bounce_mueller(sa, si, bs, lane_bsdf, lane_type, wgt, present,
                         out_local=None, wavelengths=None):
    """The Mueller factor of an interaction in PHOTON order (light arrives
    along -si.wi and leaves along ``out_local``, by default the sampled
    bs.wo) in the world's implicit bases, its M[0][0] the scalar weight
    ``wgt``: the camera-order matrices with the roles swapped (the
    polarized light tracer's). measured_polarized reads its tables at the
    swapped pair (its non-reciprocal adjoint correction is not modelled,
    as in the JAX package)."""
    wo = bs.wo if out_local is None else out_local
    M = _base_mueller(lane_type, wgt)
    neg_wi = -si.wi
    for tid in present:
        if tid == BSDF_MEASURED_POL:
            M_t = _measured_pol_mueller(sa, lane_bsdf, si._replace(wi=wo),
                                        si.wi)
            M_t = _to_world_mueller(si, M_t, neg_wi, wo)
        elif tid in (BSDF_POLARIZER, BSDF_RETARDER, BSDF_CIRCULAR):
            M_t = _element_bounce_mueller(
                si._replace(wi=neg_wi), _param(sa, P_POL_THETA, lane_bsdf),
                _param(sa, P_POL_DELTA, lane_bsdf), int(tid))
            M_t = _to_world_mueller(si, M_t, neg_wi, neg_wi)
        else:
            e_re, e_im = _dielectric_or_conductor(sa, lane_bsdf, tid,
                                                  wavelengths)
            M_t = _specular_bounce_mueller(
                si._replace(wi=wo), bs._replace(wo=si.wi), e_re, e_im,
                rough=(tid == BSDF_ROUGHCONDUCTOR))
            M_t = _to_world_mueller(si, M_t, neg_wi, wo)
        M = mu.mm_where(lane_type == tid, renormalize(M_t, wgt), M)
    return M


def path_loop_polarized(integrator, sa, sampler, state, ray: Ray, active,
                        modulation_weight=None, use_correlate=False,
                        wavelengths=None):
    """The Mueller-throughput twin of the scalar path loop (the same
    sampler draws). As in the JAX package it applies no normal map and
    always takes NEE (``use_nee`` is the scalar loop's).

    Returns (stokes: a 4-tuple of Vec3 in the basis stokes_basis(-ray.d),
    valid, state)."""
    n = ray.o.x.shape[0]
    dev = ray.o.x.device
    zero = torch.zeros((n,), device=dev)
    zero3 = Vec3(zero, zero, zero)

    throughput = Vec3.ones(n, device=dev)
    T_mm = mu.mm_identity(zero)                 # the Mueller throughput
    S_res = (zero3, zero3, zero3, zero3)        # the accumulated Stokes
    path_length = torch.zeros((n,), device=dev)
    eta = torch.ones((n,), device=dev)
    depth = torch.zeros((n,), dtype=torch.int64, device=dev)
    has_env = sa.has_environment and not integrator.hide_emitters
    valid_ray = torch.full((n,), bool(has_env), dtype=torch.bool,
                           device=dev)
    prev_p = ray.o
    prev_bsdf_pdf = torch.ones((n,), device=dev)
    prev_bsdf_delta = torch.ones((n,), dtype=torch.bool, device=dev)

    bsdf_flags = torch.tensor(sa.bsdf_flags_host, dtype=torch.int32,
                              device=dev)
    pcd = integrator.path_correlation_depth
    depth_cap = min(integrator.max_depth, 2 ** 31 - 1)
    any_emission = sa.n_emitters > 0 or has_env
    present = polarizing_present(sa)

    def weight_fn(t, pl):
        if modulation_weight is None:
            return 1.0
        return modulation_weight(t, pl)

    def draw_1d(state, active, correlate):
        if use_correlate:
            return sampler.next_1d_correlate(state, active, correlate)
        return sampler.next_1d(state, active)

    def draw_2d(state, active, correlate):
        if use_correlate:
            return sampler.next_2d_correlate(state, active, correlate)
        return sampler.next_2d(state, active)

    # the scalar loop's early stop: an all-dead bounce changes no state
    for _ in range(integrator.loop_iterations):
        if not bool(active.any()):
            break
        correlate = (depth + 1) < pcd

        with profile_phase("RayIntersect"):
            si = ray_intersect(sa, ray, active)
        path_length = path_length + torch.where(si.valid, si.t * eta, 0.0)
        inst = torch.clamp(si.inst, min=0).long()
        lane_emitter = torch.where(si.valid, sa.inst_emitter[inst], -1)
        if any_emission:
            if sa.n_emitters > 0:
                em_val = em_mod.eval_emitter_hit(sa, si.sh_n, -ray.d,
                                                 lane_emitter, si.uv_u,
                                                 si.uv_v, wavelengths)
            else:
                em_val = zero3
            if has_env:
                miss_env = (~si.valid) & active
                em_val = where3(miss_env, em_mod.environment_eval(
                    sa, ray.d, wavelengths), em_val)
                emit_mask = active & ((lane_emitter >= 0) | miss_env)
            else:
                emit_mask = active & (lane_emitter >= 0)
            d_seg = si.p - prev_p
            dist = torch.sqrt(torch.clamp(dot(d_seg, d_seg), min=1e-20))
            ds_hit = DirectionSample(
                p=si.p, n=si.sh_n, d=d_seg * (1.0 / dist), dist=dist,
                pdf=zero, delta=torch.zeros_like(active),
                emitter=lane_emitter)
            em_pdf = zero
            if sa.n_emitters > 0:
                em_pdf = torch.where(prev_bsdf_delta, 0.0,
                                     em_mod.pdf_direction(
                                         sa, ds_hit, prim=si.prim,
                                         time=ray.time))
            if has_env:
                env_pdf = em_mod.environment_pdf_direction(
                    sa, ray.d) * (1.0 / max(sa.n_emitters, 1))
                em_pdf = torch.where(miss_env & ~prev_bsdf_delta, env_pdf,
                                     em_pdf)
            mis_bsdf = _mis_weight(prev_bsdf_pdf, em_pdf)
            lw = weight_fn(ray.time, path_length)
            scale = torch.where(emit_mask, mis_bsdf * lw, 0.0)
            # emitters are unpolarized: the first column of T_mm
            S_add = first_column(T_mm, em_val * scale)
            S_res = tuple(S_res[i] + S_add[i] for i in range(4))

        active_next = (depth + 1 < depth_cap) & si.valid & active
        lane_bsdf = sa.inst_bsdf[inst].long()
        lane_type = sa.bsdf_type[lane_bsdf]
        smooth = (bsdf_flags[lane_bsdf] & FLAG_SMOOTH) != 0

        active_em = active_next & smooth
        nee, state = draw_2d(state, active, correlate)
        if sa.n_emitters > 0:
            ds, em_weight = em_mod.sample_direction(sa, si.p, ray.time,
                                                    nee[0], nee[1],
                                                    wavelengths)
            active_em = active_em & (ds.pdf != 0.0)
            with profile_phase("RayTest"):
                occluded = ray_test(sa, si.spawn_ray_to(ds.p), active_em)
            nee_ok = active_em & ~occluded
            wo_nee = si.to_local(ds.d)
        else:
            wo_nee = zero3

        s1, state = draw_1d(state, active, correlate)
        s2, state = draw_2d(state, active, correlate)
        tex_refl, tex_mask = textured_reflectance(sa, lane_bsdf, si,
                                                  wavelengths)
        bs = bsdf_eval_pdf_sample(sa, lane_bsdf, si.wi, wo_nee, s1, s2[0],
                                  s2[1], tex_refl, tex_mask, wavelengths)

        # NEE: diffuse connections depolarize (exactly); roughconductor
        # and measured_polarized connections take their Mueller matrices;
        # delta lobes have val_nee = 0
        if sa.n_emitters > 0:
            mis_em = torch.where(ds.delta, 1.0,
                                 _mis_weight(ds.pdf, bs.pdf_nee))
            lw = weight_fn(ray.time, path_length + ds.dist)
            scale = torch.where(nee_ok, mis_em * lw, 0.0)
            v_nee = bs.val_nee * em_weight * scale
            S_add = camera_nee_stokes_add(sa, si, bs, wo_nee, lane_bsdf,
                                          lane_type, T_mm, v_nee,
                                          wavelengths)
            S_res = tuple(S_res[i] + S_add[i] for i in range(4))

        # the bounce's Mueller factor
        wgt = where3(active_next, bs.weight, Vec3.ones(n, device=dev))
        M_bounce = camera_bounce_mueller(sa, si, bs, lane_bsdf, lane_type,
                                         wgt, present, wavelengths)
        T_mm = mu.mm_where(active_next, mu.mm_mul(T_mm, M_bounce), T_mm)

        wo_world = si.to_world(bs.wo)
        new_ray = si.spawn_ray(wo_world)
        throughput = where3(active_next, throughput * bs.weight, throughput)
        eta = eta * torch.where(active_next, bs.eta, 1.0)
        valid_ray = valid_ray | (active & si.valid & ~bs.sampled_null)
        prev_p = where3(si.valid, si.p, prev_p)
        prev_bsdf_pdf = torch.where(active_next, bs.pdf, prev_bsdf_pdf)
        prev_bsdf_delta = torch.where(active_next, bs.sampled_delta,
                                      prev_bsdf_delta)
        depth = depth + (si.valid & active).to(torch.int64)

        throughput_max = vmax(throughput)
        rr_prob = torch.clamp(throughput_max * eta * eta, max=0.95)
        rr_active = depth >= integrator.rr_depth
        rr_draw, state = draw_1d(state, active, correlate)
        rr_continue = rr_draw < rr_prob
        rr_scale = torch.where(rr_active,
                               1.0 / torch.clamp(rr_prob, min=1e-8), 1.0)
        throughput = throughput * rr_scale
        T_mm = mu.mm_scale(T_mm, rr_scale)

        active = (active_next & (~rr_active | rr_continue)
                  & (throughput_max != 0.0))
        ray = Ray(where3(active_next, new_ray.o, ray.o),
                  where3(active_next, wo_world, ray.d),
                  ray.time, new_ray.maxt)

    S_out = tuple(where3(valid_ray, s, zero3) for s in S_res)
    return S_out, valid_ray, state


@register_plugin("integrator", "stokes")
class StokesIntegrator(SamplingIntegrator):
    """The Stokes-vector integrator (reference src/integrators/stokes.cpp):
    it wraps a path-style integrator (path, dopplertofpath, volpath,
    volpathmis); S0 is the image and the whole Stokes vector (S0..S3 x
    RGB) its 12 AOV channels, after one rotation that aligns the Stokes
    frame with the sensor's horizontal axis (stokes.cpp:99-109). Only the
    polarized variants render it. The render orchestration is
    SamplingIntegrator's; the sampling knobs are the nested
    integrator's."""
    spectral_mode = "hero"

    def __init__(self, props: Properties):
        Integrator.__init__(self, props)
        nested = [o for _, o in props.objects()
                  if hasattr(o, "sample_stokes")]
        if len(nested) != 1:
            others = [type(o).__name__ for _, o in props.objects()
                      if isinstance(o, Integrator)]
            if others:
                raise RuntimeError(
                    f"stokes: nested integrator {others[0]} does not "
                    "support Stokes output (path, dopplertofpath, volpath "
                    "and volpathmis do)")
            raise RuntimeError("stokes: specify exactly one nested "
                               "path-style integrator")
        self.nested = nested[0]
        for k in ("is_doppler", "time_sampling_method", "antithetic_shift",
                  "use_stratified_sampling_for_each_interval",
                  "path_correlation_depth", "samples_per_pass"):
            setattr(self, k, getattr(self.nested, k))
        self._sensor_up = (0.0, 1.0, 0.0)

    def aov_names(self):
        return [f"S{i}.{c}" for i in range(4) for c in "RGB"]

    def set_sensor(self, sensor):
        m = np.asarray(getattr(sensor, "to_world", np.eye(4)), np.float64)
        up = m[:3, :3] @ np.array([0.0, 1.0, 0.0])
        self._sensor_up = tuple(float(x) for x in up)

    def sample(self, sa, sampler, state, ray, active, wavelengths=None):
        if not sa.polarized:
            raise RuntimeError("stokes: only available in the polarized "
                               "variants (mi.set_variant("
                               "'cuda_rgb_polarized' or "
                               "'cuda_spectral_polarized'))")
        S, valid, state = self.nested.sample_stokes(
            sa, sampler, state, ray, active, wavelengths=wavelengths)
        # into the sensor's basis (stokes.cpp:99-109)
        n = ray.d.x.shape[0]
        up = Vec3.full(n, *self._sensor_up, device=ray.d.x.device)
        fwd = -ray.d
        cur = mu.stokes_basis(fwd)
        R = mu.rotate_stokes_basis(fwd, cur, _safe_axis(cross(ray.d, up),
                                                        cur))
        S = mu.mm_apply_stokes(R, S)
        S_aov = S
        if wavelengths is not None:
            # spectral: the AOVs are sRGB (linear in the samples); the
            # returned S0 stays raw: the sample body converts it
            from ..core.cie import hero_to_srgb
            S_aov = tuple(hero_to_srgb(s, wavelengths) for s in S)
        aovs = [c for s in S_aov for c in s]
        return S[0], valid, state, aovs


__all__ = ["StokesIntegrator", "path_loop_polarized",
           "camera_bounce_mueller", "camera_nee_stokes_add",
           "light_bounce_mueller", "rayleigh_scatter_mueller",
           "conductor_eta_k", "polarizing_present", "POLARIZING_TYPES"]
