"""Volumetric path tracer (port of the JAX package's
``integrators/volpath.py``, in every variant; reference
src/integrators/volpath.cpp).

Homogeneous media sample their free flights by the channel-mean
extinction with an exact rgb transmittance reweighting; heterogeneous
(grid) media by delta tracking against the majorant, their shadow
segments by ratio tracking (``_delta_track``, ``_ratio_track``). NEE runs
from medium and surface vertices; a shadow connection walks through up to
``_MAX_NULL`` null boundaries with a closest-hit query per segment,
switching media at each crossing (``_shadow_transmittance``). Media
change at transmissive boundaries by the closed-shape convention.

The tracking loops draw only on their live lanes and stop once none is
live, as the JAX package's ``bounce_loop`` does, so the draws stay the JAX
package's lane for lane. The phase of a medium event is the row's
``M_PHASE`` kernel: HG, SGGX (its S constant or looked up in the S grid
at the event, ``_sggx_S6``), Rayleigh or tabulated, for the sampled
direction and for NEE alike. In the spectral variant sigma_t is its
peak times its sigmoid spectrum at the hero wavelengths, and the albedo
its sigmoid spectrum.

The polarized variants' Stokes branch (``stokes=True``) carries a Mueller
throughput beside the scalar one: surface bounces and their NEE take the
path loop's Mueller factors (``integrators/polarized.py``), transmittance
scales all four Stokes components, Rayleigh events apply the exact
scattering matrix (sampled bounces and NEE alike), and the other phases
act as ideal depolarizers.
"""

from __future__ import annotations

import torch

from ..bsdfs import (FLAG_NULL, FLAG_SMOOTH,
                     eval_pdf_sample as bsdf_eval_pdf_sample)
from ..core import mueller as mu
from ..core.cie import eval_reflectance_spectrum
from ..core.logger import profile_phase
from ..core.properties import register_plugin
from ..core.vec import Vec3, dot, vmax, where3
from .. import emitters as em_mod
from ..media import (M_ALBEDO, M_FILTER, M_G, M_GRID_OFF, M_MAXD, M_NX,
                     M_NY, M_NZ, M_PHASE, M_SAMPLE_EM, M_SGGX, M_SGGX_NX,
                     M_SGGX_NY, M_SGGX_NZ, M_SGGX_OFF, M_SIGMA_T, M_ST_PEAK,
                     hg_eval, hg_sample, rayleigh_eval, rayleigh_sample,
                     sggx_eval, sggx_sample, tab_eval, tab_phase_tables,
                     tab_sample)
from ..render.scene import ray_intersect, ray_test
from ..render.types import SHADOW_EPSILON, DirectionSample, Ray
from ..volumes import grid_cell, trilinear
from . import MonteCarloIntegrator, mis_weight

_DT_STEPS = 64     # delta-tracking collision budget per bounce (minimum)
_RT_STEPS = 32     # ratio-tracking steps for shadow transmittance (minimum)
_MAX_NULL = 3      # null boundary crossings a shadow ray may tunnel through


def _step_budgets(sa):
    """Tracking budgets from the scene's largest optical depth (the
    expected majorant collisions along a scene-crossing ray), as the JAX
    package sets them."""
    tau = sa.max_optical_depth_hint or 0.0
    dt = int(min(max(_DT_STEPS, 3.0 * tau + 16), 1024))
    rt = int(min(max(_RT_STEPS, 3.0 * tau + 8), 1024))
    return dt, rt


def _grid_density(sa, medium, p: Vec3):
    """sigma_t at world points ``p`` of media ``medium``: the grid (world
    -> [0,1]^3 by the medium's inverse to_world, zero outside the unit
    cube), trilinear or nearest (reference gridvolume.cpp eval), times the
    gray base M_SIGMA_T (the medium's scale)."""
    idx = torch.clamp(medium, min=0).long()

    def w2g(j):
        return sa.med_w2g[j][idx]

    def mp(j):
        return sa.med_params[j][idx]

    lx = w2g(0) * p.x + w2g(1) * p.y + w2g(2) * p.z + w2g(3)
    ly = w2g(4) * p.x + w2g(5) * p.y + w2g(6) * p.z + w2g(7)
    lz = w2g(8) * p.x + w2g(9) * p.y + w2g(10) * p.z + w2g(11)
    inside = ((lx >= 0.0) & (lx <= 1.0) & (ly >= 0.0) & (ly <= 1.0)
              & (lz >= 0.0) & (lz <= 1.0))
    nx = mp(M_NX).to(torch.int32)
    ny = mp(M_NY).to(torch.int32)
    nz = mp(M_NZ).to(torch.int32)
    off = mp(M_GRID_OFF).to(torch.int32)
    nxf = torch.clamp(nx.to(torch.float32), min=1.0)
    nyf = torch.clamp(ny.to(torch.float32), min=1.0)
    nzf = torch.clamp(nz.to(torch.float32), min=1.0)
    last = sa.med_grid.shape[0] - 1

    def at(x, y, z):
        lin = off + (z * ny + y) * nx + x
        return sa.med_grid[torch.clamp(lin, 0, last).long()]

    dens = trilinear(at, grid_cell(lx, nx), grid_cell(ly, ny),
                     grid_cell(lz, nz))
    # nearest lookup (gridvolume.cpp filter_type="nearest")
    nearest = mp(M_FILTER) > 0.5
    xn = torch.minimum(torch.clamp((lx * nxf).to(torch.int32), min=0), nx - 1)
    yn = torch.minimum(torch.clamp((ly * nyf).to(torch.int32), min=0), ny - 1)
    zn = torch.minimum(torch.clamp((lz * nzf).to(torch.int32), min=0), nz - 1)
    dens = torch.where(nearest, at(xn, yn, zn), dens)
    return torch.where(inside, dens * mp(M_SIGMA_T), 0.0)


def _sggx_S6(sa, medium, p: Vec3, S6_const):
    """The SGGX S of media ``medium`` at world points ``p``: a trilinear
    lookup of the 6-channel S grid (reference sggx.cpp eval_ndf_params ->
    gridvolume eval_6), or the row's constant S where the medium has no
    grid (M_SGGX_NX == 0). Eight row gathers of the (V, 6) atlas a lane,
    the blend weights shared by the six channels."""
    idx = torch.clamp(medium, min=0).long()

    def w2g(j):
        return sa.sggx_w2g[j][idx]

    def mp(j):
        return sa.med_params[j][idx]

    lx = w2g(0) * p.x + w2g(1) * p.y + w2g(2) * p.z + w2g(3)
    ly = w2g(4) * p.x + w2g(5) * p.y + w2g(6) * p.z + w2g(7)
    lz = w2g(8) * p.x + w2g(9) * p.y + w2g(10) * p.z + w2g(11)
    nx = mp(M_SGGX_NX).to(torch.int32)
    ny = mp(M_SGGX_NY).to(torch.int32)
    off = mp(M_SGGX_OFF).to(torch.int32)
    last = sa.sggx_grid.shape[0] - 1

    def at(x, y, z):
        lin = torch.clamp(off + (z * ny + y) * nx + x, 0, last).long()
        return sa.sggx_grid[lin]                           # (N, 6)

    def cell(lc, n):
        i0, i1, t = grid_cell(lc, n)
        return i0, i1, t[:, None]
    S = trilinear(at, cell(lx, nx), cell(ly, ny),
                  cell(lz, mp(M_SGGX_NZ).to(torch.int32)))
    return tuple(torch.where(nx > 0, S[:, i], S6_const[i])
                 for i in range(6))


def _phase_sample_eval(sa, medium, p_evt, d, d_nee, s2x, s2y):
    """The phase of each lane's medium, by its row's kernel: (wo, pdf) of
    a direction sampled at ``p_evt`` for a ray travelling along ``d``, and
    the phase value toward the NEE direction ``d_nee``."""
    def med(j):
        return sa.med_params[j][torch.clamp(medium, min=0).long()]
    g = med(M_G)
    wi = -d
    wo, pdf = hg_sample(wi, g, s2x, s2y)
    cos_nee = dot(d, d_nee)
    phase_nee = hg_eval(cos_nee, g)
    kernel = med(M_PHASE)
    if sa.any_sggx:
        S6 = tuple(med(M_SGGX + i) for i in range(6))
        if sa.any_sggx_grid:
            # S varying in space, at the scattering event
            S6 = _sggx_S6(sa, medium, p_evt, S6)
        is_sggx = torch.abs(kernel - 1.0) < 0.5
        wo_s, pdf_s = sggx_sample(wi, s2x, s2y, S6)
        wo = where3(is_sggx, wo_s, wo)
        pdf = torch.where(is_sggx, pdf_s, pdf)
        phase_nee = torch.where(is_sggx, sggx_eval(wi, d_nee, S6),
                                phase_nee)
    if sa.any_rayleigh:
        is_ray = torch.abs(kernel - 2.0) < 0.5
        wo_r, pdf_r = rayleigh_sample(wi, s2x, s2y)
        wo = where3(is_ray, wo_r, wo)
        pdf = torch.where(is_ray, pdf_r, pdf)
        phase_nee = torch.where(is_ray, rayleigh_eval(cos_nee), phase_nee)
    for mi_, tv in enumerate(sa.tab_phase_tables or ()):
        if tv is None:
            continue
        # one table a medium, built once a scene on its device
        key = ("tab_phase", mi_)
        if key not in sa._cache:
            *tables, inv_n = tab_phase_tables(tv)
            sa._cache[key] = tuple(torch.tensor(t, device=sa.device)
                                   for t in tables) + (float(inv_n),)
        grid, vals, cdf, inv_n = sa._cache[key]
        is_tab = (medium == mi_) & (torch.abs(kernel - 3.0) < 0.5)
        wo_t, pdf_t = tab_sample(wi, s2x, s2y, grid, vals, cdf, inv_n)
        wo = where3(is_tab, wo_t, wo)
        pdf = torch.where(is_tab, pdf_t, pdf)
        phase_nee = torch.where(is_tab, tab_eval(cos_nee, grid, vals, inv_n),
                                phase_nee)
    return wo, pdf, phase_nee


def _delta_track(sa, sampler, state, ray, medium, t_surf, sigma_bar, alive):
    """Free-flight sampling against the majorant ``sigma_bar`` (Woodcock /
    delta tracking; reference medium.cpp sample_interaction's decision
    chain). Returns (t_event, scattered, state); lanes that exhaust the
    step budget without a real collision escape."""
    n = t_surf.shape[0]
    sb = torch.clamp(sigma_bar, min=1e-8)
    t = torch.zeros((n,), device=t_surf.device)
    done = ~alive
    scat = torch.zeros_like(alive)
    live = alive
    for _ in range(_step_budgets(sa)[0]):
        if not bool(live.any()):
            break
        u1, state = sampler.next_1d(state, live)
        t_new = t - torch.log(torch.clamp(1.0 - u1, min=1e-20)) / sb
        esc = t_new >= t_surf
        p = Vec3(ray.o.x + ray.d.x * t_new, ray.o.y + ray.d.y * t_new,
                 ray.o.z + ray.d.z * t_new)
        dens = _grid_density(sa, medium, p)
        u2, state = sampler.next_1d(state, live)
        real = u2 < (dens / sb)
        done_now = live & (esc | real)
        scat = torch.where(live & ~esc & real, True, scat)
        t = torch.where(live, torch.where(esc, t_surf, t_new), t)
        done = done | done_now
        live = live & ~done
    return torch.where(scat, t, t_surf), scat & alive, state


def _ratio_track(sa, sampler, state, origin, dirn, dist, medium, sigma_bar,
                 alive):
    """Shadow transmittance by ratio tracking: the product of
    (1 - density / majorant) over majorant-exponential steps."""
    sb = torch.clamp(sigma_bar, min=1e-8)
    t = torch.zeros_like(dist)
    tr = torch.ones_like(dist)
    live = alive
    for _ in range(_step_budgets(sa)[1]):
        if not bool(live.any()):
            break
        u, state = sampler.next_1d(state, live)
        t_new = t - torch.log(torch.clamp(1.0 - u, min=1e-20)) / sb
        inside = t_new < dist
        p = Vec3(origin.x + dirn.x * t_new, origin.y + dirn.y * t_new,
                 origin.z + dirn.z * t_new)
        dens = _grid_density(sa, medium, p)
        tr = torch.where(live & inside,
                         tr * torch.clamp(1.0 - dens / sb, min=0.0), tr)
        t = torch.where(live, t_new, t)
        live = live & inside
    return tr, state


def _sigma_t(sa, idx, wavelengths):
    """The media ``idx``'s sigma_t: its rgb columns, or with
    ``wavelengths`` (the spectral variant) peak * S(coeffs) at the hero
    wavelengths."""
    st = [sa.med_params[M_SIGMA_T + c][idx] for c in range(3)]
    if wavelengths is None:
        return st
    pk = sa.med_params[M_ST_PEAK][idx]
    return [pk * eval_reflectance_spectrum(*st, lam) for lam in wavelengths]


def _segment_tr(sa, sampler, state, o, dn, dist, medium, act,
                wavelengths=None):
    """Transmittance of one shadow segment in ``medium``: the exponential
    per channel, ratio-tracked on heterogeneous lanes."""
    idx = torch.clamp(medium, min=0).long()
    in_med = medium >= 0
    st = _sigma_t(sa, idx, wavelengths)
    tr = where3(in_med, Vec3(*(torch.exp(-s * dist) for s in st)),
                Vec3.ones(dist.shape[0], device=dist.device))
    if sa.any_hetero:
        maxd = sa.med_params[M_MAXD][idx]
        het = in_med & (maxd > 0.0)
        tr_h, state = _ratio_track(sa, sampler, state, o, dn, dist, medium,
                                   maxd, act & het)
        tr = where3(het, Vec3(tr_h, tr_h, tr_h), tr)
    return tr, state


def _shadow_transmittance(sa, sampler, state, sh_o, sh_dn, time, sh_dist,
                          medium, active_em, null_ids, wavelengths=None):
    """A shadow connection through up to ``_MAX_NULL`` null boundaries:
    one closest-hit query per segment, the segment's transmittance in its
    medium, and the medium switched at each null crossing (reference
    volpath.cpp's transmittance along NEE rays). Any other hit occludes;
    lanes still inside geometry after the crossing budget count as
    occluded. Returns (occluded, transmittance, state)."""
    n = sh_dist.shape[0]
    tr = Vec3.ones(n, device=sh_dist.device)
    occluded = torch.zeros_like(active_em)
    alive = active_em
    seg_o = sh_o
    seg_med = medium
    remaining = sh_dist
    for _ in range(_MAX_NULL + 1):
        r = Ray(seg_o, sh_dn, time, remaining * (1.0 - SHADOW_EPSILON))
        si = ray_intersect(sa, r, alive)
        hit = alive & si.valid
        seg_len = torch.where(hit, si.t, remaining)
        tr_seg, state = _segment_tr(sa, sampler, state, seg_o, sh_dn,
                                    seg_len, seg_med, alive, wavelengths)
        tr = where3(alive, tr * tr_seg, tr)
        inst = torch.clamp(si.inst, min=0).long()
        lane_bsdf = sa.inst_bsdf[inst]
        nm = torch.zeros_like(hit)
        for nid in null_ids:
            nm = nm | (lane_bsdf == nid)
        is_null = hit & nm
        occluded = occluded | (hit & ~nm)
        # the medium across the boundary (closed-shape convention, as in
        # the bounce loop): the exterior is the sensor's medium
        entering = dot(sh_dn, si.n) < 0.0
        inst_med = sa.inst_int_medium[inst]
        seg_med = torch.where(
            is_null & (inst_med >= 0),
            torch.where(entering, inst_med, sa.sensor_medium), seg_med)
        seg_o = where3(hit, si._offset_p(sh_dn), seg_o)
        remaining = torch.where(hit, remaining - si.t, remaining)
        alive = is_null & (remaining > 1e-5)
    return occluded | alive, tr, state


@register_plugin("integrator", "volpath")
class VolPathIntegrator(MonteCarloIntegrator):
    """Volumetric path tracing with NEE and MIS (reference volpath.cpp)."""
    spectral_mode = "hero"

    def sample(self, sa, sampler, state, ray, active, wavelengths=None):
        return _volpath_loop(self, sa, sampler, state, ray, active,
                             wavelengths)

    def sample_stokes(self, sa, sampler, state, ray, active,
                      wavelengths=None):
        """Polarized volumetric transport: (Stokes 4-tuple, valid,
        state)."""
        return _volpath_loop(self, sa, sampler, state, ray, active,
                             wavelengths, stokes=True)


@register_plugin("integrator", "volpathmis")
class VolPathMISIntegrator(VolPathIntegrator):
    """reference volpathmis.cpp, the spectral-MIS variant: in the rgb
    variant its estimator is volpath's, and so is its class (the JAX
    package's subclass overrides nothing)."""


def _volpath_loop(integrator, sa, sampler, state, ray: Ray, active,
                  wavelengths=None, stokes=False):
    n = ray.o.x.shape[0]
    dev = ray.o.x.device

    throughput = Vec3.ones(n, device=dev)
    result = Vec3.zeros(n, device=dev)
    ones3 = Vec3.ones(n, device=dev)
    zero = torch.zeros((n,), device=dev)
    false_ = torch.zeros((n,), dtype=torch.bool, device=dev)
    eta = torch.ones((n,), device=dev)
    depth = torch.zeros((n,), dtype=torch.int64, device=dev)
    has_env = sa.has_environment and not integrator.hide_emitters
    valid_ray = torch.full((n,), bool(has_env), dtype=torch.bool, device=dev)
    medium = torch.full((n,), sa.sensor_medium, dtype=torch.int32, device=dev)
    prev_p = ray.o
    prev_pdf = torch.ones((n,), device=dev)   # bsdf or phase pdf
    prev_delta = torch.ones((n,), dtype=torch.bool, device=dev)

    bsdf_flags = torch.tensor(sa.bsdf_flags_host, dtype=torch.int32,
                              device=dev)
    null_ids = [i for i, f in enumerate(sa.bsdf_flags_host) if f & FLAG_NULL]
    depth_cap = min(integrator.max_depth, 2 ** 31 - 1)
    nee_on = sa.n_emitters > 0
    if stokes:
        from . import polarized as pol
        present = pol.polarizing_present(sa)
        T_mm = mu.mm_identity(zero)
        S_res = tuple(Vec3(zero, zero, zero) for _ in range(4))

    def med(j, med_id):
        return sa.med_params[j][torch.clamp(med_id, min=0).long()]

    for _ in range(integrator.loop_iterations):
        if not bool(active.any()):
            break
        with profile_phase("RayIntersect"):
            si = ray_intersect(sa, ray, active)

        # ---------------- medium distance sampling --------------------
        in_med = (medium >= 0) & active
        med_idx = torch.clamp(medium, min=0).long()
        st_r, st_g, st_b = _sigma_t(sa, med_idx, wavelengths)
        st_mean = torch.clamp((st_r + st_g + st_b) / 3.0, min=1e-8)
        u, state = sampler.next_1d(state, active)
        t_med = -torch.log(torch.clamp(1.0 - u, min=1e-20)) / st_mean
        t_surf = si.t
        hit_med = in_med & (t_med < t_surf)
        t_trav = torch.where(in_med, torch.minimum(t_med, t_surf), t_surf)
        t_fin = torch.where(torch.isfinite(t_trav), t_trav, 0.0)

        # transmittance / pdf reweighting (exponential sampling by the
        # mean sigma_t)
        tr = Vec3(torch.exp(-st_r * t_fin), torch.exp(-st_g * t_fin),
                  torch.exp(-st_b * t_fin))
        pdf_dist = torch.where(hit_med,
                               st_mean * torch.exp(-st_mean * t_fin),
                               torch.exp(-st_mean * t_fin))
        w_med = where3(in_med,
                       tr * (1.0 / torch.clamp(pdf_dist, min=1e-20)), ones3)
        al_r = med(M_ALBEDO, medium)
        al_g = med(M_ALBEDO + 1, medium)
        al_b = med(M_ALBEDO + 2, medium)
        if wavelengths is not None:
            # the albedo's sigmoid coefficients at the hero wavelengths
            al_r, al_g, al_b = (eval_reflectance_spectrum(al_r, al_g, al_b,
                                                          lam)
                                for lam in wavelengths)
        sig_s = Vec3(st_r * al_r, st_g * al_g, st_b * al_b)
        w_med = where3(hit_med, w_med * sig_s, w_med)

        if sa.any_hetero:
            # heterogeneous lanes: delta tracking against the majorant
            # (unit weight; scattering events carry the albedo)
            maxd = med(M_MAXD, medium)
            is_het = in_med & (maxd > 0.0)
            with profile_phase("DeltaTracking"):
                t_het, scat_het, state = _delta_track(
                    sa, sampler, state, ray, medium, t_surf, maxd,
                    active & is_het)
            hit_med = torch.where(is_het, scat_het, hit_med)
            t_fin = torch.where(
                is_het, torch.where(scat_het, t_het, torch.where(
                    torch.isfinite(t_surf), t_surf, 0.0)), t_fin)
            w_het = where3(scat_het, Vec3(al_r, al_g, al_b), ones3)
            w_med = where3(is_het, w_het, w_med)
        throughput = throughput * w_med
        if stokes:
            # attenuation does not depolarize: it scales every component
            T_mm = mu.mm_scale(T_mm, w_med)

        # ---------------- emission on surface hits / env --------------
        surf_evt = active & ~hit_med & si.valid
        inst = torch.clamp(si.inst, min=0).long()
        lane_emitter = torch.where(surf_evt, sa.inst_emitter[inst], -1)
        if nee_on:
            em_val = em_mod.eval_emitter_hit(sa, si.sh_n, -ray.d,
                                             lane_emitter, si.uv_u, si.uv_v,
                                             wavelengths)
            miss_env = (~si.valid) & active & ~hit_med
            mis_emitter = lane_emitter
            if has_env:
                em_val = where3(miss_env, em_mod.environment_eval(
                    sa, ray.d, wavelengths), em_val)
                emit_mask = (lane_emitter >= 0) | miss_env
                # escaped lanes carry the environment's index, so that
                # their MIS pdf is the environment's NEE pdf
                mis_emitter = torch.where(miss_env, sa.env_index,
                                          lane_emitter)
            else:
                emit_mask = lane_emitter >= 0
            d_seg = si.p - prev_p
            dist = torch.sqrt(torch.clamp(dot(d_seg, d_seg), min=1e-20))
            ds_hit = DirectionSample(
                p=si.p, n=si.sh_n,
                d=where3(miss_env, ray.d, d_seg * (1.0 / dist)), dist=dist,
                pdf=zero, delta=false_, emitter=mis_emitter)
            em_pdf = torch.where(prev_delta, 0.0, em_mod.pdf_direction(
                sa, ds_hit, prim=si.prim, time=ray.time))
            scale = torch.where(emit_mask, mis_weight(prev_pdf, em_pdf), 0.0)
            result = result + throughput * em_val * scale
            if stokes:
                # unpolarized emitters: the throughput's first column
                S_add = pol.first_column(T_mm, em_val * scale)
                S_res = tuple(S_res[i] + S_add[i] for i in range(4))

        active_next = ((depth + 1) < depth_cap) & active & (hit_med
                                                            | si.valid)

        # the interaction point (medium or surface)
        p_evt = where3(hit_med, ray.o + ray.d * t_fin, si.p)
        med_se = med(M_SAMPLE_EM, medium) > 0.5
        lane_bsdf = sa.inst_bsdf[inst]

        # ---------------- NEE from the medium or the surface ------------
        nee, state = sampler.next_2d(state, active)
        if nee_on:
            ds, em_weight = em_mod.sample_direction(sa, p_evt, ray.time,
                                                    nee[0], nee[1],
                                                    wavelengths)
            smooth = (bsdf_flags[lane_bsdf.long()] & FLAG_SMOOTH) != 0
            # media with sample_emitters=false take no NEE from their
            # events (medium.h sample_emitters)
            active_em = active_next & (ds.pdf != 0.0) & (
                (hit_med & med_se) | (~hit_med & si.valid & smooth))
            sh_o = where3(hit_med, p_evt, si._offset_p(ds.p - si.p))
            sh_d = ds.p - sh_o
            sh_dist = torch.sqrt(torch.clamp(dot(sh_d, sh_d), min=1e-20))
            sh_dn = sh_d * (1.0 / sh_dist)
            if not null_ids:
                with profile_phase("RayTest"):
                    occluded = ray_test(sa, Ray(
                        sh_o, sh_dn, ray.time,
                        sh_dist * (1.0 - SHADOW_EPSILON)), active_em)
                # transmittance along the shadow segment (current medium)
                tr_sh = where3(in_med, Vec3(torch.exp(-st_r * ds.dist),
                                            torch.exp(-st_g * ds.dist),
                                            torch.exp(-st_b * ds.dist)),
                               ones3)
                if sa.any_hetero:
                    maxd_sh = med(M_MAXD, medium)
                    het_sh = in_med & (maxd_sh > 0.0)
                    tr_h, state = _ratio_track(sa, sampler, state, sh_o,
                                               sh_dn, sh_dist, medium,
                                               maxd_sh, active_em & het_sh)
                    tr_sh = where3(het_sh, Vec3(tr_h, tr_h, tr_h), tr_sh)
            else:
                # null-transparent shadow rays: a medium enclosed in a null
                # shell does not occlude its own NEE
                with profile_phase("ShadowTransmittance"):
                    occluded, tr_sh, state = _shadow_transmittance(
                        sa, sampler, state, sh_o, sh_dn, ray.time, sh_dist,
                        medium, active_em, null_ids, wavelengths)
            nee_ok = active_em & ~occluded
            em_weight = em_weight * tr_sh
        else:
            ds = DirectionSample(Vec3(zero, zero, zero),
                                 Vec3(zero, zero, zero),
                                 Vec3(zero, zero, zero), zero, zero, false_,
                                 torch.full((n,), -1, dtype=torch.int32,
                                            device=dev))

        # ---------------- next direction: phase or BSDF ---------------
        s1, state = sampler.next_1d(state, active)
        s2, state = sampler.next_2d(state, active)
        wo_phase, pdf_phase, phase_nee = _phase_sample_eval(
            sa, medium, p_evt, ray.d, ds.d, s2[0], s2[1])
        # the JAX package's volpath evaluates BSDFs with their rows'
        # reflectance: no texture lookup here
        bs = bsdf_eval_pdf_sample(sa, lane_bsdf, si.wi, si.to_local(ds.d),
                                  s1, s2[0], s2[1],
                                  wavelengths=wavelengths)

        # NEE contribution (medium: phase; surface: bsdf)
        if nee_on:
            val = where3(hit_med, Vec3(phase_nee, phase_nee, phase_nee),
                         bs.val_nee)
            pdf_fwd = torch.where(hit_med, phase_nee, bs.pdf_nee)
            mis_em = torch.where(ds.delta, 1.0, mis_weight(ds.pdf, pdf_fwd))
            scale = torch.where(nee_ok, mis_em, 0.0)
            result = result + throughput * val * em_weight * scale
            if stokes:
                # the exact Mueller matrix on roughconductor and measured
                # surfaces and on Rayleigh events, the depolarizer on the
                # other connections (medium events take type -1)
                v_nee = val * em_weight * scale
                lt_nee = torch.where(hit_med, -1,
                                     sa.bsdf_type[lane_bsdf.long()])
                S_add = pol.camera_nee_stokes_add(
                    sa, si, bs, si.to_local(ds.d), lane_bsdf, lt_nee, T_mm,
                    v_nee, wavelengths)
                if sa.any_rayleigh:
                    is_ray_n = hit_med & (torch.abs(
                        med(M_PHASE, medium) - 2.0) < 0.5)
                    TMr = mu.mm_mul(T_mm, pol.renormalize(
                        pol.rayleigh_scatter_mueller(ray.d, ds.d), v_nee))
                    S_add = tuple(where3(is_ray_n, TMr[4 * i], S_add[i])
                                  for i in range(4))
                S_res = tuple(S_res[i] + S_add[i] for i in range(4))

        # next ray
        wo_world_surf = si.to_world(bs.wo)
        d_next = where3(hit_med, wo_phase, wo_world_surf)
        o_next = where3(hit_med, p_evt, si.spawn_ray(wo_world_surf).o)

        surf_next = active_next & ~hit_med
        throughput = where3(surf_next, throughput * bs.weight, throughput)
        if stokes:
            M_b = pol.camera_bounce_mueller(
                sa, si, bs, lane_bsdf, sa.bsdf_type[lane_bsdf.long()],
                where3(surf_next, bs.weight, ones3), present, wavelengths)
            # phase scattering: the depolarizer for HG, SGGX and tabulated
            # phases (weight 1: sigma_s rode w_med), Rayleigh's exact
            # scattering matrix (rayleigh.cpp's polarized phase)
            M_p = mu.depolarizer(ones3)
            if sa.any_rayleigh:
                is_ray_p = torch.abs(med(M_PHASE, medium) - 2.0) < 0.5
                M_p = mu.mm_where(is_ray_p, pol.rayleigh_scatter_mueller(
                    ray.d, wo_phase), M_p)
            M_b = mu.mm_where(hit_med & active_next, M_p, M_b)
            T_mm = mu.mm_where(active_next, mu.mm_mul(T_mm, M_b), T_mm)
        eta = eta * torch.where(surf_next, bs.eta, 1.0)
        valid_ray = valid_ray | (active & (hit_med | si.valid))

        # medium transitions: for closed shapes, the side of the outgoing
        # direction against the geometric normal decides inside or out
        entering = dot(wo_world_surf, si.n) < 0.0
        inst_med = sa.inst_int_medium[inst]
        medium = torch.where(
            active_next & surf_evt & (inst_med >= 0),
            torch.where(entering, inst_med, sa.sensor_medium), medium)

        # null (index-matched) crossings are no events for MIS and depth
        # (reference volpath.cpp: they neither reset the last real vertex
        # nor count as bounces)
        null_evt = surf_evt & bs.sampled_null
        real_evt = (hit_med | si.valid) & ~null_evt
        prev_p = where3(real_evt, p_evt, prev_p)
        keep = active_next & ~null_evt
        prev_pdf = torch.where(keep, torch.where(hit_med, pdf_phase, bs.pdf),
                               prev_pdf)
        prev_delta = torch.where(
            keep, torch.where(hit_med, ~med_se, bs.sampled_delta),
            prev_delta)
        depth = depth + (real_evt & active).to(torch.int64)

        # russian roulette
        tmax = vmax(throughput)
        rr_prob = torch.clamp(tmax * eta * eta, max=0.95)
        rr_active = depth >= integrator.rr_depth
        rr_draw, state = sampler.next_1d(state, active)
        rr_continue = rr_draw < rr_prob
        rr_scale = torch.where(rr_active,
                               1.0 / torch.clamp(rr_prob, min=1e-8), 1.0)
        throughput = throughput * rr_scale
        if stokes:
            T_mm = mu.mm_scale(T_mm, rr_scale)
        active = active_next & (~rr_active | rr_continue) & (tmax != 0.0)

        ray = Ray(where3(active_next, o_next, ray.o),
                  where3(active_next, d_next, ray.d), ray.time,
                  torch.full((n,), float("inf"), device=dev))

    zero3 = Vec3(zero, zero, zero)
    if stokes:
        return (tuple(where3(valid_ray, s, zero3) for s in S_res), valid_ray,
                state)
    return where3(valid_ray, result, zero3), valid_ray, state, []


__all__ = ["VolPathIntegrator"]
