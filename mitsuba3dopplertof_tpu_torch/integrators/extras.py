"""The direct, aov and moment integrators (port of the JAX package's
``integrators/extras.py``; reference src/integrators/{direct,aov,
moment}.cpp), in every ported variant: direct transports the hero
wavelengths of the spectral variant, aov and moment take their nested
integrator's spectral mode (aov without one is wavelength-free)."""

from __future__ import annotations

import torch

from ..core.properties import Properties, register_plugin
from ..core.vec import Vec3, dot, where3
from ..ops.intersect_kernel import intersect, with_plain_miss_payload
from ..render.scene import build_si, ray_intersect, ray_test
from ..render.types import DirectionSample
from ..bsdfs import (eval_pdf_sample as bsdf_eval_pdf_sample, FLAG_SMOOTH,
                     P_REFL, P_REFL_TEX)
from .. import emitters as em_mod
from ..textures import eval_texture
from . import (SamplingIntegrator, _apply_normal_maps, mis_weight,
               textured_reflectance)


def _nested_integrator(props: Properties):
    """The last nested sampling integrator among the properties, or
    None."""
    child = None
    for _, v in props.objects():
        if isinstance(v, SamplingIntegrator):
            child = v
    return child


@register_plugin("integrator", "direct")
class DirectIntegrator(SamplingIntegrator):
    """MIS direct illumination with an N emitter / M BSDF sample split
    (reference src/integrators/direct.cpp:99-211): each strategy's
    contribution is averaged over its own draw count and MIS-weighted by
    the sampling-effort fractions N/(N+M), M/(N+M)."""
    spectral_mode = "hero"

    def __init__(self, props: Properties):
        super().__init__(props)
        shading = props.get_int("shading_samples", 1)
        self.emitter_samples = props.get_int("emitter_samples", shading)
        self.bsdf_samples = props.get_int("bsdf_samples", shading)
        if self.emitter_samples + self.bsdf_samples == 0:
            raise RuntimeError(
                "direct: must have at least 1 BSDF or emitter sample")

    def sample(self, sa, sampler, state, ray, active, wavelengths=None):
        N = self.emitter_samples
        M = self.bsdf_samples
        total = max(N + M, 1)
        frac_lum = N / total
        frac_bsdf = M / total
        w_lum = 1.0 / max(N, 1)
        w_bsdf = 1.0 / max(M, 1)
        n = ray.o.x.shape[0]
        dev = ray.o.x.device
        zero = torch.zeros((n,), device=dev)

        si = ray_intersect(sa, ray, active)
        if sa.any_nmap:
            si = _apply_normal_maps(sa, si)
        result = Vec3(zero, zero, zero)
        has_env = sa.has_environment and not self.hide_emitters
        valid_ray = torch.full((n,), bool(has_env), dtype=torch.bool,
                               device=dev) | (active & si.valid)

        # ---- first-hit emission (direct.cpp:128-137, weight 1) ----------
        lane_emitter = torch.where(
            si.valid, sa.inst_emitter[torch.clamp(si.inst, min=0).long()],
            -1)
        if sa.n_emitters > 0 and not self.hide_emitters:
            em_val = em_mod.eval_emitter_hit(sa, si.sh_n, -ray.d,
                                             lane_emitter, si.uv_u, si.uv_v,
                                             wavelengths)
            emit_mask = active & (lane_emitter >= 0)
            if has_env:
                miss_env = (~si.valid) & active
                em_val = where3(miss_env, em_mod.environment_eval(
                    sa, ray.d, wavelengths), em_val)
                emit_mask = emit_mask | miss_env
            result = result + em_val * torch.where(emit_mask, 1.0, 0.0)

        lane_bsdf = sa.inst_bsdf[torch.clamp(si.inst, min=0).long()].long()
        bsdf_flags = torch.tensor(sa.bsdf_flags_host, dtype=torch.int32,
                                  device=dev)
        smooth = (bsdf_flags[lane_bsdf] & FLAG_SMOOTH) != 0
        act_surf = active & si.valid
        tex_refl, tex_mask = textured_reflectance(sa, lane_bsdf, si,
                                                  wavelengths)
        half = torch.full((n,), 0.5, device=dev)

        # ---- N emitter samples (direct.cpp:148-176) ---------------------
        for _ in range(N if sa.n_emitters > 0 else 0):
            s2, state = sampler.next_2d(state, active)
            ds, em_weight = em_mod.sample_direction(sa, si.p, ray.time,
                                                    s2[0], s2[1],
                                                    wavelengths)
            act_em = act_surf & smooth & (ds.pdf != 0.0)
            occluded = ray_test(sa, si.spawn_ray_to(ds.p), act_em)
            ok = act_em & ~occluded
            r = bsdf_eval_pdf_sample(sa, lane_bsdf, si.wi, si.to_local(ds.d),
                                     half, half, half, tex_refl, tex_mask,
                                     wavelengths)
            mis = torch.where(
                ds.delta, 1.0,
                mis_weight(ds.pdf * frac_lum, r.pdf_nee * frac_bsdf)) * w_lum
            result = result + r.val_nee * em_weight * torch.where(ok, mis,
                                                                  0.0)

        # ---- M BSDF samples (direct.cpp:180-207) ------------------------
        for _ in range(M if sa.n_emitters > 0 else 0):
            s1, state = sampler.next_1d(state, active)
            s2, state = sampler.next_2d(state, active)
            r = bsdf_eval_pdf_sample(sa, lane_bsdf, si.wi, si.wi, s1, s2[0],
                                     s2[1], tex_refl, tex_mask, wavelengths)
            act_b = act_surf & (r.pdf > 0.0)
            ray2 = si.spawn_ray(si.to_world(r.wo))
            si2 = ray_intersect(sa, ray2, act_b)
            lane_em2 = torch.where(
                si2.valid,
                sa.inst_emitter[torch.clamp(si2.inst, min=0).long()], -1)
            em_val2 = em_mod.eval_emitter_hit(sa, si2.sh_n, -ray2.d,
                                              lane_em2, si2.uv_u, si2.uv_v,
                                              wavelengths)
            hit_em = act_b & (lane_em2 >= 0)
            d_seg = si2.p - si.p
            dist = torch.sqrt(torch.clamp(dot(d_seg, d_seg), min=1e-20))
            ds_hit = DirectionSample(
                p=si2.p, n=si2.sh_n, d=d_seg * (1.0 / dist), dist=dist,
                pdf=zero, delta=torch.zeros_like(act_b), emitter=lane_em2)
            em_pdf = torch.where(r.sampled_delta, 0.0, em_mod.pdf_direction(
                sa, ds_hit, prim=si2.prim, time=ray2.time))
            if has_env:
                miss2 = (~si2.valid) & act_b
                env_pdf = em_mod.environment_pdf_direction(sa, ray2.d) * (
                    1.0 / max(sa.n_emitters, 1))
                em_val2 = where3(miss2, em_mod.environment_eval(
                    sa, ray2.d, wavelengths), em_val2)
                em_pdf = torch.where(miss2 & ~r.sampled_delta, env_pdf,
                                     em_pdf)
                hit_em = hit_em | miss2
            mis = mis_weight(r.pdf * frac_bsdf, em_pdf * frac_lum) * w_bsdf
            result = result + r.weight * em_val2 * torch.where(hit_em, mis,
                                                               0.0)

        spec = where3(valid_ray, result, Vec3(zero, zero, zero))
        return spec, valid_ray, state, []


@register_plugin("integrator", "aov")
class AOVIntegrator(SamplingIntegrator):
    """Arbitrary output variables (reference src/integrators/aov.cpp).

    ``aovs`` = "name:type,..." with types in {depth, position, uv,
    geo_normal, sh_normal, prim_index, shape_index, albedo}; the channels
    follow the film's own. A nested integrator, if given, provides the
    RGB channels (else they are 0). On lanes that hit nothing the normals
    and uv are the plain intersector's (the first triangle slot's, as in
    the JAX package) on every device and route, not a kernel's own."""

    _SIZES = {"depth": 1, "position": 3, "uv": 2, "geo_normal": 3,
              "sh_normal": 3, "prim_index": 1, "shape_index": 1,
              "albedo": 3}

    def __init__(self, props: Properties):
        super().__init__(props)
        spec = props.get_string("aovs", "")
        self.outputs = []
        for part in [p for p in spec.split(",") if p.strip()]:
            name, _, ty = part.partition(":")
            ty = ty.strip() or name.strip()
            if ty in ("duv_dx", "duv_dy"):
                raise RuntimeError(
                    "aov: screen-space UV partials need ray differentials, "
                    "which this wavefront design does not carry")
            if ty not in self._SIZES:
                raise RuntimeError(f"aov: unknown type '{ty}'")
            self.outputs.append((name.strip(), ty))
        self.child = _nested_integrator(props)

    def aov_names(self):
        names = []
        for name, ty in self.outputs:
            k = self._SIZES[ty]
            if k == 1:
                names.append(name)
            else:
                suffix = {2: ["u", "v"], 3: ["x", "y", "z"]}[k]
                names.extend(f"{name}.{s}" for s in suffix)
        return names

    @property
    def spectral_mode(self):
        return (self.child.spectral_mode if self.child is not None
                else "neutral")

    def sample(self, sa, sampler, state, ray, active, wavelengths=None):
        si = build_si(sa, ray, with_plain_miss_payload(
            sa, ray, intersect(sa, ray, active)), active)
        aovs = []
        for _, ty in self.outputs:
            if ty == "depth":
                aovs.append(torch.where(si.valid, si.t, 0.0))
            elif ty == "position":
                aovs.extend([si.p.x, si.p.y, si.p.z])
            elif ty == "uv":
                aovs.extend([si.uv_u, si.uv_v])
            elif ty == "geo_normal":
                aovs.extend([si.n.x, si.n.y, si.n.z])
            elif ty == "sh_normal":
                aovs.extend([si.sh_n.x, si.sh_n.y, si.sh_n.z])
            elif ty == "prim_index":
                aovs.append(si.prim.to(torch.float32))
            elif ty == "shape_index":
                aovs.append(si.inst.to(torch.float32))
            elif ty == "albedo":
                # the reflectance at the first hit, textures included
                # (aov.cpp albedo: eval_diffuse_reflectance); as in the JAX
                # package a row whose texture column is 0 takes texture 0
                lane_bsdf = sa.inst_bsdf[
                    torch.clamp(si.inst, min=0).long()].long()
                alb = Vec3(sa.bsdf_params[P_REFL][lane_bsdf],
                           sa.bsdf_params[P_REFL + 1][lane_bsdf],
                           sa.bsdf_params[P_REFL + 2][lane_bsdf])
                if sa.n_textures > 0:
                    lane_tex = sa.bsdf_params[P_REFL_TEX][lane_bsdf].to(
                        torch.int32)
                    alb = where3(lane_tex >= 0, eval_texture(
                        sa, lane_tex, si.uv_u, si.uv_v, p=si.p, b_u=si.b_u,
                        b_v=si.b_v, prim=si.prim, wavelengths=wavelengths),
                        alb)
                vm = torch.where(si.valid, 1.0, 0.0)
                aovs.extend([alb.x * vm, alb.y * vm, alb.z * vm])
        if self.child is not None:
            spec, valid, state, _ = self.child.sample(
                sa, sampler, state, ray, active, wavelengths=wavelengths)
        else:
            z = torch.zeros_like(si.t)
            spec, valid = Vec3(z, z, z), si.valid
        return spec, valid, state, aovs


@register_plugin("integrator", "moment")
class MomentIntegrator(SamplingIntegrator):
    """The second moment of a nested integrator as three AOV channels
    (reference src/integrators/moment.cpp:21-59): per-pixel variance is
    m2 - mean^2. It takes the child's Doppler and time-sampling settings,
    so that its draws, and its RGB, are those of the child's own render."""

    def __init__(self, props: Properties):
        super().__init__(props)
        self.child = _nested_integrator(props)
        if self.child is None:
            raise RuntimeError("moment: requires a nested integrator")
        self.is_doppler = self.child.is_doppler
        for attr in ("time_sampling_method", "antithetic_shift",
                     "use_stratified_sampling_for_each_interval",
                     "path_correlation_depth"):
            setattr(self, attr, getattr(self.child, attr))

    def aov_names(self):
        return ["m2.R", "m2.G", "m2.B"]

    @property
    def spectral_mode(self):
        return self.child.spectral_mode

    def sample(self, sa, sampler, state, ray, active, wavelengths=None):
        # in the spectral variant the moments are of the hero-wavelength
        # samples, before their sRGB conversion, as in the JAX package
        spec, valid, state, _ = self.child.sample(
            sa, sampler, state, ray, active, wavelengths=wavelengths)
        return spec, valid, state, [spec.x * spec.x, spec.y * spec.y,
                                    spec.z * spec.z]


__all__ = ["DirectIntegrator", "AOVIntegrator", "MomentIntegrator"]
