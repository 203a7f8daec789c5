"""GGX and Beckmann microfacet distributions with visible-normal sampling,
component-wise (port of the JAX package's ``core/microfacet.py``;
reference include/mitsuba/render/microfacet.h)."""

from __future__ import annotations

import torch

from .math import PI, TWO_PI
from .vec import Vec3, dot, normalize


def ggx_D(m: Vec3, alpha_u, alpha_v):
    """GGX normal distribution (reference microfacet.h eval)."""
    c2 = m.z * m.z
    t = (m.x * m.x) / (alpha_u * alpha_u) + (m.y * m.y) / (alpha_v * alpha_v) + c2
    result = 1.0 / (PI * alpha_u * alpha_v * t * t)
    return torch.where(m.z > 0.0, result, 0.0)


def beckmann_D(m: Vec3, alpha_u, alpha_v):
    c2 = m.z * m.z
    arg = -((m.x * m.x) / (alpha_u * alpha_u)
            + (m.y * m.y) / (alpha_v * alpha_v)) / torch.clamp(c2, min=1e-12)
    result = torch.exp(arg) / (PI * alpha_u * alpha_v
                               * torch.clamp(c2 * c2, min=1e-20))
    return torch.where(m.z > 0.0, result, 0.0)


def _sq(x):
    return x * x


def ggx_smith_g1(v: Vec3, m: Vec3, alpha_u, alpha_v):
    """Smith masking-shadowing for GGX (reference microfacet.h smith_g1)."""
    xy_alpha2 = _sq(alpha_u * v.x) + _sq(alpha_v * v.y)
    tan2 = xy_alpha2 / torch.clamp(v.z * v.z, min=1e-20)
    g = 2.0 / (1.0 + torch.sqrt(1.0 + tan2))
    # perpendicular incidence / backside guards
    g = torch.where(xy_alpha2 == 0.0, 1.0, g)
    g = torch.where(dot(v, m) * v.z <= 0.0, 0.0, g)
    return g


def ggx_sample_vndf(wi: Vec3, alpha_u, alpha_v, s1, s2):
    """Sample the GGX distribution of visible normals (Heitz 2018), the
    reference's sample_visible=true path. Returns (m, pdf)."""
    # stretch
    vh = normalize(Vec3(alpha_u * wi.x, alpha_v * wi.y, wi.z))
    # orthonormal basis around vh
    lensq = vh.x * vh.x + vh.y * vh.y
    inv = torch.where(lensq > 1e-12,
                      1.0 / torch.sqrt(torch.clamp(lensq, min=1e-20)), 0.0)
    t1 = Vec3(-vh.y * inv, vh.x * inv, torch.zeros_like(vh.z))
    t1 = Vec3(torch.where(lensq > 1e-12, t1.x, 1.0),
              torch.where(lensq > 1e-12, t1.y, 0.0), t1.z)
    t2 = Vec3(vh.y * t1.z - vh.z * t1.y,
              vh.z * t1.x - vh.x * t1.z,
              vh.x * t1.y - vh.y * t1.x)
    # parameterize projected area
    r = torch.sqrt(s1)
    phi = TWO_PI * s2
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    ss = 0.5 * (1.0 + vh.z)
    p2 = (1.0 - ss) * torch.sqrt(torch.clamp(1.0 - p1 * p1, min=0.0)) + ss * p2
    p3 = torch.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=0.0))
    nh = t1 * p1 + t2 * p2 + vh * p3
    # unstretch
    m = normalize(Vec3(alpha_u * nh.x, alpha_v * nh.y,
                       torch.clamp(nh.z, min=1e-6)))
    pdf = ggx_pdf_visible(wi, m, alpha_u, alpha_v)
    return m, pdf


def ggx_pdf_visible(wi: Vec3, m: Vec3, alpha_u, alpha_v):
    """pdf of sample_vndf: G1(wi) * |wi.m| * D(m) / |cos_theta_i|."""
    d = ggx_D(m, alpha_u, alpha_v)
    g1 = ggx_smith_g1(wi, m, alpha_u, alpha_v)
    return g1 * torch.abs(dot(wi, m)) * d / torch.clamp(torch.abs(wi.z),
                                                        min=1e-12)


def ggx_G(wi: Vec3, wo: Vec3, m: Vec3, alpha_u, alpha_v):
    return (ggx_smith_g1(wi, m, alpha_u, alpha_v)
            * ggx_smith_g1(wo, m, alpha_u, alpha_v))


def beckmann_smith_g1(v: Vec3, m: Vec3, alpha_u, alpha_v):
    """Smith masking for Beckmann (reference microfacet.h smith_g1,
    Walter et al. 2007 rational approximation), anisotropic via the
    projected roughness."""
    xy_alpha2 = _sq(alpha_u * v.x) + _sq(alpha_v * v.y)
    tan2 = xy_alpha2 / torch.clamp(v.z * v.z, min=1e-20)
    a = 1.0 / torch.sqrt(torch.clamp(tan2, min=1e-20))
    g = torch.where(a >= 1.6, 1.0,
                    (3.535 * a + 2.181 * a * a)
                    / torch.clamp(1.0 + 2.276 * a + 2.577 * a * a, min=1e-12))
    g = torch.where(xy_alpha2 == 0.0, 1.0, g)
    g = torch.where(dot(v, m) * v.z <= 0.0, 0.0, g)
    return g


def beckmann_sample(alpha_u, alpha_v, s1, s2):
    """Classic full-D(m)·cos sampling of the anisotropic Beckmann
    distribution (reference sample_visible=false mode; Walter et al.
    slope-space form). Returns (m, pdf)."""
    r = torch.sqrt(torch.clamp(-torch.log(torch.clamp(1.0 - s1, min=1e-20)),
                               min=0.0))
    phi = TWO_PI * s2
    sx = r * torch.cos(phi) * alpha_u
    sy = r * torch.sin(phi) * alpha_v
    inv = 1.0 / torch.sqrt(sx * sx + sy * sy + 1.0)
    m = Vec3(-sx * inv, -sy * inv, inv)
    return m, beckmann_pdf(m, alpha_u, alpha_v)


def beckmann_pdf(m: Vec3, alpha_u, alpha_v):
    """pdf of beckmann_sample: D(m) * cos_theta_m."""
    return beckmann_D(m, alpha_u, alpha_v) * torch.clamp(m.z, min=0.0)


def beckmann_G(wi: Vec3, wo: Vec3, m: Vec3, alpha_u, alpha_v):
    return (beckmann_smith_g1(wi, m, alpha_u, alpha_v)
            * beckmann_smith_g1(wo, m, alpha_u, alpha_v))


__all__ = ["ggx_D", "beckmann_D", "beckmann_smith_g1",
           "beckmann_sample", "beckmann_pdf", "beckmann_G",
           "ggx_smith_g1", "ggx_sample_vndf",
           "ggx_pdf_visible", "ggx_G"]
