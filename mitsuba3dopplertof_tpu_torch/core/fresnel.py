"""Fresnel terms, component-wise (port of the JAX package's
``core/fresnel.py``; reference include/mitsuba/render/fresnel.h)."""

from __future__ import annotations

import torch

from .vec import Vec3


def fresnel_dielectric(cos_theta_i, eta):
    """Unpolarized Fresnel for a dielectric boundary.

    Returns (F, cos_theta_t, eta_it, eta_ti) like the reference's
    ``fresnel()``: cos_theta_t is signed (negative side of the boundary),
    eta_it/eta_ti are the relative iors for the transmitted ray. ``eta``
    is a float or a per-lane tensor.
    """
    out_mask = cos_theta_i >= 0.0
    rcp_eta = 1.0 / eta
    eta_it = torch.where(out_mask, eta, rcp_eta)
    eta_ti = torch.where(out_mask, rcp_eta, eta)

    cos_theta_t_sqr = 1.0 - eta_ti * eta_ti * (1.0 - cos_theta_i * cos_theta_i)
    abs_cos_i = torch.abs(cos_theta_i)
    cos_theta_t = torch.sqrt(torch.clamp(cos_theta_t_sqr, min=0.0))

    tir = cos_theta_t_sqr <= 0.0

    a_s = (abs_cos_i - eta_it * cos_theta_t) / torch.clamp(
        abs_cos_i + eta_it * cos_theta_t, min=1e-20)
    a_p = (eta_it * abs_cos_i - cos_theta_t) / torch.clamp(
        eta_it * abs_cos_i + cos_theta_t, min=1e-20)
    F = 0.5 * (a_s * a_s + a_p * a_p)
    F = torch.where(tir, 1.0, F)
    F = torch.where(torch.as_tensor(eta, device=F.device) == 1.0, 0.0, F)

    cos_theta_t = torch.where(cos_theta_i >= 0.0, -cos_theta_t, cos_theta_t)
    return F, cos_theta_t, eta_it, eta_ti


def fresnel_conductor(cos_theta_i, eta, k):
    """Unpolarized Fresnel for a conductor (complex ior eta - i*k), per
    channel. ``eta``/``k`` may be floats or (N,) tensors; returns F."""
    c2 = cos_theta_i * cos_theta_i
    s2 = 1.0 - c2
    e2 = eta * eta
    k2 = k * k
    t0 = e2 - k2 - s2
    a2pb2 = torch.sqrt(torch.clamp(t0 * t0 + 4.0 * e2 * k2, min=0.0))
    t1 = a2pb2 + c2
    a = torch.sqrt(torch.clamp(0.5 * (a2pb2 + t0), min=0.0))
    t2 = 2.0 * a * cos_theta_i
    rs = (t1 - t2) / torch.clamp(t1 + t2, min=1e-20)
    t3 = c2 * a2pb2 + s2 * s2
    t4 = t2 * s2
    rp = rs * (t3 - t4) / torch.clamp(t3 + t4, min=1e-20)
    return 0.5 * (rp + rs)


def reflect(wi: Vec3) -> Vec3:
    """Mirror about the local normal (+z)."""
    return Vec3(-wi.x, -wi.y, wi.z)


def refract(wi: Vec3, cos_theta_t, eta_ti) -> Vec3:
    """Refraction in the local frame (reference fresnel.h refract)."""
    scale = -eta_ti
    return Vec3(scale * wi.x, scale * wi.y, cos_theta_t)


__all__ = ["fresnel_dielectric", "fresnel_conductor", "reflect", "refract"]
