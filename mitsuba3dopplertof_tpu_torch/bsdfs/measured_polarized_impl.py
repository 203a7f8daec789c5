"""Measured polarized pBRDF tables (port of the JAX package's
``bsdfs/measured_polarized_impl.py``; reference src/bsdfs/
measured_polarized.cpp, Baek et al. 2020's pBRDF dataset).

Tensor-file fields (measured_polarized.cpp:125-153): ``theta_h`` (1, Nh),
``theta_d`` (1, Nd), ``phi_d`` (1, Np) float32 grids, ``wvls`` (Nw,)
uint16 wavelengths, ``M`` (Np, Nd, Nh, Nw, 4, 4) float32 Mueller matrices
in the Rusinkiewicz parameterization. A lookup interpolates multilinearly
over (phi_d, theta_d, theta_h, wavelength): the reference wraps the same
lookup in a Marginal2D<4> used only as an interpolator.

Sampling (measured_polarized.cpp:177-210, 333-344): a fixed mixture of
the cosine hemisphere (weight 0.1) and GGX(alpha_sample) visible-normal
reflection; the pdf is the same mixture.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..core import mueller as mu
from ..core.vec import Vec3, cross, dot, normalize, where3

COSINE_HEMISPHERE_PDF_WEIGHT = 0.1
# representative rgb band centres within the dataset's 450-650 nm
RGB_WAVELENGTHS = (620.0, 550.0, 465.0)


class PbsdfTables(NamedTuple):
    phi_d: torch.Tensor    # (Np,)
    theta_d: torch.Tensor  # (Nd,)
    theta_h: torch.Tensor  # (Nh,)
    wvls: torch.Tensor     # (Nw,)
    M: torch.Tensor        # (Np*Nd*Nh*Nw, 16) flattened Mueller entries


def build_pbsdf_tables(fields) -> PbsdfTables:
    """The tables of a ``.pbsdf`` file's fields, on the CPU."""
    th = np.asarray(fields["theta_h"], np.float32).reshape(-1)
    td = np.asarray(fields["theta_d"], np.float32).reshape(-1)
    pd = np.asarray(fields["phi_d"], np.float32).reshape(-1)
    wv = np.asarray(fields["wvls"], np.float32).reshape(-1)
    M = np.asarray(fields["M"], np.float32)
    expect = (pd.size, td.size, th.size, wv.size, 4, 4)
    if M.shape != expect:
        raise RuntimeError(
            f"pbsdf: M shape {M.shape} does not match grids {expect} "
            "(measured_polarized.cpp:131-153 layout)")
    return PbsdfTables(*(torch.tensor(a)
                         for a in (pd, td, th, wv, M.reshape(-1, 16))))


def pbsdf_tables_to(tbl, device) -> PbsdfTables:
    """Tables with the fields of ``PbsdfTables`` (the port's or the JAX
    package's, as numpy-convertible arrays) as float32 tensors on
    ``device``."""
    return PbsdfTables(*(torch.tensor(np.array(getattr(tbl, k)),
                                      dtype=torch.float32, device=device)
                         for k in PbsdfTables._fields))


def _interp_axis(grid, x):
    """Clamped linear interpolation weights on a sorted 1-D grid."""
    K = int(grid.shape[0])
    i1 = torch.clamp(torch.searchsorted(grid, x.contiguous(), right=True),
                     1, K - 1)
    i0 = i1 - 1
    g0 = grid[i0]
    g1 = grid[i1]
    t = torch.clamp((x - g0) / torch.clamp(g1 - g0, min=1e-12), 0.0, 1.0)
    return i0, i1, t


def pbsdf_fetch16(tbl: PbsdfTables, pd, td, th, lam):
    """The 16 interpolated Mueller entries (row-major) at per-lane
    (phi_d, theta_d, theta_h, wavelength). A NaN cell zeroes the whole
    matrix (measured_polarized.cpp:283-287); entry 0 is clamped >= 0."""
    Nd = int(tbl.theta_d.shape[0])
    Nh = int(tbl.theta_h.shape[0])
    Nw = int(tbl.wvls.shape[0])
    ip0, ip1, tp = _interp_axis(tbl.phi_d, pd)
    id0, id1, tdt = _interp_axis(tbl.theta_d, td)
    ih0, ih1, tht = _interp_axis(tbl.theta_h, th)
    iw0, iw1, twt = _interp_axis(tbl.wvls, lam)

    out = [0.0] * 16
    for ip, wp in ((ip0, 1.0 - tp), (ip1, tp)):
        for idx_d, wd in ((id0, 1.0 - tdt), (id1, tdt)):
            for ih, wh in ((ih0, 1.0 - tht), (ih1, tht)):
                for iw, ww in ((iw0, 1.0 - twt), (iw1, twt)):
                    w = wp * wd * wh * ww
                    lin = ((ip * Nd + idx_d) * Nh + ih) * Nw + iw
                    rows = tbl.M[lin]                    # (n, 16)
                    for e in range(16):
                        out[e] = out[e] + w * rows[:, e]
    bad = ~torch.isfinite(out[0])
    for e in range(16):
        out[e] = torch.where(bad | ~torch.isfinite(out[e]), 0.0, out[e])
    out[0] = torch.clamp(out[0], min=0.0)
    return out


def _phi(v: Vec3):
    p = torch.atan2(v.y, v.x)
    return torch.where(p < 0.0, p + 2.0 * math.pi, p)


def _rotate_z(v: Vec3, angle):
    """Rotation about +z (the reference's rotate_vector, axis (0, 0, 1))."""
    s = torch.sin(angle)
    c = torch.cos(angle)
    return Vec3(v.x * c - v.y * s, v.x * s + v.y * c, v.z)


def rusinkiewicz(i: Vec3, o: Vec3):
    """(phi_d, theta_h, theta_d) (measured_polarized.cpp:374-391)."""
    h = normalize(i + o)
    bx, by = -h.y, h.x                       # cross(n = (0,0,1), h)
    bl = torch.sqrt(torch.clamp(bx * bx + by * by, min=1e-18))
    b = Vec3(bx / bl, by / bl, torch.zeros_like(bl))
    t = normalize(cross(b, h))
    td = torch.acos(torch.clamp(dot(h, i), -1.0, 1.0))
    th = torch.acos(torch.clamp(h.z, -1.0, 1.0))
    i_prj = normalize(i - h * dot(i, h))
    cos_pd = torch.clamp(dot(t, i_prj), -1.0, 1.0)
    sin_pd = torch.clamp(dot(b, i_prj), -1.0, 1.0)
    pd = torch.atan2(sin_pd, cos_pd)
    return pd, th, td


def pbsdf_eval_mueller(tbl: PbsdfTables, wi: Vec3, wo: Vec3,
                       wavelengths=RGB_WAVELENGTHS):
    """The full 4x4 Mueller eval in the LOCAL frame, in the implicit
    Stokes bases of (-wo, wi), the three channels at three wavelengths
    (measured_polarized.cpp:215-299). Radiance transport: light arrives
    along -wo and leaves along wi. Includes cos_theta_o. Returns a Mueller
    16-tuple of Vec3 (``core.mueller`` layout)."""
    wo_hat, wi_hat = wo, wi
    phi_std = _phi(wi_hat)
    wo_std = _rotate_z(wo_hat, -phi_std)
    wi_std = _rotate_z(wi_hat, -phi_std)
    pd, th, td = rusinkiewicz(wo_std, wi_std)

    entries = [pbsdf_fetch16(tbl, pd, td, th,
                             torch.full_like(pd, float(np.float32(lam))))
               for lam in wavelengths]
    M = tuple(Vec3(entries[0][e], entries[1][e], entries[2][e])
              for e in range(16))

    # the measurement's Stokes frames: reflection-plane bases (Figure 4)
    zo = -wo_std
    to = normalize(cross(wo_std - wi_std, zo))
    yo = normalize(cross(to, zo))
    xo = cross(yo, zo)
    zi = wi_std
    ti = normalize(cross(wi_std - wo_std, zi))
    yi = normalize(cross(ti, zi))
    xi = cross(yi, zi)
    # undo the phi_std rotation on the frame vectors, then rotate into the
    # implicit local Stokes bases
    xo_hat = _rotate_z(xo, phi_std)
    xi_hat = _rotate_z(xi, phi_std)
    M = mu.rotate_mueller_basis(M,
                                -wo_hat, xo_hat, mu.stokes_basis(-wo_hat),
                                wi_hat, xi_hat, mu.stokes_basis(wi_hat))
    cos_o = torch.clamp(wo.z, min=0.0)
    return mu.mm_scale(M, Vec3(cos_o, cos_o, cos_o))


def mixture_pdf(wi: Vec3, wo: Vec3, alpha, clip: bool = True):
    """The mixture's pdf (measured_polarized.cpp pdf()). ``clip=True``
    gates on cos_theta_o > 0, as the reference's BSDF pdf does (GGX
    reflections below the horizon are dead samples); ``clip=False`` is the
    raw sampling density over the sphere."""
    from ..core import microfacet as mf
    h = normalize(wi + wo)
    pdf_d = torch.clamp(wo.z, min=0.0) / math.pi
    pdf_m = mf.ggx_pdf_visible(wi, h, alpha, alpha) / torch.clamp(
        4.0 * torch.abs(dot(wo, h)), min=1e-9)
    p = (COSINE_HEMISPHERE_PDF_WEIGHT * pdf_d
         + (1.0 - COSINE_HEMISPHERE_PDF_WEIGHT) * pdf_m)
    ok = (wi.z > 0.0) & (wo.z > 0.0) if clip else (wi.z > 0.0)
    return torch.where(ok, p, 0.0)


def pbsdf_eval_pdf_sample(tbl: PbsdfTables, alpha, wi: Vec3, wo_nee: Vec3,
                          s1, s2x, s2y, wavelengths=RGB_WAVELENGTHS):
    """The scalar (intensity, M00) record: the unpolarized variants' BSDF
    and the polarized loop's importance weights; measured_polarized.cpp
    sample() / pdf() / eval() with value = M00 cos."""
    from ..core import microfacet as mf
    from ..core import warp
    from . import BSDFSampleResult

    def m00(wo):
        phi_wi = _phi(wi)
        pd_, th_, td_ = rusinkiewicz(_rotate_z(wo, -phi_wi),
                                     _rotate_z(wi, -phi_wi))
        return Vec3(*(pbsdf_fetch16(
            tbl, pd_, td_, th_,
            torch.full_like(pd_, float(np.float32(lam))))[0]
            for lam in wavelengths))

    # NEE eval: f cos
    ok_nee = (wi.z > 0.0) & (wo_nee.z > 0.0)
    val_nee = m00(wo_nee) * torch.where(ok_nee,
                                        torch.clamp(wo_nee.z, min=0.0), 0.0)
    pdf_nee = mixture_pdf(wi, wo_nee, alpha)

    # the sample: cosine / GGX mixture
    diffuse_lobe = s1 < COSINE_HEMISPHERE_PDF_WEIGHT
    wo_d = warp.cosine_hemisphere_c(s2x, s2y)
    m, _ = mf.ggx_sample_vndf(wi, alpha, alpha, s2x, s2y)
    wo_m = m * (2.0 * dot(wi, m)) - wi
    wo = where3(diffuse_lobe, wo_d, wo_m)
    pdf = mixture_pdf(wi, wo, alpha)
    ok = (wi.z > 0.0) & (wo.z > 0.0) & (pdf > 1e-9)
    w = m00(wo) * torch.where(ok, torch.clamp(wo.z, min=0.0)
                              / torch.clamp(pdf, min=1e-9), 0.0)
    false_ = torch.zeros_like(ok)
    return BSDFSampleResult(
        val_nee=val_nee, pdf_nee=pdf_nee, wo=wo, weight=w, pdf=pdf,
        eta=torch.ones_like(pdf), sampled_delta=false_,
        sampled_null=false_)


__all__ = ["PbsdfTables", "build_pbsdf_tables", "pbsdf_tables_to",
           "pbsdf_fetch16", "pbsdf_eval_mueller", "pbsdf_eval_pdf_sample",
           "rusinkiewicz", "mixture_pdf", "RGB_WAVELENGTHS",
           "COSINE_HEMISPHERE_PDF_WEIGHT"]
