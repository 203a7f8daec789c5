"""The data-driven measured BRDF (port of the JAX package's
``bsdfs/measured_impl.py``; reference src/bsdfs/measured.cpp, the Dupuy &
Jakob adaptive parameterization in the RGL tensor format).

The reference samples micro-normals through parameterized ``Marginal2D``
warps. As in the JAX package, the warps here are histograms: the host
builds the marginal and conditional CDFs of every parameter slice
(``build_tables``), and each lane runs a fixed-depth binary search whose
CDF values are blended from the 2^K parameter corners at every probe
(``warp_sample``), so every lane follows the same control flow. Sampling,
inversion and the reported pdfs are consistent with one another; the
field lookups (ndf, sigma, spectra) interpolate their nodes bilinearly,
as the reference does.

The tables are ``MeasuredTables`` of float32 tensors; ``tables_from``
copies them, or the JAX package's (any object with the same fields, as
numpy-convertible arrays), to a device.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..core.vec import Vec3


class WarpTables(NamedTuple):
    """Histogram warp over (*param_dims, ry, rx) node data."""
    cw: torch.Tensor          # (P*T, (ry-1)*(rx-1)) cell weights
    cond_cdf: torch.Tensor    # (P*T, ry-1, rx-1) per-row inclusive cdf
    marg_cdf: torch.Tensor    # (P*T, ry-1) inclusive cdf of row masses
    total: torch.Tensor       # (P*T,)
    ry: int
    rx: int


class MeasuredTables(NamedTuple):
    phi_i: torch.Tensor        # (P,)
    theta_i: torch.Tensor      # (T,)
    wavelengths: torch.Tensor  # (W,)
    vndf: WarpTables
    luminance: WarpTables
    ndf: torch.Tensor          # (ry, rx) raw nodes
    sigma: torch.Tensor        # (ry, rx)
    spectra: torch.Tensor      # (P, T, W, rs, rs) raw nodes
    isotropic: bool
    jacobian: bool


def _f32(a, device="cpu"):
    return torch.tensor(np.asarray(a), dtype=torch.float32, device=device)


def _build_warp(data: np.ndarray) -> WarpTables:
    """(P, T, ry, rx) node values -> histogram CDF tables (float64 on the
    host, stored as float32)."""
    P, T, ry, rx = data.shape
    cells = 0.25 * (data[..., :-1, :-1] + data[..., :-1, 1:]
                    + data[..., 1:, :-1] + data[..., 1:, 1:])
    cells = np.maximum(cells, 0.0)
    cond = np.cumsum(cells, axis=-1)                      # (P,T,ry-1,rx-1)
    marg = np.cumsum(cond[..., -1], axis=-1)              # (P,T,ry-1)
    total = np.maximum(marg[..., -1], 1e-12)
    return WarpTables(
        cw=_f32(cells.reshape(P * T, -1).astype(np.float32)),
        cond_cdf=_f32(cond.reshape(P * T, ry - 1, rx - 1).astype(
            np.float32)),
        marg_cdf=_f32(marg.reshape(P * T, ry - 1).astype(np.float32)),
        total=_f32(total.reshape(P * T).astype(np.float32)),
        ry=ry, rx=rx)


def build_tables(fields) -> MeasuredTables:
    """The tables from a tensor file's raw fields (measured.cpp:40-160),
    on the CPU."""
    vndf = np.asarray(fields["vndf"], np.float64)
    lum = np.asarray(fields["luminance"], np.float64)
    phi_i = np.asarray(fields["phi_i"], np.float64)
    return MeasuredTables(
        phi_i=_f32(phi_i.astype(np.float32)),
        theta_i=_f32(np.asarray(fields["theta_i"], np.float64).astype(
            np.float32)),
        wavelengths=_f32(np.asarray(fields["wavelengths"],
                                    np.float64).astype(np.float32)),
        vndf=_build_warp(vndf),
        luminance=_build_warp(lum),
        ndf=_f32(np.asarray(fields["ndf"], np.float32)),
        sigma=_f32(np.asarray(fields["sigma"], np.float32)),
        spectra=_f32(np.asarray(fields["spectra"], np.float32)),
        isotropic=phi_i.shape[0] <= 2,
        jacobian=bool(np.asarray(fields["jacobian"]).ravel()[0]))


def _warp_to(w, device) -> WarpTables:
    return WarpTables(*(_f32(getattr(w, k), device)
                        for k in ("cw", "cond_cdf", "marg_cdf", "total")),
                      ry=int(w.ry), rx=int(w.rx))


def tables_from(tbl, device="cpu") -> MeasuredTables:
    """Tables with the fields of ``MeasuredTables`` (the port's or the JAX
    package's) as float32 tensors on ``device``."""
    arr = {k: _f32(getattr(tbl, k), device)
           for k in ("phi_i", "theta_i", "wavelengths", "ndf", "sigma",
                     "spectra")}
    return MeasuredTables(vndf=_warp_to(tbl.vndf, device),
                          luminance=_warp_to(tbl.luminance, device),
                          isotropic=bool(tbl.isotropic),
                          jacobian=bool(tbl.jacobian), **arr)


# ---------------------------------------------------------------------------
# parameter interpolation
# ---------------------------------------------------------------------------

def _take(flat, idx):
    """flat[idx] with the index clipped to the array (jnp.take's
    mode="clip")."""
    return flat[torch.clamp(idx, 0, flat.shape[0] - 1).long()]


def _param_weight(coords, value):
    """(index, lerp weight) of ``value`` in the sorted ``coords``; a
    1-entry array does not interpolate."""
    n = int(coords.shape[0])
    if n == 1:
        z = torch.zeros_like(value)
        return z.to(torch.int32), z
    idx = torch.clamp(torch.searchsorted(coords, value.contiguous(),
                                         right=True) - 1, 0, n - 2)
    c0 = coords[idx]
    c1 = coords[idx + 1]
    w = torch.clamp((value - c0) / torch.clamp(c1 - c0, min=1e-9), 0.0, 1.0)
    return idx.to(torch.int32), w


def _corner_ids(tbl: MeasuredTables, phi_i, theta_i):
    """The 4 parameter-corner slice ids and weights of (phi_i, theta_i)."""
    P = int(tbl.phi_i.shape[0])
    T = int(tbl.theta_i.shape[0])
    pi_, pw = _param_weight(tbl.phi_i, phi_i)
    ti_, tw = _param_weight(tbl.theta_i, theta_i)
    ids, wts = [], []
    for dp in (0, 1):
        for dt in (0, 1):
            p = torch.clamp(pi_ + dp, max=P - 1)
            t = torch.clamp(ti_ + dt, max=T - 1)
            ids.append(p * T + t)
            wts.append((pw if dp else (1.0 - pw))
                       * (tw if dt else (1.0 - tw)))
    return ids, wts


def _blend(arrs_flat, ids, wts, inner, j):
    """Corner-blended gather: sum_k w_k A[ids_k * inner + j]."""
    acc = 0.0
    for i, w in zip(ids, wts):
        acc = acc + w * _take(arrs_flat, i.long() * inner + j)
    return acc


# ---------------------------------------------------------------------------
# histogram warp: sample / invert (vectorised binary search)
# ---------------------------------------------------------------------------

def _bsearch(cdf_at, n, target):
    """Smallest j in [0, n) with cdf_at(j) >= target (inclusive cdf)."""
    lo = torch.zeros(target.shape, dtype=torch.int64, device=target.device)
    hi = torch.full_like(lo, n - 1)
    for _ in range(max(1, math.ceil(math.log2(max(n, 2))))):
        mid = (lo + hi) // 2
        go_hi = cdf_at(mid) < target
        lo = torch.where(go_hi, torch.clamp(mid + 1, max=n - 1), lo)
        hi = torch.where(go_hi, hi, mid)
    return hi


def _total(w: WarpTables, ids, wts):
    return sum(wt * _take(w.total, i.long()) for i, wt in zip(ids, wts))


def warp_sample(w: WarpTables, ids, wts, ux, uy):
    """Uniform (ux, uy) -> (x, y) distributed per the table density, and
    that density with respect to the unit square."""
    ny, nx = w.ry - 1, w.rx - 1
    total = _total(w, ids, wts)
    ty = uy * total
    marg_flat = w.marg_cdf.reshape(-1)

    def marg_at(j):
        return _blend(marg_flat, ids, wts, ny, j)

    j = _bsearch(marg_at, ny, ty)
    cdf_jm1 = torch.where(j > 0, marg_at(torch.clamp(j - 1, min=0)), 0.0)
    row_mass = torch.clamp(marg_at(j) - cdf_jm1, min=1e-12)
    fy = torch.clamp((ty - cdf_jm1) / row_mass, 0.0, 1.0)
    y = (j.to(torch.float32) + fy) / ny

    tx = ux * row_mass
    cond_flat = w.cond_cdf.reshape(-1)

    def cond_at(i):
        return _blend(cond_flat, ids, wts, ny * nx, j * nx + i)

    i = _bsearch(cond_at, nx, tx)
    ccdf_im1 = torch.where(i > 0, cond_at(torch.clamp(i - 1, min=0)), 0.0)
    cell = torch.clamp(cond_at(i) - ccdf_im1, min=1e-12)
    fx = torch.clamp((tx - ccdf_im1) / cell, 0.0, 1.0)
    x = (i.to(torch.float32) + fx) / nx
    dens = cell * (nx * ny) / total
    return x, y, dens


def warp_invert(w: WarpTables, ids, wts, x, y):
    """The inverse of ``warp_sample``: (x, y) -> (ux, uy, density)."""
    ny, nx = w.ry - 1, w.rx - 1
    total = _total(w, ids, wts)
    j = torch.clamp((y * ny).to(torch.int64), 0, ny - 1)
    fy = y * ny - j.to(torch.float32)
    i = torch.clamp((x * nx).to(torch.int64), 0, nx - 1)
    fx = x * nx - i.to(torch.float32)
    marg_flat = w.marg_cdf.reshape(-1)
    cond_flat = w.cond_cdf.reshape(-1)

    def marg_at(jj):
        return _blend(marg_flat, ids, wts, ny, jj)

    def cond_at(ii):
        return _blend(cond_flat, ids, wts, ny * nx, j * nx + ii)

    cdf_jm1 = torch.where(j > 0, marg_at(torch.clamp(j - 1, min=0)), 0.0)
    row_mass = torch.clamp(marg_at(j) - cdf_jm1, min=1e-12)
    ccdf_im1 = torch.where(i > 0, cond_at(torch.clamp(i - 1, min=0)), 0.0)
    cell = torch.clamp(cond_at(i) - ccdf_im1, min=1e-12)
    uy = (cdf_jm1 + fy * row_mass) / torch.clamp(total, min=1e-12)
    ux = (ccdf_im1 + fx * cell) / row_mass
    dens = cell * (nx * ny) / torch.clamp(total, min=1e-12)
    return ux, uy, dens


# ---------------------------------------------------------------------------
# bilinear field lookups
# ---------------------------------------------------------------------------

def eval_grid2d(grid, x, y):
    """Bilinear node interpolation of a (ry, rx) grid on [0, 1]^2."""
    ry, rx = int(grid.shape[0]), int(grid.shape[1])
    gx = torch.clamp(x, 0.0, 1.0) * (rx - 1)
    gy = torch.clamp(y, 0.0, 1.0) * (ry - 1)
    x0 = torch.clamp(gx.to(torch.int64), 0, rx - 2)
    y0 = torch.clamp(gy.to(torch.int64), 0, ry - 2)
    tx = gx - x0
    ty = gy - y0
    flat = grid.reshape(-1)

    def at(yy, xx):
        return _take(flat, yy * rx + xx)
    v0 = at(y0, x0) * (1 - tx) + at(y0, x0 + 1) * tx
    v1 = at(y0 + 1, x0) * (1 - tx) + at(y0 + 1, x0 + 1) * tx
    return v0 * (1 - ty) + v1 * ty


def eval_spectra(tbl: MeasuredTables, ids, wts, lam, x, y):
    """spectra(phi_i, theta_i, lambda, y, x), blended over the parameters
    and the wavelength (the reference's Warp2D3.eval)."""
    P, T, W, rs_y, rs_x = (int(s) for s in tbl.spectra.shape)
    li, lw = _param_weight(tbl.wavelengths, lam)
    flat = tbl.spectra.reshape(-1)
    gx = torch.clamp(x, 0.0, 1.0) * (rs_x - 1)
    gy = torch.clamp(y, 0.0, 1.0) * (rs_y - 1)
    x0 = torch.clamp(gx.to(torch.int64), 0, rs_x - 2)
    y0 = torch.clamp(gy.to(torch.int64), 0, rs_y - 2)
    tx = gx - x0
    ty = gy - y0
    li = li.long()

    def node(pt, wl, yy, xx):
        return _take(flat, (pt.long() * W + wl) * (rs_y * rs_x)
                     + yy * rs_x + xx)

    acc = 0.0
    for pt, pw in zip(ids, wts):
        for dl in (0, 1):
            wl = torch.clamp(li + dl, max=W - 1)
            ww = pw * (lw if dl else (1.0 - lw))
            v0 = (node(pt, wl, y0, x0) * (1 - tx)
                  + node(pt, wl, y0, x0 + 1) * tx)
            v1 = (node(pt, wl, y0 + 1, x0) * (1 - tx)
                  + node(pt, wl, y0 + 1, x0 + 1) * tx)
            acc = acc + ww * (v0 * (1 - ty) + v1 * ty)
    return acc


# ---------------------------------------------------------------------------
# the measured BSDF (measured.cpp:173-385)
# ---------------------------------------------------------------------------

def _elevation(d: Vec3):
    """Numerically stable acos(d.z) (measured.cpp:166-170)."""
    dz = d.z - 1.0
    dist = torch.sqrt(d.x * d.x + d.y * d.y + dz * dz)
    return 2.0 * torch.asin(torch.clamp(0.5 * dist, 0.0, 1.0))


def _u2theta(u):
    return u * u * (math.pi / 2.0)


def _u2phi(u):
    return (2.0 * u - 1.0) * math.pi


def _theta2u(theta):
    return torch.sqrt(torch.clamp(theta * (2.0 / math.pi), min=0.0))


def _phi2u(phi):
    return (phi + math.pi) * (0.5 / math.pi)


# the three representative wavelengths of the rgb variant's channels
RGB_WAVELENGTHS = (611.0, 549.0, 465.0)


def _spectrum3(tbl, ids, wts, x, y, wavelengths):
    if wavelengths is None:
        lams = [torch.full_like(x, lam) for lam in RGB_WAVELENGTHS]
    else:
        lams = [wavelengths.x, wavelengths.y, wavelengths.z]
    return Vec3(*(eval_spectra(tbl, ids, wts, lam, x, y) for lam in lams))


def _lum_density(tbl, ids, wts, x, y):
    """The luminance warp's normalised histogram density at (x, y)."""
    w = tbl.luminance
    ny, nx = w.ry - 1, w.rx - 1
    total = _total(w, ids, wts)
    j = torch.clamp((y * ny).to(torch.int64), 0, ny - 1)
    i = torch.clamp((x * nx).to(torch.int64), 0, nx - 1)
    cell = _blend(w.cw.reshape(-1), ids, wts, ny * nx, j * nx + i)
    return cell * (nx * ny) / torch.clamp(total, min=1e-12)


def _fr_common(tbl: MeasuredTables, wi: Vec3, wo: Vec3, wavelengths):
    """f_r(wi, wo) cos(wo) and the sampling pdf of wo (measured.cpp
    eval / pdf), and the lanes where both lie above the surface."""
    active = (wi.z > 0.0) & (wo.z > 0.0)
    hx, hy, hz = wi.x + wo.x, wi.y + wo.y, wi.z + wo.z
    hl = torch.sqrt(torch.clamp(hx * hx + hy * hy + hz * hz, min=1e-18))
    m = Vec3(hx / hl, hy / hl, hz / hl)

    theta_i = _elevation(wi)
    phi_i = torch.atan2(wi.y, wi.x)
    theta_m = _elevation(m)
    phi_m = torch.atan2(m.y, m.x)

    u_wi_x = _theta2u(theta_i)
    u_wi_y = _phi2u(phi_i)
    phi_rel = phi_m - phi_i if tbl.isotropic else phi_m
    um_x = _theta2u(theta_m)
    um_y = _phi2u(phi_rel)
    um_y = um_y - torch.floor(um_y)

    ids, wts = _corner_ids(tbl, phi_i, theta_i)
    sx, sy, vndf_pdf = warp_invert(tbl.vndf, ids, wts, um_x, um_y)

    spec = _spectrum3(tbl, ids, wts, sx, sy, wavelengths)
    if tbl.jacobian:
        nd = eval_grid2d(tbl.ndf, um_x, um_y)
        sg = eval_grid2d(tbl.sigma, u_wi_x, u_wi_y)
        spec = spec * (nd / torch.clamp(4.0 * sg, min=1e-12))

    # the pdf of the sampled wo (measured.cpp pdf():354-365)
    sin_m = torch.sqrt(torch.clamp(1.0 - m.z * m.z, min=0.0))
    dot_wim = wi.x * m.x + wi.y * m.y + wi.z * m.z
    jacobian = torch.clamp(2.0 * math.pi ** 2 * um_x * sin_m,
                           min=1e-6) * 4.0 * dot_wim
    lum_dens = _lum_density(tbl, ids, wts, sx, sy)
    pdf = vndf_pdf * lum_dens / jacobian
    spec = Vec3(torch.where(active, spec.x, 0.0),
                torch.where(active, spec.y, 0.0),
                torch.where(active, spec.z, 0.0))
    return spec, torch.where(active, pdf, 0.0), active


def measured_eval_pdf_sample(tbl: MeasuredTables, wi: Vec3, wo_nee: Vec3,
                             s2x, s2y, wavelengths=None):
    """The dispatch entry: the NEE value and pdf at ``wo_nee`` and a
    sampled direction with its weight (measured.cpp sample():174-276), as
    the analytic BSDFs' record. The RGL spectra include the cosine
    foreshortening (the reference's BSDF::eval returns f_r cos(wo))."""
    from . import BSDFSampleResult
    val_nee, pdf_nee, _ = _fr_common(tbl, wi, wo_nee, wavelengths)

    # sampling: the luminance warp, then the VNDF warp
    active = wi.z > 0.0
    theta_i = _elevation(wi)
    phi_i = torch.atan2(wi.y, wi.x)
    ids, wts = _corner_ids(tbl, phi_i, theta_i)
    # the reference swaps the 2D sample's components (measured.cpp:205)
    lx, ly, lum_dens = warp_sample(tbl.luminance, ids, wts, s2y, s2x)
    um_x, um_y, vndf_pdf = warp_sample(tbl.vndf, ids, wts, lx, ly)

    phi_m = _u2phi(um_y)
    theta_m = _u2theta(um_x)
    if tbl.isotropic:
        phi_m = phi_m + phi_i
    sin_t = torch.sin(theta_m)
    cos_t = torch.cos(theta_m)
    m = Vec3(torch.cos(phi_m) * sin_t, torch.sin(phi_m) * sin_t, cos_t)

    dot_wim = wi.x * m.x + wi.y * m.y + wi.z * m.z
    jac = torch.clamp(2.0 * math.pi ** 2 * um_x * sin_t,
                      min=1e-6) * 4.0 * dot_wim
    two_dot = 2.0 * dot_wim
    wo = Vec3(m.x * two_dot - wi.x, m.y * two_dot - wi.y,
              m.z * two_dot - wi.z)
    pdf = vndf_pdf * lum_dens / jac

    # (lx, ly), the VNDF warp's input, are the spectra's coordinates
    spec = _spectrum3(tbl, ids, wts, lx, ly, wavelengths)
    if tbl.jacobian:
        nd = eval_grid2d(tbl.ndf, um_x, um_y)
        sg = eval_grid2d(tbl.sigma, _theta2u(theta_i), _phi2u(phi_i))
        spec = spec * (nd / torch.clamp(4.0 * sg, min=1e-12))

    ok = active & (wo.z > 0.0) & (pdf > 0.0)
    inv_pdf = torch.where(ok, 1.0 / torch.clamp(pdf, min=1e-18), 0.0)
    weight = Vec3(spec.x * inv_pdf, spec.y * inv_pdf, spec.z * inv_pdf)
    false_ = torch.zeros_like(active)
    return BSDFSampleResult(
        val_nee=val_nee, pdf_nee=pdf_nee, wo=wo, weight=weight,
        pdf=torch.where(ok, pdf, 0.0), eta=torch.ones_like(pdf),
        sampled_delta=false_, sampled_null=false_)


__all__ = ["WarpTables", "MeasuredTables", "build_tables", "tables_from",
           "measured_eval_pdf_sample", "warp_sample",
           "warp_invert", "eval_grid2d", "eval_spectra", "RGB_WAVELENGTHS"]
