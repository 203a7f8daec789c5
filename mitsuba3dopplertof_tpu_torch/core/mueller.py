"""Mueller / Stokes polarization calculus for the polarized variants (port
of the JAX package's ``core/mueller.py``; reference
include/mitsuba/render/mueller.h and the polarized branch of fresnel.h
fresnel_polarized:227-273), in the component-wise SoA layout:

  * a Stokes vector is a 4-tuple of Vec3 (one Vec3 per Stokes component,
    the three channels inside the Vec3);
  * a Mueller matrix is a flat 16-tuple of Vec3, row-major.

Every entry is an (N,) tensor; rotators and the other elements that do
not depend on the wavelength share one tensor across the three channels.
Complex numbers are (re, im) pairs of real tensors, as in the JAX package.
"""

from __future__ import annotations

import torch

from .vec import Vec3, coordinate_system, cross, dot, normalize, where3

# ---------------------------------------------------------------------------
# complex helpers ((re, im) pairs of (N,) tensors)
# ---------------------------------------------------------------------------


def _c_mul(a, b):
    return a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0]


def _c_rcp(a):
    d = torch.clamp(a[0] * a[0] + a[1] * a[1], min=1e-20)
    return a[0] / d, -a[1] / d


def _c_sqrt(a):
    # the principal square root: re >= 0
    r = torch.sqrt(torch.clamp(a[0] * a[0] + a[1] * a[1], min=0.0))
    re = torch.sqrt(torch.clamp(0.5 * (r + a[0]), min=0.0))
    im = torch.sqrt(torch.clamp(0.5 * (r - a[0]), min=0.0))
    im = torch.where(a[1] < 0.0, -im, im)
    return re, im


def _c_abs2(a):
    return a[0] * a[0] + a[1] * a[1]


def _full_like(x, v):
    if torch.is_tensor(v):
        return v
    return torch.full_like(x, float(v))


def fresnel_polarized(cos_theta_i, eta_re, eta_im):
    """Complex s / p reflection amplitudes (reference fresnel.h:227-273,
    Verdet convention). Returns (a_s, a_p, cos_theta_t_signed, eta_it_re,
    eta_ti_re), a_s and a_p as (re, im) pairs. ``eta_im`` is the graphics
    convention's k >= 0 (conjugated inside, as the reference does for
    imag > 0)."""
    eta_re = _full_like(cos_theta_i, eta_re)
    eta_im = _full_like(cos_theta_i, eta_im)
    outside = cos_theta_i >= 0.0
    # the physics convention (negative kappa)
    eta = (eta_re, torch.where(eta_im > 0.0, -eta_im, eta_im))
    rcp_eta = _c_rcp(eta)
    eta_it = (torch.where(outside, eta[0], rcp_eta[0]),
              torch.where(outside, eta[1], rcp_eta[1]))
    eta_ti = (torch.where(outside, rcp_eta[0], eta[0]),
              torch.where(outside, rcp_eta[1], eta[1]))

    sin2_i = torch.clamp(1.0 - cos_theta_i * cos_theta_i, min=0.0)
    eta_ti2 = _c_mul(eta_ti, eta_ti)
    ctt2 = (1.0 - eta_ti2[0] * sin2_i, -eta_ti2[1] * sin2_i)
    ci = torch.abs(cos_theta_i)
    ctt = _c_sqrt(ctt2)
    # the root's sign follows sign(re(ctt2)) (the TIR phase, Clarke A.2)
    sgn = torch.where(ctt2[0] >= 0.0, 1.0, -1.0)
    ctt = (ctt[0] * sgn, ctt[1] * sgn)

    ec = _c_mul(eta_it, ctt)
    a_s_num = (ci - ec[0], -ec[1])
    a_s_den = (ci + ec[0], ec[1])
    a_s = _c_mul(a_s_num, _c_rcp(a_s_den))
    eci = (eta_it[0] * ci, eta_it[1] * ci)
    a_p_num = (eci[0] - ctt[0], eci[1] - ctt[1])
    a_p_den = (eci[0] + ctt[0], eci[1] + ctt[1])
    a_p = _c_mul(a_p_num, _c_rcp(a_p_den))

    matched = ((torch.abs(_c_abs2(eta) - 1.0) < 1e-9)
               & (torch.abs(eta[1]) < 1e-9))
    invalid = _c_abs2(eta) < 1e-12
    kill = matched | invalid
    a_s = (torch.where(kill, 0.0, a_s[0]), torch.where(kill, 0.0, a_s[1]))
    a_p = (torch.where(kill, 0.0, a_p[0]), torch.where(kill, 0.0, a_p[1]))

    ctt_signed = torch.where(ctt2[0] >= 0.0,
                             -torch.sign(cos_theta_i) * torch.abs(ctt[0]),
                             0.0)
    return a_s, a_p, ctt_signed, eta_it[0], eta_ti[0]


# ---------------------------------------------------------------------------
# Mueller matrices: flat 16-tuple of Vec3, row-major
# ---------------------------------------------------------------------------

def _v(x):
    """One per-lane tensor as a Vec3 (the three channels share it)."""
    return Vec3(x, x, x)


def mm_zero(z):
    zz = _v(torch.zeros_like(z))
    return tuple(zz for _ in range(16))


def mm_identity(z):
    o = _v(torch.ones_like(z))
    zz = _v(torch.zeros_like(z))
    return tuple(o if i % 5 == 0 else zz for i in range(16))


def mm_from_rows(rows):
    """rows: 16 entries, each a Vec3 or an (N,) tensor."""
    return tuple(e if isinstance(e, Vec3) else _v(e) for e in rows)


def depolarizer(value: Vec3):
    """The ideal depolarizer: only the (0, 0) element (mueller.h:37-41)."""
    z = torch.zeros_like(value.x)
    zz = Vec3(z, z, z)
    return (value,) + tuple(zz for _ in range(15))


def mm_mul(A, B):
    out = []
    for i in range(4):
        for j in range(4):
            acc = A[4 * i] * B[j]
            for k in range(1, 4):
                acc = acc + A[4 * i + k] * B[4 * k + j]
            out.append(acc)
    return tuple(out)


def mm_transpose(A):
    return tuple(A[4 * j + i] for i in range(4) for j in range(4))


def mm_scale(A, s):
    """Scale by a per-lane scalar or Vec3 (the reference's absorber)."""
    if not isinstance(s, Vec3):
        s = _v(s)
    return tuple(e * s for e in A)


def mm_where(mask, A, B):
    return tuple(where3(mask, a, b) for a, b in zip(A, B))


def mm_apply_stokes(A, S):
    """A @ S, S a 4-tuple of Vec3."""
    return tuple(A[4 * i] * S[0] + A[4 * i + 1] * S[1]
                 + A[4 * i + 2] * S[2] + A[4 * i + 3] * S[3]
                 for i in range(4))


def stokes_where(mask, S, T):
    return tuple(where3(mask, a, b) for a, b in zip(S, T))


def linear_polarizer(value=1.0, like=None):
    """mueller.h:65-73 (Collett ch. 5 eq. 13)."""
    a = 0.5 * value * torch.ones_like(like)
    z = torch.zeros_like(like)
    return mm_from_rows([a, a, z, z,
                         a, a, z, z,
                         z, z, z, z,
                         z, z, z, z])


def linear_retarder(phase):
    """mueller.h:91-101 (Goldstein eq. 6.43), fast axis horizontal."""
    s, c = torch.sin(phase), torch.cos(phase)
    o = torch.ones_like(phase)
    z = torch.zeros_like(phase)
    return mm_from_rows([o, z, z, z,
                         z, o, z, z,
                         z, z, c, s,
                         z, z, -s, c])


def right_circular_polarizer(like):
    h = 0.5 * torch.ones_like(like)
    z = torch.zeros_like(like)
    return mm_from_rows([h, z, z, h,
                         z, z, z, z,
                         z, z, z, z,
                         h, z, z, h])


def left_circular_polarizer(like):
    h = 0.5 * torch.ones_like(like)
    z = torch.zeros_like(like)
    return mm_from_rows([h, z, z, -h,
                         z, z, z, z,
                         z, z, z, z,
                         -h, z, z, h])


def rotator(theta):
    """Counter-clockwise rotation of the E field (mueller.h:137-147)."""
    s, c = torch.sin(2.0 * theta), torch.cos(2.0 * theta)
    o = torch.ones_like(theta)
    z = torch.zeros_like(theta)
    return mm_from_rows([o, z, z, z,
                         z, c, s, z,
                         z, -s, c, z,
                         z, z, z, o])


def rotated_element(theta, M):
    """R^T M R (mueller.h:152-158)."""
    R = rotator(theta)
    return mm_mul(mm_transpose(R), mm_mul(M, R))


def specular_reflection_mueller(cos_theta_i, eta_re, eta_im):
    """The Fresnel Mueller matrix of specular reflection
    (mueller.h:198-235), per channel: ``eta_re`` / ``eta_im`` are 3-tuples
    (conductors) or one value for all channels."""
    comps = []
    for ch in range(3):
        er = eta_re[ch] if isinstance(eta_re, (tuple, Vec3)) else eta_re
        ei = eta_im[ch] if isinstance(eta_im, (tuple, Vec3)) else eta_im
        a_s, a_p, _, _, _ = fresnel_polarized(cos_theta_i, er, ei)
        r_s = _c_abs2(a_s)
        r_p = _c_abs2(a_p)
        a = 0.5 * (r_s + r_p)
        b = 0.5 * (r_s - r_p)
        c = torch.sqrt(torch.clamp(r_s * r_p, min=0.0))
        # delta = arg(a_p) - arg(a_s), through a_p * conj(a_s)
        u = _c_mul(a_p, (a_s[0], -a_s[1]))
        nrm = torch.sqrt(torch.clamp(_c_abs2(u), min=1e-20))
        cos_d = torch.where(c == 0.0, 0.0, u[0] / nrm)
        sin_d = torch.where(c == 0.0, 0.0, u[1] / nrm)
        comps.append((a, b, c * cos_d, c * sin_d))
    z = torch.zeros_like(cos_theta_i)
    zz = Vec3(z, z, z)

    def V(k):
        return Vec3(comps[0][k], comps[1][k], comps[2][k])
    A, B, CC, CS = V(0), V(1), V(2), V(3)
    return (A, B, zz, zz,
            B, A, zz, zz,
            zz, zz, CC, -CS,
            zz, zz, CS, CC)


def specular_transmission_mueller(cos_theta_i, eta):
    """The Fresnel Mueller matrix of specular transmission
    (mueller.h:242-276), real eta (dielectrics)."""
    zero = torch.zeros_like(cos_theta_i)
    a_s, a_p, cos_theta_t, eta_it, eta_ti = fresnel_polarized(
        cos_theta_i, eta, zero)
    big = torch.abs(cos_theta_i) > 1e-8
    factor = -eta_it * torch.where(
        big, cos_theta_t / torch.where(big, cos_theta_i, 1.0), 0.0)
    a_s_r = 1.0 + a_s[0]
    a_p_r = (1.0 + a_p[0]) * eta_ti
    t_s = a_s_r * a_s_r
    t_p = a_p_r * a_p_r
    a = 0.5 * factor * (t_s + t_p)
    b = 0.5 * factor * (t_s - t_p)
    c = factor * torch.sqrt(torch.clamp(t_s * t_p, min=0.0))
    z = zero
    return mm_from_rows([a, b, z, z,
                         b, a, z, z,
                         z, z, c, z,
                         z, z, z, c])


# ---------------------------------------------------------------------------
# Stokes reference-frame rotations (mueller.h:285-407)
# ---------------------------------------------------------------------------

def stokes_basis(forward: Vec3) -> Vec3:
    return coordinate_system(forward)[0]


def _unit_angle(u: Vec3, v: Vec3):
    """The angle between unit vectors, stable near 0 and pi."""
    d = v - u
    half = 0.5 * torch.sqrt(torch.clamp(dot(d, d), min=0.0))
    return 2.0 * torch.asin(torch.clamp(half, 0.0, 1.0))


def rotate_stokes_basis(forward: Vec3, basis_current: Vec3,
                        basis_target: Vec3):
    """mueller.h:315-323."""
    bc = normalize(basis_current)
    bt = normalize(basis_target)
    theta = _unit_angle(bc, bt)
    theta = torch.where(dot(forward, cross(bc, bt)) < 0.0, -theta, theta)
    return rotator(theta)


def rotate_mueller_basis(M, in_forward, in_b_cur, in_b_tgt,
                         out_forward, out_b_cur, out_b_tgt):
    """R_out M R_in^T (mueller.h:361-371)."""
    R_in = rotate_stokes_basis(in_forward, in_b_cur, in_b_tgt)
    R_out = rotate_stokes_basis(out_forward, out_b_cur, out_b_tgt)
    return mm_mul(R_out, mm_mul(M, mm_transpose(R_in)))


def rotate_mueller_basis_collinear(M, forward, basis_current, basis_target):
    """R M R^T (mueller.h:400-406)."""
    R = rotate_stokes_basis(forward, basis_current, basis_target)
    return mm_mul(R, mm_mul(M, mm_transpose(R)))


__all__ = [
    "fresnel_polarized", "depolarizer", "linear_polarizer", "linear_retarder",
    "right_circular_polarizer", "left_circular_polarizer", "rotator",
    "rotated_element", "specular_reflection_mueller",
    "specular_transmission_mueller", "stokes_basis", "rotate_stokes_basis",
    "rotate_mueller_basis", "rotate_mueller_basis_collinear",
    "mm_zero", "mm_identity", "mm_mul", "mm_transpose", "mm_scale",
    "mm_where", "mm_apply_stokes", "mm_from_rows", "stokes_where",
]
