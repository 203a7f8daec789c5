"""Principled / principledthin lobe math (port of the JAX package's
``bsdfs/principled_impl.py``; reference src/bsdfs/principled.cpp,
principledhelpers.h and principledthin.cpp, Burley 2012/2015).

Both BSDFs are fused eval + pdf + sample functions over the parameter
table: diffuse + retro-reflection + fake subsurface (flatness) + tinted
sheen, anisotropic GGX main specular with the metallic / spec_tint
Schlick-blended Fresnel (principledhelpers.h:240-275), GTR1 clearcoat
(principledhelpers.h:22-60) and rough dielectric transmission
(spec_trans). The thin variant replaces refraction by reflect-and-flip
with the Burley-2015 scaled roughness (principledthin.cpp:360-380) and
adds diffuse transmission (diff_trans).

Sampling picks a lobe over [diffuse | clearcoat | spec_trans |
spec_reflect] with Fresnel at the sampled microfacet normal, while the pdf
re-derives the mixture at the half-vector of the given wo
(principled.cpp:374-417 vs :760-840); the weight is eval(wo) / pdf(wo),
as in the reference and the JAX package.
"""

from __future__ import annotations

import torch

from ..core import microfacet as mf
from ..core import warp
from ..core.fresnel import fresnel_dielectric
from ..core.math import PI, INV_PI
from ..core.vec import Vec3, dot, normalize, where3
from . import (BSDFSampleResult, P_REFL, P_TWOSIDED, P_ETA, P_PR_AX,
               P_PR_AY, P_METALLIC, P_SPECTUNE, P_PR_SHEEN, P_PR_SHEENTINT,
               P_PR_FLAT, P_PR_CC, P_PR_CCGLOSS, P_PR_STRANS, P_PR_DSRATE,
               P_PR_SSRATE, P_PR_CSRATE, P_PR_ROUGH)


def _luminance(c: Vec3):
    return 0.212671 * c.x + 0.715160 * c.y + 0.072169 * c.z


def _schlick_weight(cos_i):
    m = torch.clamp(1.0 - cos_i, 0.0, 1.0)
    return (m * m) * (m * m) * m


def _schlick_w(cos_theta_i, eta):
    """The Schlick weight with the transmitted-angle correction for eta < 1
    (principledhelpers.h calc_schlick)."""
    outside = cos_theta_i >= 0.0
    eta_it = torch.where(outside, eta, 1.0 / eta)
    eta_ti = torch.where(outside, 1.0 / eta, eta)
    ctt_sqr = 1.0 - (1.0 - cos_theta_i * cos_theta_i) * eta_ti * eta_ti
    cos_theta_t = torch.sqrt(torch.clamp(ctt_sqr, min=0.0))
    return torch.where(eta_it > 1.0, _schlick_weight(torch.abs(cos_theta_i)),
                       _schlick_weight(cos_theta_t))


def _calc_schlick1(r0: float, cos_theta_i, eta):
    return r0 + (1.0 - r0) * _schlick_w(cos_theta_i, eta)


def _calc_schlick3(r0: Vec3, cos_theta_i, eta) -> Vec3:
    w = _schlick_w(cos_theta_i, eta)
    return Vec3(r0.x + (1.0 - r0.x) * w, r0.y + (1.0 - r0.y) * w,
                r0.z + (1.0 - r0.z) * w)


def _schlick_r0_eta(eta):
    return ((eta - 1.0) / (eta + 1.0)) ** 2


def _mac_mic(m: Vec3, wi: Vec3, wo: Vec3, cos_i, reflection: bool):
    """Macro/micro surface compatibility (principledhelpers.h:199-212)."""
    s = torch.sign(cos_i)
    a = (wi.x * m.x + wi.y * m.y + wi.z * m.z) * s > 0.0
    if reflection:
        b = (wo.x * m.x + wo.y * m.y + wo.z * m.z) * s > 0.0
    else:
        b = (wo.x * m.x + wo.y * m.y + wo.z * m.z) * (-s) > 0.0
    return a & b


def _gtr1_eval(m_z, alpha):
    a2 = alpha * alpha
    res = (a2 - 1.0) / (PI * torch.log(a2) * (1.0 + (a2 - 1.0) * m_z * m_z))
    return torch.where(res * m_z > 1e-20, res, 0.0)


def _gtr1_pdf(m_z, alpha):
    return torch.where(m_z < 0.0, 0.0, m_z * _gtr1_eval(m_z, alpha))


def _gtr1_sample(alpha, s1, s2):
    phi = 2.0 * PI * s1
    a2 = alpha * alpha
    ct2 = (1.0 - torch.pow(a2, 1.0 - s2)) / (1.0 - a2)
    st = torch.sqrt(torch.clamp(1.0 - ct2, min=0.0))
    ct = torch.sqrt(torch.clamp(ct2, min=0.0))
    return Vec3(torch.cos(phi) * st, torch.sin(phi) * st, ct)


def _smith_ggx1(v: Vec3, wh: Vec3, alpha: float):
    """Separable GGX masking for the clearcoat lobe
    (principledhelpers.h:85-113)."""
    a2 = alpha * alpha
    ct = torch.abs(v.z)
    ct2 = ct * ct
    tan2 = (1.0 - ct2) / torch.clamp(ct2, min=1e-20)
    g = 2.0 / (1.0 + torch.sqrt(1.0 + a2 * tan2))
    g = torch.where(v.z == 1.0, 1.0, g)
    return torch.where(dot(v, wh) * v.z <= 0.0, 0.0, g)


def _reflect(w: Vec3, m: Vec3) -> Vec3:
    k = 2.0 * dot(w, m)
    return Vec3(k * m.x - w.x, k * m.y - w.y, k * m.z - w.z)


def _refract(w: Vec3, m: Vec3, cos_theta_t, eta_ti) -> Vec3:
    k = dot(w, m) * eta_ti + cos_theta_t
    return Vec3(k * m.x - eta_ti * w.x, k * m.y - eta_ti * w.y,
                k * m.z - eta_ti * w.z)


def _mulsign(v: Vec3, s) -> Vec3:
    sg = torch.sign(torch.where(s == 0.0, 1.0, s))
    return Vec3(v.x * sg, v.y * sg, v.z * sg)


def _tint(base: Vec3, lum) -> Vec3:
    """The base color normalized by its luminance (1 where that is 0)."""
    inv = 1.0 / torch.clamp(lum, min=1e-12)
    pos = lum > 0.0
    return Vec3(torch.where(pos, base.x * inv, 1.0),
                torch.where(pos, base.y * inv, 1.0),
                torch.where(pos, base.z * inv, 1.0))


def _base_color(param, tex_refl, tex_mask) -> Vec3:
    base = Vec3(param(P_REFL), param(P_REFL + 1), param(P_REFL + 2))
    if tex_refl is not None:
        base = where3(tex_mask, tex_refl, base)
    return base


def _diffuse_shape(cos_o, cos_i, cos_d, rough, flatness):
    """Burley diffuse with retro-reflection, blended with the fake
    subsurface term by flatness."""
    Fo = _schlick_weight(torch.abs(cos_o))
    Fi = _schlick_weight(torch.abs(cos_i))
    f_diff = (1.0 - 0.5 * Fi) * (1.0 - 0.5 * Fo)
    Rr = 2.0 * rough * cos_d * cos_d
    f_retro = Rr * (Fo + Fi + Fo * Fi * (Rr - 1.0))
    Fss90 = 0.5 * Rr
    Fss = (1.0 + (Fss90 - 1.0) * Fo) * (1.0 + (Fss90 - 1.0) * Fi)
    f_ss = 1.25 * (Fss * (1.0 / torch.clamp(
        torch.abs(cos_o) + torch.abs(cos_i), min=1e-12) - 0.5) + 0.5)
    return (1.0 - flatness) * (f_diff + f_retro) + flatness * f_ss


# ---------------------------------------------------------------------------
# principled
# ---------------------------------------------------------------------------

def principled_eval_pdf_sample(param, wi: Vec3, wo_nee: Vec3, s1, s2x, s2y,
                               tex_refl=None, tex_mask=None):
    """The full principled BSDF (reference principled.cpp)."""
    base = _base_color(param, tex_refl, tex_mask)
    two_sided = param(P_TWOSIDED) > 0.5
    sgn = torch.where(two_sided & (wi.z < 0.0), -1.0, 1.0)
    wi_l = Vec3(wi.x, wi.y, wi.z * sgn)
    cos_i = wi_l.z

    eta = param(P_ETA)
    eta = torch.where(eta <= 0.0, 1.5, eta)     # non-principled rows guard
    ax = torch.clamp(param(P_PR_AX), min=1e-4)
    ay = torch.clamp(param(P_PR_AY), min=1e-4)
    metallic = param(P_METALLIC)
    spec_tint = param(P_SPECTUNE)
    sheen = param(P_PR_SHEEN)
    sheen_tint = param(P_PR_SHEENTINT)
    flatness = param(P_PR_FLAT)
    clearcoat = param(P_PR_CC)
    cc_gloss = param(P_PR_CCGLOSS)
    strans = param(P_PR_STRANS)
    dsrate = param(P_PR_DSRATE)
    ssrate = param(P_PR_SSRATE)
    csrate = param(P_PR_CSRATE)
    rough = param(P_PR_ROUGH)

    brdf_w = (1.0 - metallic) * (1.0 - strans)
    bsdf_w = (1.0 - metallic) * strans
    front = cos_i > 0.0
    active0 = (cos_i != 0.0) & (front | (bsdf_w > 0.0))
    alpha_cc = 0.1 + (0.001 - 0.1) * cc_gloss
    inv_eta = 1.0 / eta
    eta_path = torch.where(front, eta, inv_eta)
    inv_eta_path = torch.where(front, inv_eta, eta)
    lum = _luminance(base)

    def lobe_probs(F):
        """Unnormalized (spec reflect, spec trans, clearcoat, diffuse)
        selection weights at the Fresnel value F."""
        p_sr = torch.where(front, ssrate * (1.0 - bsdf_w * (1.0 - F)), F)
        p_st = torch.where(front, ssrate * bsdf_w * (1.0 - F), 1.0 - F)
        p_st = torch.where(strans > 0.0, p_st, 0.0)
        p_cc = torch.where(front, 0.25 * clearcoat * csrate, 0.0)
        p_d = torch.where(front, brdf_w * dsrate, 0.0)
        return p_sr, p_st, p_cc, p_d

    def half_vector(wo: Vec3, reflect):
        s = torch.where(reflect, 1.0, eta_path)
        wh = normalize(Vec3(wi_l.x + wo.x * s, wi_l.y + wo.y * s,
                            wi_l.z + wo.z * s))
        return _mulsign(wh, wh.z)

    def mixture_pdf(wo: Vec3):
        """reference pdf() (principled.cpp:713-840)."""
        cos_o = wo.z
        reflect = cos_i * cos_o > 0.0
        refract = cos_i * cos_o < 0.0
        wh = half_vector(wo, reflect)
        F_sd, _, _, _ = fresnel_dielectric(dot(wi_l, wh), eta)
        p_sr, p_st, p_cc, p_d = lobe_probs(F_sd)
        rcp = 1.0 / torch.clamp(p_sr + p_st + p_cc + p_d, min=1e-12)

        dot_wi_h = dot(wi_l, wh)
        dot_wo_h = dot(wo, wh)
        dwh_dwo = torch.abs(torch.where(
            reflect,
            1.0 / torch.where(dot_wo_h == 0.0, 1e12, 4.0 * dot_wo_h),
            (eta_path * eta_path * dot_wo_h)
            / torch.clamp((dot_wi_h + eta_path * dot_wo_h) ** 2,
                          min=1e-12)))

        wi_f = _mulsign(wi_l, cos_i)
        pdf_m = mf.ggx_pdf_visible(wi_f, wh, ax, ay)
        mm_r = _mac_mic(wh, wi_l, wo, cos_i, True) & reflect
        mm_t = _mac_mic(wh, wi_l, wo, cos_i, False) & refract

        pdf = torch.where(mm_r, p_sr * rcp * pdf_m * dwh_dwo, 0.0)
        pdf = pdf + torch.where(
            reflect, p_d * rcp * INV_PI
            * torch.clamp(cos_o * torch.sign(cos_i), min=0.0), 0.0)
        pdf = pdf + torch.where(mm_t, p_st * rcp * pdf_m * dwh_dwo, 0.0)
        pdf = pdf + torch.where(mm_r, p_cc * rcp * _gtr1_pdf(wh.z, alpha_cc)
                                * dwh_dwo, 0.0)
        return torch.where(active0, pdf, 0.0)

    def eval_f(wo: Vec3) -> Vec3:
        """reference eval() (principled.cpp:494-712): f * cos."""
        cos_o = wo.z
        reflect = cos_i * cos_o > 0.0
        refract = cos_i * cos_o < 0.0
        wh = half_vector(wo, reflect)
        F_sd, _, _, _ = fresnel_dielectric(dot(wi_l, wh), eta)
        mm_r = _mac_mic(wh, wi_l, wo, cos_i, True)
        mm_t = _mac_mic(wh, wi_l, wo, cos_i, False)

        spec_refl_act = active0 & reflect & mm_r & (F_sd > 0.0)
        cc_act = active0 & (clearcoat > 0.0) & reflect & mm_r & front
        st_act = (active0 & (strans > 0.0) & (bsdf_w > 0.0) & refract & mm_t
                  & (F_sd < 1.0))
        diff_act = active0 & (brdf_w > 0.0) & reflect & front
        sheen_act = (active0 & (sheen > 0.0) & reflect
                     & (1.0 - metallic > 0.0) & front)

        D = mf.ggx_D(wh, ax, ay)
        G = mf.ggx_G(wi_l, wo, wh, ax, ay)
        dot_wi_h = dot(wi_l, wh)

        # principled_fresnel (principledhelpers.h:240-275)
        Fm = _calc_schlick3(base, dot_wi_h, eta)
        c_tint = _tint(base, lum)
        r0e = _schlick_r0_eta(torch.where(dot_wi_h >= 0.0, eta, inv_eta))
        Ft = _calc_schlick3(Vec3(c_tint.x * r0e, c_tint.y * r0e,
                                 c_tint.z * r0e), dot_wi_h, eta)
        f_front_base = (1.0 - metallic) * (1.0 - spec_tint) * F_sd
        Fp = Vec3(f_front_base + metallic * Fm.x
                  + (1.0 - metallic) * spec_tint * Ft.x,
                  f_front_base + metallic * Fm.y
                  + (1.0 - metallic) * spec_tint * Ft.y,
                  f_front_base + metallic * Fm.z
                  + (1.0 - metallic) * spec_tint * Ft.z)
        fb = bsdf_w * F_sd
        Fp = where3(front, Fp, Vec3(fb, fb, fb))

        spec_sc = torch.where(
            spec_refl_act,
            D * G / torch.clamp(4.0 * torch.abs(cos_i), min=1e-12), 0.0)
        val = Vec3(Fp.x * spec_sc, Fp.y * spec_sc, Fp.z * spec_sc)

        # specular transmission (radiance transport scale), sqrt tint
        dot_wo_h = dot(wo, wh)
        denom = torch.clamp((dot_wi_h + eta_path * dot_wo_h) ** 2, min=1e-12)
        st_sc = torch.where(
            st_act,
            bsdf_w * torch.abs(inv_eta_path * inv_eta_path
                               * (1.0 - F_sd) * D * G * eta_path * eta_path
                               * dot_wi_h * dot_wo_h
                               / (cos_i * denom)), 0.0)
        val = Vec3(val.x + torch.sqrt(torch.clamp(base.x, min=0.0)) * st_sc,
                   val.y + torch.sqrt(torch.clamp(base.y, min=0.0)) * st_sc,
                   val.z + torch.sqrt(torch.clamp(base.z, min=0.0)) * st_sc)

        # clearcoat (GTR1, Schlick 0.04, separable GGX1 G at alpha 0.25)
        Fcc = _calc_schlick1(0.04, dot_wi_h, eta)
        Dcc = _gtr1_eval(wh.z, alpha_cc)
        Gcc = _smith_ggx1(wi_l, wh, 0.25) * _smith_ggx1(wo, wh, 0.25)
        cc = torch.where(cc_act, 0.25 * clearcoat * Fcc * Dcc * Gcc
                         * torch.abs(cos_o), 0.0)
        val = Vec3(val.x + cc, val.y + cc, val.z + cc)

        # diffuse + retro + fake subsurface
        cos_d = dot(wh, wo)
        f_d = _diffuse_shape(cos_o, cos_i, cos_d, rough, flatness)
        dsc = torch.where(diff_act,
                          brdf_w * torch.abs(cos_o) * INV_PI * f_d, 0.0)
        val = Vec3(val.x + base.x * dsc, val.y + base.y * dsc,
                   val.z + base.z * dsc)

        # sheen (tinted towards the normalized base color)
        Fd = _schlick_weight(torch.abs(cos_d))
        shn = torch.where(sheen_act, sheen * (1.0 - metallic) * Fd
                          * torch.abs(cos_o), 0.0)
        return Vec3(val.x + shn * (1.0 + (c_tint.x - 1.0) * sheen_tint),
                    val.y + shn * (1.0 + (c_tint.y - 1.0) * sheen_tint),
                    val.z + shn * (1.0 + (c_tint.z - 1.0) * sheen_tint))

    # --- NEE direction ----------------------------------------------------
    wo_nee_l = Vec3(wo_nee.x, wo_nee.y, wo_nee.z * sgn)
    val_nee = eval_f(wo_nee_l)
    pdf_nee = mixture_pdf(wo_nee_l)

    # --- sampling (principled.cpp:332-493) --------------------------------
    wi_f = _mulsign(wi_l, cos_i)
    m_spec, _ = mf.ggx_sample_vndf(wi_f, ax, ay, s2x, s2y)
    F_m, cos_t_m, eta_it_m, eta_ti_m = fresnel_dielectric(
        dot(wi_l, m_spec), eta)
    p_sr, p_st, p_cc, p_d = lobe_probs(F_m)
    rcp = 1.0 / torch.clamp(p_sr + p_st + p_cc + p_d, min=1e-12)
    p_d, p_cc, p_st = p_d * rcp, p_cc * rcp, p_st * rcp

    pick_d = s1 < p_d
    pick_cc = (~pick_d) & (s1 < p_d + p_cc)
    pick_st = (~pick_d) & (~pick_cc) & (s1 < p_d + p_cc + p_st)

    wo_d = warp.cosine_hemisphere_c(s2x, s2y)
    m_cc = _gtr1_sample(alpha_cc, s2x, s2y)
    wo_cc = _reflect(wi_l, m_cc)
    wo_st = _refract(wi_l, m_spec, cos_t_m, eta_ti_m)
    wo_sr = _reflect(wi_l, m_spec)

    wo = where3(pick_d, wo_d,
                where3(pick_cc, wo_cc, where3(pick_st, wo_st, wo_sr)))
    ok_sr = (_mac_mic(m_spec, wi_l, wo_sr, cos_i, True)
             & (cos_i * wo_sr.z > 0.0))
    ok_st = (_mac_mic(m_spec, wi_l, wo_st, cos_i, False)
             & (cos_i * wo_st.z < 0.0))
    ok_cc = (_mac_mic(m_cc, wi_l, wo_cc, cos_i, True)
             & (cos_i * wo_cc.z > 0.0))
    ok_d = cos_i * wo_d.z > 0.0
    sel_ok = torch.where(pick_d, ok_d, torch.where(
        pick_cc, ok_cc, torch.where(pick_st, ok_st, ok_sr)))

    pdf_s = mixture_pdf(wo)
    # a sample whose selected lobe failed the macro/micro side test is a
    # rejection (principled.cpp:488-492): weight and pdf are both 0
    ok_w = active0 & sel_ok & (pdf_s > 1e-12)
    val_s = eval_f(wo)
    inv_pdf = torch.where(ok_w, 1.0 / torch.clamp(pdf_s, min=1e-12), 0.0)
    weight = Vec3(val_s.x * inv_pdf, val_s.y * inv_pdf, val_s.z * inv_pdf)
    pdf_out = torch.where(ok_w, pdf_s, 0.0)

    bs_eta = torch.where(pick_st & ok_w, eta_it_m, 1.0)
    false_ = torch.zeros_like(cos_i, dtype=torch.bool)
    return BSDFSampleResult(val_nee, pdf_nee, Vec3(wo.x, wo.y, wo.z * sgn),
                            weight, pdf_out, bs_eta, false_, false_)


# ---------------------------------------------------------------------------
# principledthin
# ---------------------------------------------------------------------------

def principledthin_eval_pdf_sample(param, wi: Vec3, wo_nee: Vec3, s1, s2x,
                                   s2y, tex_refl=None, tex_mask=None):
    """The thin principled BSDF (reference principledthin.cpp): a
    symmetric sheet whose lobes are specular reflect, specular "transmit"
    (reflect-and-flip with the scaled roughness), diffuse reflect (+retro,
    fake subsurface, sheen) and diffuse transmit; no metallic and no
    clearcoat."""
    base = _base_color(param, tex_refl, tex_mask)

    cos_ti = wi.z
    active0 = cos_ti != 0.0
    # the sheet is symmetric: work on the +z side, flip wo at the end
    sgn = torch.sign(torch.where(cos_ti == 0.0, 1.0, cos_ti))
    wi_l = Vec3(wi.x, wi.y, wi.z * sgn)
    cos_i = wi_l.z

    eta_t = param(P_ETA)
    eta_t = torch.where(eta_t <= 0.0, 1.5, eta_t)
    ax = torch.clamp(param(P_PR_AX), min=1e-4)
    ay = torch.clamp(param(P_PR_AY), min=1e-4)
    spec_tint = param(P_SPECTUNE)
    sheen = param(P_PR_SHEEN)
    sheen_tint = param(P_PR_SHEENTINT)
    flatness = param(P_PR_FLAT)
    diff_trans = param(P_PR_CC) * 0.5          # column reuse; range 0..2
    dt_srate = param(P_PR_CCGLOSS)             # column reuse
    strans = param(P_PR_STRANS)
    dsrate = param(P_PR_DSRATE)
    sr_srate = param(P_PR_SSRATE)
    st_srate = param(P_PR_CSRATE)              # column reuse
    rough = param(P_PR_ROUGH)
    lum = _luminance(base)

    # scaled distribution for thin transmission (Burley 2015, Fig. 15)
    aspect = torch.sqrt(torch.clamp(ay, min=1e-8) / torch.clamp(ax, min=1e-8))
    r_scaled = (0.65 * eta_t - 0.35) * rough
    axs = torch.clamp(r_scaled * r_scaled / aspect, min=1e-3)
    ays = torch.clamp(r_scaled * r_scaled * aspect, min=1e-3)

    p_sr = strans * sr_srate * 0.5
    p_st = strans * st_srate * 0.5
    p_dr = dsrate * (1.0 - strans) * (1.0 - diff_trans)
    p_dt = dt_srate * (1.0 - strans) * diff_trans
    rcp = 1.0 / torch.clamp(p_sr + p_st + p_dr + p_dt, min=1e-12)
    p_sr, p_st, p_dr, p_dt = p_sr * rcp, p_st * rcp, p_dr * rcp, p_dt * rcp

    def half_vector(wo_t: Vec3):
        wo_r = Vec3(wo_t.x, wo_t.y, torch.abs(wo_t.z))
        return wo_r, normalize(Vec3(wi_l.x + wo_r.x, wi_l.y + wo_r.y,
                                    wi_l.z + wo_r.z))

    def mixture_pdf(wo_t: Vec3):
        cos_o = wo_t.z
        reflect = cos_o > 0.0
        refract = cos_o < 0.0
        wo_r, wh = half_vector(wo_t)
        mm_r = _mac_mic(wh, wi_l, wo_t, cos_i, True) & reflect
        mm_t = _mac_mic(wh, wi_l, wo_t, cos_i, False) & refract
        dot_wor_wh = dot(wo_r, wh)
        dwh_dwo = torch.abs(1.0 / torch.where(dot_wor_wh == 0.0, 1e12,
                                              4.0 * dot_wor_wh))
        pdf = torch.where(mm_r & (strans > 0.0),
                          p_sr * mf.ggx_pdf_visible(wi_l, wh, ax, ay)
                          * dwh_dwo, 0.0)
        pdf = pdf + torch.where(mm_t & (strans > 0.0),
                                p_st * mf.ggx_pdf_visible(wi_l, wh, axs, ays)
                                * dwh_dwo, 0.0)
        pdf = pdf + torch.where(
            reflect, p_dr * INV_PI * torch.clamp(cos_o, min=0.0), 0.0)
        pdf = pdf + torch.where(
            refract, p_dt * INV_PI * torch.clamp(-cos_o, min=0.0), 0.0)
        return torch.where(active0, pdf, 0.0)

    def eval_f(wo_t: Vec3) -> Vec3:
        cos_o = wo_t.z
        reflect = cos_o > 0.0
        refract = cos_o < 0.0
        _, wh = half_vector(wo_t)
        mm_r = _mac_mic(wh, wi_l, wo_t, cos_i, True)
        mm_t = _mac_mic(wh, wi_l, wo_t, cos_i, False)
        F_sd, _, _, _ = fresnel_dielectric(dot(wi_l, wh), eta_t)

        sr_act = active0 & (strans > 0.0) & reflect & mm_r
        st_act = active0 & (strans > 0.0) & refract & mm_t
        dr_act = active0 & reflect & (strans < 1.0) & (diff_trans < 1.0)
        dt_act = active0 & refract & (strans < 1.0) & (diff_trans > 0.0)

        # thin fresnel blend (principledhelpers.h thin_fresnel)
        c_tint = _tint(base, lum)
        r0e = _schlick_r0_eta(eta_t)
        Fs = _calc_schlick3(Vec3(c_tint.x * r0e, c_tint.y * r0e,
                                 c_tint.z * r0e), dot(wi_l, wh), eta_t)
        F_thin = Vec3(F_sd + (Fs.x - F_sd) * spec_tint,
                      F_sd + (Fs.y - F_sd) * spec_tint,
                      F_sd + (Fs.z - F_sd) * spec_tint)

        D = mf.ggx_D(wh, ax, ay)
        G = mf.ggx_G(wi_l, wo_t, wh, ax, ay)
        sr_sc = torch.where(sr_act, strans * D * G
                            / torch.clamp(4.0 * cos_i, min=1e-12), 0.0)
        val = Vec3(F_thin.x * sr_sc, F_thin.y * sr_sc, F_thin.z * sr_sc)

        Ds = mf.ggx_D(wh, axs, ays)
        Gs = mf.ggx_G(wi_l, wo_t, wh, axs, ays)
        st_sc = torch.where(st_act, strans * (1.0 - F_sd) * Ds * Gs
                            / torch.clamp(4.0 * cos_i, min=1e-12), 0.0)
        val = Vec3(val.x + base.x * st_sc, val.y + base.y * st_sc,
                   val.z + base.z * st_sc)

        cos_d = dot(wh, wo_t)
        f_d = _diffuse_shape(cos_o, cos_i, cos_d, rough, flatness)
        dsc = torch.where(dr_act, (1.0 - strans) * cos_o * INV_PI
                          * (1.0 - diff_trans) * f_d, 0.0)
        val = Vec3(val.x + base.x * dsc, val.y + base.y * dsc,
                   val.z + base.z * dsc)

        Fd = _schlick_weight(torch.abs(cos_d))
        shn = torch.where(dr_act & (sheen > 0.0),
                          sheen * (1.0 - strans) * Fd * (1.0 - diff_trans)
                          * torch.abs(cos_o), 0.0)
        val = Vec3(val.x + shn * (1.0 + (c_tint.x - 1.0) * sheen_tint),
                   val.y + shn * (1.0 + (c_tint.y - 1.0) * sheen_tint),
                   val.z + shn * (1.0 + (c_tint.z - 1.0) * sheen_tint))

        dtc = torch.where(dt_act, (1.0 - strans) * diff_trans * INV_PI
                          * torch.abs(cos_o), 0.0)
        return Vec3(val.x + base.x * dtc, val.y + base.y * dtc,
                    val.z + base.z * dtc)

    wo_nee_t = Vec3(wo_nee.x, wo_nee.y, wo_nee.z * sgn)
    val_nee = eval_f(wo_nee_t)
    pdf_nee = mixture_pdf(wo_nee_t)

    # --- sampling ----------------------------------------------------------
    pick_sr = (strans > 0.0) & (s1 < p_sr)
    pick_st = (strans > 0.0) & (~pick_sr) & (s1 < p_sr + p_st)
    pick_dr = (~pick_sr) & (~pick_st) & (s1 < p_sr + p_st + p_dr)

    m_r, _ = mf.ggx_sample_vndf(wi_l, ax, ay, s2x, s2y)
    wo_sr = _reflect(wi_l, m_r)
    m_t, _ = mf.ggx_sample_vndf(wi_l, axs, ays, s2x, s2y)
    wo_rt = _reflect(wi_l, m_t)
    wo_st = Vec3(wo_rt.x, wo_rt.y, -wo_rt.z)
    wo_dr = warp.cosine_hemisphere_c(s2x, s2y)
    wo_dt = Vec3(wo_dr.x, wo_dr.y, -wo_dr.z)

    wo_t = where3(pick_sr, wo_sr,
                  where3(pick_st, wo_st, where3(pick_dr, wo_dr, wo_dt)))
    ok_sr = _mac_mic(m_r, wi_l, wo_sr, cos_i, True) & (wo_sr.z > 0.0)
    ok_st = _mac_mic(m_t, wi_l, wo_st, cos_i, False) & (wo_st.z < 0.0)
    sel_ok = torch.where(pick_sr, ok_sr,
                         torch.where(pick_st, ok_st, torch.ones_like(ok_st)))

    pdf_s = mixture_pdf(wo_t)
    # as in principled: a selection-rejected sample zeroes weight and pdf
    ok_w = active0 & sel_ok & (pdf_s > 1e-12)
    val_s = eval_f(wo_t)
    inv_pdf = torch.where(ok_w, 1.0 / torch.clamp(pdf_s, min=1e-12), 0.0)
    weight = Vec3(val_s.x * inv_pdf, val_s.y * inv_pdf, val_s.z * inv_pdf)
    pdf_out = torch.where(ok_w, pdf_s, 0.0)

    false_ = torch.zeros_like(cos_i, dtype=torch.bool)
    return BSDFSampleResult(val_nee, pdf_nee,
                            Vec3(wo_t.x, wo_t.y, wo_t.z * sgn), weight,
                            pdf_out, torch.ones_like(cos_i), false_, false_)
