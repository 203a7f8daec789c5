"""Participating media and phase functions (port of the JAX package's
``media/__init__.py``: ``homogeneous`` and ``heterogeneous`` media with the
``isotropic``, ``hg``, ``rayleigh``, ``blendphase``, ``tabphase`` and
``sggx`` phases; reference src/media/{homogeneous,heterogeneous}.cpp,
src/phase/{isotropic,hg,rayleigh,blendphase,tabphase,sggx}.cpp).

A medium compiles to one row of the medium table (the ``M_*`` columns,
the JAX package's layout); a heterogeneous medium's density grid rides a
flat atlas and an SGGX phase's 6-channel S grid a (V, 6) atlas
(``render/scene.py``), which ``integrators/volpath.py`` samples. The
phase kernel of a row is its ``M_PHASE`` code: 0 HG (isotropic at g = 0;
a blendphase reduces to an HG of the weight-interpolated g, as in the
JAX package), 1 SGGX, 2 Rayleigh, 3 tabulated (the table is the scene's
``tab_phase_tables`` entry).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import warp
from ..core.math import PI, TWO_PI
from ..core.properties import Properties, register_plugin
from ..core.vec import Vec3, coordinate_system, normalize

PHASE_ISOTROPIC = 0
PHASE_HG = 1
PHASE_RAYLEIGH = 2
PHASE_SGGX = 3
PHASE_TAB = 4

N_MED_PARAMS = 27
M_SIGMA_T = 0    # rgb extinction (heterogeneous: gray base, the grid scales)
M_ALBEDO = 3     # rgb single-scattering albedo
M_G = 6          # HG asymmetry
M_SCALE = 7
M_MAXD = 8       # heterogeneous: majorant scale * max(grid); 0 = homogeneous
M_GRID_OFF = 9   # heterogeneous: offset into the flat grid atlas
M_NX = 10        # grid resolution
M_NY = 11
M_NZ = 12
M_PHASE = 13     # phase kernel: 0 = isotropic / HG (M_G), 1 = SGGX,
                 # 2 = Rayleigh, 3 = tabulated
M_SGGX = 14      # SGGX S entries Sxx, Syy, Szz, Sxy, Sxz, Syz (14:20)
M_ST_PEAK = 20   # spectral variant: sigma_t's peak; M_SIGMA_T then holds
                 # the sigmoid coefficients of sigma_t / peak
M_SGGX_OFF = 21  # S grid: first row in the (V, 6) atlas sa.sggx_grid,
M_SGGX_NX = 22   # and its resolution; NX == 0 means the constant S of
M_SGGX_NY = 23   # M_SGGX. The world -> grid transform is a column of
M_SGGX_NZ = 24   # sa.sggx_w2g (12, n_media).
M_FILTER = 25    # grid interpolation: 0 = trilinear, 1 = nearest
M_SAMPLE_EM = 26  # 1 = NEE from medium events (medium.h sample_emitters)


def _get_rgb(props, key, default):
    v = props.get(key, default)
    from ..spectra import Spectrum
    from ..textures import Texture
    from ..volumes import Volume
    if isinstance(v, (Spectrum, Texture, Volume)):
        return np.asarray(v.mean_rgb())
    if isinstance(v, dict):
        v = v.get("value")
    a = np.asarray(v, dtype=np.float64).reshape(-1)
    if a.size == 1:
        a = np.repeat(a, 3)
    return a[:3]


class PhaseFunction:
    type_id = PHASE_ISOTROPIC
    g = 0.0

    def __init__(self, props: Properties):
        self.id = props.id


@register_plugin("phase", "isotropic")
class IsotropicPhase(PhaseFunction):
    """reference src/phase/isotropic.cpp."""
    type_id = PHASE_ISOTROPIC


@register_plugin("phase", "hg")
class HGPhase(PhaseFunction):
    """Henyey-Greenstein (reference src/phase/hg.cpp)."""
    type_id = PHASE_HG

    def __init__(self, props: Properties):
        super().__init__(props)
        self.g = props.get_float("g", 0.8)


@register_plugin("phase", "rayleigh")
class RayleighPhase(PhaseFunction):
    """reference src/phase/rayleigh.cpp."""
    type_id = PHASE_RAYLEIGH


@register_plugin("phase", "blendphase")
class BlendPhase(PhaseFunction):
    """reference src/phase/blendphase.cpp, as the JAX package has it: an
    HG whose g is the weight-interpolated g of the two children (the
    reference mixes the two phases; ROADMAP Queue C)."""

    def __init__(self, props: Properties):
        super().__init__(props)
        children = [v for _, v in props.objects()
                    if isinstance(v, PhaseFunction)]
        w = props.get_float("weight", 0.5)
        gs = [getattr(c, "g", 0.0) for c in children] or [0.0]
        self.g = float((1 - w) * gs[0] + w * (gs[-1]))
        self.type_id = PHASE_HG if abs(self.g) > 1e-4 else PHASE_ISOTROPIC


@register_plugin("phase", "tabphase")
class TabulatedPhase(PhaseFunction):
    """reference src/phase/tabphase.cpp — a piecewise-linear phase
    function of cos(theta) over [-1, 1] (forward convention: theta between
    the propagation direction and wo), sampled by the exact inverse of the
    trapezoid CDF (ContinuousDistribution, distr_1d.h)."""
    type_id = PHASE_TAB

    def __init__(self, props: Properties):
        super().__init__(props)
        vals = props.get("values", [1.0])
        if isinstance(vals, str):
            vals = [float(x) for x in vals.replace(",", " ").split()]
        v = np.asarray(vals, np.float64)
        if v.size < 2:
            v = np.repeat(v, 2)
        if (v < 0).any() or v.max() <= 0:
            raise RuntimeError("tabphase: values must be >= 0, not all 0")
        self.values = v
        cos = np.linspace(-1, 1, len(v))
        self.g = float((v * cos).sum() / max(v.sum(), 1e-9))


@register_plugin("phase", "sggx")
class SGGXPhase(PhaseFunction):
    """SGGX specular microflakes (reference src/phase/sggx.cpp,
    include/mitsuba/render/microflake.h; Heitz et al. 2015). S comes from
    a constvolume of six values, or, varying in space, from a 6-channel
    gridvolume looked up trilinearly at each interaction."""
    type_id = PHASE_SGGX

    def __init__(self, props: Properties):
        super().__init__(props)
        from ..volumes import GridVolume, Volume
        S = None
        self.S_grid = None   # a 6-channel GridVolume, or None
        for key, v in props.objects():
            if isinstance(v, GridVolume):
                if v.data.shape[-1] < 6:
                    raise RuntimeError(
                        "sggx: S gridvolume must have 6 channels "
                        "(Sxx, Syy, Szz, Sxy, Sxz, Syz), got "
                        f"{v.data.shape[-1]}")
                self.S_grid = v
                # the channel means stay as the row's constant S
                S = v.data[..., :6].reshape(-1, 6).mean(
                    axis=0).astype(np.float64)
            elif isinstance(v, Volume):
                vals = getattr(v, "values_raw", None)
                if vals is None:
                    vals = getattr(v, "value", None)
                S = np.asarray(vals, np.float64).reshape(-1)
        if S is None and props.has_property("S"):
            S = np.asarray(props.get("S"), np.float64).reshape(-1)
        if S is None or S.size < 6:
            raise RuntimeError("sggx: provide an 'S' volume with six values "
                               "(Sxx, Syy, Szz, Sxy, Sxz, Syz)")
        self.S = S[:6]


def sggx_not_pd(S6) -> np.ndarray:
    """Which rows of (..., 6) SGGX entries (Sxx, Syy, Szz, Sxy, Sxz, Syz)
    are not positive definite (a leading principal minor <= 0)."""
    sxx, syy, szz, sxy, sxz, syz = np.moveaxis(
        np.asarray(S6, np.float64)[..., :6], -1, 0)
    det = (sxx * syy * szz - sxx * syz * syz - syy * sxz * sxz
           - szz * sxy * sxy + 2.0 * sxy * sxz * syz)
    return (sxx <= 0.0) | (sxx * syy - sxy * sxy <= 0.0) | (det <= 0.0)


def warn_sggx_not_pd(medium) -> int:
    """Warn, through the logger, when a medium's SGGX S is not positive
    definite: its constant S, or the texels of its S grid. The phase then
    takes |det S|, as the JAX package does, which can make fireflies.
    Returns the count of such S (0 for other phases)."""
    phase = medium.phase
    if phase.type_id != PHASE_SGGX:
        return 0
    grid = phase.S_grid
    bad = sggx_not_pd(phase.S if grid is None
                      else grid.data[..., :6].reshape(-1, 6))
    n_bad = int(np.count_nonzero(bad))
    if n_bad:
        from ..core.logger import WARN, log
        where_ = ("its constant S" if grid is None
                  else f"{n_bad} of {bad.size} texels of its S grid")
        log(WARN, "medium '%s': the SGGX S is not positive definite in %s; "
            "the phase takes |det S| there", medium.id, where_)
    return n_bad


class Medium:
    def __init__(self, props: Properties):
        self.id = props.id
        self.phase = None
        for key, v in props.objects():
            if isinstance(v, PhaseFunction):
                self.phase = v
        if self.phase is None:
            self.phase = IsotropicPhase(Properties("isotropic"))

    def params_row(self) -> np.ndarray:
        return np.zeros(N_MED_PARAMS)


@register_plugin("medium", "homogeneous")
class HomogeneousMedium(Medium):
    """reference src/media/homogeneous.cpp — constant sigma_t and albedo
    (or sigma_s and sigma_a), times ``scale``."""

    def __init__(self, props: Properties):
        super().__init__(props)
        self.scale = props.get_float("scale", 1.0)
        if props.has_property("sigma_t"):
            self.sigma_t = _get_rgb(props, "sigma_t", [1, 1, 1]) * self.scale
            self.albedo = _get_rgb(props, "albedo", [0.75, 0.75, 0.75])
        else:
            sigma_s = _get_rgb(props, "sigma_s", [1, 1, 1]) * self.scale
            sigma_a = _get_rgb(props, "sigma_a", [0.5, 0.5, 0.5]) * self.scale
            self.sigma_t = sigma_s + sigma_a
            self.albedo = sigma_s / np.maximum(self.sigma_t, 1e-9)
        self.sample_emitters = props.get_bool("sample_emitters", True)

    def params_row(self):
        p = np.zeros(N_MED_PARAMS)
        p[M_SIGMA_T:M_SIGMA_T + 3] = self.sigma_t
        p[M_ALBEDO:M_ALBEDO + 3] = self.albedo
        p[M_G] = getattr(self.phase, "g", 0.0)
        p[M_SCALE] = self.scale
        p[M_SAMPLE_EM] = 1.0 if self.sample_emitters else 0.0
        tid = self.phase.type_id
        if tid == PHASE_SGGX:
            p[M_PHASE] = 1.0
            p[M_SGGX:M_SGGX + 6] = self.phase.S
        elif tid == PHASE_RAYLEIGH:
            p[M_PHASE] = 2.0
        elif tid == PHASE_TAB:
            p[M_PHASE] = 3.0
        return p


@register_plugin("medium", "heterogeneous")
class HeterogeneousMedium(HomogeneousMedium):
    """reference src/media/heterogeneous.cpp: sigma_t(x) = scale * grid(x)
    for a ``gridvolume`` sigma_t, sampled by delta tracking and shadowed
    by ratio tracking against the majorant scale * max(grid)
    (integrators/volpath.py). Extinction is gray (the grid's first
    channel); albedo stays rgb. Any other sigma_t volume reduces to the
    homogeneous medium of its mean."""

    def __init__(self, props: Properties):
        from ..volumes import GridVolume, Volume
        self.grid = None
        sigma_t_vol = None
        for key, v in props.objects():
            if isinstance(v, Volume) and key == "sigma_t":
                sigma_t_vol = v
        if isinstance(sigma_t_vol, GridVolume):
            self.grid = sigma_t_vol
            # gray base; the grid carries the spatial variation
            props["sigma_t"] = {"type": "rgb", "value": [1.0, 1.0, 1.0]}
        elif sigma_t_vol is not None:
            props["sigma_t"] = {"type": "rgb",
                                "value": list(sigma_t_vol.mean_rgb())}
        super().__init__(props)

    def params_row(self):
        p = super().params_row()
        if self.grid is not None:
            p[M_MAXD] = self.scale * self.grid.max()
            g = self.grid.scalar_grid()
            p[M_NX], p[M_NY], p[M_NZ] = g.shape[2], g.shape[1], g.shape[0]
            p[M_FILTER] = 1.0 if self.grid.filter_type == "nearest" else 0.0
        return p


# ---------------------------------------------------------------------------
# Device-side phase sampling and eval (component-wise)
# ---------------------------------------------------------------------------

def hg_sample(wi: Vec3, g, s1, s2):
    """Sample HG around -wi (forward convention: wo distributed about the
    propagation direction d = -wi). Returns (wo, pdf)."""
    d = -wi
    g_safe = torch.where(torch.abs(g) < 1e-3, 1e-3, g)
    sqr_term = (1.0 - g * g) / (1.0 - g + 2.0 * g * s1)
    cos_theta = torch.where(
        torch.abs(g) < 1e-3,
        1.0 - 2.0 * s1,
        (1.0 + g * g - sqr_term * sqr_term) / (2.0 * g_safe))
    return _about(d, cos_theta, s2), hg_eval(cos_theta, g)


def hg_eval(cos_forward, g):
    """HG phase, forward convention: cos_forward = dot(propagation, wo);
    peaks at +1 for g > 0 (reference hg.cpp's 1 + g^2 + 2g dot(wi, wo)
    with wi toward the source)."""
    denom = 1.0 + g * g - 2.0 * g * cos_forward
    return (1.0 / (4.0 * PI)) * (1.0 - g * g) / torch.clamp(
        denom * torch.sqrt(torch.clamp(denom, min=1e-12)), min=1e-12)


def _sggx_quad(S, a: Vec3, b: Vec3):
    """a^T S b for the symmetric S = (Sxx, Syy, Szz, Sxy, Sxz, Syz)."""
    sxx, syy, szz, sxy, sxz, syz = S
    return (a.x * b.x * sxx + a.y * b.y * syy + a.z * b.z * szz
            + (a.x * b.y + a.y * b.x) * sxy
            + (a.x * b.z + a.z * b.x) * sxz
            + (a.y * b.z + a.z * b.y) * syz)


def sggx_projected_area(w: Vec3, S):
    """sqrt(w^T S w) (reference microflake.h:118-128)."""
    sxx, syy, szz, sxy, sxz, syz = S
    s2 = (w.x * w.x * sxx + w.y * w.y * syy + w.z * w.z * szz
          + 2.0 * (w.x * w.y * sxy + w.x * w.z * sxz + w.y * w.z * syz))
    return torch.sqrt(torch.clamp(s2, min=1e-18))


def sggx_ndf_pdf(wm: Vec3, S):
    """The SGGX normal distribution (reference microflake.h:86-103)."""
    sxx, syy, szz, sxy, sxz, syz = S
    det = torch.abs(sxx * syy * szz - sxx * syz * syz - syy * sxz * sxz
                    - szz * sxy * sxy + 2.0 * sxy * sxz * syz)
    den = (wm.x * wm.x * (syy * szz - syz * syz)
           + wm.y * wm.y * (sxx * szz - sxz * sxz)
           + wm.z * wm.z * (sxx * syy - sxy * sxy)
           + 2.0 * (wm.x * wm.y * (sxz * syz - szz * sxy)
                    + wm.x * wm.z * (sxy * syz - syy * sxz)
                    + wm.y * wm.z * (sxy * sxz - sxx * syz)))
    detc = torch.clamp(det, min=0.0)
    return detc * torch.sqrt(detc) / (PI * torch.clamp(den * den,
                                                         min=1e-18))


def sggx_sample_vndf(wi: Vec3, s2x, s2y, S):
    """A visible microflake normal (reference microflake.h:36-60)."""
    ek, ej = coordinate_system(wi)
    ei = wi
    s_kk = _sggx_quad(S, ek, ek)
    s_jj = _sggx_quad(S, ej, ej)
    s_ii = _sggx_quad(S, ei, ei)
    s_kj = _sggx_quad(S, ek, ej)
    s_ki = _sggx_quad(S, ek, ei)
    s_ji = _sggx_quad(S, ej, ei)
    det = (s_kk * s_jj * s_ii - s_kk * s_ji * s_ji - s_jj * s_ki * s_ki
           - s_ii * s_kj * s_kj + 2.0 * s_kj * s_ki * s_ji)
    inv_sqrt_ii = torch.rsqrt(torch.clamp(s_ii, min=1e-18))
    tmp = torch.sqrt(torch.clamp(s_jj * s_ii - s_ji * s_ji, min=1e-18))
    mk0 = torch.sqrt(torch.abs(det)) / tmp
    mj0 = -inv_sqrt_ii * (s_ki * s_ji - s_kj * s_ii) / tmp
    mj1 = inv_sqrt_ii * tmp
    mi0, mi1, mi2 = inv_sqrt_ii * s_ki, inv_sqrt_ii * s_ji, \
        inv_sqrt_ii * s_ii
    uvw = warp.cosine_hemisphere_c(s2x, s2y)
    lx = uvw.x * mk0 + uvw.y * mj0 + uvw.z * mi0
    ly = uvw.y * mj1 + uvw.z * mi1
    lz = uvw.z * mi2
    ln = torch.sqrt(torch.clamp(lx * lx + ly * ly + lz * lz, min=1e-18))
    lx, ly, lz = lx / ln, ly / ln, lz / ln
    return normalize(ek * lx + ej * ly + ei * lz)


def sggx_sample(wi: Vec3, s2x, s2y, S):
    """Specular microflake scattering: ``wi`` (toward where the light came
    from) reflected about a sampled visible normal; the pdf is the phase
    value (sggx.cpp:86-105)."""
    m = sggx_sample_vndf(wi, s2x, s2y, S)
    d = 2.0 * (wi.x * m.x + wi.y * m.y + wi.z * m.z)
    wo = normalize(Vec3(m.x * d - wi.x, m.y * d - wi.y, m.z * d - wi.z))
    return wo, 0.25 * sggx_ndf_pdf(m, S) / sggx_projected_area(wi, S)


def sggx_eval(wi: Vec3, wo: Vec3, S):
    """sggx.cpp eval: D(h) / (4 sigma(wi)) with h = normalize(wi + wo)."""
    h = normalize(wi + wo)
    return 0.25 * sggx_ndf_pdf(h, S) / sggx_projected_area(wi, S)


def rayleigh_eval(cos_theta):
    return 3.0 / (16.0 * PI) * (1.0 + cos_theta * cos_theta)


def _cbrt(x):
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def rayleigh_sample(wi: Vec3, s1, s2):
    """The exact inverse CDF of the Rayleigh phase about the propagation
    direction -wi (reference src/phase/rayleigh.cpp): c^3 + 3c = 4(2u - 1)
    by Cardano."""
    z = 4.0 * (2.0 * s1 - 1.0)
    disc = torch.sqrt(z * z + 4.0)
    cos_theta = torch.clamp(_cbrt(0.5 * (z + disc)) + _cbrt(0.5 * (z - disc)),
                            -1.0, 1.0)
    return _about(-wi, cos_theta, s2), rayleigh_eval(cos_theta)


def _about(d: Vec3, cos_theta, s2):
    """The direction at angle acos(cos_theta) from ``d``, azimuth 2 pi s2."""
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    phi = TWO_PI * s2
    t1, t2 = coordinate_system(d)
    return (t1 * (sin_theta * torch.cos(phi))
            + t2 * (sin_theta * torch.sin(phi)) + d * cos_theta)


def tab_phase_tables(values):
    """Host tables of a tabulated phase: (grid, vals, cdf, inv_norm), the
    cdf the trapezoid integral of the piecewise-linear pdf (reference
    ContinuousDistribution, distr_1d.h), float32 as the JAX package's."""
    v = np.asarray(values, np.float64)
    grid = np.linspace(-1.0, 1.0, v.size)
    seg = 0.5 * (v[:-1] + v[1:]) * (grid[1] - grid[0])
    cdf = np.concatenate([[0.0], np.cumsum(seg)])
    total = cdf[-1]
    return (grid.astype(np.float32), v.astype(np.float32),
            (cdf / total).astype(np.float32), np.float32(1.0 / total))


def _interp(x, xp, fp):
    """Piecewise-linear interpolation of (xp, fp) at x, clamped to the
    end values outside [xp[0], xp[-1]] (numpy's interp)."""
    k = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1,
                    k - 1)
    x0, x1 = xp[i - 1], xp[i]
    f0, f1 = fp[i - 1], fp[i]
    f = f0 + (x - x0) / (x1 - x0) * (f1 - f0)
    f = torch.where(x <= xp[0], fp[0], f)
    return torch.where(x >= xp[-1], fp[-1], f)


def tab_eval(cos_theta, grid, vals, inv_norm):
    """The normalized solid-angle phase value (tabphase.cpp:100-116:
    eval_pdf_normalized / (2 pi)); ``grid`` and ``vals`` are tensors on
    the lanes' device."""
    return _interp(cos_theta, grid, vals) * inv_norm * (1.0 / TWO_PI)


def tab_sample(wi: Vec3, s1, s2, grid, vals, cdf, inv_norm):
    """The exact inverse of the trapezoid CDF: the segment, then the
    quadratic of its linear pdf (ContinuousDistribution::sample)."""
    k = grid.shape[0]
    i = torch.clamp(torch.searchsorted(cdf, s1.contiguous(), right=True) - 1,
                    0, k - 2)
    f0 = vals[i]
    f1 = vals[i + 1]
    dx = grid[1] - grid[0]
    a_rem = (s1 - cdf[i]) / inv_norm      # un-normalized area into segment
    slope = (f1 - f0) / dx
    # (slope / 2) x^2 + f0 x - a_rem = 0
    disc = torch.sqrt(torch.clamp(f0 * f0 + 2.0 * slope * a_rem, min=0.0))
    steep = torch.abs(slope) > 1e-9
    x_lin = torch.where(steep, (disc - f0) / torch.where(steep, slope, 1.0),
                        a_rem / torch.clamp(f0, min=1e-12))
    cos_theta = torch.clamp(grid[i] + x_lin, -1.0, 1.0)
    return (_about(-wi, cos_theta, s2),
            tab_eval(cos_theta, grid, vals, inv_norm))


__all__ = ["PhaseFunction", "IsotropicPhase", "HGPhase", "RayleighPhase",
           "BlendPhase", "TabulatedPhase", "SGGXPhase", "Medium",
           "HomogeneousMedium", "HeterogeneousMedium", "hg_sample",
           "hg_eval", "rayleigh_sample", "rayleigh_eval", "sggx_sample",
           "sggx_eval", "sggx_sample_vndf", "sggx_ndf_pdf",
           "sggx_projected_area", "tab_phase_tables", "tab_sample",
           "tab_eval", "N_MED_PARAMS", "M_SIGMA_T", "M_ALBEDO", "M_G",
           "M_SCALE", "M_MAXD", "M_GRID_OFF", "M_NX", "M_NY", "M_NZ",
           "sggx_not_pd", "warn_sggx_not_pd",
           "M_PHASE", "M_SGGX", "M_ST_PEAK", "M_SGGX_OFF", "M_SGGX_NX", "M_SGGX_NY",
           "M_SGGX_NZ", "M_FILTER", "M_SAMPLE_EM", "PHASE_ISOTROPIC",
           "PHASE_HG", "PHASE_RAYLEIGH", "PHASE_SGGX", "PHASE_TAB"]
