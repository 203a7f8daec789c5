"""CIE colorimetry and spectral upsampling for the spectral variant (port
of the JAX package's ``core/cie.py``).

As in the JAX package (and the reference's spectral variants, reference
src/core/spectrum.cpp, ext/rgb2spec), a lane carries three hero
wavelengths, converts its samples to XYZ with analytic CIE 1931 colour
matching functions (Wyman, Sloan & Shirley 2013: multi-lobe Gaussians) and
upsamples rgb reflectances with the Jakob & Hanika sigmoid polynomial
S(lambda) = sigmoid(c2 x^2 + c1 x + c0), its coefficients fitted by a
small Gauss-Newton solve.

Two halves:

  * the host half, in numpy: the RGB <-> XYZ matrices adapted to this
    module's D65, the fit tables, the per-colour fit and the trilinear
    lookup into the coefficient lattice. Its colour matching functions are
    evaluated in float32, as the JAX package's are (through jnp), before
    the float64 numpy arithmetic;
  * the device half, in torch: the colour matching functions, the D65
    spectrum, the reflectance and emission spectra at per-lane
    wavelengths, ``hero_to_srgb``, and the batched fit that builds the
    coefficient lattice and the envmap's per-texel spectra (float64 on
    the scene's device, the JAX package's algorithm and schedule).

The 32^3 lattice is fitted once and cached under
``~/.cache/mitsuba3dopplertof_tpu_torch/``; ``set_coeff_lattice`` gives a
lattice from elsewhere (the tests give the JAX package's).

Wavelengths are in nanometres over [360, 830].
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .math import sqrt_rn

LAMBDA_MIN = 360.0
LAMBDA_MAX = 830.0
LAMBDA_RANGE = LAMBDA_MAX - LAMBDA_MIN

# sRGB primaries; the matrices below are adapted to this module's D65, so
# a flat unit spectrum maps to rgb (1, 1, 1) and back
_PRIMARIES_XY = np.array([[0.64, 0.33], [0.30, 0.60], [0.15, 0.06]])

_H, _C, _KB, _T = 6.62607015e-34, 2.99792458e8, 1.380649e-23, 6504.0


# ---------------------------------------------------------------------------
# device half: colour matching functions and spectra (float32 tensors)
# ---------------------------------------------------------------------------

def _g(x, mu, s1, s2):
    """Piecewise Gaussian of Wyman et al."""
    s = torch.where(x < mu, s1, s2)
    t = (x - mu) / s
    return torch.exp(-0.5 * t * t)


def cie_xbar(lam):
    return (1.056 * _g(lam, 599.8, 37.9, 31.0)
            + 0.362 * _g(lam, 442.0, 16.0, 26.7)
            - 0.065 * _g(lam, 501.1, 20.4, 26.2))


def cie_ybar(lam):
    return (0.821 * _g(lam, 568.8, 46.9, 40.5)
            + 0.286 * _g(lam, 530.9, 16.3, 31.1))


def cie_zbar(lam):
    return (1.217 * _g(lam, 437.0, 11.8, 36.0)
            + 0.681 * _g(lam, 459.0, 26.0, 13.8))


def _p560() -> float:
    lm560 = 560e-9
    return (1.0 / (lm560 ** 5)) / (np.exp(_H * _C / (lm560 * _KB * _T))
                                   - 1.0)


def d65_spd(lam):
    """Approximate D65: Planck at 6504 K normalised to 1 at 560 nm. The
    JAX package's float32 arithmetic step for step: lm^5 as
    lm * ((lm lm)(lm lm)) and hc / (lm kb T) as a true division."""
    lm = lam * 1e-9
    lm2 = lm * lm
    lm5 = lm * (lm2 * lm2)
    hc = torch.tensor(_H * _C, dtype=lam.dtype, device=lam.device)
    planck = (1.0 / lm5) / (torch.exp(torch.div(hc, lm * _KB * _T)) - 1.0)
    return planck / _p560()


def xyz_weights(lam):
    """The colour matching functions at ``lam``: the per-sample weights of
    the Monte Carlo spectral-to-XYZ conversion."""
    return cie_xbar(lam), cie_ybar(lam), cie_zbar(lam)


def eval_reflectance_spectrum(c0, c1, c2, lam):
    """The sigmoid-polynomial spectrum at per-lane wavelengths."""
    x = (lam - LAMBDA_MIN) / LAMBDA_RANGE * 2.0 - 1.0
    p = c2 * x * x + c1 * x + c0
    return 0.5 + p / (2.0 * sqrt_rn(1.0 + p * p))


def eval_emission_spectrum(c0, c1, c2, scale, lam, inv_norm):
    """Emission SPD scale * S(coeffs, lambda) * D65(lambda) / int D65 ybar
    (reference srgb.cpp's emission upsampling: a chromaticity spectrum
    times D65, the luminance restored by ``scale``); ``inv_norm`` is
    1 / d65_y_norm()."""
    return (scale * eval_reflectance_spectrum(c0, c1, c2, lam)
            * d65_spd(lam) * inv_norm)


def hero_wavelengths(u):
    """The three hero wavelengths of a uniform draw ``u``: u + k/3,
    wrapped to [0, 1), over [LAMBDA_MIN, LAMBDA_MAX] (the reference's
    spectral variants draw the wavelength sample right after the sensor's
    draws, integrator.cpp:497-499)."""
    from .vec import Vec3

    def hero(k):
        v = u + k * (1.0 / 3.0)
        v = v - torch.floor(v)
        return LAMBDA_MIN + v * LAMBDA_RANGE
    return Vec3(hero(0), hero(1), hero(2))


def hero_to_srgb(spec, wavelengths):
    """Linear sRGB from the three hero-wavelength samples riding a Vec3:
    XYZ = (range / 3) sum_i v_i cmf(lambda_i) (each wavelength has pdf
    1 / range), then XYZ -> sRGB. Linear in the samples, so converting
    before the film splat equals converting at develop."""
    from .vec import Vec3
    K = LAMBDA_RANGE / 3.0
    xs = [xyz_weights(lam) for lam in
          (wavelengths.x, wavelengths.y, wavelengths.z)]
    vals = (spec.x, spec.y, spec.z)
    X = K * sum(v * c[0] for v, c in zip(vals, xs))
    Y = K * sum(v * c[1] for v, c in zip(vals, xs))
    Z = K * sum(v * c[2] for v, c in zip(vals, xs))
    M = [[float(v) for v in row] for row in _matrices()[0]]
    return Vec3(M[0][0] * X + M[0][1] * Y + M[0][2] * Z,
                M[1][0] * X + M[1][1] * Y + M[1][2] * Z,
                M[2][0] * X + M[2][1] * Y + M[2][2] * Z)


# ---------------------------------------------------------------------------
# host half (numpy; the colour matching functions in float32)
# ---------------------------------------------------------------------------

def _cmf_f32(lam: np.ndarray):
    """(3, L) colour matching functions and (L,) D65 at ``lam`` rounded to
    float32, evaluated in float32 on the CPU, as numpy float32 arrays."""
    t = torch.tensor(np.asarray(lam), dtype=torch.float32)
    cm = np.stack([cie_xbar(t).numpy(), cie_ybar(t).numpy(),
                   cie_zbar(t).numpy()])
    return cm, d65_spd(t).numpy()


_MAT_CACHE = {}


def _matrices():
    """(xyz2rgb, rgb2xyz) as float64 numpy arrays: the primaries' XYZ
    directions scaled so that rgb (1, 1, 1) maps to this module's D65
    white (Y = 1)."""
    if "xyz2rgb" not in _MAT_CACHE:
        lam = np.linspace(LAMBDA_MIN, LAMBDA_MAX, 2048)
        cm, d = _cmf_f32(lam)
        W = np.trapezoid(cm * d[None, :], lam, axis=1)
        W = W / W[1]
        xyY = _PRIMARIES_XY
        P = np.stack([xyY[:, 0] / xyY[:, 1],
                      np.ones(3),
                      (1.0 - xyY[:, 0] - xyY[:, 1]) / xyY[:, 1]])
        scale = np.linalg.solve(P, W)
        rgb2xyz = P * scale[None, :]
        _MAT_CACHE["rgb2xyz"] = rgb2xyz
        _MAT_CACHE["xyz2rgb"] = np.linalg.inv(rgb2xyz)
    return _MAT_CACHE["xyz2rgb"], _MAT_CACHE["rgb2xyz"]


def xyz_to_srgb_np(xyz: np.ndarray) -> np.ndarray:
    return xyz @ _matrices()[0].T


def srgb_to_xyz_np(rgb: np.ndarray) -> np.ndarray:
    return rgb @ _matrices()[1].T


_Y_INT = None


def y_integral() -> float:
    """int ybar over [LAMBDA_MIN, LAMBDA_MAX]."""
    global _Y_INT
    if _Y_INT is None:
        lam = np.linspace(LAMBDA_MIN, LAMBDA_MAX, 2048)
        _Y_INT = float(np.trapezoid(_cmf_f32(lam)[0][1], lam))
    return _Y_INT


_D65_Y_NORM = None


def d65_y_norm() -> float:
    """int D65 ybar: the luminance normalisation of the reflectance fit
    and of emission spectra, so that a directly viewed emitter reproduces
    its rgb after the XYZ -> sRGB step (float64 numpy throughout, as in the
    JAX package)."""
    global _D65_Y_NORM
    if _D65_Y_NORM is None:
        lam = np.linspace(LAMBDA_MIN, LAMBDA_MAX, 2048)

        def g(x, mu, s1, s2):
            sd = np.where(x < mu, s1, s2)
            return np.exp(-0.5 * ((x - mu) / sd) ** 2)

        y = (0.821 * g(lam, 568.8, 46.9, 40.5)
             + 0.286 * g(lam, 530.9, 16.3, 31.1))
        lm = lam * 1e-9
        planck = (1.0 / lm ** 5) / (np.exp(_H * _C / (lm * _KB * _T)) - 1.0)
        _D65_Y_NORM = float(np.trapezoid(planck / _p560() * y, lam))
    return _D65_Y_NORM


def _sigmoid(x):
    return 0.5 + x / (2.0 * np.sqrt(1.0 + x * x))


def _spectrum_np(coeffs, lam):
    x = (lam - LAMBDA_MIN) / LAMBDA_RANGE * 2.0 - 1.0
    p = coeffs[2] * x * x + coeffs[1] * x + coeffs[0]
    return _sigmoid(p)


_FIT_LAM = np.linspace(LAMBDA_MIN, LAMBDA_MAX, 128)
_FIT_X = None


def _fit_tables():
    """(3, L) weights taking a spectrum on _FIT_LAM to XYZ under D65,
    normalised by int D65 ybar."""
    global _FIT_X
    if _FIT_X is None:
        cm, d65 = _cmf_f32(_FIT_LAM)
        norm = np.trapezoid(d65 * cm[1], _FIT_LAM)
        _FIT_X = (cm * d65[None, :]) / norm
    return _FIT_X


def rgb_of_coeffs(coeffs: np.ndarray) -> np.ndarray:
    X = _fit_tables()
    S = _spectrum_np(coeffs, _FIT_LAM)
    xyz = np.trapezoid(X * S[None, :], _FIT_LAM, axis=1)
    return xyz_to_srgb_np(xyz)


def fit_reflectance_coeffs(rgb, iters: int = 60) -> np.ndarray:
    """Sigmoid-polynomial coefficients reproducing ``rgb`` under D65: a
    Gauss-Newton solve on the rgb residual, first with a smoothness prior
    on the slope and curvature (the rgb2spec objective's smooth basin),
    then unregularised. The JAX package's numpy code, step for step."""
    rgb = np.clip(np.asarray(rgb, np.float64), 1e-4, 0.9999)
    y = float(srgb_to_xyz_np(rgb)[1])
    y = min(max(y, 1e-3), 0.999)
    c = np.array([np.arctanh(2.0 * y - 1.0) if 0 < y < 1 else 0.0, 0.0, 0.0])

    def residual(c):
        return rgb_of_coeffs(c) - rgb

    def run(c, w_smooth, iters):
        def res(cc):
            return np.concatenate([residual(cc), w_smooth * cc])

        lam_reg = 1e-6
        r = res(c)
        for _ in range(iters):
            J = np.zeros((6, 3))
            eps = 1e-4
            for j in range(3):
                cp = c.copy()
                cp[j] += eps
                J[:, j] = (res(cp) - r) / eps
            try:
                step = np.linalg.solve(J.T @ J + lam_reg * np.eye(3),
                                       -J.T @ r)
            except np.linalg.LinAlgError:
                break
            c_new = c + step
            r_new = res(c_new)
            if np.linalg.norm(r_new) < np.linalg.norm(r):
                c, r = c_new, r_new
                lam_reg = max(lam_reg * 0.5, 1e-8)
            else:
                lam_reg *= 4.0
            if np.linalg.norm(r[:3]) < 1e-6:
                break
        return c

    c = run(c, np.array([0.0, 3e-3, 3e-3]), iters)
    c = run(c, np.zeros(3), 20)
    return c.astype(np.float32)


# ---------------------------------------------------------------------------
# batched fit (torch float64 on the scene's device) and the lattice
# ---------------------------------------------------------------------------

def _trapezoid(y, x):
    """np.trapezoid along the last axis."""
    d = x[1:] - x[:-1]
    return torch.sum(d * (y[..., 1:] + y[..., :-1]) / 2.0, dim=-1)


def fit_reflectance_coeffs_batch(rgbs, iters: int = 60,
                                 device=None) -> np.ndarray:
    """(N, 3) float32 coefficients of N colours at once: the per-colour
    fit's two-phase schedule as one vectorised Gauss-Newton with an
    accept / reject step per colour (the JAX package's batched fit), in
    float64 on ``device`` (default: the CPU)."""
    dev = torch.device(device) if device is not None else torch.device("cpu")
    f64 = torch.float64
    rgbs_np = np.clip(np.asarray(rgbs, np.float64), 1e-4, 0.9999)
    n = rgbs_np.shape[0]
    rgbs = torch.tensor(rgbs_np, dtype=f64, device=dev)
    X = torch.tensor(np.asarray(_fit_tables(), np.float64), device=dev)
    lam = torch.tensor(_FIT_LAM, dtype=f64, device=dev)
    xg = (lam - LAMBDA_MIN) / LAMBDA_RANGE * 2.0 - 1.0
    basis = torch.stack([torch.ones_like(xg), xg, xg * xg])    # (3, L)
    xyz2rgb, rgb2xyz = _matrices()
    M = torch.tensor(xyz2rgb, dtype=f64, device=dev)
    XM = M @ X                                                 # (3, L)

    y = (rgbs @ torch.tensor(rgb2xyz, dtype=f64, device=dev).T)[:, 1]
    y = torch.clamp(y, 1e-3, 0.999)
    c = torch.zeros((n, 3), dtype=f64, device=dev)
    c[:, 0] = torch.atanh(2.0 * y - 1.0)
    eye = torch.eye(3, dtype=f64, device=dev)

    def rgb_res(cc):
        p = cc @ basis
        S = 0.5 + p / (2.0 * torch.sqrt(1.0 + p * p))
        return _trapezoid(X[None] * S[:, None, :], lam) @ M.T - rgbs

    def gn(c, w_smooth, iters):
        ws = torch.tensor(w_smooth, dtype=f64, device=dev)
        WtW = torch.diag(ws) @ torch.diag(ws)
        lam_reg = torch.full((n,), 1e-6, dtype=f64, device=dev)
        for _ in range(iters):
            p = c @ basis                                      # (N, L)
            den = 1.0 + p * p
            dS = 0.5 / den ** 1.5
            r = rgb_res(c)                                     # (N, 3)
            w = dS[:, None, :] * basis[None, :, :]             # (N, 3, L)
            J = _trapezoid(XM[None, :, None, :] * w[:, None, :, :], lam)
            A = (torch.einsum("nki,nkj->nij", J, J) + WtW
                 + lam_reg[:, None, None] * eye)
            b = -torch.einsum("nki,nk->ni", J, r) - c @ WtW
            try:
                step = torch.linalg.solve(A, b[..., None])[..., 0]
            except RuntimeError:
                break
            c_new = c + step
            r_new = rgb_res(c_new)
            better = (torch.linalg.norm(r_new, dim=1)
                      + torch.linalg.norm(c_new * ws, dim=1)
                      < torch.linalg.norm(r, dim=1)
                      + torch.linalg.norm(c * ws, dim=1))
            c = torch.where(better[:, None], c_new, c)
            lam_reg = torch.where(better,
                                  torch.clamp(lam_reg * 0.5, min=1e-8),
                                  lam_reg * 4.0)
        return c

    c = gn(c, [0.0, 3e-3, 3e-3], iters)
    c = gn(c, [0.0, 0.0, 0.0], 20)
    return c.to(torch.float32).cpu().numpy()


_LATTICE = None
_LATTICE_N = 32
_GIVEN_LATTICE = None       # set_coeff_lattice's


def lattice_cache_path(n: int = _LATTICE_N) -> str:
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "mitsuba3dopplertof_tpu_torch", f"rgb2spec_{n}.npz")


def fit_coeff_lattice(n: int = _LATTICE_N, device=None) -> np.ndarray:
    """(n, n, n, 3) coefficients over the sRGB cube, fitted now (no
    cache): chunks of 2048 colours on the CPU, one batch on a card."""
    g = np.linspace(0.0, 1.0, n)
    r, gg, b = np.meshgrid(g, g, g, indexing="ij")
    rgbs = np.stack([r, gg, b], axis=-1).reshape(-1, 3)
    dev = torch.device(device) if device is not None else torch.device("cpu")
    chunk = 2048 if dev.type == "cpu" else 1 << 15
    coeffs = np.concatenate(
        [fit_reflectance_coeffs_batch(rgbs[i:i + chunk], device=dev)
         for i in range(0, rgbs.shape[0], chunk)], axis=0)
    return coeffs.reshape(n, n, n, 3)


def coeff_lattice(n: int = _LATTICE_N, device=None) -> np.ndarray:
    """The (n, n, n, 3) coefficient lattice over the sRGB cube: from
    memory, else the disk cache, else fitted on ``device`` and cached (the
    role of the reference's .coeff tables)."""
    global _LATTICE
    if _LATTICE is not None and _LATTICE.shape[0] == n:
        return _LATTICE
    path = lattice_cache_path(n)
    if os.path.exists(path):
        _LATTICE = np.load(path)["lattice"]
        return _LATTICE
    _LATTICE = fit_coeff_lattice(n, device)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez_compressed(tmp, lattice=_LATTICE)
    os.replace(tmp, path)
    return _LATTICE


def set_coeff_lattice(lattice) -> None:
    """Use ``lattice`` ((n, n, n, 3) coefficients of any n, e.g. the JAX
    package's) for every later upsampling, in place of ``coeff_lattice``;
    None goes back to it."""
    global _GIVEN_LATTICE
    _GIVEN_LATTICE = (None if lattice is None
                      else np.asarray(lattice, np.float32))


def upsample_rgb_array(rgb: np.ndarray, lattice=None,
                       device=None) -> np.ndarray:
    """(N, 3) rgb -> (N, 3) coefficients by trilinear interpolation in the
    lattice (default: the one given to ``set_coeff_lattice``, else
    ``coeff_lattice()``, fitted on ``device`` if cold): the per-texel path
    of the spectral variant (reference srgb.cpp)."""
    if lattice is None:
        lattice = (_GIVEN_LATTICE if _GIVEN_LATTICE is not None
                   else coeff_lattice(device=device))
    lat = np.asarray(lattice)
    n = lat.shape[0]
    q = np.clip(np.asarray(rgb, np.float64), 0.0, 1.0) * (n - 1)
    i0 = np.clip(q.astype(np.int32), 0, n - 2)
    t = q - i0
    out = np.zeros((rgb.shape[0], 3))
    for dr in (0, 1):
        for dg in (0, 1):
            for db in (0, 1):
                w = ((t[:, 0] if dr else 1 - t[:, 0])
                     * (t[:, 1] if dg else 1 - t[:, 1])
                     * (t[:, 2] if db else 1 - t[:, 2]))
                out += w[:, None] * lat[i0[:, 0] + dr, i0[:, 1] + dg,
                                        i0[:, 2] + db]
    return out.astype(np.float32)


__all__ = ["LAMBDA_MIN", "LAMBDA_MAX", "LAMBDA_RANGE",
           "cie_xbar", "cie_ybar", "cie_zbar", "d65_spd", "xyz_weights",
           "y_integral", "d65_y_norm", "fit_reflectance_coeffs",
           "fit_reflectance_coeffs_batch", "rgb_of_coeffs",
           "fit_coeff_lattice", "coeff_lattice", "set_coeff_lattice",
           "lattice_cache_path",
           "upsample_rgb_array", "eval_reflectance_spectrum",
           "eval_emission_spectrum", "hero_wavelengths", "hero_to_srgb",
           "xyz_to_srgb_np", "srgb_to_xyz_np"]
