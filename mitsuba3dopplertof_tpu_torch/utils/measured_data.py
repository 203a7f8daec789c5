"""A synthetic measured BRDF in the RGL tensor format: GGX copper
(alpha 0.3) written through the port's own warps, so that its stored
spectra are consistent with the measured BSDF's sampler and no file has
to be downloaded. The port's copy of the synthesis in the JAX package's
``tests/test_measured.py``.

    from mitsuba3dopplertof_tpu_torch.utils.measured_data import \\
        write_ggx_copper_bsdf
    write_ggx_copper_bsdf("ggx_cu.bsdf")

Also ``measured_sphere_dict``: a UV-sphere mesh with that BSDF, as the
benchmark scenes' static mesh; and a synthetic measured polarized pBRDF
(``write_pbsdf``, the synthesis of the JAX package's
``tests/test_measured_polarized.py``, with ``polarizing_mueller`` as its
default content) with ``measured_polarized_sphere_dict``.
"""

from __future__ import annotations

import numpy as np
import torch

ALPHA = 0.3
# (eta, k) of a copper-like conductor at the file's three wavelengths
ETA_K = {611.0: (0.2004, 3.9129), 549.0: (0.9240, 2.4528),
         465.0: (1.1022, 2.1421)}
WAVS = np.array([465.0, 549.0, 611.0], np.float32)


def _D(ct):
    ct = np.clip(ct, 1e-6, 1.0)
    a2 = ALPHA * ALPHA
    return a2 / (np.pi * (ct * ct * (a2 - 1) + 1) ** 2)


def _G1(ct):
    ct = np.clip(ct, 1e-6, 1.0)
    st = np.sqrt(1 - ct * ct)
    return 1.0 / (1.0 + 0.5 * (-1 + np.sqrt(1 + (ALPHA * st / ct) ** 2)))


def _fresnel(ci, e, k):
    ci2 = ci * ci
    si2 = 1 - ci2
    e2, k2 = e * e, k * k
    t0 = e2 - k2 - si2
    a2pb2 = np.sqrt(np.maximum(t0 * t0 + 4 * e2 * k2, 0))
    t1 = a2pb2 + ci2
    a = np.sqrt(np.maximum(0.5 * (a2pb2 + t0), 0))
    t2 = 2 * a * ci
    Rs = (t1 - t2) / (t1 + t2)
    t3 = ci2 * a2pb2 + si2 * si2
    t4 = t2 * si2
    return 0.5 * (Rs + Rs * (t3 - t4) / (t3 + t4))


def ggx_copper_fields(T: int = 24, R: int = 48, S: int = 48) -> dict:
    """The tensor file's fields: T incident elevations, an R x R VNDF
    and NDF grid, S x S spectra at three wavelengths, one azimuth
    (isotropic)."""
    from ..bsdfs import measured_impl as mi
    theta_i = (np.linspace(0, 1, T) ** 2) * (np.pi / 2 * 0.98)
    phi_i = np.array([0.0], np.float32)
    u = np.linspace(0, 1, R)
    th_m = u ** 2 * (np.pi / 2)
    ndf = np.tile(_D(np.cos(th_m))[None, :], (R, 1)).astype(np.float32)
    sigma = np.tile((np.cos(th_m) / _G1(np.cos(th_m)))[None, :],
                    (R, 1)).astype(np.float32)
    vndf = np.zeros((1, T, R, R), np.float32)
    for t, ti in enumerate(theta_i):
        wi = np.array([np.sin(ti), 0, np.cos(ti)])
        PH, TH = np.meshgrid((2 * u - 1) * np.pi, th_m, indexing="ij")
        m = np.stack([np.cos(PH) * np.sin(TH), np.sin(PH) * np.sin(TH),
                      np.cos(TH)], -1)
        dvis = (_D(np.cos(TH)) * np.maximum(m @ wi, 0)
                / max(np.cos(ti) / _G1(np.cos(ti)), 1e-9))
        jac = 2 * np.pi ** 2 * np.tile(u[None, :], (R, 1)) * np.sin(TH)
        vndf[0, t] = (dvis * jac).astype(np.float32)
    lum = np.ones((1, T, S, S), np.float32)
    tbl = mi.build_tables({
        "phi_i": phi_i, "theta_i": theta_i.astype(np.float32),
        "wavelengths": WAVS, "vndf": vndf, "luminance": lum, "ndf": ndf,
        "sigma": sigma, "spectra": np.zeros((1, T, 3, S, S), np.float32),
        "jacobian": np.array([1], np.uint8)})
    gx, gy = np.meshgrid(np.linspace(0, 1, S), np.linspace(0, 1, S))
    spectra = np.zeros((1, T, 3, S, S), np.float32)
    for t, ti in enumerate(theta_i):
        ids, wts = mi._corner_ids(tbl, torch.zeros(S * S),
                                  torch.full((S * S,), float(ti)))
        ux, uy, _ = mi.warp_sample(
            tbl.vndf, ids, wts,
            torch.tensor(gx.ravel(), dtype=torch.float32),
            torch.tensor(gy.ravel(), dtype=torch.float32))
        ux, uy = ux.numpy(), uy.numpy()
        thm = ux ** 2 * (np.pi / 2)
        phm = (2 * uy - 1) * np.pi
        m = np.stack([np.cos(phm) * np.sin(thm), np.sin(phm) * np.sin(thm),
                      np.cos(thm)], -1)
        wi = np.array([np.sin(ti), 0, np.cos(ti)])
        wo = 2 * (m @ wi)[:, None] * m - wi[None, :]
        ci = max(np.cos(ti), 1e-6)
        co = np.clip(wo[:, 2], 1e-6, 1)
        D = _D(np.clip(m[:, 2], 1e-6, 1))
        G = _G1(ci) * _G1(co)
        sig = ci / _G1(ci)
        for w, lam in enumerate(WAVS):
            e, k = ETA_K[float(lam)]
            F = _fresnel(np.clip(m @ wi, 1e-6, 1), e, k)
            fcos = D * F * G / (4 * ci * co) * co      # f_r * cos_o
            val = np.where(wo[:, 2] > 1e-4,
                           fcos * 4 * sig / np.maximum(D, 1e-9), 0.0)
            spectra[0, t, w] = val.reshape(S, S)
    return {"phi_i": phi_i, "theta_i": theta_i.astype(np.float32),
            "wavelengths": WAVS, "ndf": ndf, "sigma": sigma, "vndf": vndf,
            "luminance": lum, "spectra": spectra,
            "jacobian": np.array([1], np.uint8),
            "description": np.frombuffer(b"synthetic GGX Cu", np.uint8)}


def write_ggx_copper_bsdf(path: str, **size) -> str:
    """Write the synthetic GGX copper .bsdf to ``path``; returns it."""
    from ..io.tensor_file import write_tensor_file
    write_tensor_file(path, ggx_copper_fields(**size))
    return path


def measured_sphere_dict(bsdf_path: str, obj_path, spp: int,
                         res: int = 256, tf=None,
                         integrator=None) -> dict:
    """A UV-sphere mesh (``obj_path``, from
    ``utils/bench_scenes.write_uv_sphere_obj``; None: the analytic unit
    sphere) with the ``measured`` BSDF of ``bsdf_path`` at rest over the
    benchmark scenes' floor, under their point light, rendered with
    ``path`` (max_depth 4) and an independent sampler. ``tf``: the
    transform module of the package that loads the dict (default: this
    package's)."""
    from . import bench_scenes
    scene = bench_scenes.static_mesh_scene(obj_path, spp, res, tf)
    if obj_path is None:
        scene["mesh"] = {"type": "sphere"}
    scene["mesh"]["bsdf"] = {"type": "measured", "filename": bsdf_path}
    if integrator is not None:
        scene["integrator"] = integrator
    return scene


def polarizing_mueller(phi_d, theta_d, theta_h, wvl):
    """An analytic, partly polarizing pBRDF cell: a lobe around the half
    vector that fades with the wavelength, linear diattenuation growing
    with theta_d and a retardance that turns with phi_d."""
    a = (0.6 * np.exp(-8.0 * theta_h * theta_h) + 0.05
         + 0.1 * (wvl - 450.0) / 200.0)
    b = -0.4 * a * np.sin(theta_d) ** 2
    c = 0.5 * a * np.cos(theta_d)
    s = 0.2 * a * np.sin(theta_d) * np.cos(phi_d)
    return np.array([[a, b, 0, 0], [b, a, 0, 0], [0, 0, c, -s],
                     [0, 0, s, c]], np.float32)


def pbsdf_fields(m_fn=polarizing_mueller, Np: int = 4, Nd: int = 5,
                 Nh: int = 6, wvls=(450, 500, 550, 600, 650)) -> dict:
    """The fields of a ``.pbsdf`` file: M[p, d, h, w] = m_fn(phi_d,
    theta_d, theta_h, wvl), a (4, 4) matrix, on uniform grids of phi_d in
    [-pi, pi] and theta_d, theta_h in [0, pi / 2]."""
    pd = np.linspace(-np.pi, np.pi, Np, dtype=np.float32)
    td = np.linspace(0, np.pi / 2, Nd, dtype=np.float32)
    th = np.linspace(0, np.pi / 2, Nh, dtype=np.float32)
    wv = np.asarray(wvls, np.uint16)
    M = np.zeros((Np, Nd, Nh, len(wvls), 4, 4), np.float32)
    for a, p in enumerate(pd):
        for b, d in enumerate(td):
            for c, h in enumerate(th):
                for e, w in enumerate(wv):
                    M[a, b, c, e] = m_fn(p, d, h, float(w))
    return {"theta_h": th.reshape(1, -1), "theta_d": td.reshape(1, -1),
            "phi_d": pd.reshape(1, -1), "wvls": wv, "M": M}


def write_pbsdf(path: str, **kw) -> str:
    """Write a synthetic ``.pbsdf`` (``pbsdf_fields(**kw)``); returns
    ``path``."""
    from ..io.tensor_file import write_tensor_file
    write_tensor_file(path, pbsdf_fields(**kw))
    return path


def measured_polarized_sphere_dict(pbsdf_path: str, obj_path, spp: int,
                                   res: int = 256, tf=None,
                                   integrator=None) -> dict:
    """``measured_sphere_dict`` with the ``measured_polarized`` BSDF of
    ``pbsdf_path`` (GGX sampling alpha 0.2) on the sphere."""
    scene = measured_sphere_dict(pbsdf_path, obj_path, spp, res, tf,
                                 integrator)
    scene["mesh"]["bsdf"] = {"type": "measured_polarized",
                             "filename": pbsdf_path,
                             "alpha_sample": 0.2}
    return scene


__all__ = ["ggx_copper_fields", "write_ggx_copper_bsdf",
           "measured_sphere_dict", "polarizing_mueller", "pbsdf_fields",
           "write_pbsdf", "measured_polarized_sphere_dict"]
