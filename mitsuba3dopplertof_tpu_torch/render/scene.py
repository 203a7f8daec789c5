"""Scene assembly and compilation into device SoA tables (port of the JAX
package's ``render/scene.py``: ``Scene.compile`` for the shapes, BSDFs
(with the wrappers' nested rows and the shared null row of ``mask``, and
the measured BSDFs' and the measured pBRDFs' tables), textures, emitters
(area lights on spheres included), the constant and envmap environments
and media, in every variant: rgb, spectral, mono, rgb_polarized and
spectral_polarized; ``build_si``, ``ray_intersect`` and ``ray_test``).

The variant at compile time shapes the tables, as in the JAX package:
mono collapses every rgb input to its BT.709 luminance; spectral stores
sigmoid-polynomial coefficients in place of the rgb of the upsampled
BSDF types' reflectance, of emitters (with their peak), of media's
sigma_t (with its peak) and albedo, of every texel of the bitmap atlas
(``tex_atlas_c0..c2``, from the coefficient lattice) and of the envmap
(``env_coeff``, fitted per texel on the scene's device), and names each
named-material conductor's eta / k spectra (``ior_spectra``);
spectral_polarized compiles as spectral. The polarized variants set
``polarized``, which the integrators read.

The host compiles the shape graph into flat component-wise triangle /
instance / BSDF / emitter tables (each column a (T,) tensor). Triangle slot
order is the JAX package's, so ``prim`` ids agree between the two: static
triangles first, then each animated instance's object-space triangles.

Motion blur: every shape is an instance with two keyframe matrices; rays
enter an animated instance's object space through the exact inverse of the
lerped matrix at their own time (reference src/shapes/instance.cpp:155-250,
transform.h:458-466).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.vec import Vec3, dot, normalize, coordinate_system
from .types import Ray, SurfaceInteraction

# triangle component columns (all (T,) tensors)
_TRI_COLS = ("v0x", "v0y", "v0z", "e1x", "e1y", "e1z", "e2x", "e2y", "e2z",
             "n0x", "n0y", "n0z", "n1x", "n1y", "n1z", "n2x", "n2y", "n2z",
             "uv0u", "uv0v", "uv1u", "uv1v", "uv2u", "uv2v")
_TRI_INT_COLS = ("inst", "prim")


class SceneArrays:
    """Compiled tables on one device plus host-side metadata."""

    ARRAY_FIELDS = (
        ["s_" + c for c in _TRI_COLS] + ["s_" + c for c in _TRI_INT_COLS]
        + ["a_" + c for c in _TRI_COLS] + ["a_" + c for c in _TRI_INT_COLS]
        + ["inst_m0c", "inst_m1c", "inst_t0", "inst_t1",
           "inst_bsdf", "inst_emitter", "inst_nsign",
           "bsdf_type", "bsdf_params",       # bsdf_params: (P, B)
           "emitter_type", "emitter_params", "emitter_m",  # (P, E), (12, E)
           "tex_type", "tex_params", "tex_h",             # tex_params: (P, X)
           "tex_atlas_r", "tex_atlas_g", "tex_atlas_b",
           "tex_atlas_c0", "tex_atlas_c1", "tex_atlas_c2",
           "sph_m0c", "sph_m1c", "sph_t0", "sph_t1", "sph_inst",
           "env_img_r", "env_img_g", "env_img_b", "env_pdf", "env_cdf",
           "env_alias", "env_aprob", "env_rot", "env_rot_fwd",
           "env_coeff",                      # (4, T): c0..c2, peak
           "em_tri_cdf",
           "med_params", "inst_int_medium", "med_grid", "med_w2g",
           "sggx_grid", "sggx_w2g",          # sggx_grid: (V, 6)
           "bsphere_radius", "bsphere_center"]
    )
    META_FIELDS = [
        "n_static_tris", "n_anim_tris", "anim_ranges", "bsdf_types_present",
        "emitter_types_present", "n_emitters", "has_environment",
        "env_radiance", "bsdf_flags_host", "tex_types_present", "n_textures",
        "n_spheres", "sphere_animated", "env_kind", "env_shape", "env_index",
        "mesh_em_meta", "sensor_medium", "n_media", "any_hetero", "any_flip",
        "max_optical_depth_hint", "any_nmap", "any_sggx", "any_sggx_grid",
        "any_rayleigh", "tab_phase_tables", "spectral", "ior_spectra",
        "bsdf_ior_host", "polarized", "measured_pol_wls",
    ]

    def __init__(self, arrays: Dict[str, np.ndarray], meta: Dict[str, Any],
                 device):
        for k in self.ARRAY_FIELDS:
            a = np.asarray(arrays[k])
            dt = torch.int32 if a.dtype.kind in "iu" else torch.float32
            setattr(self, k, torch.tensor(a, dtype=dt, device=device))
        # (n_chunks, 6) world AABBs of the 32-triangle chunks
        # (ops/intersect_stream.chunk_aabbs), which B2 and ray binning cull
        # with; None when the scene carries none
        box = arrays.get("chunk_aabb")
        self.chunk_aabb = (None if box is None else torch.tensor(
            np.asarray(box), dtype=torch.float32, device=device))
        # (9, T) per-vertex attribute of every triangle slot (three rgb
        # corners), which mesh_attribute textures read; None without one
        attr = arrays.get("mesh_attr")
        self.mesh_attr = (None if attr is None else torch.tensor(
            np.asarray(attr), dtype=torch.float32, device=device))
        # the measured BSDFs' tables, by P_MEASURED_IDX
        from ..bsdfs.measured_impl import tables_from
        self.measured = tuple(tables_from(t, device)
                              for t in arrays.get("measured") or ())
        # the measured pBRDFs' tables, by P_MEASURED_IDX (their channels'
        # wavelengths are measured_pol_wls)
        from ..bsdfs.measured_polarized_impl import pbsdf_tables_to
        self.measured_pol = tuple(pbsdf_tables_to(t, device)
                                  for t in arrays.get("measured_pol") or ())
        # the tensors' own device: "cuda" resolves to "cuda:<current>"
        self.device = self.inst_t0.device
        for k in self.META_FIELDS:
            setattr(self, k, meta[k])
        self._tables = None     # B1's tables (ops/intersect_kernel)
        self._cache = {}        # the large-scene tables (ops/intersect_v4),
                                # volpath's tabulated phases

    def tri(self, prefix: str, col: str):
        return getattr(self, prefix + "_" + col)

    def inst_cmat(self, which: int, inst: int):
        arr = self.inst_m0c if which == 0 else self.inst_m1c   # (12, I)
        return tuple(arr[j, inst] for j in range(12))


def from_jax_scene_arrays(arrays: Dict[str, np.ndarray], meta,
                          device="cpu") -> SceneArrays:
    """The port's tables from the JAX package's compiled ``SceneArrays``,
    given as numpy arrays (``arrays``, by field name) and its metadata
    (``meta``: a mapping or an object with the same attributes), and its
    ``chunk_aabb``, ``mesh_attr``, ``measured`` and ``measured_pol``
    tables (from ``arrays`` or ``meta``). The JAX package's BVHs (``bvh``,
    ``anim_blas``) are left behind: the card does not use them."""
    get = (meta.get if isinstance(meta, dict)
           else lambda k, d=None: getattr(meta, k, d))
    arrays = dict(arrays)
    for k in ("chunk_aabb", "mesh_attr"):
        if arrays.get(k) is None and get(k) is not None:
            arrays[k] = np.asarray(get(k))
    for k in ("measured", "measured_pol"):
        if arrays.get(k) is None:
            arrays[k] = get(k)
    return SceneArrays(arrays, {k: get(k) for k in SceneArrays.META_FIELDS},
                       device)


def _morton_order(cen: np.ndarray) -> np.ndarray:
    """Permutation sorting points by 30-bit 3D Morton code (the JAX
    package's triangle order for meshes above 64 faces)."""
    lo, hi = cen.min(axis=0), cen.max(axis=0)
    q = ((cen - lo) / np.maximum(hi - lo, 1e-20)
         * 1023.0).astype(np.uint32)

    def spread(x):
        x = x.astype(np.uint64)
        x = (x | (x << np.uint64(16))) & np.uint64(0x030000FF)
        x = (x | (x << np.uint64(8))) & np.uint64(0x0300F00F)
        x = (x | (x << np.uint64(4))) & np.uint64(0x030C30C3)
        x = (x | (x << np.uint64(2))) & np.uint64(0x09249249)
        return x

    code = ((spread(q[:, 0]) << np.uint64(2))
            | (spread(q[:, 1]) << np.uint64(1)) | spread(q[:, 2]))
    return np.argsort(code, kind="stable")


class Scene:
    """Host-side object graph (reference src/render/scene.cpp:22-101)."""

    def __init__(self, shapes, emitters, sensors, integrator=None,
                 device=None):
        from .. import get_device
        self.shapes = shapes
        self.emitters = emitters
        self.sensors = sensors
        self.integrator = integrator
        self.device = torch.device(device if device is not None
                                   else get_device())
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "the scene's device is CUDA (the default), but no CUDA "
                "device is available: pass device='cpu' or call "
                "set_device('cpu') to render on the CPU")
        self._host: Optional[Tuple[dict, dict]] = None
        self._compiled: Dict[str, SceneArrays] = {}

    @property
    def sensor(self):
        return self.sensors[0]

    def environment(self):
        for e in self.emitters:
            if e.is_environment:
                return e
        return None

    def compile(self, device=None) -> SceneArrays:
        """The scene's tables on ``device`` (default: the scene's own)."""
        dev = torch.device(device if device is not None else self.device)
        if str(dev) not in self._compiled:
            if self._host is None:
                self._host = self._compile_host()
            self._compiled[str(dev)] = SceneArrays(*self._host, dev)
        return self._compiled[str(dev)]

    def _compile_host(self):
        from .. import variant
        from ..bsdfs import (BlendBSDF, Diffuse, Mask, Measured,
                             MeasuredPolarized, Null,
                             P_NMAP_TEX, P_REFL, TEXTURED_TYPES)
        from ..bsdfs.ior_data import CONDUCTOR_SPECTRA
        from ..core import cie
        from ..core.properties import Properties
        from ..emitters import (E_AREA, E_CUTOFF, E_POS, E_SPH_SLOT,
                                EMITTER_AREA_MESH, EMITTER_AREA_RECT,
                                EMITTER_AREA_SPHERE, E_INTENSITY,
                                N_EMITTER_PARAMS)
        from ..ops.intersect_stream import chunk_aabbs
        from ..shapes import RectangleShape

        spectral = variant() in ("cuda_spectral", "cuda_spectral_polarized")
        mono = variant() == "cuda_mono"
        polarized = variant() in ("cuda_rgb_polarized",
                                  "cuda_spectral_polarized")

        def _lum(rgb3):
            # BT.709 luminance: the reference's mono variants collapse rgb
            # inputs with it (spectrum.h)
            return 0.2126 * rgb3[0] + 0.7152 * rgb3[1] + 0.0722 * rgb3[2]

        # --- BSDF table (deduplicated by identity) -----------------------
        bsdf_objs: List[Any] = []
        bsdf_index: Dict[int, int] = {}

        def add_bsdf(b):
            if id(b) not in bsdf_index:
                bsdf_index[id(b)] = len(bsdf_objs)
                bsdf_objs.append(b)
            return bsdf_index[id(b)]

        for sh in self.shapes:
            if sh.bsdf is None:
                sh.bsdf = Diffuse(Properties("diffuse"))
            add_bsdf(sh.bsdf)
        # wrappers: their nested rows join the table, and every mask
        # shares one plain null row (the JAX package's order: the shapes'
        # rows, then each wrapper's nested rows; nested wrappers are not
        # expanded again)
        null_row = None
        for b in list(bsdf_objs):
            if isinstance(b, Mask):
                b.nested_index = add_bsdf(b.nested_bsdf)
                if null_row is None:
                    null_row = add_bsdf(Null(Properties("null")))
                b.null_index = null_row
            elif isinstance(b, BlendBSDF):
                b.nested_indices = (add_bsdf(b.nested[0]),
                                    add_bsdf(b.nested[1]))

        # --- texture table + bitmap atlas --------------------------------
        from ..textures import (N_TEX_PARAMS, T_ATLAS, TEX_BITMAP,
                                TEX_MESHATTR, TEX_VOLUME)
        tex_objs: List[Any] = []
        tex_index: Dict[int, int] = {}

        def add_tex(t):
            if id(t) not in tex_index:
                tex_index[id(t)] = len(tex_objs)
                tex_objs.append(t)
            return tex_index[id(t)]

        for b in bsdf_objs:
            t = getattr(b, "reflectance_tex", None)
            if t is None and hasattr(b, "nested"):
                t = getattr(b.nested, "reflectance_tex", None)
            if t is not None:
                b.tex_index = add_tex(t)
                if hasattr(b, "nested"):
                    b.nested.tex_index = b.tex_index
            # normalmap / bumpmap: the texture their row names
            nm = getattr(b, "normalmap_tex", None)
            if nm is not None:
                b.nmap_index = add_tex(nm)
        for em in self.emitters:
            # an area emitter's radiance, the projector's image
            t = getattr(em, "irradiance_tex", None)
            if t is not None:
                em.tex_index = add_tex(t)
        tex_rows, tex_types, tex_h, atlas = [], [], [], []
        atlas_off = 0
        for t in tex_objs:
            row = t.params_row()
            if t.type_id == TEX_BITMAP:
                img = t.image
                row[T_ATLAS] = float(atlas_off)
                row[T_ATLAS + 1] = float(img.shape[1])
                tex_h.append(img.shape[0])
                atlas.append(img.reshape(-1, 3))
                atlas_off += img.shape[0] * img.shape[1]
            elif t.type_id == TEX_VOLUME:
                # volume grids ride the same flat rgb atlas
                g = t.grid_rgb()
                row[T_ATLAS] = float(atlas_off)
                tex_h.append(0)
                atlas.append(g.reshape(-1, 3))
                atlas_off += g.shape[0] * g.shape[1] * g.shape[2]
            else:
                tex_h.append(0)
            tex_rows.append(row)
            tex_types.append(t.type_id)
        # the attributes mesh_attribute textures name, packed per triangle
        # slot in the shape sweep below
        mesh_attr_names = [t.name for t in tex_objs
                           if t.type_id == TEX_MESHATTR]
        s_attr_rows, a_attr_rows = [], []
        atlas_np = (np.concatenate(atlas, axis=0) if atlas
                    else np.zeros((1, 3), np.float32))
        if mono and atlas:
            la = (0.2126 * atlas_np[:, 0] + 0.7152 * atlas_np[:, 1]
                  + 0.0722 * atlas_np[:, 2])
            atlas_np = np.stack([la, la, la], axis=1)
        # spectral: a parallel atlas of every texel's sigmoid-polynomial
        # coefficients, interpolated in the coefficient lattice (reference
        # ext/rgb2spec tables + src/core/srgb.cpp)
        atlas_coeff = (cie.upsample_rgb_array(atlas_np, device=self.device)
                       if spectral and atlas
                       else np.zeros((1, 3), np.float32))

        if not bsdf_objs:
            bsdf_objs.append(Diffuse(Properties("diffuse")))
        bsdf_type = np.array([b.type_id for b in bsdf_objs], np.int32)
        bsdf_flags = np.array([b.flags for b in bsdf_objs], np.int32)
        measured, measured_pol, measured_pol_wls = [], [], []
        for b in bsdf_objs:
            if isinstance(b, MeasuredPolarized):
                b.measured_index = len(measured_pol)
                measured_pol.append(b.tables)
                measured_pol_wls.append(tuple(b.pol_wavelengths()))
            elif isinstance(b, Measured):
                b.measured_index = len(measured)
                measured.append(b.tables)
        bsdf_params = np.stack([b.params_row() for b in bsdf_objs]).T
        # rows without a normal or bump map carry -1 in its column (0
        # would name texture row 0)
        for bi, b in enumerate(bsdf_objs):
            if getattr(b, "nmap_index", -1) < 0:
                bsdf_params[P_NMAP_TEX, bi] = -1.0
        if mono:
            for bi in range(len(bsdf_objs)):
                rgb = bsdf_params[P_REFL:P_REFL + 3, bi]
                if rgb.max() > 0:
                    bsdf_params[P_REFL:P_REFL + 3, bi] = _lum(rgb)
        # spectral: each named-material conductor row names its entry of
        # the eta / k spectra (reference ior.h complex_ior)
        ior_spectra, ior_by_name, bsdf_ior_host = [], {}, []
        for b in bsdf_objs:
            mat = getattr(b, "material", None)
            if spectral and mat in CONDUCTOR_SPECTRA:
                if mat not in ior_by_name:
                    ior_by_name[mat] = len(ior_spectra)
                    ior_spectra.append(CONDUCTOR_SPECTRA[mat])
                bsdf_ior_host.append(ior_by_name[mat])
            else:
                bsdf_ior_host.append(-1)
        if spectral:
            # the upsampled types' reflectance as sigmoid coefficients;
            # every other type reads its P_REFL rgb as the values at the
            # three hero wavelengths, as in the JAX package
            for bi, b in enumerate(bsdf_objs):
                if b.type_id not in TEXTURED_TYPES:
                    continue
                rgb = bsdf_params[P_REFL:P_REFL + 3, bi]
                if rgb.max() > 0:
                    bsdf_params[P_REFL:P_REFL + 3, bi] = \
                        cie.fit_reflectance_coeffs(rgb)

        # --- emitter table ------------------------------------------------
        emitter_rows, emitter_types, emitter_mats = [], [], []
        mesh_emitter_shapes = {}     # emitter idx -> shape (CDF built later)
        for ei, em in enumerate(self.emitters):
            row = em.params_row()
            etype = em.type_id
            m0 = np.eye(4)           # emitters without a shape (point)
            if hasattr(em, "to_world") and em.shape is None:
                m0 = np.asarray(em.to_world, np.float64)     # envmap
            if em.shape is not None and getattr(
                    em.shape, "is_analytic_sphere", False):
                # cone-sampled (sphere.cpp): the world center and radius;
                # an animated sphere names its sphere-table slot so that
                # its cone follows the keyframe lerp at each lane's time
                m0 = em.shape.to_world.matrices()[0]
                etype = EMITTER_AREA_SPHERE
                r_w = float(np.linalg.norm(m0[:3, 0]))
                row[E_POS:E_POS + 3] = m0[:3, 3]
                row[E_CUTOFF] = r_w
                row[E_AREA] = 4.0 * np.pi * r_w * r_w
                slot = sum(1 for s_ in
                           self.shapes[:self.shapes.index(em.shape)]
                           if getattr(s_, "is_analytic_sphere", False))
                row[E_SPH_SLOT] = (float(slot) if em.shape.to_world.animated
                                   else -1.0)
            elif em.shape is not None:
                m0 = em.shape.to_world.matrices()[0]
                row[E_AREA] = float(np.sum(em.shape.mesh.surface_areas(m0)))
                if etype == EMITTER_AREA_RECT and (
                        not isinstance(em.shape, RectangleShape)
                        or em.shape.to_world.animated):
                    # animated rect emitters also take the mesh-CDF path
                    # so their sampled points follow the keyframe lerp
                    etype = EMITTER_AREA_MESH
                    mesh_emitter_shapes[ei] = em.shape
            emitter_rows.append(row)
            emitter_types.append(etype)
            emitter_mats.append(m0[:3, :4].reshape(-1))
        n_emitters = len(self.emitters)
        emitter_params = (np.stack(emitter_rows).T if emitter_rows
                          else np.zeros((N_EMITTER_PARAMS, 0)))
        emitter_type = np.array(emitter_types, np.int32)
        emitter_m = (np.stack(emitter_mats).T if emitter_mats
                     else np.zeros((12, 0)))
        for ei in range(n_emitters):
            rgb = emitter_params[E_INTENSITY:E_INTENSITY + 3, ei]
            if mono:
                emitter_params[E_INTENSITY:E_INTENSITY + 3, ei] = _lum(rgb)
            elif spectral:
                # emission spectra scale * S(coeffs) * D65 / int D65 ybar:
                # the coefficients fit the chromaticity, the peak restores
                # the luminance (srgb.cpp emission); columns 12:16
                peak = max(float(rgb.max()), 1e-9)
                emitter_params[12:15, ei] = cie.fit_reflectance_coeffs(
                    rgb / peak)
                emitter_params[15, ei] = peak

        # --- environment ---------------------------------------------------
        env = self.environment()
        env_radiance = (np.asarray(env.radiance, np.float32)
                        if env is not None else np.zeros(3, np.float32))
        env_kind = None
        env_index = -1
        env_img = np.zeros((1, 1, 3), np.float32)
        env_pdf = np.ones(1, np.float32)
        env_cdf = np.ones(1, np.float32)
        env_alias = np.zeros(1, np.int32)
        env_aprob = np.ones(1, np.float32)
        env_rot = np.eye(3).reshape(-1)
        env_rot_fwd = np.eye(3).reshape(-1)
        if env is not None:
            from ..emitters import EnvmapEmitter
            env_index = self.emitters.index(env)
            # the constant environment needs no tables: its radiance is
            # env_radiance
            env_kind = ("envmap" if isinstance(env, EnvmapEmitter)
                        else "constant")
        if env_kind == "envmap":
            env_img = env.image
            env_pdf = env.texel_pdf.reshape(-1)
            env_cdf = env.texel_cdf
            env_alias = env.texel_alias
            env_aprob = env.texel_aprob
            R = env.to_world[:3, :3]
            env_rot_fwd = R.reshape(-1)
            env_rot = np.linalg.inv(R).reshape(-1)
        env_coeff = np.zeros((4, 1), np.float32)
        if spectral and env_kind == "envmap":
            # each texel's emission spectrum: coefficients of its
            # chromaticity and its peak (the batched fit, on the scene's
            # device)
            flat = env_img.reshape(-1, 3).astype(np.float64)
            peak = np.maximum(flat.max(axis=1), 1e-9)
            coeffs = cie.fit_reflectance_coeffs_batch(flat / peak[:, None],
                                                      device=self.device)
            env_coeff = np.concatenate(
                [np.asarray(coeffs, np.float32).T,
                 peak[None, :].astype(np.float32)], axis=0)

        # --- media: the sensor's first, then each shape's interior ---------
        from ..media import (M_ALBEDO, M_GRID_OFF, M_MAXD, M_SGGX_NX,
                             M_SGGX_NY, M_SGGX_NZ, M_SGGX_OFF, M_SIGMA_T,
                             M_ST_PEAK, N_MED_PARAMS, PHASE_RAYLEIGH,
                             PHASE_SGGX, PHASE_TAB, warn_sggx_not_pd)
        media_objs: List[Any] = []
        media_index: Dict[int, int] = {}

        def add_medium(m):
            if m is None:
                return -1
            if id(m) not in media_index:
                media_index[id(m)] = len(media_objs)
                media_objs.append(m)
            return media_index[id(m)]

        sensor_medium = add_medium(self.sensor.medium)
        inst_int_medium = [add_medium(sh.interior_medium)
                           for sh in self.shapes]
        med_params = (np.stack([m.params_row() for m in media_objs]).T
                      if media_objs else np.zeros((N_MED_PARAMS, 1)))
        for m in media_objs:
            warn_sggx_not_pd(m)
        for mi_ in range(len(media_objs) if spectral else 0):
            # sigma_t / peak and the albedo as sigmoid coefficients
            st = med_params[M_SIGMA_T:M_SIGMA_T + 3, mi_]
            peak = max(float(st.max()), 1e-9)
            med_params[M_SIGMA_T:M_SIGMA_T + 3, mi_] = \
                cie.fit_reflectance_coeffs(st / peak)
            med_params[M_ST_PEAK, mi_] = peak
            al = med_params[M_ALBEDO:M_ALBEDO + 3, mi_]
            if al.max() > 0:
                med_params[M_ALBEDO:M_ALBEDO + 3, mi_] = \
                    cie.fit_reflectance_coeffs(al)
        # flat density atlas + world->grid transforms of the grid media
        med_grid_parts = []
        med_w2g = np.zeros((12, max(len(media_objs), 1)))
        grid_off = 0
        for mi_, m in enumerate(media_objs):
            g = getattr(m, "grid", None)
            if g is None:
                continue
            data = g.scalar_grid().ravel()     # index (z*ny + y)*nx + x
            med_params[M_GRID_OFF, mi_] = grid_off
            med_grid_parts.append(data)
            grid_off += data.size
            w2g = np.linalg.inv(np.asarray(g.to_world, np.float64))
            med_w2g[:, mi_] = w2g[:3, :4].reshape(-1)
        med_grid = (np.concatenate(med_grid_parts)
                    if med_grid_parts else np.zeros(1, np.float32))
        # spatially varying SGGX: the 6-channel S grids as rows of one
        # (V, 6) atlas, looked up at each scattering event (reference
        # sggx.cpp eval_ndf_params); M_SGGX_NX == 0 keeps the constant S
        sggx_parts = []
        sggx_w2g = np.zeros((12, max(len(media_objs), 1)))
        sggx_row_off = 0
        for mi_, m in enumerate(media_objs):
            sg = getattr(m.phase, "S_grid", None)
            if sg is None:
                continue
            rows = np.ascontiguousarray(sg.data[..., :6].reshape(-1, 6),
                                        np.float32)
            med_params[M_SGGX_OFF, mi_] = sggx_row_off
            med_params[M_SGGX_NX, mi_] = sg.data.shape[2]
            med_params[M_SGGX_NY, mi_] = sg.data.shape[1]
            med_params[M_SGGX_NZ, mi_] = sg.data.shape[0]
            sggx_parts.append(rows)
            sggx_row_off += rows.shape[0]
            sggx_w2g[:, mi_] = np.linalg.inv(np.asarray(
                sg.to_world, np.float64))[:3, :4].reshape(-1)
        sggx_grid = (np.concatenate(sggx_parts, axis=0)
                     if sggx_parts else np.zeros((1, 6), np.float32))

        # --- instances & triangles -----------------------------------------
        inst_m0, inst_m1, inst_t0, inst_t1 = [], [], [], []
        inst_bsdf, inst_emitter, inst_nsign = [], [], []
        s_cols = {c: [] for c in _TRI_COLS + _TRI_INT_COLS}
        a_cols = {c: [] for c in _TRI_COLS + _TRI_INT_COLS}
        anim_ranges: List[Tuple[int, int, int]] = []
        all_pts = []
        sph_m0, sph_m1, sph_t0, sph_t1, sph_inst = [], [], [], [], []
        sphere_animated = []
        static_ranges = {}           # instance -> (tri start, count)

        for ii, sh in enumerate(self.shapes):
            m0, m1, t0, t1 = sh.to_world.matrices()
            animated = sh.to_world.animated
            if (sh.mesh is not None and sh.mesh.faces.shape[0] > 64
                    and not getattr(sh.mesh, "_morton_ordered", False)):
                f = sh.mesh.faces
                sh.mesh.faces = f[_morton_order(
                    sh.mesh.vertices[f].mean(axis=1))]
                sh.mesh._morton_ordered = True
            inst_m0.append(m0[:3, :4].reshape(-1))
            inst_m1.append(m1[:3, :4].reshape(-1))
            inst_t0.append(t0)
            inst_t1.append(t1)
            inst_bsdf.append(bsdf_index[id(sh.bsdf)])
            inst_emitter.append(self.emitters.index(sh.emitter)
                                if sh.emitter is not None else -1)
            inst_nsign.append(-1.0 if sh.flip_normals else 1.0)

            if getattr(sh, "is_analytic_sphere", False):
                sph_m0.append(m0[:3, :4].reshape(-1))
                sph_m1.append(m1[:3, :4].reshape(-1))
                sph_t0.append(t0)
                sph_t1.append(t1)
                sph_inst.append(ii)
                sphere_animated.append(animated)
                for mm in ((m0, m1) if animated else (m0,)):
                    c = mm[:3, 3]
                    r = float(np.linalg.norm(mm[:3, :3], 2))
                    all_pts.append(c[None, :] + np.array(
                        [[-r, -r, -r], [r, r, r]]))
                continue

            mesh = sh.mesh
            f = mesh.faces
            v = mesh.vertices
            nt = f.shape[0]
            if animated:
                cols = a_cols
                vv = v
                for mm in (m0, m1):
                    all_pts.append(v @ mm[:3, :3].T + mm[:3, 3])
            else:
                cols = s_cols
                vv = v @ m0[:3, :3].T + m0[:3, 3]
                all_pts.append(vv)
                static_ranges[ii] = (sum(a.shape[0] for a in s_cols["inst"]),
                                     nt)
            p0, p1, p2 = vv[f[:, 0]], vv[f[:, 1]], vv[f[:, 2]]
            e1 = p1 - p0
            e2 = p2 - p0
            if mesh.normals is not None:
                if animated:
                    nrm = mesh.normals
                else:
                    nrm = mesh.normals @ np.linalg.inv(m0[:3, :3])
                    nrm = nrm / np.maximum(
                        np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-20)
                n0, n1, n2 = nrm[f[:, 0]], nrm[f[:, 1]], nrm[f[:, 2]]
            else:
                gn = np.cross(e1, e2)
                gn = gn / np.maximum(
                    np.linalg.norm(gn, axis=-1, keepdims=True), 1e-20)
                n0 = n1 = n2 = gn
            if mesh.uvs is not None:
                uv0, uv1, uv2 = (mesh.uvs[f[:, 0]], mesh.uvs[f[:, 1]],
                                 mesh.uvs[f[:, 2]])
            else:
                uv0 = uv1 = uv2 = np.zeros((nt, 2))
            if mesh_attr_names:
                # the first named attribute the mesh has, its three
                # corners per triangle (0.5 gray without one)
                att = None
                for name in mesh_attr_names:
                    att = mesh.attributes.get(name)
                    if att is not None:
                        break
                if att is None:
                    rows9 = np.full((nt, 9), 0.5, np.float32)
                else:
                    att = np.asarray(att, np.float32)
                    if att.ndim == 1:
                        att = att[:, None]
                    if att.shape[1] == 1:
                        att = np.repeat(att, 3, axis=1)
                    rows9 = np.concatenate(
                        [att[f[:, k]][:, :3] for k in range(3)], axis=1)
                (a_attr_rows if animated else s_attr_rows).append(rows9)
            data = {"inst": np.full(nt, ii, np.int32),
                    "prim": np.arange(nt, dtype=np.int32)}
            for name, arr in (("v0", p0), ("e1", e1), ("e2", e2),
                              ("n0", n0), ("n1", n1), ("n2", n2)):
                for j, c in enumerate("xyz"):
                    data[name + c] = arr[:, j]
            for name, arr in (("uv0", uv0), ("uv1", uv1), ("uv2", uv2)):
                data[name + "u"], data[name + "v"] = arr[:, 0], arr[:, 1]
            for c in _TRI_COLS + _TRI_INT_COLS:
                cols[c].append(data[c])
            if animated:
                start = sum(r[2] for r in anim_ranges)
                anim_ranges.append((ii, start, nt))

        def pack(cols, prefix, out):
            nt = sum(a.shape[0] for a in cols["inst"])
            for c in _TRI_COLS + _TRI_INT_COLS:
                is_int = c in _TRI_INT_COLS
                if nt > 0:
                    cat = np.concatenate(cols[c], axis=0)
                else:
                    cat = np.full((1,), -1) if is_int else np.zeros((1,))
                out[prefix + c] = cat.astype(np.int32 if is_int
                                             else np.float32)
            return nt

        arrays: Dict[str, np.ndarray] = {}
        n_static = pack(s_cols, "s_", arrays)
        n_anim = pack(a_cols, "a_", arrays)

        # mesh-area-emitter triangle CDFs; animated shapes sample their
        # object-space CDF (meta: emitter, tri start, count, cdf offset,
        # animated, instance)
        mesh_em_meta = []
        cdf_parts = []
        cdf_off = 0
        for ei, shp in mesh_emitter_shapes.items():
            ii = self.shapes.index(shp)
            if shp.to_world.animated:
                rng_a = next(r for r in anim_ranges if r[0] == ii)
                start, cnt = rng_a[1], rng_a[2]
                areas = shp.mesh.surface_areas(np.eye(4))
                anim = 1
            else:
                start, cnt = static_ranges[ii]
                areas = shp.mesh.surface_areas(shp.to_world.matrices()[0])
                anim = 0
            cdf_parts.append(np.cumsum(areas / max(areas.sum(), 1e-20)))
            mesh_em_meta.append((ei, start, cnt, cdf_off, anim, ii))
            cdf_off += cnt

        pts = np.concatenate(all_pts, axis=0) if all_pts else np.zeros((1, 3))
        center = 0.5 * (pts.min(0) + pts.max(0))
        radius = float(np.linalg.norm(pts - center, axis=-1).max()) + 1e-3

        def stack_t(rows, empty):
            return np.stack(rows).T if rows else empty

        # per-chunk world AABBs for B2's culling and ray binning
        def cat3(cols, a, b, c):
            if not cols[a]:
                return np.zeros((0, 3), np.float32)
            return np.stack([np.concatenate(cols[a]), np.concatenate(cols[b]),
                             np.concatenate(cols[c])], axis=1)

        # (9, T) per-vertex attribute table in global slot order
        arrays["mesh_attr"] = (
            np.concatenate(s_attr_rows + a_attr_rows, axis=0).T.astype(
                np.float32)
            if mesh_attr_names and (s_attr_rows or a_attr_rows) else None)
        arrays["chunk_aabb"] = chunk_aabbs(
            n_static, tuple(anim_ranges),
            cat3(s_cols, "v0x", "v0y", "v0z"),
            cat3(s_cols, "e1x", "e1y", "e1z"),
            cat3(s_cols, "e2x", "e2y", "e2z"),
            cat3(a_cols, "v0x", "v0y", "v0z"),
            cat3(a_cols, "e1x", "e1y", "e1z"),
            cat3(a_cols, "e2x", "e2y", "e2z"),
            [np.asarray(inst_m0[i]).reshape(3, 4) for i, _, _ in anim_ranges],
            [np.asarray(inst_m1[i]).reshape(3, 4) for i, _, _ in anim_ranges])

        f32, i32 = np.float32, np.int32
        arrays.update(
            inst_m0c=stack_t(inst_m0, np.zeros((12, 1))).astype(f32),
            inst_m1c=stack_t(inst_m1, np.zeros((12, 1))).astype(f32),
            inst_t0=np.asarray(inst_t0 or [0.0], f32),
            inst_t1=np.asarray(inst_t1 or [1.0], f32),
            inst_bsdf=np.asarray(inst_bsdf or [0], i32),
            inst_emitter=np.asarray(inst_emitter or [-1], i32),
            inst_nsign=np.asarray(inst_nsign or [1.0], f32),
            bsdf_type=bsdf_type,
            bsdf_params=bsdf_params.astype(f32),
            emitter_type=emitter_type,
            emitter_params=emitter_params.astype(f32),
            emitter_m=emitter_m.astype(f32),
            sph_m0c=stack_t(sph_m0, np.zeros((12, 1))).astype(f32),
            sph_m1c=stack_t(sph_m1, np.zeros((12, 1))).astype(f32),
            sph_t0=np.asarray(sph_t0 or [0.0], f32),
            sph_t1=np.asarray(sph_t1 or [1.0], f32),
            sph_inst=np.asarray(sph_inst or [-1], i32),
            em_tri_cdf=(np.concatenate(cdf_parts) if cdf_parts
                        else np.ones(1)).astype(f32),
            tex_type=np.asarray(tex_types or [0], i32),
            tex_params=(np.stack(tex_rows).T if tex_rows
                        else np.zeros((N_TEX_PARAMS, 1))).astype(f32),
            tex_h=np.asarray(tex_h or [0], i32),
            tex_atlas_r=atlas_np[:, 0].astype(f32),
            tex_atlas_g=atlas_np[:, 1].astype(f32),
            tex_atlas_b=atlas_np[:, 2].astype(f32),
            tex_atlas_c0=atlas_coeff[:, 0].astype(f32),
            tex_atlas_c1=atlas_coeff[:, 1].astype(f32),
            tex_atlas_c2=atlas_coeff[:, 2].astype(f32),
            env_coeff=env_coeff.astype(f32),
            measured=tuple(measured),
            measured_pol=tuple(measured_pol),
            env_img_r=env_img[..., 0].reshape(-1).astype(f32),
            env_img_g=env_img[..., 1].reshape(-1).astype(f32),
            env_img_b=env_img[..., 2].reshape(-1).astype(f32),
            env_pdf=np.asarray(env_pdf, f32),
            env_cdf=np.asarray(env_cdf, f32),
            env_alias=np.asarray(env_alias, i32),
            env_aprob=np.asarray(env_aprob, f32),
            env_rot=np.asarray(env_rot, f32),
            env_rot_fwd=np.asarray(env_rot_fwd, f32),
            med_params=med_params.astype(f32),
            inst_int_medium=np.asarray(inst_int_medium or [-1], i32),
            med_grid=med_grid.astype(f32),
            med_w2g=med_w2g.astype(f32),
            sggx_grid=sggx_grid.astype(f32),
            sggx_w2g=sggx_w2g.astype(f32),
            bsphere_radius=np.asarray(radius, f32),
            bsphere_center=np.asarray(center, f32),
        )
        meta = dict(
            n_static_tris=n_static,
            n_anim_tris=n_anim,
            anim_ranges=tuple(anim_ranges),
            bsdf_types_present=tuple(sorted(set(int(t) for t in bsdf_type))),
            emitter_types_present=tuple(sorted(set(
                int(t) for t in emitter_type))),
            n_emitters=n_emitters,
            bsdf_flags_host=tuple(int(f) for f in bsdf_flags),
            n_spheres=len(sph_inst),
            sphere_animated=tuple(sphere_animated),
            mesh_em_meta=tuple(mesh_em_meta),
            any_flip=any(s < 0.0 for s in inst_nsign),
            has_environment=env is not None,
            env_radiance=(lambda e: (_lum(e),) * 3 if mono else e)(
                tuple(float(x) for x in env_radiance)),
            tex_types_present=tuple(sorted(set(int(t) for t in tex_types))),
            n_textures=len(tex_objs),
            env_kind=env_kind,
            env_shape=(int(env_img.shape[0]), int(env_img.shape[1])),
            env_index=env_index,
            sensor_medium=sensor_medium,
            n_media=len(media_objs),
            any_hetero=bool(med_grid_parts),
            any_nmap=any(getattr(b, "nmap_index", -1) >= 0
                         for b in bsdf_objs),
            any_rayleigh=any(m.phase.type_id == PHASE_RAYLEIGH
                             for m in media_objs),
            tab_phase_tables=tuple(
                (tuple(float(x) for x in m.phase.values)
                 if m.phase.type_id == PHASE_TAB else None)
                for m in media_objs),
            any_sggx=any(m.phase.type_id == PHASE_SGGX for m in media_objs),
            any_sggx_grid=bool(sggx_parts),
            spectral=spectral,
            polarized=polarized,
            measured_pol_wls=tuple(measured_pol_wls),
            ior_spectra=tuple(ior_spectra),
            bsdf_ior_host=tuple(bsdf_ior_host),
            # the largest majorant (or sigma_t) times the scene's diameter:
            # the volpath tracking loops' budgets (the JAX package's host
            # code)
            max_optical_depth_hint=float(
                max((max(float(np.max(m.params_row()[M_MAXD:M_MAXD + 1])),
                         float(np.max(m.params_row()[:3])))
                     for m in media_objs), default=0.0) * 2.0 * radius),
        )
        return arrays, meta


# ---------------------------------------------------------------------------
# Ray queries
# ---------------------------------------------------------------------------

def build_si(sa: SceneArrays, ray: Ray, hit, active=None) -> SurfaceInteraction:
    """The SurfaceInteraction from the hit payload — elementwise only
    (reference compute_surface_interaction)."""
    valid = hit.prim >= 0
    if active is not None:
        valid = valid & active
    t = torch.where(valid, hit.t, float("inf"))
    p = ray.o + ray.d * torch.where(valid, hit.t, 0.0)
    ng = normalize(Vec3(hit.gnx, hit.gny, hit.gnz))
    ns = normalize(Vec3(hit.nsx, hit.nsy, hit.nsz))
    if sa.any_flip:
        # per-instance flip_normals (reference shape.cpp)
        sgn = sa.inst_nsign[torch.clamp(hit.inst, min=0).long()]
        ng = ng * sgn
        ns = ns * sgn
    sh_s, sh_t = coordinate_system(ns)
    wi_world = -ray.d
    wi = Vec3(dot(wi_world, sh_s), dot(wi_world, sh_t), dot(wi_world, ns))
    return SurfaceInteraction(
        valid=valid, t=t, p=p, n=ng, sh_n=ns, sh_s=sh_s, sh_t=sh_t,
        uv_u=hit.uv_u, uv_v=hit.uv_v, wi=wi,
        inst=torch.where(valid, hit.inst, -1),
        prim=torch.where(valid, hit.prim, -1), time=ray.time,
        b_u=hit.u, b_v=hit.v)


def ray_intersect(sa: SceneArrays, ray: Ray, active=None) -> SurfaceInteraction:
    """Full surface-interaction query (reference scene.cpp:125-137). The
    closest hit comes from ``ops.intersect_kernel.intersect``: the CUDA
    kernels for tensors on the card, the plain version for CPU tensors."""
    from ..ops.intersect_kernel import intersect
    return build_si(sa, ray, intersect(sa, ray, active), active)


def ray_test(sa: SceneArrays, ray: Ray, active=None):
    """Shadow/any-hit query (reference scene.cpp ray_test)."""
    from ..ops.intersect_kernel import ray_test as occluded_fn
    occluded = occluded_fn(sa, ray, active)
    if active is not None:
        occluded = occluded & active
    return occluded


__all__ = ["Scene", "SceneArrays", "from_jax_scene_arrays", "build_si",
           "ray_intersect", "ray_test"]
