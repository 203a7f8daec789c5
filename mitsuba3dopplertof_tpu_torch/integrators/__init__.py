"""Integrator plugins and render orchestration (port of the JAX package's
``integrators/__init__.py``: ``SamplingIntegrator.render`` with strip
passes, timeout, ``cancel()``, checkpoints and AOV channels, the sample
body of every variant (hero wavelengths, specfilm binning, the polarized
variants' Mueller transport and its depolarizing fast path), the MIS path
loop with environment emission, textured reflectance, null crossings and
``use_nee``, ``path``, ``dopplertofpath``, ``velocity`` and ``depth``;
``volpath`` and ``volpathmis`` are in ``integrators/volpath.py``,
``direct``, ``aov`` and ``moment`` in ``integrators/extras.py``,
``ptracer`` in ``integrators/ptracer.py``, ``stokes`` and the polarized
path loop in ``integrators/polarized.py``).

  * render orchestration (wavefront sizing, passes, film)
      — reference src/render/integrator.cpp:104-347
  * doppler branch of render_sample (correlated pixel/time draws)
      — reference integrator.cpp:399-543
  * ``path``           — reference src/integrators/path.cpp
  * ``dopplertofpath`` — reference src/integrators/dopplertofpath.cpp
  * ``velocity``       — reference src/integrators/velocity.cpp:125-137
  * ``depth``          — reference src/integrators/depth.cpp

One pass renders a wavefront of lanes: pixel decode, sampler draws, camera
ray, the bounce loop over masked lanes, film accumulation. Every per-lane
quantity is an (N,) tensor on the scene's device.
"""

from __future__ import annotations

import math
import os
import threading
import time as _time

import numpy as np
import torch

from ..core.cie import LAMBDA_RANGE, hero_to_srgb, hero_wavelengths
from ..core.math import interp
from ..core.properties import Properties, register_plugin
from ..core.vec import Vec3, coordinate_system, dot, normalize, where3, vmax
from ..core.waveform import (WAVEFORM_TYPES, eval_modulation,
                             eval_modulation_low_pass)
from ..core import logger as _log
from ..core.logger import profile_phase
from ..render.types import Ray, DirectionSample
from ..render.scene import ray_intersect, ray_test
from ..samplers import TIME_SAMPLING_METHODS, TIME_ANTITHETIC
from ..bsdfs import (eval_pdf_sample as bsdf_eval_pdf_sample, FLAG_SMOOTH,
                     P_BMAP_SCALE, P_NMAP_TEX, P_REFL_TEX)
from .. import emitters as em_mod
from ..textures import eval_texture
from ..films import (block_create, block_splat_wavefront, develop,
                     filter_reach)
from ..sensors import sample_ray_kind

# lanes per pass (the reference's analogous limit is the 2^32 wavefront
# cap, integrator.cpp:227-245)
DEFAULT_MAX_LANES = 1 << 20


def mis_weight(pdf_a, pdf_b):
    """Power heuristic with the reference's non-finite guard
    (reference dopplertofpath.cpp:296-301)."""
    a2 = pdf_a * pdf_a
    w = a2 / (a2 + pdf_b * pdf_b)
    return torch.where(torch.isfinite(w), w, 0.0)


class Integrator:
    """Base (reference integrator.cpp:22-28)."""

    # the spectral variant: "hero" draws hero wavelengths and transports
    # them, "neutral" outputs geometry free of wavelengths, None cannot
    # render in that variant
    spectral_mode = None

    def __init__(self, props: Properties):
        self.id = props.id
        # cooperative cancellation budget in seconds (reference
        # integrator.cpp:24,48-50), checked between passes
        self.timeout = props.get_float("timeout", -1.0)
        self.hide_emitters = props.get_bool("hide_emitters", False)
        self._cancel = False

    def cancel(self):
        """Request cooperative cancellation (reference Integrator::cancel,
        integrator.cpp:48-50): the render stops at the next pass boundary
        and develops what it has accumulated. A render resets the request
        when it starts, so a cancel() before it is a no-op."""
        self._cancel = True

    def should_stop(self, start_time: float) -> bool:
        return self._cancel or (self.timeout > 0.0
                                and _time.time() - start_time > self.timeout)

    def aov_names(self):
        """The names of the channels this integrator adds after the film's
        own (aov and moment have some)."""
        return []


class SamplingIntegrator(Integrator):
    """Adds the fork's Doppler/time-sampling parameters
    (reference integrator.cpp:54-100)."""

    is_doppler = False

    def __init__(self, props: Properties):
        super().__init__(props)
        self.is_doppler = (props.get_bool("is_doppler_integrator", False)
                           or self.is_doppler)
        tsm = props.get_string("time_sampling_method", "antithetic")
        if tsm not in TIME_SAMPLING_METHODS:
            raise RuntimeError(f"Unknown time_sampling_method '{tsm}'")
        self.time_sampling_method = TIME_SAMPLING_METHODS[tsm]
        default_shift = (0.5 if self.time_sampling_method == TIME_ANTITHETIC
                         else 0.0)
        self.antithetic_shift = props.get_float("antithetic_shift",
                                                default_shift)
        self.use_stratified_sampling_for_each_interval = props.get_bool(
            "use_stratified_sampling_for_each_interval", True)
        self.path_correlation_depth = props.get_int("path_correlation_depth",
                                                    0)
        props.get_int("block_size", 0)
        self.samples_per_pass = props.get_int("samples_per_pass", -1)

    def sample(self, sa, sampler, state, ray: Ray, active,
               wavelengths=None):
        """(spectrum, valid, sampler state, AOV channels): one channel
        tensor per name of ``aov_names()``, so an empty list for most.
        ``wavelengths`` (the spectral variant): the lanes' three hero
        wavelengths, whose radiance samples ride the spectrum's channels."""
        raise NotImplementedError

    def render(self, scene, sensor=None, seed: int = 0, spp: int = 0,
               develop_film: bool = True,
               max_lanes: int = DEFAULT_MAX_LANES, device=None,
               checkpoint_path: str = None, checkpoint_every: int = 16):
        """Render on ``device`` (default: the scene's device).

        Wavefront sizing, as in the JAX package: when the frame at full spp
        exceeds ``max_lanes``, each pass renders the next few pixel rows at
        full spp (strip passes); sampler streams are windowed from one
        global wavefront, so the image does not depend on the split. Else,
        when ``MI_SPP_SLICE_PASSES`` is set, or when the integrator has a
        ``timeout``, spp is sliced: the largest divisor of spp with
        W*H*d <= max_lanes per pass (integrator.cpp:227-245).

        Between passes the render stops early on ``cancel()`` or once
        ``timeout`` seconds have passed, and develops what it has. With
        ``checkpoint_path`` the block and the pass count are saved to that
        ``.npz`` every ``checkpoint_every`` passes and after the last, and
        a render of the same seed, spp and split resumes from the file:
        each pass is a pure function of (scene, seed, pass), so a resumed
        render equals an uninterrupted one bit for bit."""
        if sensor is None:
            sensor = scene.sensor
        film = sensor.film
        sampler = sensor.sampler
        if spp:
            sampler.set_sample_count(spp)
        spp = sampler.sample_count

        W, H = film.crop_size
        spp_per_pass = spp if self.samples_per_pass < 0 else min(
            self.samples_per_pass, spp)
        rows_per_pass = max_lanes // max(W * spp, 1)
        # a timed render keeps spp slicing: its partial film must be a
        # whole (noisy) image, not a band of rows (integrator.cpp:248-255)
        strip_mode = (self.samples_per_pass < 0 and self.timeout <= 0.0
                      and W * H * spp > max_lanes and rows_per_pass >= 1
                      and not os.environ.get("MI_SPP_SLICE_PASSES"))
        if strip_mode:
            spp_per_pass = spp
            rows_per_pass = min(rows_per_pass, H)
            n_passes = -(-H // rows_per_pass)
            n_lanes = rows_per_pass * W * spp
        else:
            while W * H * spp_per_pass > max_lanes and spp_per_pass > 1:
                d = spp_per_pass - 1
                while spp % d != 0:
                    d -= 1
                spp_per_pass = d
            n_passes = spp // spp_per_pass
            n_lanes = W * H * spp_per_pass

        sampler.set_samples_per_wavefront(spp_per_pass)
        sa = scene.compile(device)
        state = sampler.seed(seed, n_lanes, device=sa.device)
        # the film's channels, then the integrator's AOVs
        n_channels = film.channel_count + len(self.aov_names())
        if strip_mode:
            # canvas: filter-reach pads + whole strips (a ragged last strip
            # renders inactive lanes); the center [pad, pad+H) is the image
            pad_k = filter_reach(film.rfilter)
            block = block_create(W, pad_k * 2 + n_passes * rows_per_pass,
                                 n_channels, device=sa.device)
        else:
            pad_k = 0
            block = block_create(W, H, n_channels, device=sa.device)
        run_pass = _build_pass_fn(self, sensor, sampler, film, W, H,
                                  spp_per_pass,
                                  rows_per_pass if strip_mode else None,
                                  pad_k, mueller=mueller_path(self, sa))
        start_pass = 0
        if checkpoint_path is not None and os.path.exists(checkpoint_path):
            with np.load(checkpoint_path) as f:
                ck = {k: f[k] for k in f.files}
            if (int(ck["seed"]) == seed and int(ck["spp"]) == spp
                    and bool(ck.get("strip", False)) == strip_mode
                    and ck["block"].shape == tuple(block.shape)):
                start_pass = int(ck["pass_idx"])
                block = torch.as_tensor(ck["block"], device=sa.device)
                if strip_mode:
                    # windowed streams depend only on (seed, lane): seed
                    # the resume strip's lane window directly
                    state = sampler.seed(seed, n_lanes,
                                         lane0=start_pass * n_lanes,
                                         device=sa.device)
                else:
                    for _ in range(start_pass):
                        state = sampler.advance(state)

        self._cancel = False
        t_start = _time.time()
        # The pass loop queues work on the card without waiting for it. A
        # timeout measures the card's progress, and a cancel() can come
        # only from another thread, so in either case each pass is waited
        # for before the check; otherwise nothing waits.
        sync = sa.device.type == "cuda" and (
            self.timeout > 0.0 or threading.active_count() > 1)
        for p in range(start_pass, n_passes):
            block, state = run_pass(sa, block, state)
            if p + 1 < n_passes:
                state = (sampler.advance_window(state) if strip_mode
                         else sampler.advance(state))
            if checkpoint_path is not None and (
                    (p + 1) % checkpoint_every == 0 or p + 1 == n_passes):
                np.savez(checkpoint_path, block=block.cpu().numpy(),
                         pass_idx=p + 1, seed=seed, spp=spp,
                         strip=strip_mode)
            if p + 1 < n_passes:
                if sync:
                    torch.cuda.synchronize(sa.device)
                if self.should_stop(t_start):
                    # develop the partial accumulation, scaled by its own
                    # weight channel (integrator.cpp:48-50)
                    _log.log(_log.WARN,
                             "render cancelled after %d/%d passes (%s)",
                             p + 1, n_passes,
                             "cancel()" if self._cancel else "timeout")
                    break
        if strip_mode:
            block = block[:, pad_k:pad_k + H]
        if develop_film:
            return develop(block, film.has_alpha, film.weight_index)
        return block


def scene_depolarizing(sa) -> bool:
    """True when polarized transport provably equals scalar transport,
    so the Mueller chain can be skipped: every BSDF is an exact
    depolarizer (diffuse or null), every emitter emits unpolarized light,
    media transmittance is diagonal and no phase is Rayleigh. The
    polarized film holds S0, so on such scenes the scalar loop's image is
    the polarized one (S1..S3 vanish). ``MI_NO_DEPOL_FASTPATH=1`` turns
    the fast path off, as in the JAX package."""
    if os.environ.get("MI_NO_DEPOL_FASTPATH"):
        return False
    if set(sa.bsdf_types_present) - {0, 1}:
        return False
    return not sa.any_rayleigh


def mueller_path(integrator, sa) -> bool:
    """Whether a render of ``integrator`` on ``sa`` takes the Mueller
    loop (its ``sample_stokes``) outside ``stokes``: a polarized variant,
    a path-style integrator (``stokes`` has no ``sample_stokes``: it
    always runs its nested one) and a scene that is not depolarizing. Taken
    once a render, so that the pass function is keyed on the decision
    itself (the JAX package's pass cache leaves the environment switch
    out of its key)."""
    return (bool(sa.polarized) and hasattr(integrator, "sample_stokes")
            and not scene_depolarizing(sa))


def _build_sample_fn(integrator, sensor, sampler, film, W, H, spp_per_pass,
                     mueller: bool = False):
    """The per-lane sample body: pixel decode, sampler draws, camera ray,
    integrator, film channels (an integrator's AOVs follow RGB, alpha and
    the weight). In the spectral variants a "hero" integrator gets three
    hero wavelengths from one more draw right after the sensor's, and its
    samples become linear sRGB, or a specfilm's SRF channels, before the
    splat. With ``mueller`` the integrator's ``sample_stokes`` runs and
    its S0 is the spectrum. Returns ``sample_wavefront(sa, state, lane,
    active) -> (values, put_x, put_y, active, state)`` with ``lane`` the
    global lane ids (lane // spp = pixel, row-major)."""
    sensor_params = sensor.device_params()
    lens_params = (sensor.device_lens_params()
                   if hasattr(sensor, "device_lens_params") else None)
    needs_aperture = sensor.needs_aperture_sample
    rfilter = film.rfilter
    has_alpha = film.has_alpha
    shutter_open = float(sensor.shutter_open)
    shutter_time = float(sensor.shutter_open_time)
    is_doppler = integrator.is_doppler
    correlate_pixel = integrator.path_correlation_depth > 0
    if hasattr(integrator, "set_sensor"):
        integrator.set_sensor(sensor)

    def sample_wavefront(sa, state, lane, active):
        n = lane.shape[0]
        pix = lane // spp_per_pass
        py = (pix // W).to(torch.float32)
        px = (pix % W).to(torch.float32)

        # ---- position / aperture / time draws (integrator.cpp:399-543) --
        if is_doppler:
            off, state = sampler.next_2d_correlate(state, active,
                                                   correlate_pixel)
        else:
            off, state = sampler.next_2d(state, active)
        sx = px + off[0]
        sy = py + off[1]
        adj_x = sx * (1.0 / W)
        adj_y = sy * (1.0 / H)

        if needs_aperture:
            if is_doppler:
                ap, state = sampler.next_2d_correlate(state, active,
                                                      correlate_pixel)
            else:
                ap, state = sampler.next_2d(state, active)
            ap_x, ap_y = ap
        else:
            ap_x = ap_y = torch.full((n,), 0.5, device=lane.device)

        time = torch.full((n,), shutter_open, device=lane.device)
        if shutter_time > 0.0:
            if is_doppler:
                ts, state = sampler.next_1d_time(
                    state, active, integrator.time_sampling_method,
                    integrator.antithetic_shift,
                    integrator.use_stratified_sampling_for_each_interval)
            else:
                ts, state = sampler.next_1d(state, active)
            time = time + ts * shutter_time

        ray, ray_weight = sample_ray_kind(sensor_params, lens_params, time,
                                          adj_x, adj_y, ap_x, ap_y)
        if sa.spectral and integrator.spectral_mode is None:
            raise RuntimeError(
                f"integrator '{type(integrator).__name__}' does not support "
                "the spectral variants")
        wavelengths = None
        if sa.spectral and integrator.spectral_mode == "hero":
            # the wavelength sample follows the sensor's draws
            # (integrator.cpp:497-499), pixel-correlated under the Doppler
            # sampler
            if is_doppler:
                wls, state = sampler.next_1d_correlate(state, active,
                                                       correlate_pixel)
            else:
                wls, state = sampler.next_1d(state, active)
            wavelengths = hero_wavelengths(wls)
        if mueller:
            # the polarized variants: Mueller transport, the film's image
            # is S0
            S, valid, state = integrator.sample_stokes(
                sa, sampler, state, ray, active, wavelengths=wavelengths)
            spec, aovs = S[0], []
        else:
            spec, valid, state, aovs = integrator.sample(
                sa, sampler, state, ray, active, wavelengths=wavelengths)
        spec = spec * ray_weight

        one = torch.ones((n,), device=lane.device)
        if wavelengths is not None and getattr(film, "srfs", None):
            # specfilm: ch_k = (range / 3) sum_i v_i SRF_k(lambda_i)
            values = []
            for lam_tab, val_tab in film.srf_tables():
                lt = torch.tensor(lam_tab, dtype=torch.float32,
                                  device=lane.device)
                vt = torch.tensor(val_tab, dtype=torch.float32,
                                  device=lane.device)
                ch = 0.0
                for lam, v in zip(wavelengths, spec):
                    ch = ch + v * interp(lam, lt, vt, 0.0, 0.0)
                values.append((LAMBDA_RANGE / 3.0) * ch)
            values = values + [one] + aovs
        else:
            if wavelengths is not None:
                spec = hero_to_srgb(spec, wavelengths)
            alpha = [torch.where(valid, 1.0, 0.0)] if has_alpha else []
            values = [spec.x, spec.y, spec.z] + alpha + [one] + aovs
        # box filter: accumulate into the sample's own pixel
        # (imageblock.cpp:471)
        put_x = px if rfilter.is_box else sx
        put_y = py if rfilter.is_box else sy
        return values, put_x, put_y, active, state

    return sample_wavefront


def _build_pass_fn(integrator, sensor, sampler, film, W, H, spp_per_pass,
                   strip_rows: int = None, pad_rows: int = 0,
                   mueller: bool = False):
    """One pass over the sampler state's lane window. With ``strip_rows``
    the pass covers pixel rows [row0, row0 + strip_rows) at full spp, row0
    given by the window's first lane. ``mueller``: see
    ``mueller_path``."""
    sample_fn = _build_sample_fn(integrator, sensor, sampler, film, W, H,
                                 spp_per_pass, mueller)
    strip = strip_rows is not None

    def run_pass(sa, block, state):
        lane = state.lane
        if strip:
            # ragged last strip: lanes past the frame are inactive
            active = lane < W * H * spp_per_pass
            row0 = state.lane0 // (W * spp_per_pass)
        else:
            active = torch.ones(lane.shape, dtype=torch.bool,
                                device=lane.device)
            row0 = 0
        values, put_x, put_y, active, state = sample_fn(sa, state, lane,
                                                        active)
        with profile_phase("ImageBlockPut"):
            block = block_splat_wavefront(
                block, film.rfilter, put_x, put_y, values, active, W, H,
                spp_per_pass, pad_rows=pad_rows, row0=row0,
                strip_rows=strip_rows)
        return block, state

    return run_pass


class MonteCarloIntegrator(SamplingIntegrator):
    """reference integrator.cpp:568-588."""

    def __init__(self, props: Properties):
        super().__init__(props)
        md = props.get_int("max_depth", -1)
        if md < 0 and md != -1:
            raise RuntimeError("max_depth must be -1 or >= 0")
        self.max_depth = 2 ** 31 if md == -1 else md
        self.rr_depth = props.get_int("rr_depth", 5)
        if self.rr_depth <= 0:
            raise RuntimeError("rr_depth must be > 0")
        # pure BSDF sampling with use_nee=false (the reference's
        # prb_basic): no emitter draws are used, no shadow rays, and
        # emitter hits are not MIS-weighted
        self.use_nee = props.get_bool("use_nee", True)

    @property
    def loop_iterations(self) -> int:
        return min(self.max_depth, 64)


# ---------------------------------------------------------------------------
# The shared MIS path loop (path.cpp == dopplertofpath.cpp modulo the
# modulation weight and the correlate-gated draws)
# ---------------------------------------------------------------------------

def textured_reflectance(sa, lane_bsdf, si, wavelengths=None):
    """(reflectance, mask) of the lanes whose BSDF row names a texture,
    or (None, None) in a scene without textures. The mask is the row's
    texture column >= 0, as in the JAX package: plastic rows leave it at 0
    and so take texture 0 (ROADMAP Queue C). With ``wavelengths`` bitmaps
    give their reflectance spectra at those wavelengths."""
    if sa.n_textures == 0:
        return None, None
    lane_tex = sa.bsdf_params[P_REFL_TEX][lane_bsdf.long()].to(torch.int32)
    return (eval_texture(sa, lane_tex, si.uv_u, si.uv_v, p=si.p, b_u=si.b_u,
                         b_v=si.b_v, prim=si.prim, wavelengths=wavelengths),
            lane_tex >= 0)


def _apply_normal_maps(sa, si):
    """The shading frames of lanes whose BSDF row names a normal or
    height map, perturbed at the hit: a tangent-space normal from the
    texel (reference src/bsdfs/normalmap.cpp), or for a bump map the
    height's central-difference uv gradient (bumpmap.cpp: dp_du' = dp_du
    + n dh/du) times the row's scale; ``wi`` is re-expressed in the new
    frame."""
    lane_bsdf = sa.inst_bsdf[torch.clamp(si.inst, min=0).long()].long()
    nm_tex = sa.bsdf_params[P_NMAP_TEX][lane_bsdf].to(torch.int32)
    bscale = sa.bsdf_params[P_BMAP_SCALE][lane_bsdf]
    has = (nm_tex >= 0) & si.valid
    c = eval_texture(sa, nm_tex, si.uv_u, si.uv_v, p=si.p, b_u=si.b_u,
                     b_v=si.b_v, prim=si.prim)
    is_bump = bscale > 0.0
    eps = 1e-3

    def lum(v):
        return (v.x + v.y + v.z) * (1.0 / 3.0)
    hu1 = lum(eval_texture(sa, nm_tex, si.uv_u + eps, si.uv_v))
    hu0 = lum(eval_texture(sa, nm_tex, si.uv_u - eps, si.uv_v))
    hv1 = lum(eval_texture(sa, nm_tex, si.uv_u, si.uv_v + eps))
    hv0 = lum(eval_texture(sa, nm_tex, si.uv_u, si.uv_v - eps))
    dhdu = bscale * (hu1 - hu0) * (0.5 / eps)
    dhdv = bscale * (hv1 - hv0) * (0.5 / eps)
    tx = torch.where(is_bump, -dhdu, 2.0 * c.x - 1.0)
    ty = torch.where(is_bump, -dhdv, 2.0 * c.y - 1.0)
    tz = torch.where(is_bump, 1.0, 2.0 * c.z - 1.0)
    new_n = normalize(si.sh_s * tx + si.sh_t * ty + si.sh_n * tz)
    ns = where3(has, new_n, si.sh_n)
    sh_s, sh_t = coordinate_system(ns)
    wi_world = si.to_world(si.wi)
    wi = Vec3(dot(wi_world, sh_s), dot(wi_world, sh_t), dot(wi_world, ns))
    return si._replace(sh_n=ns, sh_s=sh_s, sh_t=sh_t, wi=wi)


def _path_loop(integrator, sa, sampler, state, ray: Ray, active,
               modulation_weight=None, use_correlate=False,
               wavelengths=None):
    n = ray.o.x.shape[0]
    dev = ray.o.x.device

    throughput = Vec3.ones(n, device=dev)
    result = Vec3.zeros(n, device=dev)
    path_length = torch.zeros((n,), device=dev)
    eta = torch.ones((n,), device=dev)
    depth = torch.zeros((n,), dtype=torch.int64, device=dev)
    # with an environment every camera ray sees something
    has_env = sa.has_environment and not integrator.hide_emitters
    valid_ray = torch.full((n,), bool(has_env), dtype=torch.bool,
                           device=dev)
    prev_p = ray.o
    prev_bsdf_pdf = torch.ones((n,), device=dev)
    prev_bsdf_delta = torch.ones((n,), dtype=torch.bool, device=dev)
    zero = torch.zeros((n,), device=dev)

    bsdf_flags = torch.tensor(sa.bsdf_flags_host, dtype=torch.int32,
                              device=dev)
    pcd = integrator.path_correlation_depth
    depth_cap = min(integrator.max_depth, 2 ** 31 - 1)
    any_emission = sa.n_emitters > 0
    nee_on = any_emission and integrator.use_nee

    def weight_fn(t, pl):
        if modulation_weight is None:
            return 1.0
        return modulation_weight(t, pl)

    def draw_1d(state, active, correlate):
        if use_correlate:
            return sampler.next_1d_correlate(state, active, correlate)
        return sampler.next_1d(state, active)

    def draw_2d(state, active, correlate):
        if use_correlate:
            return sampler.next_2d_correlate(state, active, correlate)
        return sampler.next_2d(state, active)

    # Python loop over bounces. It stops early once no lane is active,
    # where the JAX package's bounce_loop does: draws advance only on
    # active lanes, so an all-dead bounce changes no state, and
    # correlated transport keeps its lockstep draws.
    for _ in range(integrator.loop_iterations):
        if not bool(active.any()):
            break
        correlate = (depth + 1) < pcd

        with profile_phase("RayIntersect"):
            si = ray_intersect(sa, ray, active)
        if sa.any_nmap:
            si = _apply_normal_maps(sa, si)
        path_length = path_length + torch.where(si.valid, si.t * eta, 0.0)

        # ---------------- direct emission (path.cpp:150-168) -------------
        lane_emitter = torch.where(
            si.valid, sa.inst_emitter[torch.clamp(si.inst, min=0).long()],
            -1)
        if any_emission:
            em_val = em_mod.eval_emitter_hit(sa, si.sh_n, -ray.d,
                                             lane_emitter, si.uv_u, si.uv_v,
                                             wavelengths)
            if has_env:
                # rays that escape see the environment
                miss_env = (~si.valid) & active
                em_val = where3(miss_env, em_mod.environment_eval(
                    sa, ray.d, wavelengths), em_val)
                emit_mask = active & ((lane_emitter >= 0) | miss_env)
            else:
                emit_mask = active & (lane_emitter >= 0)
            # MIS pdf of NEE sampling this hit from the previous vertex
            # (without NEE the hit is weighted 1)
            em_pdf = zero
            if nee_on:
                d_seg = si.p - prev_p
                dist = torch.sqrt(torch.clamp(dot(d_seg, d_seg), min=1e-20))
                ds_hit = DirectionSample(
                    p=si.p, n=si.sh_n, d=d_seg * (1.0 / dist), dist=dist,
                    pdf=zero, delta=torch.zeros_like(active),
                    emitter=lane_emitter)
                em_pdf = torch.where(prev_bsdf_delta, 0.0,
                                     em_mod.pdf_direction(
                                         sa, ds_hit, prim=si.prim,
                                         time=ray.time))
                if has_env:
                    # NEE samples the environment too: escaped rays are
                    # MIS-weighted against it
                    env_pdf = em_mod.environment_pdf_direction(
                        sa, ray.d) * (1.0 / max(sa.n_emitters, 1))
                    em_pdf = torch.where(miss_env & ~prev_bsdf_delta,
                                         env_pdf, em_pdf)
            mis_bsdf = mis_weight(prev_bsdf_pdf, em_pdf)
            lw = weight_fn(ray.time, path_length)
            scale = torch.where(emit_mask, mis_bsdf * lw, 0.0)
            result = result + throughput * em_val * scale

        active_next = (depth + 1 < depth_cap) & si.valid & active
        lane_bsdf = sa.inst_bsdf[torch.clamp(si.inst, min=0).long()].long()
        smooth = (bsdf_flags[lane_bsdf] & FLAG_SMOOTH) != 0

        # ---------------- emitter sampling / NEE (path.cpp:178-201) ------
        active_em = active_next & smooth
        nee, state = draw_2d(state, active, correlate)
        if nee_on:
            ds, em_weight = em_mod.sample_direction(sa, si.p, ray.time,
                                                    nee[0], nee[1],
                                                    wavelengths)
            active_em = active_em & (ds.pdf != 0.0)
            shadow_ray = si.spawn_ray_to(ds.p)
            with profile_phase("RayTest"):
                occluded = ray_test(sa, shadow_ray, active_em)
            nee_ok = active_em & ~occluded
            wo_nee = si.to_local(ds.d)
        else:
            wo_nee = Vec3(zero, zero, zero)

        # ------------- BSDF eval & sample (path.cpp:204-210) -------------
        s1, state = draw_1d(state, active, correlate)
        s2, state = draw_2d(state, active, correlate)
        tex_refl, tex_mask = textured_reflectance(sa, lane_bsdf, si,
                                                  wavelengths)
        bs = bsdf_eval_pdf_sample(sa, lane_bsdf, si.wi, wo_nee, s1, s2[0],
                                  s2[1], tex_refl, tex_mask, wavelengths)

        # ------------- NEE contribution (path.cpp:212-226) ---------------
        if nee_on:
            mis_em = torch.where(ds.delta, 1.0,
                                 mis_weight(ds.pdf, bs.pdf_nee))
            lw = weight_fn(ray.time, path_length + ds.dist)
            scale = torch.where(nee_ok, mis_em * lw, 0.0)
            result = result + throughput * bs.val_nee * em_weight * scale

        # ------------- next ray (path.cpp:228-258) ------------------------
        wo_world = si.to_world(bs.wo)
        new_ray = si.spawn_ray(wo_world)

        throughput = where3(active_next, throughput * bs.weight, throughput)
        eta = eta * torch.where(active_next, bs.eta, 1.0)
        valid_ray = valid_ray | (active & si.valid & ~bs.sampled_null)
        prev_p = where3(si.valid, si.p, prev_p)
        prev_bsdf_pdf = torch.where(active_next, bs.pdf, prev_bsdf_pdf)
        prev_bsdf_delta = torch.where(active_next, bs.sampled_delta,
                                      prev_bsdf_delta)
        depth = depth + (si.valid & active).to(torch.int64)

        # ------------- russian roulette (path.cpp:260-276) ----------------
        throughput_max = vmax(throughput)
        rr_prob = torch.clamp(throughput_max * eta * eta, max=0.95)
        rr_active = depth >= integrator.rr_depth
        rr_draw, state = draw_1d(state, active, correlate)
        rr_continue = rr_draw < rr_prob
        rr_scale = torch.where(rr_active,
                               1.0 / torch.clamp(rr_prob, min=1e-8), 1.0)
        throughput = throughput * rr_scale

        active = (active_next & (~rr_active | rr_continue)
                  & (throughput_max != 0.0))
        ray = Ray(where3(active_next, new_ray.o, ray.o),
                  where3(active_next, wo_world, ray.d),
                  ray.time, new_ray.maxt)

    spec = where3(valid_ray, result, Vec3(zero, zero, zero))
    return spec, valid_ray, state, []


@register_plugin("integrator", "path")
class PathIntegrator(MonteCarloIntegrator):
    """MIS path tracer (reference src/integrators/path.cpp)."""
    spectral_mode = "hero"

    def sample(self, sa, sampler, state, ray, active, wavelengths=None):
        return _path_loop(self, sa, sampler, state, ray, active,
                          wavelengths=wavelengths)

    def sample_stokes(self, sa, sampler, state, ray, active,
                      wavelengths=None):
        from .polarized import path_loop_polarized
        return path_loop_polarized(self, sa, sampler, state, ray, active,
                                   wavelengths=wavelengths)


@register_plugin("integrator", "dopplertofpath")
class DopplerToFPathIntegrator(MonteCarloIntegrator):
    """Doppler ToF path tracer (reference src/integrators/dopplertofpath.cpp;
    parameters and semantics of dopplertofpath.cpp:19-77)."""
    is_doppler = True
    spectral_mode = "hero"

    def __init__(self, props: Properties):
        props.mark_queried("is_doppler_integrator")
        super().__init__(props)
        self.time = props.get_float("time", 0.0015)
        self.w_g = props.get_float("w_g", 30.0)
        self.g_1 = props.get_float("g_1", 0.5)
        self.g_0 = props.get_float("g_0", 0.5)
        self.w_s = props.get_float("w_s", 30.0)
        self.sensor_phase_offset = props.get_float("sensor_phase_offset", 0.0)
        if props.has_property("hetero_offset"):
            self.sensor_phase_offset = (props.get_float("hetero_offset")
                                        * 2.0 * math.pi)
        if props.has_property("hetero_frequency"):
            self.hetero_frequency = props.get_float("hetero_frequency")
            self.w_s = self.w_g + self.hetero_frequency / self.time * 1e-6
        else:
            self.hetero_frequency = (self.w_s - self.w_g) * 1e6 * self.time
        wft = props.get_string("wave_function_type", "sinusoidal")
        if wft not in WAVEFORM_TYPES:
            raise RuntimeError(f"Unknown wave_function_type '{wft}'")
        self.wave_function_type = WAVEFORM_TYPES[wft]
        self.low_frequency_component_only = props.get_bool(
            "low_frequency_component_only", True)

    def eval_modulation_weight(self, ray_time, path_length):
        """reference dopplertofpath.cpp:60-77."""
        w_g = 2.0 * math.pi * self.w_g * 1e6
        w_d = 2.0 * math.pi / self.time * self.hetero_frequency
        phi = (2.0 * math.pi * self.w_g) / 300.0 * path_length
        if self.low_frequency_component_only:
            t = w_d * ray_time + self.sensor_phase_offset + phi
            return 0.5 * self.g_1 * eval_modulation_low_pass(
                t, self.wave_function_type)
        t1 = w_g * ray_time - phi
        t2 = (w_g + w_d) * ray_time + self.sensor_phase_offset
        g_t = (self.g_1 * eval_modulation(t1, self.wave_function_type)
               + self.g_0)
        return eval_modulation(t2, self.wave_function_type) * g_t

    def _wrap_time(self, ray):
        # ray-time wrap into [0, T) (dopplertofpath.cpp:93)
        return ray._replace(time=torch.where(ray.time < self.time, ray.time,
                                             ray.time - self.time))

    def sample(self, sa, sampler, state, ray, active, wavelengths=None):
        return _path_loop(self, sa, sampler, state, self._wrap_time(ray),
                          active,
                          modulation_weight=self.eval_modulation_weight,
                          use_correlate=True, wavelengths=wavelengths)

    def sample_stokes(self, sa, sampler, state, ray, active,
                      wavelengths=None):
        from .polarized import path_loop_polarized
        return path_loop_polarized(
            self, sa, sampler, state, self._wrap_time(ray), active,
            modulation_weight=self.eval_modulation_weight,
            use_correlate=True, wavelengths=wavelengths)


@register_plugin("integrator", "velocity")
class VelocityIntegrator(MonteCarloIntegrator):
    """Ground-truth radial velocity (reference velocity.cpp:125-137): the
    first-hit distance at time ``time`` minus that at time 0, over
    ``time``. Two closest-hit queries a lane, each at one time for all
    lanes."""
    spectral_mode = "neutral"

    def __init__(self, props: Properties):
        super().__init__(props)
        self.time = props.get_float("time", 0.0015)

    def sample(self, sa, sampler, state, ray, active, wavelengths=None):
        si1 = ray_intersect(sa, ray._replace(
            time=torch.zeros_like(ray.time)), active)
        si2 = ray_intersect(sa, ray._replace(
            time=torch.full_like(ray.time, self.time)), active)
        velocity = (torch.where(si2.valid, si2.t, 0.0)
                    - torch.where(si1.valid, si1.t, 0.0)) / self.time
        valid = si1.valid & si2.valid
        v = torch.where(valid, velocity, 0.0)
        return Vec3(v, v, v), valid, state, []


@register_plugin("integrator", "depth")
class DepthIntegrator(SamplingIntegrator):
    """reference src/integrators/depth.cpp: the first-hit distance."""
    spectral_mode = "neutral"

    def sample(self, sa, sampler, state, ray, active, wavelengths=None):
        si = ray_intersect(sa, ray, active)
        v = torch.where(si.valid, si.t, 0.0)
        return Vec3(v, v, v), si.valid, state, []


__all__ = [
    "Integrator", "SamplingIntegrator", "MonteCarloIntegrator",
    "PathIntegrator", "DopplerToFPathIntegrator", "VelocityIntegrator",
    "DepthIntegrator", "mis_weight", "textured_reflectance",
    "scene_depolarizing", "mueller_path", "DEFAULT_MAX_LANES",
]
