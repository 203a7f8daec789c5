"""The PyTorch port's per-module functions against the JAX package on the
same inputs (made with numpy): waveforms, warps, camera rays, emitter
sampling and pdfs (rectangle and animated mesh lights), and the BSDF
dispatch."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import mitsuba3dopplertof_tpu as mj
import mitsuba3dopplertof_tpu_torch as mt
from mitsuba3dopplertof_tpu import bsdfs as jb, emitters as je
from mitsuba3dopplertof_tpu.core import transform as jtf, warp as jw
from mitsuba3dopplertof_tpu.core import waveform as jwf
from mitsuba3dopplertof_tpu.core.vec import Vec3 as JV
from mitsuba3dopplertof_tpu.render.types import DirectionSample as JDS
from mitsuba3dopplertof_tpu.sensors import sample_ray as j_sample_ray
from mitsuba3dopplertof_tpu_torch import bsdfs as tb, emitters as te
from mitsuba3dopplertof_tpu_torch.core import transform as ttf, warp as tw
from mitsuba3dopplertof_tpu_torch.core import waveform as twf
from mitsuba3dopplertof_tpu_torch.core.vec import Vec3 as TV
from mitsuba3dopplertof_tpu_torch.render.scene import (SceneArrays,
                                                       from_jax_scene_arrays)
from mitsuba3dopplertof_tpu_torch.render.types import DirectionSample as TDS
from mitsuba3dopplertof_tpu_torch.sensors import sample_ray_kind

N = 4096


def _f(rng, lo, hi, n=N):
    return rng.uniform(lo, hi, n).astype(np.float32)


def _close(j, t, rtol=1e-5, atol=1e-6):
    j = np.asarray(j)
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return j.shape == t.shape and np.allclose(t, j, rtol=rtol, atol=atol)


@pytest.mark.parametrize("wave", sorted(jwf.WAVEFORM_TYPES.values()))
def test_waveforms(wave):
    t = _f(np.random.default_rng(wave), -60.0, 60.0)
    for jfn, tfn in ((jwf.eval_modulation, twf.eval_modulation),
                     (jwf.eval_modulation_low_pass,
                      twf.eval_modulation_low_pass)):
        a = np.asarray(jfn(jnp.asarray(t), wave))
        b = tfn(torch.from_numpy(t), wave).numpy()
        if wave in (jwf.WAVE_RECTANGULAR, jwf.WAVE_TRIANGULAR) or (
                jfn is jwf.eval_modulation_low_pass
                and wave == jwf.WAVE_TRAPEZOIDAL):
            # no transcendental: the floored modulus must be exact
            assert np.array_equal(a, b)
        else:
            assert np.allclose(b, a, rtol=0, atol=2e-6)


def test_cosine_hemisphere():
    rng = np.random.default_rng(1)
    sx, sy = _f(rng, 0, 1), _f(rng, 0, 1)
    sx[:4] = 0.5
    sy[:4] = [0.5, 0.0, 1.0, 0.5]
    j = jw.cosine_hemisphere_c(jnp.asarray(sx), jnp.asarray(sy))
    t = tw.cosine_hemisphere_c(torch.from_numpy(sx), torch.from_numpy(sy))
    for a, b in zip(j, t):
        assert _close(a, b, atol=2e-6)


CANONICAL_KW = dict(spp=4, resx=8, resy=8)


def _canonical():
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scenes", "canonical", "scene.xml")
    return mj.load_file(path, **CANONICAL_KW), mt.load_file(
        path, device="cpu", **CANONICAL_KW)


def test_camera_rays():
    sj, st = _canonical()
    rng = np.random.default_rng(2)
    sx, sy, time = _f(rng, 0, 1), _f(rng, 0, 1), _f(rng, 0, 0.0015)
    rj, _ = j_sample_ray(sj.sensor.device_params(), jnp.asarray(time),
                         jnp.asarray(sx), jnp.asarray(sy), None, None)
    rt, w = sample_ray_kind(st.sensor.device_params(), None,
                            torch.from_numpy(time), torch.from_numpy(sx),
                            torch.from_numpy(sy))
    assert w == 1.0
    for a, b in zip((*rj.o, *rj.d, rj.time, rj.maxt),
                    (*rt.o, *rt.d, rt.time, rt.maxt)):
        assert _close(a, b)


def _mesh_light_scenes():
    """A static rectangle light and an animated cube light (the mesh-CDF
    path of both sample_direction and pdf_direction)."""
    def d(tf):
        return {
            "type": "scene",
            "sensor": {"type": "perspective", "fov": 45},
            "floor": {"type": "rectangle",
                      "to_world": tf.translate([0, -1, 0])
                      @ tf.rotate([1, 0, 0], -90) @ tf.scale([3, 3, 1])},
            "lamp": {"type": "rectangle",
                     "to_world": tf.translate([0, 1.5, 0])
                     @ tf.rotate([1, 0, 0], 90) @ tf.scale([0.3, 0.3, 1]),
                     "emitter": {"type": "area", "radiance": {
                         "type": "rgb", "value": [4.0, 3.0, 2.0]}}},
            "glow": {"type": "cube", "to_world": tf.AnimatedTransform([
                (0.0, tf.translate([0.5, 0, 0.5]) @ tf.scale([0.2] * 3)),
                (1.0, tf.translate([0.9, 0.3, 0.5]) @ tf.scale([0.25] * 3))]),
                "emitter": {"type": "area", "radiance": {
                    "type": "rgb", "value": [1.0, 2.0, 5.0]}}},
        }
    return mj.load_dict(d(jtf)), mt.load_dict(d(ttf), device="cpu")


def _tables(sj):
    sa_j = sj.compile()
    return sa_j, from_jax_scene_arrays(
        {k: np.asarray(getattr(sa_j, k)) for k in SceneArrays.ARRAY_FIELDS},
        sa_j)


@pytest.mark.parametrize("scene", ["canonical", "mesh_lights"])
def test_emitter_sampling_and_pdf(scene):
    sj, st = _canonical() if scene == "canonical" else _mesh_light_scenes()
    sa_j, sa_t = _tables(sj)
    sa_p = st.compile()
    for k in SceneArrays.ARRAY_FIELDS:       # the port's own compile
        assert torch.equal(getattr(sa_p, k), getattr(sa_t, k)), k
    assert sa_p.mesh_em_meta == sa_j.mesh_em_meta
    rng = np.random.default_rng(3)
    p = [_f(rng, -0.8, 0.8) for _ in range(3)]
    time = _f(rng, 0.0, 1.0)
    ux, uy = _f(rng, 0, 1), _f(rng, 0, 1)
    jp, tp = JV(*map(jnp.asarray, p)), TV(*map(torch.from_numpy, p))
    dsj, spj = je.sample_direction(sa_j, jp, jnp.asarray(time),
                                   jnp.asarray(ux), jnp.asarray(uy))
    dst, spt = te.sample_direction(sa_t, tp, torch.from_numpy(time),
                                   torch.from_numpy(ux), torch.from_numpy(uy))
    for a, b in zip(dsj, dst):
        if isinstance(a, JV):
            assert all(_close(x, y, rtol=1e-4, atol=1e-5)
                       for x, y in zip(a, b))
        else:
            assert _close(a, b, rtol=1e-4, atol=1e-5)
    for a, b in zip(spj, spt):
        assert _close(a, b, rtol=1e-4, atol=1e-5)
    assert float(dst.pdf.max()) > 0.0
    # the MIS pdf of those samples as hits, with the hit slot for the
    # animated mesh light's per-triangle area
    n_tri = sa_j.n_static_tris + sa_j.n_anim_tris
    prim = rng.integers(0, n_tri, N).astype(np.int32)
    hj = JDS(dsj.p, dsj.n, dsj.d, dsj.dist, dsj.pdf, dsj.delta, dsj.emitter)
    ht = TDS(*dst)
    a = je.pdf_direction(sa_j, hj, prim=jnp.asarray(prim),
                         time=jnp.asarray(time))
    b = te.pdf_direction(sa_t, ht, prim=torch.from_numpy(prim),
                         time=torch.from_numpy(time))
    assert _close(a, b, rtol=1e-4, atol=1e-6)
    emitter = rng.integers(-1, sa_j.n_emitters, N).astype(np.int32)
    towards = [_f(rng, -1, 1) for _ in range(3)]
    a = je.eval_emitter_hit(sa_j, dsj.n, JV(*map(jnp.asarray, towards)),
                            jnp.asarray(emitter))
    b = te.eval_emitter_hit(sa_t, dst.n, TV(*map(torch.from_numpy, towards)),
                            torch.from_numpy(emitter))
    for x, y in zip(a, b):
        assert _close(x, y, rtol=1e-5)


def test_bsdf_dispatch():
    sj, _ = _canonical()
    sa_j, sa_t = _tables(sj)
    rng = np.random.default_rng(4)
    lane_bsdf = rng.integers(0, sa_j.bsdf_type.shape[0], N).astype(np.int32)
    wi = [_f(rng, -1, 1) for _ in range(3)]
    wo = [_f(rng, -1, 1) for _ in range(3)]
    s = [_f(rng, 0, 1) for _ in range(3)]
    rj = jb.eval_pdf_sample(sa_j, jnp.asarray(lane_bsdf),
                            JV(*map(jnp.asarray, wi)),
                            JV(*map(jnp.asarray, wo)),
                            *map(jnp.asarray, s))
    rt = tb.eval_pdf_sample(sa_t, torch.from_numpy(lane_bsdf),
                            TV(*map(torch.from_numpy, wi)),
                            TV(*map(torch.from_numpy, wo)),
                            *map(torch.from_numpy, s))
    # cos/sin of the concentric warp differ in their last bit between XLA
    # and torch; z = sqrt(1 - x^2 - y^2) magnifies that near the rim
    for a, b in zip(rj, rt):
        pairs = zip(a, b) if isinstance(a, JV) else [(a, b)]
        for x, y in pairs:
            assert _close(x, y, atol=1e-5)
