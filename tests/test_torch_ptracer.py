"""The particle tracer and its emitters in the PyTorch port against the JAX
package on the CPU: ``ptracer`` on a floor lit by an area light, a
``projector`` and a ``directionalarea`` beam (16x16 x 64 light paths a
pixel, seed 0), the film's scatter splat, and the two emitters' tables,
NEE samples, pdfs and hit radiance."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba3dopplertof_tpu as mj
from mitsuba3dopplertof_tpu import emitters as jem
from mitsuba3dopplertof_tpu.core import transform as jtf
from mitsuba3dopplertof_tpu.films import block_splat_scatter as jsplat

import mitsuba3dopplertof_tpu_torch as mt
from mitsuba3dopplertof_tpu_torch import emitters as tem
from mitsuba3dopplertof_tpu_torch.films import block_splat_scatter as tsplat

from test_torch_hero_plugins import _close, _close3, _jv, _tv
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import ptracer_emitters_dict  # noqa: E402  (imports nothing else)


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    prev = mt.get_device()
    mt.set_device("cpu")
    yield
    mt.set_device(prev)


def _rgb(v):
    return {"type": "rgb", "value": v}


def ptracer_scene(spp=64, integrator=None, projector_image=None):
    """chip_smoke.py's ptracer scene (a diffuse floor under an area-lit
    panel, a projector and a collimated directionalarea rectangle), 16x16
    with a box filter, ``integrator`` in place of its ptracer."""
    d = ptracer_emitters_dict(spp, jtf, projector_image)
    if integrator is not None:
        d["integrator"] = dict(integrator)
    return d


def test_ptracer_matches_jax():
    """The light-traced image within rtol 1e-4, atol 1e-4 * max|ref|
    (PERF.md section 2). Measured: the largest difference 6.8e-6 of an
    image maximum of 1.77; the JAX package's scatter splat, a difference
    of one running float32 sum, contributes most of it (test below)."""
    ref = np.asarray(mj.render(mj.load_dict(ptracer_scene()), spp=64,
                               seed=0))
    scene = mt.load_dict(ptracer_scene())
    sa = scene.compile()
    assert sa.emitter_types_present == (1, 7, 8)
    img = mt.render(scene, spp=64, seed=0).numpy()
    assert img.shape == ref.shape == (16, 16, 3)
    assert np.isfinite(img).all()
    scale = np.abs(ref).max()
    assert scale > 0.0
    np.testing.assert_allclose(img, ref, rtol=1e-4, atol=1e-4 * scale)
    # ptracer leaves the sampler at one sample a pixel, as the JAX
    # package does
    assert scene.sensor.sampler.sample_count == 1


def test_camera_paths_do_not_see_directionalarea():
    """A camera ray never sees the collimated beam's emission and NEE
    cannot sample it (directionalarea.cpp): path tracing the beam alone
    gives a black image, while ptracer lights the floor."""
    d = ptracer_scene(integrator={"type": "path", "max_depth": 3})
    del d["panel"], d["proj"]
    fw = mt.render(mt.load_dict(d), spp=16, seed=0).numpy()
    assert fw.sum() == 0.0
    lt = mt.render(mt.load_dict(d), spp=64, seed=0, integrator=mt.load_dict(
        {"type": "ptracer", "max_depth": 3})).numpy()
    assert lt.sum() > 0.0


def test_ptracer_rejects_meters():
    scene = mt.load_dict({
        "type": "scene", "integrator": {"type": "ptracer", "max_depth": 2},
        "sensor": {"type": "radiancemeter",
                   "film": {"type": "hdrfilm", "width": 1, "height": 1},
                   "sampler": {"type": "independent", "sample_count": 4}},
        "light": {"type": "constant"}})
    with pytest.raises(RuntimeError, match="ptracer.*sensor"):
        mt.render(scene, spp=4, seed=0)


def test_ptracer_rejects_checkpoints():
    """The light tracer saves no checkpoints: the camera-path integrators'
    checkpoint arguments are refused, not dropped."""
    scene = mt.load_dict(ptracer_scene(spp=4))
    with pytest.raises(TypeError, match="checkpoint_path"):
        scene.integrator.render(scene, spp=4, checkpoint_path="ck.npz")


@pytest.mark.parametrize("size", [(16, 16, 16384), (64, 32, 1 << 17)])
def test_scatter_splat(size):
    """block_splat_scatter against the exact (float64) per-pixel sums and
    against the JAX package's. Inactive records add nothing. The port adds
    each record into its pixel; the JAX package takes a pixel's sum as the
    difference of a running float32 sum over all records, whose rounding
    grows with the records before the pixel. Measured at 16,384 records
    over 16x16 pixels: the port within 4.3e-7 of the mean pixel, the JAX
    package within 4.1e-5 (at 2^20 records over 256x256: 6.0e-7 and
    1.1e-2)."""
    W, H, n = size
    rng = np.random.default_rng(11)
    px = rng.integers(0, W, n).astype(np.int32)
    py = rng.integers(0, H, n).astype(np.int32)
    v = (rng.exponential(1.0, (3, n))
         * (rng.uniform(size=n) < 0.5)).astype(np.float32)
    act = rng.uniform(size=n) < 0.8
    exact = np.zeros((3, H * W))
    for c in range(3):
        np.add.at(exact[c], (py * W + px)[act], v[c][act].astype(np.float64))
    exact = exact.reshape(3, H, W)
    mean = np.abs(exact).mean()
    block = torch.full((4, H, W), 0.5)
    ours = tsplat(block, torch.from_numpy(px), torch.from_numpy(py),
                  [torch.from_numpy(x) for x in v], torch.from_numpy(act),
                  W, H)
    assert ours is block
    assert torch.equal(ours[3], torch.full((H, W), 0.5))
    ours = ours[:3].numpy() - 0.5
    theirs = np.asarray(jsplat(jnp.zeros((4, H, W)), jnp.asarray(px),
                               jnp.asarray(py), [jnp.asarray(x) for x in v],
                               jnp.asarray(act), W, H))[:3]
    assert np.abs(ours - exact).max() <= 2e-6 * mean
    err_jax = np.abs(theirs - exact).max()
    assert err_jax <= 1e-3 * mean
    assert np.abs(ours - theirs).max() <= err_jax + 2e-6 * mean


def test_projector_and_directionalarea_emitters_match_jax():
    """The projector (its image a checkerboard) and the directionalarea
    rectangle beside an area light: the emitter and texture tables bit
    for bit; NEE samples from random points (directions, distances,
    weights and pdfs within rtol 1e-5, atol 1e-6, index and delta flags
    exactly; the projector lights only points inside its frustum, the
    beam is never sampled); their pdf 0; the hit radiance of the
    directionalarea rectangle 0, the area light's its radiance."""
    image = {"type": "checkerboard", "color0": _rgb([9.0, 3.0, 1.0]),
             "color1": _rgb([1.0, 4.0, 12.0]),
             "to_uv": jtf.scale([3, 2, 1])}
    sa_j = mj.load_dict(ptracer_scene(projector_image=image)).compile()
    sa_t = mt.load_dict(ptracer_scene(projector_image=image)).compile()
    for k in ("emitter_type", "emitter_params", "emitter_m", "tex_params",
              "tex_type", "inst_emitter"):
        assert np.array_equal(getattr(sa_t, k).numpy(),
                              np.asarray(getattr(sa_j, k))), k
    assert sa_t.n_textures == sa_j.n_textures == 1
    rng = np.random.default_rng(5)
    n = 20000
    p = rng.uniform([-2, -0.5, -2], [2, 1.5, 2], (n, 3)).astype(np.float32)
    t = np.zeros(n, np.float32)
    s = rng.uniform(0.0, 1.0, (n, 2)).astype(np.float32)
    ds_j, w_j = jem.sample_direction(sa_j, _jv(p), jnp.asarray(t),
                                     jnp.asarray(s[:, 0]),
                                     jnp.asarray(s[:, 1]))
    ds_t, w_t = tem.sample_direction(sa_t, _tv(p), torch.from_numpy(t),
                                     torch.from_numpy(s[:, 0]),
                                     torch.from_numpy(s[:, 1]))
    for f in ("p", "n", "d"):
        _close3(getattr(ds_t, f), getattr(ds_j, f), f)
    _close3(w_t, w_j, "weight")
    for f in ("dist", "pdf"):
        _close(getattr(ds_t, f), getattr(ds_j, f), f)
    for f in ("delta", "emitter"):
        _close(getattr(ds_t, f), getattr(ds_j, f), f, exact=True)
    kinds = np.asarray(sa_j.emitter_type)[np.asarray(ds_j.emitter)]
    assert set(np.unique(kinds)) == {1, 7, 8}
    lit = w_t.x.numpy() > 0.0
    assert 0.05 < lit[kinds == 7].mean() < 0.95
    assert not lit[kinds == 8].any()
    pdf_t = tem.pdf_direction(sa_t, ds_t).numpy()
    assert (pdf_t[kinds != 1] == 0.0).all()
    # hit radiance on the front (the lower) side of the area light and of
    # the beam
    inst = sa_t.inst_emitter.numpy()
    lanes = np.repeat(inst[inst >= 0], 4).astype(np.int32)
    down = np.tile(np.float32([0.0, -1.0, 0.0]), (len(lanes), 1))
    ours = tem.eval_emitter_hit(sa_t, _tv(down), _tv(down),
                                torch.from_numpy(lanes))
    theirs = jem.eval_emitter_hit(sa_j, _jv(down), _jv(down),
                                  jnp.asarray(lanes))
    _close3(ours, theirs, "hit radiance")
    kinds_hit = sa_t.emitter_type.numpy()[lanes]
    assert set(kinds_hit) == {1, 8}
    assert (ours.x.numpy()[kinds_hit == 8] == 0.0).all()
    assert (ours.x.numpy()[kinds_hit == 1] == 4.0).all()


def _floor_scene(emitter: dict, integrator: dict, spp: int,
                 sensor: dict = None) -> dict:
    """The JAX package's tests/test_ptracer_emitters.py scene: a diffuse
    floor lit by one emitter, 16x16 with a box filter."""
    d = ptracer_scene(spp, integrator)
    for key in ("panel", "proj", "beam"):
        del d[key]
    d["light"] = emitter
    if sensor is not None:
        d["sensor"] = dict(d["sensor"], **sensor)
        if sensor["type"] == "orthographic":
            del d["sensor"]["fov"]
    return d


ENERGY_CASES = {
    "point": ({"type": "point", "position": [0, 2, 0],
               "intensity": _rgb(10.0)}, None, 0.12),
    "spot": ({"type": "spot", "to_world": jtf.look_at([0, 3, 0], [0, 0, 0],
                                                      [0, 0, 1]),
              "cutoff_angle": 35.0, "beam_width": 20.0,
              "intensity": _rgb(30.0)}, None, 0.12),
    "directional": ({"type": "directional", "direction": [0.2, -1.0, 0.3],
                     "irradiance": _rgb(3.0)}, None, 0.12),
    "sphere": ({"type": "sphere", "radius": 0.3,
                "to_world": jtf.translate([0, 2, 0]),
                "emitter": {"type": "area", "radiance": _rgb(10.0)}},
               None, 0.12),
    "mesh": ({"type": "cube", "to_world": jtf.translate([0, 2, 0])
              @ jtf.scale([0.3, 0.3, 0.3]),
              "emitter": {"type": "area", "radiance": _rgb(6.0)}},
             None, 0.12),
    "constant": ({"type": "constant", "radiance": _rgb(0.8)}, None, 0.15),
    "envmap": ({"type": "envmap", "radiance": _rgb(0.8)}, None, 0.15),
    "thinlens": ({"type": "sphere", "radius": 0.3,
                  "to_world": jtf.translate([0, 1.2, 0]),
                  "emitter": {"type": "area", "radiance": _rgb(10.0)}},
                 {"type": "thinlens", "aperture_radius": 0.1,
                  "focus_distance": 3.0}, 0.15),
    "orthographic": ({"type": "point", "position": [0, 2, 0],
                      "intensity": _rgb(10.0)},
                     {"type": "orthographic", "to_world": jtf.look_at(
                         [0, 1.5, -3], [0, 0, 0], [0, 1, 0])
                      @ jtf.scale([2, 2, 1])}, 0.12),
}


@pytest.mark.parametrize("case", list(ENERGY_CASES))
def test_ptracer_energy_matches_path(case):
    """Light tracing against path tracing, by total energy, for every
    emitter kind the light paths start from and for the thin lens and the
    orthographic camera (the JAX package's criteria in
    tests/test_ptracer_emitters.py: the ratio within 12%, 15% for the
    environments and the lens): the estimators agree in the mean."""
    emitter, sensor, rel = ENERGY_CASES[case]
    imgs = []
    for integ, spp in (({"type": "path", "max_depth": 3}, 96),
                       ({"type": "ptracer", "max_depth": 3}, 512)):
        d = _floor_scene(emitter, integ, spp, sensor)
        imgs.append(mt.render(mt.load_dict(d), spp=spp, seed=0).numpy())
    fw, lt = imgs
    assert np.isfinite(lt).all() and fw.sum() > 0 and lt.sum() > 0
    assert abs(lt.sum() / fw.sum() - 1.0) < rel, (lt.sum(), fw.sum())
