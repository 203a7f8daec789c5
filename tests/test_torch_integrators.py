"""The rgb variant's other camera-path integrators in the PyTorch port
against the JAX package on the CPU: ``direct`` on the canonical stand-in
(16x16 x 16 spp, seed 0) with three walls made ``principled``,
``principledthin`` and ``pplastic``, ``path`` with ``use_nee=false``,
``volpathmis`` (volpath's estimator in rgb), and the ``aov`` / ``moment``
front ends. Images agree within rtol 1e-4, atol 1e-4 * max|ref|
(PERF.md section 2). ``moment`` and ``aov`` against the JAX package's
renders are in tests/test_torch_render.py, which shares its renders."""

import os

import jax
import numpy as np
import pytest
import torch

import mitsuba3dopplertof_tpu as mj
from mitsuba3dopplertof_tpu.integrators import volpath as jvolpath
from mitsuba3dopplertof_tpu.io.xml import xml_to_dict as jxml_to_dict

import mitsuba3dopplertof_tpu_torch as mt
from mitsuba3dopplertof_tpu_torch.core.vec import Vec3
from mitsuba3dopplertof_tpu_torch.integrators import volpath as tvolpath
from mitsuba3dopplertof_tpu_torch.io.xml import xml_to_dict as txml_to_dict
from mitsuba3dopplertof_tpu_torch.render.scene import ray_intersect
from mitsuba3dopplertof_tpu_torch.render.types import Ray

from torch_port_helpers import mini_hero_dict
from torch_threads import shared_cores  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CANONICAL = os.path.join(ROOT, "scenes", "canonical", "scene.xml")
SIZE = {"spp": "16", "resx": "16", "resy": "16"}


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    prev = mt.get_device()
    mt.set_device("cpu")
    yield
    mt.set_device(prev)


def _rgb(v):
    return {"type": "rgb", "value": v}


# the three walls' BSDFs: the anisotropic, transmitting principled with
# every lobe on, the thin sheet with both transmissions, and pplastic
PRINCIPLED_WALLS = {
    "green-wall": {"type": "principled", "base_color": _rgb([0.2, 0.6, 0.1]),
                   "metallic": 0.3, "roughness": 0.35, "anisotropic": 0.5,
                   "sheen": 0.4, "clearcoat": 0.6, "spec_trans": 0.3,
                   "spec_tint": 0.2},
    "red-wall": {"type": "principledthin", "base_color": _rgb([0.7, 0.1, 0.1]),
                 "roughness": 0.4, "spec_trans": 0.4, "diff_trans": 0.6,
                 "sheen": 0.2},
    "back": {"type": "pplastic", "alpha": 0.1,
             "diffuse_reflectance": _rgb([0.6, 0.5, 0.4])},
}


def standin_dict(xml_to_dict, walls=PRINCIPLED_WALLS):
    """The canonical stand-in (16x16 x 16 spp) as a scene dict, with the
    named shapes' BSDFs replaced."""
    d = xml_to_dict(CANONICAL, dict(SIZE))
    for key, bsdf in walls.items():
        d[key] = {k: v for k, v in d[key].items()
                  if not k.startswith("_ref")}
        d[key]["bsdf"] = dict(bsdf)
    return d


def _assert_close(img, ref):
    assert img.shape == ref.shape
    assert np.isfinite(img).all()
    scale = np.abs(ref).max()
    assert scale > 0.0
    np.testing.assert_allclose(img, ref, rtol=1e-4, atol=1e-4 * scale)


def test_direct_with_principled_family_matches_jax():
    """direct (one emitter and one BSDF sample) over the principled
    family. The JAX render runs eagerly (jax.disable_jit): compiled, this
    one render took 69 s on an 8-core Intel Xeon, eagerly 21 s, with the
    same agreement (max difference 1.9e-6 of 8.1)."""
    integ = {"type": "direct"}
    with jax.disable_jit():
        ref = np.asarray(mj.render(mj.load_dict(standin_dict(jxml_to_dict)),
                                   integrator=mj.load_dict(dict(integ)),
                                   spp=16, seed=0))
    scene = mt.load_dict(standin_dict(txml_to_dict))
    sa = scene.compile()
    assert sa.bsdf_types_present == (0, 6, 11, 17)
    img = mt.render(scene, integrator=mt.load_dict(dict(integ)), spp=16,
                    seed=0).numpy()
    _assert_close(img, ref)


def test_path_without_nee_matches_jax():
    """path with use_nee=false: BSDF sampling alone, emitter hits not
    MIS-weighted; it differs from the NEE render of the same seed."""
    integ = {"type": "path", "max_depth": 4, "use_nee": False}
    ref = np.asarray(mj.render(mj.load_file(CANONICAL, **SIZE),
                               integrator=mj.load_dict(dict(integ)),
                               spp=16, seed=0))
    scene = mt.load_file(CANONICAL, **SIZE)
    img = mt.render(scene, integrator=mt.load_dict(dict(integ)), spp=16,
                    seed=0).numpy()
    _assert_close(img, ref)
    nee = mt.render(scene, integrator=mt.load_dict(
        {"type": "path", "max_depth": 4}), spp=16, seed=0).numpy()
    assert not np.allclose(nee, img)


def test_volpathmis_is_volpath():
    """volpathmis renders the mini hero as volpath does, bit for bit: in
    rgb the JAX package's class overrides nothing of volpath, and so does
    the port's."""
    # what a class statement and register_plugin set on any class
    inherited = {"__module__", "__doc__", "__qualname__", "__firstlineno__",
                 "__static_attributes__", "plugin_name", "plugin_category"}
    assert set(vars(jvolpath.VolPathMISIntegrator)) <= inherited
    assert set(vars(tvolpath.VolPathMISIntegrator)) <= inherited
    assert issubclass(tvolpath.VolPathMISIntegrator,
                      tvolpath.VolPathIntegrator)
    imgs = []
    for name in ("volpath", "volpathmis"):
        d = mini_hero_dict(True, "volpath")
        d["integrator"] = dict(d["integrator"], type=name)
        imgs.append(mt.render(mt.load_dict(d), spp=4, seed=0).numpy())
    assert np.abs(imgs[0]).max() > 0.0
    assert np.array_equal(imgs[0], imgs[1])


def test_aov_index_channels_are_the_hits():
    """aov's prim_index and shape_index channels are the closest hits'
    triangle and instance ids, exactly (the ids are the JAX package's:
    tests/test_torch_intersect.py), and depth their distance."""
    scene = mt.load_file(CANONICAL, **SIZE)
    sa = scene.compile()
    integ = mt.load_dict({"type": "aov",
                          "aovs": "pi:prim_index,si:shape_index,dd:depth"})
    assert integ.aov_names() == ["pi", "si", "dd"]
    rng = np.random.default_rng(3)
    n = 4096
    d = rng.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    o = torch.zeros(n)
    t = torch.from_numpy
    ray = Ray(Vec3(o, o, o + 0.5), Vec3(t(d[0]), t(d[1]), t(d[2])),
              t(rng.uniform(0, 0.0015, n).astype(np.float32)),
              torch.full((n,), float("inf")))
    active = torch.ones(n, dtype=torch.bool)
    spec, valid, _, aovs = integ.sample(sa, None, None, ray, active)
    si = ray_intersect(sa, ray, active)
    assert 0.5 < valid.float().mean() < 1.0   # the box is open in front
    assert torch.equal(aovs[0], si.prim.to(torch.float32))
    assert torch.equal(aovs[1], si.inst.to(torch.float32))
    assert torch.equal(aovs[2], torch.where(si.valid, si.t, 0.0))
    assert torch.equal(spec.x, torch.zeros(n))


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_front_end_errors(pkg):
    """The parameter errors of aov, moment and direct, alike in both
    packages."""
    m = mj if pkg == "jax" else mt
    with pytest.raises(RuntimeError, match="ray differentials"):
        m.load_dict({"type": "aov", "aovs": "d:duv_dx"})
    with pytest.raises(RuntimeError, match="unknown type"):
        m.load_dict({"type": "aov", "aovs": "x:curvature"})
    with pytest.raises(RuntimeError, match="nested integrator"):
        m.load_dict({"type": "moment"})
    with pytest.raises(RuntimeError, match="at least 1"):
        m.load_dict({"type": "direct", "emitter_samples": 0,
                     "bsdf_samples": 0})
    aov = m.load_dict({"type": "aov", "aovs": "p:position,u:uv,a:albedo",
                       "c": {"type": "path"}})
    assert aov.aov_names() == ["p.x", "p.y", "p.z", "u.u", "u.v", "a.x",
                               "a.y", "a.z"]
    mom = m.load_dict({"type": "moment", "c": {
        "type": "dopplertofpath", "path_correlation_depth": 3,
        "time_sampling_method": "antithetic", "antithetic_shift": 0.25}})
    assert mom.is_doppler and mom.path_correlation_depth == 3
    assert mom.antithetic_shift == 0.25
    assert mom.aov_names() == ["m2.R", "m2.G", "m2.B"]
