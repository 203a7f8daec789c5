"""The PyTorch port's sensors and reconstruction filters against the JAX
package on the CPU, function by function (no render): rays and weights of
the thinlens, orthographic, radiancemeter, irradiancemeter (bound to a
rectangle and to a sphere), distant and batch sensors within rtol 1e-6 /
atol 1e-6; the mitchell, catmullrom and lanczos filters' ``eval`` on a grid
over [-radius, radius] within 1e-6, and each one's film splat and develop
on one random 8x8 x 4 spp wavefront within 1e-6 relative to the largest
value. Inputs are made with numpy from a seed."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import mitsuba3dopplertof_tpu as mj
import mitsuba3dopplertof_tpu_torch as mt
from mitsuba3dopplertof_tpu import films as jfilms
from mitsuba3dopplertof_tpu.core import transform as jtf
from mitsuba3dopplertof_tpu.sensors import \
    sample_ray_kind as j_sample_ray_kind
from mitsuba3dopplertof_tpu_torch import films as tfilms
from mitsuba3dopplertof_tpu_torch.core import transform as ttf
from mitsuba3dopplertof_tpu_torch.sensors import sample_ray_kind

from torch_threads import shared_cores  # noqa: F401 (autouse)

N = 512


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    """The port defaults to the card; these tests run on the CPU."""
    prev = mt.get_device()
    mt.set_device("cpu")
    yield
    mt.set_device(prev)


def _film(w=32, h=24):
    return {"type": "hdrfilm", "width": w, "height": h}


def _sensor_dicts(tf):
    """Sensor dicts by label, with transforms from ``tf`` (each package's
    own transform module)."""
    look = tf.look_at([0.3, 0.5, 3.9], [0, 0, 0], [0, 1, 0])
    return {
        "thinlens": {"type": "thinlens", "fov": 40.0,
                     "aperture_radius": 0.07, "focus_distance": 3.2,
                     "principal_point_offset_x": 0.01,
                     "to_world": look, "film": _film()},
        "orthographic": {"type": "orthographic",
                         "to_world": look @ tf.scale([1.5, 1.2, 1.0]),
                         "near_clip": 0.1, "film": _film()},
        "radiancemeter": {"type": "radiancemeter", "to_world": look,
                          "film": _film(1, 1)},
        "distant": {"type": "distant", "direction": [0.2, -1.0, 0.4],
                    "film": _film()},
        "perspective": {"type": "perspective", "fov": 45.0,
                        "to_world": look, "film": _film()},
        "irradiance_rectangle": {
            "type": "rectangle",
            "to_world": tf.translate([0.1, -0.2, 0.5])
            @ tf.rotate([1, 0, 0], -60) @ tf.scale([0.7, 1.3, 1.0]),
            "meter": {"type": "irradiancemeter", "film": _film(1, 1)}},
        "irradiance_sphere": {
            "type": "sphere", "center": [0.2, 0.1, -0.3], "radius": 0.6,
            "meter": {"type": "irradiancemeter", "film": _film(1, 1)}},
        "irradiance_unbound": {"type": "irradiancemeter",
                               "to_world": tf.translate([0, 1, 0]),
                               "film": _film(1, 1)},
    }


def _load(pkg, tf, label):
    d = _sensor_dicts(tf)
    if label == "batch":
        d = {"type": "batch", "film": _film(64, 16),
             **{k: d[k] for k in ("thinlens", "orthographic", "distant",
                                  "perspective")}}
    else:
        d = d[label]
    obj = pkg.load_dict(d)
    return obj.sensor if label.startswith("irradiance_") and \
        label != "irradiance_unbound" else obj


def _params(sensor):
    lens = (sensor.device_lens_params()
            if hasattr(sensor, "device_lens_params") else None)
    return sensor.device_params(), lens


LABELS = ("thinlens", "orthographic", "radiancemeter", "distant",
          "irradiance_rectangle", "irradiance_sphere", "irradiance_unbound",
          "batch")


@pytest.mark.parametrize("label", LABELS)
def test_sensor_rays_match_jax(label):
    sj, st = _load(mj, jtf, label), _load(mt, ttf, label)
    assert type(sj).__name__ == type(st).__name__
    assert sj.needs_aperture_sample == st.needs_aperture_sample
    rng = np.random.default_rng(LABELS.index(label))
    cols = [rng.uniform(0.0, 0.0015, N).astype(np.float32)] + [
        rng.random(N, dtype=np.float32) for _ in range(4)]
    rj, wj = j_sample_ray_kind(*_params(sj), *(jnp.asarray(c)
                                               for c in cols))
    rt, wt = sample_ray_kind(*_params(st), *(torch.from_numpy(c)
                                             for c in cols))
    for a, b in zip((*rj.o, *rj.d, rj.time, rj.maxt, wj * np.ones(N)),
                    (*rt.o, *rt.d, rt.time, rt.maxt,
                     wt * torch.ones(N))):
        a = np.broadcast_to(np.asarray(a), (N,))
        b = np.broadcast_to(np.asarray(b), (N,))
        assert np.isfinite(b).all()
        assert np.allclose(b, a, rtol=1e-6, atol=1e-6), \
            float(np.abs(a - b).max())


def test_sensor_plugins_and_bindings():
    """The loader collects a shape's irradiance meter as a scene sensor;
    a batch sensor asks for no aperture sample even with a thin-lens child,
    as in the JAX package; the thin lens and the port's other new plugins
    load by name."""
    scene = mt.load_dict({
        "type": "scene",
        "plate": _sensor_dicts(ttf)["irradiance_rectangle"],
        "integrator": {"type": "depth"}})
    assert type(scene.sensor).__name__ == "IrradianceMeter"
    assert scene.sensor.shape is not None
    assert scene.sensor.device_params().kind == 5
    batch = _load(mt, ttf, "batch")
    assert [type(c).__name__ for c in batch.children] == [
        "ThinLensSensor", "OrthographicSensor", "DistantSensor",
        "PerspectiveSensor"]
    assert not batch.needs_aperture_sample
    assert _load(mt, ttf, "thinlens").needs_aperture_sample
    film = mt.load_dict({"type": "hdrfilm", "crop_offset_x": 3,
                         "crop_offset_y": 2})
    assert film.crop_offset == (3, 2)
    for kind in ("mitchell", "catmullrom", "lanczos"):
        assert type(mt.load_dict({"type": kind})).__name__.endswith("Filter")


FILTERS = ("mitchell", "catmullrom", "lanczos")


@pytest.mark.parametrize("kind", FILTERS)
def test_filter_eval_matches_jax(kind):
    fj, ft = mj.load_dict({"type": kind}), mt.load_dict({"type": kind})
    assert fj.radius == ft.radius
    x = np.linspace(-ft.radius, ft.radius, 2001, dtype=np.float32)
    a = np.asarray(fj.eval(jnp.asarray(x)))
    b = ft.eval(torch.from_numpy(x)).numpy()
    assert np.allclose(b, a, rtol=1e-6, atol=1e-6), float(np.abs(a - b).max())
    # negative lobes: the weight can go below zero, and nothing clamps it
    assert (b < 0.0).any()


W, H, SPP = 8, 8, 4


@pytest.mark.parametrize("kind", FILTERS)
def test_filter_splat_matches_jax(kind):
    rf = (mj.load_dict({"type": kind}), mt.load_dict({"type": kind}))
    assert tfilms.filter_reach(rf[1]) == jfilms.filter_reach(rf[0])
    n = W * H * SPP
    rng = np.random.default_rng(FILTERS.index(kind))
    lane = np.arange(n) // SPP
    pos_x = (lane % W + rng.random(n)).astype(np.float32)
    pos_y = (lane // W + rng.random(n)).astype(np.float32)
    values = [rng.normal(size=n).astype(np.float32) for _ in range(3)]
    values.append(np.ones(n, np.float32))
    active = rng.random(n) < 0.9
    jb = jfilms.block_splat_wavefront(
        jfilms.block_create(W, H, 4), rf[0], jnp.asarray(pos_x),
        jnp.asarray(pos_y), [jnp.asarray(v) for v in values],
        jnp.asarray(active), W, H, SPP)
    tb = tfilms.block_splat_wavefront(
        tfilms.block_create(W, H, 4), rf[1], torch.from_numpy(pos_x),
        torch.from_numpy(pos_y), [torch.from_numpy(v) for v in values],
        torch.from_numpy(active), W, H, SPP)
    for a, b in ((jb, tb), (jfilms.develop(jb, False),
                            tfilms.develop(tb, False))):
        a, b = np.asarray(a), b.numpy()
        scale = float(np.abs(a).max())
        assert np.isfinite(b).all()
        assert np.allclose(b, a, rtol=1e-6, atol=1e-6 * scale), \
            float(np.abs(a - b).max())
