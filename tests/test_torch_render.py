"""The slice end to end: the canonical scene (scenes/canonical/scene.xml) at
16x16 x 16 spp, seed 0, rendered by the PyTorch port on the CPU against the
JAX package on the CPU, with dopplertofpath (the main path; a correlation
image of scale ~1e-5) and with path (an O(1) image that shows errors the
Doppler image's scale hides). Also: strip-pass renders equal single-pass
renders bit for bit, the port compiles the JAX package's tables, and the
port never imports jax."""

import os

import numpy as np
import pytest
import torch

import mitsuba3dopplertof_tpu as mj
import mitsuba3dopplertof_tpu_torch as mt
from mitsuba3dopplertof_tpu_torch.render.scene import (SceneArrays,
                                                       from_jax_scene_arrays)

from torch_port_helpers import fresh_import_report

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CANONICAL = os.path.join(ROOT, "scenes", "canonical", "scene.xml")
SIZE = dict(spp=16, resx=16, resy=16)
PATH = {"type": "path", "max_depth": 4}

# Pixels allowed outside the tolerance because a float tie flipped a
# branch (a near-tie hit, a Russian-roulette draw equal to its threshold):
# (integrator, row, column, channel). None are known.
BRANCH_FLIPS = {"dopplertofpath": [], "path": []}


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    """The port defaults to the card; these tests run on the CPU."""
    prev = mt.get_device()
    mt.set_device("cpu")
    yield
    mt.set_device(prev)


def _render_jax(integrator):
    scene = mj.load_file(CANONICAL, **SIZE)
    kw = {} if integrator == "dopplertofpath" else {
        "integrator": mj.load_dict(dict(PATH))}
    return np.asarray(mj.render(scene, spp=16, seed=0, **kw))


def _render_port(integrator, **render_kw):
    scene = mt.load_file(CANONICAL, device="cpu", **SIZE)
    integ = (scene.integrator if integrator == "dopplertofpath"
             else mt.load_dict(dict(PATH)))
    return integ.render(scene, spp=16, seed=0, **render_kw).numpy()


@pytest.fixture(scope="module")
def jax_images():
    # each JAX render compiles for ~10 s: share them across the module
    return {k: _render_jax(k) for k in ("dopplertofpath", "path")}


@pytest.mark.parametrize("integrator", ["dopplertofpath", "path"])
def test_port_matches_jax(jax_images, integrator):
    ref = jax_images[integrator]
    img = _render_port(integrator)
    assert img.shape == ref.shape == (16, 16, 3)
    assert np.isfinite(img).all()
    scale = np.abs(ref).max()
    assert scale > 0.0
    close = np.isclose(img, ref, rtol=1e-4, atol=1e-4 * scale)
    bad = {tuple(int(i) for i in ix) for ix in np.argwhere(~close)}
    assert bad <= set(BRANCH_FLIPS[integrator]), sorted(bad)[:10]
    assert len(bad) <= 0.005 * img.size


@pytest.mark.parametrize("integrator", ["dopplertofpath", "path"])
def test_strip_passes_equal_single_pass(integrator):
    single = _render_port(integrator)
    # 1024 lanes at 16 px x 16 spp: 4-row strips, 4 passes
    strips = _render_port(integrator, max_lanes=1024)
    assert np.array_equal(single, strips)


def test_compiled_tables_match_jax():
    sa_j = mj.load_file(CANONICAL, **SIZE).compile()
    sa_p = mt.load_file(CANONICAL, device="cpu", **SIZE).compile()
    via = from_jax_scene_arrays(
        {k: np.asarray(getattr(sa_j, k)) for k in SceneArrays.ARRAY_FIELDS},
        sa_j)
    for k in SceneArrays.ARRAY_FIELDS:
        a, b = getattr(sa_p, k), getattr(via, k)
        assert a.dtype == b.dtype and torch.equal(a, b), k
    for k in SceneArrays.META_FIELDS:
        assert getattr(sa_p, k) == getattr(via, k), k
    assert (sa_p.n_static_tris, sa_p.n_anim_tris, len(sa_p.anim_ranges),
            sa_p.n_emitters) == (10, 24, 2, 1)


def test_scene_parameters():
    scene = mt.load_file(CANONICAL, device="cpu")
    assert scene.sensor.film.size == (256, 256)
    assert scene.sensor.sampler.sample_count == 1024
    integ = scene.integrator
    assert integ.plugin_name == "dopplertofpath"
    assert (integ.max_depth, integ.path_correlation_depth,
            integ.antithetic_shift, integ.time) == (4, 4, 0.5, 0.0015)
    assert integ.hetero_frequency == 1.0


def test_import_pulls_in_no_jax():
    """Importing the port, every module of it, pulls in neither jax nor the
    JAX package (one fresh interpreter per test process, shared with
    tests/test_torch_large_scene.py)."""
    assert fresh_import_report()[1] == "[]"


def test_unported_features_name_their_roadmap_item():
    with pytest.raises(NotImplementedError, match="item 11"):
        mt.set_variant("cuda_spectral")
    assert mt.set_variant("cuda_rgb") == "cuda_rgb"
    with pytest.raises(NotImplementedError, match="item 10"):
        mt.load_dict({"type": "spot"})
    with pytest.raises(NotImplementedError, match="item 3"):
        mt.load_dict({"type": "ply", "filename": "x.ply"})
