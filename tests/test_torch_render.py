"""The slice end to end: the canonical scene (scenes/canonical/scene.xml) at
16x16 x 16 spp, seed 0, rendered by the PyTorch port on the CPU against the
JAX package on the CPU, with dopplertofpath (the main path; a correlation
image of scale ~1e-5) and with path (an O(1) image that shows errors the
Doppler image's scale hides). The JAX package renders them through
``moment`` and ``aov`` (whose RGB channels are the plain renders, bit for
bit), and the port's moment and aov channels are held against theirs.
Also: strip-pass renders equal single-pass
renders bit for bit, ``MI_SPP_SLICE_PASSES`` slices spp as in the JAX
package, the port compiles the JAX package's tables, and the port never
imports jax."""

import os

import numpy as np
import pytest
import torch

import mitsuba3dopplertof_tpu as mj
import mitsuba3dopplertof_tpu_torch as mt
from mitsuba3dopplertof_tpu_torch.render.scene import (SceneArrays,
                                                       from_jax_scene_arrays)

from torch_port_helpers import fresh_import_report, jax_op_by_op
from torch_threads import shared_cores  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CANONICAL = os.path.join(ROOT, "scenes", "canonical", "scene.xml")
SIZE = dict(spp=16, resx=16, resy=16)
PATH = {"type": "path", "max_depth": 4}
AOVS = "dd:depth,nn:sh_normal,aa:albedo,pi:prim_index"

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
    """The JAX package's render with ``integrator`` wrapped: dopplertofpath
    (the scene's own) in ``moment``, path in ``aov``, run op by op
    (``jax_op_by_op``). The first three channels are the plain render's,
    bit for bit (checked in the JAX package before the fixture took them:
    no other JAX render is made)."""
    scene = mj.load_file(CANONICAL, **SIZE)
    if integrator == "dopplertofpath":
        wrapped = {"type": "moment", "nested": scene.integrator}
    else:
        wrapped = {"type": "aov", "aovs": AOVS, "nested": dict(PATH)}
    with jax_op_by_op():
        return np.asarray(mj.render(scene, spp=16, seed=0,
                                    integrator=mj.load_dict(wrapped)))


def _render_port(integrator, **render_kw):
    scene = mt.load_file(CANONICAL, device="cpu", **SIZE)
    integ = (scene.integrator if integrator == "dopplertofpath"
             else mt.load_dict(dict(PATH)))
    return integ.render(scene, spp=16, seed=0, **render_kw).numpy()


@pytest.fixture(scope="module")
def jax_renders():
    # a few seconds each: share them across the module
    return {k: _render_jax(k) for k in ("dopplertofpath", "path")}


@pytest.fixture(scope="module")
def jax_images(jax_renders):
    # the RGB channels
    return {k: v[..., :3] for k, v in jax_renders.items()}


@pytest.fixture(scope="module")
def port_images():
    # the port's single-pass renders, held against the JAX package's and
    # against strip passes
    return {k: _render_port(k) for k in ("dopplertofpath", "path")}


@pytest.mark.parametrize("integrator", ["dopplertofpath", "path"])
def test_port_matches_jax(jax_images, port_images, integrator):
    ref = jax_images[integrator]
    img = port_images[integrator]
    assert img.shape == ref.shape == (16, 16, 3)
    assert np.isfinite(img).all()
    scale = np.abs(ref).max()
    assert scale > 0.0
    close = np.isclose(img, ref, rtol=1e-4, atol=1e-4 * scale)
    bad = {tuple(int(i) for i in ix) for ix in np.argwhere(~close)}
    assert bad <= set(BRANCH_FLIPS[integrator]), sorted(bad)[:10]
    assert len(bad) <= 0.005 * img.size


# The JAX package's dopplertofpath image of the stand-in at the jax_images
# settings (16x16 x 16 spp, seed 0), rendered on the CPU by the JAX package
# of commit 6ed28bf (the package has not changed since).
STANDIN_GOLDEN = os.path.join(ROOT, "tests", "data",
                              "golden_canonical_standin_16x16_16spp.npy")


def test_standin_golden(jax_images, port_images):
    """The fixtures' dopplertofpath images, the JAX package's and the
    port's, against the stand-in's golden at the golden tolerance (atol
    2e-6, rtol 1e-4), with no new render."""
    golden = np.load(STANDIN_GOLDEN)
    assert golden.shape == (16, 16, 3) and np.abs(golden).max() > 0.0
    for img in (jax_images["dopplertofpath"],
                port_images["dopplertofpath"]):
        assert img.shape == golden.shape
        assert np.allclose(img, golden, atol=2e-6, rtol=1e-4), \
            float(np.abs(img - golden).max())


def test_moment_matches_jax(jax_renders, port_images):
    """moment around the scene's dopplertofpath: the port's RGB is its
    plain render bit for bit, and its second-moment channels agree with
    the JAX package's at the section 2 tolerance; m2 >= mean^2 per pixel
    up to rounding (a pixel's mean of squares is at least the square of
    its filtered mean). Strip passes carry the AOV channels as they carry
    RGB: the image in 4-row strips equals the single pass bit for bit."""
    scene = mt.load_file(CANONICAL, device="cpu", **SIZE)
    moment = mt.load_dict({"type": "moment", "nested": scene.integrator})
    img = moment.render(scene, spp=16, seed=0).numpy()
    strips = moment.render(scene, spp=16, seed=0, max_lanes=1024).numpy()
    assert np.array_equal(strips, img)
    ref = jax_renders["dopplertofpath"]
    assert img.shape == ref.shape == (16, 16, 6)
    assert np.array_equal(img[..., :3], port_images["dopplertofpath"])
    m2, m2_ref = img[..., 3:], ref[..., 3:]
    scale = np.abs(m2_ref).max()
    assert scale > 0.0
    np.testing.assert_allclose(m2, m2_ref, rtol=1e-4, atol=1e-4 * scale)
    assert (m2 >= img[..., :3] ** 2 * (1.0 - 1e-5) - 1e-30).all()


def test_aov_matches_jax(jax_renders, port_images, monkeypatch):
    """aov (depth, shading normal, albedo, triangle id) around path: the
    port's RGB is its plain path render bit for bit, and each AOV channel
    agrees with the JAX package's at the section 2 tolerance of that
    channel's scale. With MI_SPP_SLICE_PASSES and 1,024 lanes a pass (4
    spp slices), the slices carry the AOV channels as they carry RGB: the
    RGB is the sliced path render's bit for bit, the depth channel that
    of a sliced depth render."""
    scene = mt.load_file(CANONICAL, device="cpu", **SIZE)
    aov = mt.load_dict({"type": "aov", "aovs": AOVS, "nested": dict(PATH)})
    img = aov.render(scene, spp=16, seed=0).numpy()
    monkeypatch.setenv("MI_SPP_SLICE_PASSES", "1")
    sliced = aov.render(scene, spp=16, seed=0, max_lanes=1024).numpy()
    path_sliced = mt.load_dict(dict(PATH)).render(
        scene, spp=16, seed=0, max_lanes=1024).numpy()
    depth_sliced = mt.load_dict({"type": "depth"}).render(
        scene, spp=16, seed=0, max_lanes=1024).numpy()
    assert not np.array_equal(path_sliced, port_images["path"])
    assert np.array_equal(sliced[..., :3], path_sliced)
    np.testing.assert_allclose(sliced[..., 3], depth_sliced[..., 0],
                               rtol=1e-6, atol=1e-6)
    ref = jax_renders["path"]
    assert img.shape == ref.shape == (16, 16, 3 + 1 + 3 + 3 + 1)
    assert np.array_equal(img[..., :3], port_images["path"])
    for c in range(3, img.shape[-1]):
        scale = np.abs(ref[..., c]).max()
        assert scale > 0.0, c
        np.testing.assert_allclose(img[..., c], ref[..., c], rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=str(c))


@pytest.mark.parametrize("integrator", ["dopplertofpath", "path"])
def test_strip_passes_equal_single_pass(port_images, integrator):
    single = port_images[integrator]
    # 1024 lanes at 16 px x 16 spp: 4-row strips, 4 passes
    strips = _render_port(integrator, max_lanes=1024)
    assert np.array_equal(single, strips)


def test_spp_slice_passes_match_jax(monkeypatch):
    """With MI_SPP_SLICE_PASSES set, a frame that strip passes would split
    by rows is split by spp, as the JAX package does
    (``integrators/__init__.py`` ``render``): at 8x8 x 4 spp and 128 lanes
    a pass, two passes of 2 spp each. The port's image equals the JAX
    package's within the golden tolerance (atol 2e-6, rtol 1e-4), and
    differs from the port's strip-pass image of the same frame."""
    size = dict(spp=4, resx=8, resy=8)
    monkeypatch.setenv("MI_SPP_SLICE_PASSES", "1")
    scene_j = mj.load_file(CANONICAL, **size)
    with jax_op_by_op():
        ref = np.asarray(scene_j.integrator.render(scene_j, spp=4, seed=0,
                                                   max_lanes=128))
    scene = mt.load_file(CANONICAL, device="cpu", **size)
    img = scene.integrator.render(scene, spp=4, seed=0,
                                  max_lanes=128).numpy()
    assert img.shape == ref.shape == (8, 8, 3)
    assert np.abs(ref).max() > 0.0
    assert np.allclose(img, ref, rtol=1e-4, atol=2e-6)
    monkeypatch.delenv("MI_SPP_SLICE_PASSES")
    strips = scene.integrator.render(scene, spp=4, seed=0,
                                     max_lanes=128).numpy()
    assert not np.array_equal(strips, img)


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
    JAX package (one fresh interpreter that renders nothing, once per test
    process, shared with tests/test_torch_large_scene.py)."""
    assert fresh_import_report()[1] == "[]"


def test_unported_features_name_their_roadmap_item():
    """The polarized variants and plugins (item 11) are ported; the AD
    integrators (item 12) and dict_to_xml still name their items."""
    try:
        assert mt.set_variant("cuda_rgb_polarized") == "cuda_rgb_polarized"
    finally:
        assert mt.set_variant("cuda_rgb") == "cuda_rgb"
    assert type(mt.load_dict({"type": "polarizer"})).__name__ == "Polarizer"
    with pytest.raises(NotImplementedError, match="item 12"):
        mt.load_dict({"type": "prb_basic"})
    with pytest.raises(NotImplementedError, match="item 3"):
        mt.dict_to_xml({"type": "scene"}, "scene.xml")
    with pytest.raises(NotImplementedError, match="item 12"):
        mt.load_dict({"type": "prb"})
