"""The hero scene (utils/hero_scene.py) in the PyTorch port against the JAX
package on the CPU: its assets, its compiled tables bit for bit through
``from_jax_scene_arrays``, and the mini hero (a 192-triangle knot and a
96-triangle sphere, every plugin kept) rendered at 16x16 x 4 spp, seed 0,
by dopplertofpath and by volpath within rtol 1e-4, atol 1e-4 * max|ref|.

The hero's smoke cube stands on the floor: its bottom face and the floor
are one plane, so rays that cross it hit both at one t, to the last bits.
Which one wins is a rounding of those bits, and the two packages round
differently (XLA against PyTorch, and in the camera rays already). The
port's render marks the lanes whose paths meet such a tie or graze an
edge (``torch_ties.TieRecorder``, a few per cent of them); both packages
leave those lanes out of their films, and every other value must agree."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba3dopplertof_tpu as mj
from mitsuba3dopplertof_tpu import integrators as ji
from mitsuba3dopplertof_tpu.utils import hero_scene as jh

import mitsuba3dopplertof_tpu_torch as mt
from mitsuba3dopplertof_tpu_torch.io.bitmap import read_exr
from mitsuba3dopplertof_tpu_torch.render.scene import (SceneArrays,
                                                       from_jax_scene_arrays)
from mitsuba3dopplertof_tpu_torch.utils import hero_scene as th

from torch_port_helpers import (MINI_HERO, fresh_hero_report, jax_op_by_op,
                                jax_python_obj_loader, mini_hero_dict)
from torch_ties import TieRecorder
from torch_threads import shared_cores  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def hero_dir(tmp_path_factory):
    """The full-size hero's assets, as the JAX package writes them."""
    d = str(tmp_path_factory.mktemp("hero"))
    jh.hero_assets(d)
    return d


def test_port_hero_assets_match_jax(hero_dir, tmp_path):
    """The port's own assets: the OBJs and the .vol byte for byte, the
    EXRs (ZIP from the port; PIZ from the JAX package where it builds its
    OpenEXR shim) to the same texels."""
    ours = th.hero_assets(str(tmp_path))
    theirs = jh.hero_assets(hero_dir)
    assert sorted(ours) == sorted(theirs)
    for k in ("knot", "sphere", "smoke"):
        with open(ours[k], "rb") as a, open(theirs[k], "rb") as b:
            assert a.read() == b.read(), k
    for k in ("marble", "sky"):
        a, b = read_exr(ours[k]), read_exr(theirs[k])
        for c in "RGB":
            assert np.array_equal(a[c], b[c]), (k, c)


def test_hero_compile_matches_jax(hero_dir):
    """hero_scene_dict(res=16, spp=4) from the same asset files (the JAX
    package's OBJ loader on its pure-Python path, as the port's): the JAX
    package's tables carried over by from_jax_scene_arrays equal the
    port's own compile on every array and every metadata field."""
    d = dict(res=16, spp=4, cache_dir=hero_dir)
    with jax_python_obj_loader():
        sa_j = mj.load_dict(jh.hero_scene_dict(**d)).compile()
    sa_p = mt.load_dict(th.hero_scene_dict(**d), device="cpu").compile()
    via = from_jax_scene_arrays(
        {k: np.asarray(getattr(sa_j, k)) for k in SceneArrays.ARRAY_FIELDS},
        sa_j)
    for k in SceneArrays.ARRAY_FIELDS:
        a, b = getattr(sa_p, k), getattr(via, k)
        assert a.dtype == b.dtype and torch.equal(a, b), k
    assert torch.equal(sa_p.chunk_aabb, via.chunk_aabb)
    for k in SceneArrays.META_FIELDS:
        assert getattr(sa_p, k) == getattr(via, k), k
    assert (sa_p.n_static_tris, sa_p.n_anim_tris, sa_p.n_textures,
            sa_p.n_media, sa_p.n_emitters, sa_p.env_kind) == (
        24, 11616, 2, 1, 2, "envmap")


@functools.lru_cache(maxsize=None)
def port_mini_hero(integrator: str):
    """The port's mini hero at 16x16 x 4 spp, seed 0, on the CPU, with the
    lanes its TieRecorder marks left out of the film (the marks are made
    by the path loop, before the film is splatted): (image, recorder)."""
    res, spp = MINI_HERO["res"], MINI_HERO["spp"]
    rec = TieRecorder(res * res * spp, "cpu")
    with rec.hooked(), rec.dropped():
        img = mt.render(mt.load_dict(mini_hero_dict(True, integrator),
                                     device="cpu"), spp=spp, seed=0).numpy()
    img.setflags(write=False)
    return img, rec


@pytest.mark.parametrize("integrator", ["dopplertofpath", "volpath"])
def test_mini_hero_matches_jax(integrator, monkeypatch):
    """The JAX package renders the mini hero with the lanes the port marks
    left out of its film too (its film splat wrapped here, in the test);
    every value of the two images then agrees within rtol 1e-4, atol 1e-4
    * max|ref|, and the marked lanes are at most 6% of the lanes."""
    img, rec = port_mini_hero(integrator)
    res, spp = MINI_HERO["res"], MINI_HERO["spp"]
    n_marked = int(rec.marked.sum())
    assert 0 < n_marked <= 0.06 * res * res * spp
    keep = jnp.asarray(~rec.marked.numpy())
    splat = ji.block_splat_wavefront

    def splat_kept(block, rfilter, x, y, values, active, *args, **kw):
        assert active.shape == keep.shape
        return splat(block, rfilter, x, y, values, active & keep, *args,
                     **kw)

    monkeypatch.setattr(ji, "block_splat_wavefront", splat_kept)
    with jax_python_obj_loader():
        scene = mj.load_dict(mini_hero_dict(False, integrator))
    with jax_op_by_op():
        ref = np.asarray(mj.render(scene, spp=spp, seed=0))
    assert img.shape == ref.shape == (res, res, 3)
    assert np.isfinite(img).all()
    scale = np.abs(ref).max()
    assert scale > 0.0
    close = np.isclose(img, ref, rtol=1e-4, atol=1e-4 * scale)
    bad = [(tuple(int(i) for i in ix), float(img[tuple(ix)]),
            float(ref[tuple(ix)])) for ix in np.argwhere(~close)]
    assert not bad, (n_marked, bad)


def test_hero_renders_in_a_process_without_jax():
    """mi.render(mi.load_dict(hero_scene_dict(...))) with the port alone:
    a fresh interpreter that imports neither jax nor the JAX package
    builds the hero's assets with the port, and renders the full-size
    scene on the CPU (asked for) at 8x8 x 2 spp with dopplertofpath and
    with volpath (an interpreter of its own: the port's import checks run
    in one that renders nothing)."""
    assert fresh_hero_report() == (
        "(8, 8, 3) cpu True True", "(8, 8, 3) cpu True True",
        "['knot.obj', 'marble.exr', 'sky.exr', 'smoke.vol', 'sphere.obj']",
        "[]")


@pytest.mark.parametrize("integrator", ["dopplertofpath", "volpath"])
def test_mini_hero_routes_agree_without_marked_lanes(integrator,
                                                    monkeypatch):
    """The port alone, as chip_smoke's phase 10 holds the card against the
    CPU: the mini hero at 16x16 x 4 spp through the plain Möller
    intersector and through B5's plain version (MI_STREAM_KERNEL=v3, Woop
    and a rebuilt payload) differ only on lanes the TieRecorder marks:
    with those left out of both films, every value agrees within rtol
    1e-4, atol 1e-4 * max."""
    res, spp = MINI_HERO["res"], MINI_HERO["spp"]
    plain, rec = port_mini_hero(integrator)
    assert 0 < int(rec.marked.sum()) <= 0.1 * res * res * spp
    monkeypatch.setenv("MI_STREAM_KERNEL", "v3")
    with rec.dropped():
        woop = mt.render(mt.load_dict(mini_hero_dict(True, integrator),
                                      device="cpu"), spp=spp, seed=0).numpy()
    scale = np.abs(plain).max()
    assert scale > 0.0
    assert np.isclose(woop, plain, rtol=1e-4, atol=1e-4 * scale).all()
