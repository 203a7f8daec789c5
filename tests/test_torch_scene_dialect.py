"""The scene dialect's two renders in the PyTorch port against the JAX
package on the CPU, at 16x16 x 16 spp, seed 0: the JAX package's
deep-path benchmark row (scripts/bench_suite.py:118-139: path, max_depth
48, rr_depth 5, a sphere area light inside a two-sided diffuse box) and
the glass scene of chip_smoke.py's phase 11 with an 8x8 UV sphere (a PLY
in a shapegroup placed by an animated instance, every BSDF and emitter of
the slice; dopplertofpath, max_depth 6). Every value of the port's image
agrees with the JAX package's at the golden's tolerance (atol 2e-6, rtol
1e-4). The port's render marks the lanes whose paths meet a tie or graze
an edge (tests/torch_ties.TieRecorder), which a comparison would leave
out of both films: none are marked on these scenes."""

import os
import sys

import numpy as np
import pytest

import mitsuba3dopplertof_tpu as mj
from mitsuba3dopplertof_tpu.core import transform as jtf
from mitsuba3dopplertof_tpu.core.transform import AnimatedTransform as JAnim

import mitsuba3dopplertof_tpu_torch as mt
from mitsuba3dopplertof_tpu_torch.core import transform as ttf
from mitsuba3dopplertof_tpu_torch.core.transform import \
    AnimatedTransform as TAnim
from mitsuba3dopplertof_tpu_torch.utils.bench_scenes import (
    deep_path_scene, write_uv_sphere_ply)

from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from torch_ties import TieRecorder

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import glass_dict  # noqa: E402  (imports nothing else)

RES, SPP = 16, 16


@pytest.fixture(scope="module")
def glass_ply(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("glass") / "sphere_8x8.ply")
    assert write_uv_sphere_ply(path, 8, 8) == 128
    return path


@pytest.mark.parametrize("scene", ["deep_path", "glass"])
def test_render_matches_jax(scene, glass_ply):
    """Each scene rendered by the port on the CPU with its TieRecorder
    hooked, then by the JAX package: no lane is marked (so no lane is left
    out of either film), and every value of the port's image is within
    atol 2e-6, rtol 1e-4 of the JAX package's."""
    if scene == "deep_path":
        def make(tf, anim_cls):
            return deep_path_scene(SPP, RES, tf)
    else:
        def make(tf, anim_cls):
            return glass_dict(glass_ply, SPP, RES, tf, anim_cls)
    rec = TieRecorder(RES * RES * SPP, "cpu")
    with rec.hooked():
        img = mt.render(mt.load_dict(make(ttf, TAnim), device="cpu"),
                        spp=SPP, seed=0).numpy()
    assert int(rec.marked.sum()) == 0
    ref = np.asarray(mj.render(mj.load_dict(make(jtf, JAnim)), spp=SPP,
                               seed=0))
    assert img.shape == ref.shape == (RES, RES, 3)
    assert np.isfinite(img).all() and np.abs(ref).max() > 0.0
    close = np.isclose(img, ref, rtol=1e-4, atol=2e-6)
    bad = [(tuple(int(i) for i in ix), float(img[tuple(ix)]),
            float(ref[tuple(ix)])) for ix in np.argwhere(~close)]
    assert not bad, bad[:10]
