"""Tests of the PyTorch port that need an NVIDIA GPU: the B1 CUDA kernel
(csrc/intersect_bruteforce.cu) against its plain PyTorch version, and a
small render on the card against the same render on the CPU. They skip
without a card. This file imports only the port (no jax), so it also runs
on a machine without the JAX package:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import os

import numpy as np
import pytest
import torch

import mitsuba3dopplertof_tpu_torch as mt
from mitsuba3dopplertof_tpu_torch.core import transform as tf
from mitsuba3dopplertof_tpu_torch.core.transform import AnimatedTransform
from mitsuba3dopplertof_tpu_torch.core.vec import Vec3
from mitsuba3dopplertof_tpu_torch.ops import intersect_kernel as ik
from mitsuba3dopplertof_tpu_torch.render.types import Ray

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CANONICAL = os.path.join(ROOT, "scenes", "canonical", "scene.xml")

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _sphere_scene(device):
    def anim(a, b, t0=0.0, t1=1.0):
        return AnimatedTransform([(t0, a), (t1, b)])
    return mt.load_dict({
        "type": "scene",
        "sensor": {"type": "perspective", "fov": 45,
                   "to_world": tf.look_at([0, 0, -6], [0, 0, 0], [0, 1, 0]),
                   "film": {"type": "hdrfilm", "width": 8, "height": 8}},
        "floor": {"type": "rectangle", "to_world": tf.translate([0, -2, 0])
                  @ tf.rotate([1, 0, 0], -90) @ tf.scale([4, 4, 1])},
        "mover": {"type": "cube", "to_world": anim(
            tf.translate([-1.5, 0, 1]) @ tf.scale([0.5] * 3),
            tf.translate([-1.5, 1.0, 1]) @ tf.scale([0.5] * 3), 0.2, 0.8)},
        "ball": {"type": "sphere", "center": [0.0, 1.5, 1.0], "radius": 0.6},
        "movingball": {"type": "sphere", "to_world": anim(
            tf.translate([0.5, -1.0, 0.5]) @ tf.scale([0.45] * 3),
            tf.translate([-0.5, -1.0, 0.5]) @ tf.scale([0.45] * 3))},
    }, device=device)


def _rays(n, seed, device, z0, tmax):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3.0, 3.0, (n, 3))
    o[:, 2] = z0
    d = rng.uniform(-1.0, 1.0, (n, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    maxt = np.where(np.arange(n) < n // 4, rng.uniform(1.0, 9.0, n), np.inf)
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    return Ray(Vec3(*(f(o[:, i]) for i in range(3))),
               Vec3(*(f(d[:, i]) for i in range(3))),
               f(rng.uniform(0.0, tmax, n)), f(maxt))


@pytest.mark.parametrize("which", ["canonical", "spheres"])
def test_kernel_matches_plain(cuda, which):
    if which == "canonical":
        sa = mt.load_file(CANONICAL, device=cuda).compile()
        ray = _rays(1 << 16, 1, cuda, 3.5, 0.0015)
    else:
        sa = _sphere_scene(cuda).compile()
        ray = _rays(1 << 16, 2, cuda, -6.0, 1.0)
    ik.reset_launch_counts()
    hk = ik.intersect(sa, ray)
    occ = ik.ray_test(sa, ray)
    torch.cuda.synchronize()
    assert ik.LAUNCHES_BY_FORM == {"closest_hit": 1, "any_hit": 1}
    hr = ik.intersect_reference(sa, ray)
    hit = hr.prim >= 0
    assert torch.equal(hk.prim, hr.prim)
    assert torch.equal(occ, hit)
    assert int(hit.sum()) > 1000
    tri = hit & (hr.prim < ik._SPH_SLOT_BASE)
    # triangles: built with --fmad=false, bit for bit the plain version
    for a, b in zip(hk, hr):
        assert torch.equal(a[tri], b[tri])
    # spheres: the same function, up to atan2f/acosf rounding
    sph = hit & ~tri
    for a, b in zip(hk, hr):
        assert torch.allclose(a[sph].float(), b[sph].float(), rtol=1e-5,
                              atol=1e-6)


def test_render_on_card_matches_cpu(cuda):
    """16x16 x 16 spp: the card against the CPU within the slice test's
    tolerance on >= 99% of values (cos/sin/exp/rsqrt differ in their last
    bits between the devices)."""
    imgs = [mt.render(mt.load_file(CANONICAL, device=dev, spp=16, resx=16,
                                   resy=16), spp=16, seed=0).cpu().numpy()
            for dev in (cuda, "cpu")]
    g, c = imgs
    scale = np.abs(c).max()
    close = np.isclose(g, c, rtol=1e-4, atol=1e-4 * scale)
    assert close.mean() >= 0.99
    assert abs(g.mean() - c.mean()) <= 1e-3 * abs(c.mean())
