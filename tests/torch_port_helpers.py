"""Shared by the port's CPU tests of the large-scene kernels
(tests/test_torch_large_scene.py, tests/test_torch_alt_kernels.py): the
mixed static + animated scene of tests/test_mxu_kernel.py compiled by both
packages, rays made with numpy for both, the (t, prim) criterion, and the
JAX package's render of the 2k animated-mesh scene that both files hold
the port's renders against. Imports both packages; only the port's tests
import it."""

import functools
import os
import subprocess
import sys
import tempfile

import jax.numpy as jnp
import numpy as np
import torch

import mitsuba3dopplertof_tpu as mj
from mitsuba3dopplertof_tpu.core import transform as jtf
from mitsuba3dopplertof_tpu.core.transform import AnimatedTransform
from mitsuba3dopplertof_tpu.core.vec import Vec3 as JVec3
from mitsuba3dopplertof_tpu.render.types import Ray as JRay

import mitsuba3dopplertof_tpu_torch as mt
from mitsuba3dopplertof_tpu_torch.core.transform import \
    AnimatedTransform as TAnimatedTransform
from mitsuba3dopplertof_tpu_torch.core.vec import Vec3 as TVec3
from mitsuba3dopplertof_tpu_torch.render.scene import (SceneArrays,
                                                       from_jax_scene_arrays)
from mitsuba3dopplertof_tpu_torch.render.types import Ray as TRay
from mitsuba3dopplertof_tpu_torch.utils.bench_scenes import (
    animated_mesh_scene, write_uv_sphere_obj)

F32_ULP = 2.0 ** -23
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@functools.lru_cache(maxsize=None)
def fresh_import_report():
    """A fresh interpreter imports every module of the port; the lines it
    prints, once per process: the default device's type, the modules of
    jax and of the JAX package in ``sys.modules`` (a list, empty if the
    port pulls in none), and whether loading a scene on the default device
    raised for want of a card ("raised" also with a card)."""
    code = (
        "import sys, pkgutil, importlib, torch\n"
        "import mitsuba3dopplertof_tpu_torch as mi\n"
        "for m in pkgutil.walk_packages(mi.__path__, mi.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "print(mi.get_device().type)\n"
        "print(sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'mitsuba3dopplertof_tpu.')) "
        "or m == 'mitsuba3dopplertof_tpu'))\n"
        "if not torch.cuda.is_available():\n"
        "    try:\n"
        "        mi.load_file('scenes/canonical/scene.xml')\n"
        "        print('loaded')\n"
        "    except RuntimeError as e:\n"
        "        print('raised' if 'CUDA' in str(e) else e)\n"
        "else:\n"
        "    print('raised')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split("\n")
    return tuple(out[:3])


def sphere_obj(path, nu, nv):
    """A unit UV sphere with per-vertex normals and uvs ("f a/a/a")."""
    lines = []
    for j in range(nv + 1):
        for i in range(nu):
            th, ph = np.pi * j / nv, 2 * np.pi * i / nu
            x, y, z = np.sin(th) * np.cos(ph), np.cos(th), \
                np.sin(th) * np.sin(ph)
            lines += [f"v {x:.6f} {y:.6f} {z:.6f}",
                      f"vn {x:.6f} {y:.6f} {z:.6f}",
                      f"vt {i / nu:.6f} {j / nv:.6f}"]

    def vid(i, j):
        return j * nu + (i % nu) + 1
    for j in range(nv):
        for i in range(nu):
            a, b, c, d = vid(i, j), vid(i + 1, j), vid(i + 1, j + 1), \
                vid(i, j + 1)
            lines.append(f"f {a}/{a}/{a} {b}/{b}/{b} {c}/{c}/{c}")
            lines.append(f"f {a}/{a}/{a} {c}/{c}/{c} {d}/{d}/{d}")
    path.write_text("\n".join(lines))


def mixed_dict(obj, anim_cls, spheres=False):
    """tests/test_mxu_kernel.py's mixed scene with a 1,536-triangle sphere
    (above the binning threshold of 1,024): the static OBJ sphere, an
    animated cube, a floor and a point light."""
    d = {
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 2},
        "sensor": {"type": "perspective", "fov": 45,
                   "to_world": jtf.look_at([0, 0, -6], [0, 0, 0], [0, 1, 0]),
                   "film": {"type": "hdrfilm", "width": 8, "height": 8},
                   "sampler": {"type": "independent", "sample_count": 1}},
        "light": {"type": "point", "position": [0, 4, -4],
                  "intensity": {"type": "rgb", "value": 10.0}},
        "floor": {"type": "rectangle",
                  "to_world": jtf.translate([0, -2, 0])
                  @ jtf.rotate([1, 0, 0], -90) @ jtf.scale([4, 4, 1])},
        "bigmesh": {"type": "obj", "filename": str(obj),
                    "to_world": jtf.translate([1.5, 0.5, 1.0])
                    @ jtf.scale([0.9] * 3)},
        "mover": {"type": "cube", "to_world": anim_cls([
            (0.0, jtf.translate([-1.5, 0, 1]) @ jtf.scale([0.5] * 3)
             @ jtf.rotate([0, 1, 0], 10)),
            (1.0, jtf.translate([-1.5, 1.0, 1]) @ jtf.scale([0.5] * 3)
             @ jtf.rotate([0, 1, 0], 55))])},
    }
    if spheres:
        d["ball"] = {"type": "sphere", "center": [0.0, 1.0, 0.0],
                     "radius": 0.5}
    return d


def build_mixed_scene(tmp_dir, port_compile=True):
    """(JAX SceneArrays, port SceneArrays carried over from it, port
    SceneArrays of the port's own compile or None, OBJ path) of the mixed
    scene with a 32 x 24 sphere (1,536 triangles)."""
    obj = tmp_dir / "sph.obj"
    sphere_obj(obj, 32, 24)
    sa_j = mj.load_dict(mixed_dict(obj, AnimatedTransform)).compile()
    arrays = {k: np.asarray(getattr(sa_j, k))
              for k in SceneArrays.ARRAY_FIELDS + ["chunk_aabb"]}
    sa_t = from_jax_scene_arrays(arrays, sa_j)
    sa_p = mt.load_dict(mixed_dict(obj, TAnimatedTransform)).compile() \
        if port_compile else None
    return sa_j, sa_t, sa_p, obj


@functools.lru_cache(maxsize=None)
def jax_mesh_render():
    """scripts/bench_suite.py's 2k animated-mesh scene (32 x 32 UV sphere,
    2,048 triangles, point light, dopplertofpath, correlated sampler) at
    16x16 x 4 spp, seed 0, rendered by the JAX package on its default
    route, once per process; (OBJ path, image)."""
    obj = tempfile.mkdtemp(prefix="torch_port_mesh_") + "/sph32.obj"
    assert write_uv_sphere_obj(obj, 32, 32) == 2048
    ref = np.asarray(mj.render(mj.load_dict(animated_mesh_scene(
        obj, spp=4, res=16, tf=jtf, anim_cls=AnimatedTransform)),
        spp=4, seed=0))
    ref.setflags(write=False)
    return obj, ref


def shell_rays(n, seed):
    """tests/test_mxu_kernel.py::_rays: rays from a shell in front of the
    scene, a quarter of them with finite maxt, times in [0, 1]."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3.0, 3.0, (n, 3))
    o[:, 2] -= 5.0
    dd = rng.uniform(-2.0, 2.0, (n, 3)) - o
    dd /= np.linalg.norm(dd, axis=1, keepdims=True)
    maxt = np.full(n, np.inf)
    maxt[:n // 4] = rng.uniform(3.0, 9.0, n // 4)
    return o, dd, rng.uniform(0.0, 1.0, n), maxt


def both_rays(o, d, time, maxt):
    f32 = np.float32
    jr = JRay(JVec3(*(jnp.asarray(o[:, i], f32) for i in range(3))),
              JVec3(*(jnp.asarray(d[:, i], f32) for i in range(3))),
              jnp.asarray(time, f32), jnp.asarray(maxt, f32))
    tr = TRay(TVec3(*(torch.from_numpy(o[:, i].astype(f32))
                      for i in range(3))),
              TVec3(*(torch.from_numpy(d[:, i].astype(f32))
                      for i in range(3))),
              torch.from_numpy(time.astype(f32)),
              torch.from_numpy(maxt.astype(f32)))
    return jr, tr


def assert_t_prim(t_p, p_p, t_r, p_r, rtol, label):
    """tests/test_pallas_parity.py's criterion on (t, prim): the same lanes
    hit, t within ``rtol``, and a different prim only where t ties
    (within 1e-3 relative: a shared edge)."""
    t_p, p_p, t_r, p_r = (np.asarray(x) for x in (t_p, p_p, t_r, p_r))
    hit = p_r >= 0
    assert ((p_p >= 0) == hit).all(), (label, "occlusion")
    assert np.allclose(t_p[hit], t_r[hit], rtol=rtol, atol=0.0), \
        (label, "t", np.abs(t_p[hit] - t_r[hit]).max())
    bad = hit & (p_p != p_r)
    assert np.allclose(t_p[bad], t_r[bad], rtol=1e-3), (label, "prim")
    assert bad.mean() < 2e-3, (label, "too many ties", bad.sum())
    return int(hit.sum())
