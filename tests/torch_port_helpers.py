"""Shared by the port's CPU tests of the large-scene kernels
(tests/test_torch_large_scene.py, tests/test_torch_alt_kernels.py): the
mixed static + animated scene of tests/test_mxu_kernel.py compiled by both
packages, rays made with numpy for both, the (t, prim) criterion, and the
JAX package's render of the 2k animated-mesh scene that both files hold
the port's renders against; the fresh interpreters of the port's import
checks and of the hero's render without jax; the mini hero. Imports both
packages; only the port's tests import it."""

import contextlib
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

from torch_threads import threads_per_worker

F32_ULP = 2.0 ** -23
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# what a fresh interpreter runs: the port's import checks alone, or the
# hero's render with the port alone
_IMPORT_CHECK = (
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
_HERO_RENDER = (
    "import os, shutil, sys, tempfile, torch\n"
    "import mitsuba3dopplertof_tpu_torch as mi\n"
    "from mitsuba3dopplertof_tpu_torch.utils.hero_scene import "
    "hero_scene_dict\n"
    "mi.set_device('cpu')\n"
    "d = tempfile.mkdtemp(prefix='torch_port_hero_')\n"
    "for integ in (None, {'type': 'volpath', 'max_depth': 6}):\n"
    "    img = mi.render(mi.load_dict(hero_scene_dict(\n"
    "        res=8, spp=2, cache_dir=d, integrator=integ)))\n"
    "    print(tuple(img.shape), img.device.type, "
    "bool(torch.isfinite(img).all()), bool((img != 0).any()))\n"
    "print(sorted(os.listdir(d)))\n"
    "shutil.rmtree(d)\n"
    "print(sorted(m for m in sys.modules if m == 'jax' or "
    "m.startswith(('jax.', 'mitsuba3dopplertof_tpu.')) "
    "or m == 'mitsuba3dopplertof_tpu'))\n")


@functools.lru_cache(maxsize=None)
def _fresh_process(code: str):
    """The lines that a fresh interpreter running ``code`` prints, once
    per test process and code."""
    # the test process's share of the cores (tests/torch_threads.py)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, OMP_NUM_THREADS=str(
                             threads_per_worker())))
    assert out.returncode == 0, out.stderr[-2000:]
    return tuple(out.stdout.split("\n"))


@contextlib.contextmanager
def jax_op_by_op():
    """While open, the JAX package's renders run op by op: its pass
    functions (the camera path's and ptracer's) are called unjitted, and
    its bounce and tracking loops (``integrators.bounce_loop``) and its
    pass loops are Python loops (``MI_NO_FUSED_PASSES``), so each jnp
    function runs as its own cached program. The draws are the compiled
    render's, early exit included. Far cheaper on the CPU than one XLA
    program per scene, or than
    ``jax.disable_jit()``, which also runs each jnp function's primitives
    one by one (a measured_polarized sphere: 3 s warm against 11 s); like
    the latter, no multiply-add is fused across operations."""
    from mitsuba3dopplertof_tpu import integrators as ji
    from mitsuba3dopplertof_tpu.integrators import ptracer as jpt
    saved = ji.bounce_loop, ji._build_pass_fn, os.environ.get(
        "MI_NO_FUSED_PASSES"), jpt.jax

    class _Unjitted:
        """The jax module as ptracer sees it, its ``jit`` the identity."""
        def __getattr__(self, name):
            return getattr(saved[3], name)

        @staticmethod
        def jit(fn, **kw):
            return fn

    def bounce_loop(bounce, carry, iterations, allow_early_exit=True):
        early = (allow_early_exit and not ji._STATIC_BOUNCE_LOOP
                 and not os.environ.get("MI_NO_EARLY_EXIT"))
        for i in range(iterations):
            if early and not bool(jnp.any(carry[-1])):
                break
            carry = bounce(i, carry)
        return carry

    def build_pass_fn(*args, **kw):
        raw = saved[1](*args, **kw).raw

        def pass_fn(*a):
            return raw(*a)
        pass_fn.raw = raw
        return pass_fn

    ji.bounce_loop, ji._build_pass_fn = bounce_loop, build_pass_fn
    jpt.jax = _Unjitted()
    os.environ["MI_NO_FUSED_PASSES"] = "1"
    try:
        yield
    finally:
        ji.bounce_loop, ji._build_pass_fn = saved[:2]
        jpt.jax = saved[3]
        if saved[2] is None:
            del os.environ["MI_NO_FUSED_PASSES"]
        else:
            os.environ["MI_NO_FUSED_PASSES"] = saved[2]


def fresh_import_report():
    """A fresh interpreter imports every module of the port and renders
    nothing; the lines it prints, once per process: the default device's
    type, the modules of jax and of the JAX package in ``sys.modules`` (a
    list, empty if the port pulls in none), and whether loading a scene on
    the default device raised for want of a card ("raised" also with a
    card)."""
    return _fresh_process(_IMPORT_CHECK)[:3]


def fresh_hero_report():
    """A fresh interpreter imports the port, builds the hero's assets with
    it in a temporary directory and renders the full-size hero on the CPU
    (asked for) at 8x8 x 2 spp with dopplertofpath and with volpath: per
    render (shape, device type, all finite, any nonzero), the assets' file
    names, and the modules of jax and of the JAX package in
    ``sys.modules`` after the renders."""
    return _fresh_process(_HERO_RENDER)[:4]


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


# ---------------------------------------------------------------------------
# The mini hero: utils/hero_scene.py with a 192-triangle knot and a
# 96-triangle sphere, every plugin kept (tests/test_torch_hero.py and
# tests/test_torch_hero_plugins.py)
# ---------------------------------------------------------------------------

MINI_HERO = dict(res=16, spp=4, max_depth=4)
HERO_INTEGRATORS = {"dopplertofpath": None,
                    "volpath": {"type": "volpath", "max_depth": 4}}


@functools.lru_cache(maxsize=None)
def mini_hero_dir():
    """A directory with the mini hero's assets, once per process: the JAX
    package's ``_knot_obj(nu=12, nv=8)`` and ``_icosphere_obj(nu=8,
    nv=6)``, then its ``hero_assets`` (EXRs and the .vol grid as the JAX
    package writes them)."""
    from mitsuba3dopplertof_tpu.utils import hero_scene as jh
    d = tempfile.mkdtemp(prefix="torch_port_hero_")
    jh._knot_obj(os.path.join(d, "knot.obj"), nu=12, nv=8)
    jh._icosphere_obj(os.path.join(d, "sphere.obj"), nu=8, nv=6)
    jh.hero_assets(d)
    return d


def mini_hero_dict(port: bool, integrator: str, **kw):
    """The mini hero's scene dict for the port (``port``) or the JAX
    package, with ``integrator`` ("dopplertofpath" or "volpath")."""
    from mitsuba3dopplertof_tpu.utils import hero_scene as jh
    from mitsuba3dopplertof_tpu_torch.utils import hero_scene as th
    args = dict(MINI_HERO, cache_dir=mini_hero_dir(), **kw)
    if HERO_INTEGRATORS[integrator] is not None:
        args["integrator"] = dict(HERO_INTEGRATORS[integrator])
    return (th if port else jh).hero_scene_dict(**args)


@contextlib.contextmanager
def jax_python_obj_loader():
    """The JAX package's OBJ loader on its pure-Python path, the one the
    port ports (float64 coordinates), instead of its native shim (float32
    where it builds; ROADMAP Queue C): the two packages then compile OBJ
    meshes to the same tables bit for bit."""
    from mitsuba3dopplertof_tpu.io import mesh_loaders as jml
    saved = jml._OBJ_SHIM_TRIED, jml._OBJ_SHIM
    jml._OBJ_SHIM_TRIED, jml._OBJ_SHIM = True, None
    try:
        yield
    finally:
        jml._OBJ_SHIM_TRIED, jml._OBJ_SHIM = saved


@functools.lru_cache(maxsize=None)
def jax_mini_hero_scene():
    """The JAX package's compiled mini hero (dopplertofpath), once per
    process: its tables serve the function tests."""
    with jax_python_obj_loader():
        return mj.load_dict(mini_hero_dict(False, "dopplertofpath")).compile()
