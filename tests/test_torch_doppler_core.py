"""The rest of the Doppler core in the PyTorch port against the JAX package
on the CPU: the timestratified, stratified, multijitter, ldsampler and
orthogonal samplers draw for draw (values and RNG state bit for bit, masked
and unmasked, across ``advance``); the velocity and depth integrators and a
dopplertofpath render through a thin lens, the timestratified sampler and
the mitchell filter, on the canonical scene at 16x16 x 4 spp, seed 0,
within the golden tolerance of tests/test_torch_render.py (rtol 1e-4,
atol 1e-4 * max |image|, no pixel excused). Then, port only: a render
timeout, ``cancel()`` and checkpoints (a render stopped after 2 of 4 passes
and resumed equals the uninterrupted render bit for bit, in strip and in
spp-sliced mode; the file has the JAX package's keys). Inputs are made with
numpy from a seed."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mitsuba3dopplertof_tpu as mj
import mitsuba3dopplertof_tpu_torch as mt
from mitsuba3dopplertof_tpu import samplers as js
from mitsuba3dopplertof_tpu.core import rng as jrng

from torch_threads import shared_cores  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CANONICAL = os.path.join(ROOT, "scenes", "canonical", "scene.xml")
N = 256


@pytest.fixture(autouse=True, scope="module")
def _cpu():
    """The port defaults to the card; these tests run on the CPU."""
    prev = mt.get_device()
    mt.set_device("cpu")
    yield
    mt.set_device(prev)


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------

def _same_state(sj, st):
    for f in ("rng", "rng_time", "rng_path"):
        for x, y in zip(getattr(sj, f), getattr(st, f)):
            assert np.array_equal(np.asarray(x).astype(np.int64), y.numpy())
    assert np.array_equal(np.asarray(sj.permutation_seed).astype(np.int64),
                          st.permutation_seed.numpy())
    assert int(sj.sample_index) == st.sample_index
    assert int(sj.dimension_index) == st.dimension_index


# (plugin dict, samples per wavefront): spp 16, which orthogonal rounds up
# to 25 (the square of the smallest prime that covers it)
SAMPLERS = [
    ({"type": "timestratified"}, 16), ({"type": "timestratified"}, 4),
    ({"type": "stratified"}, 16), ({"type": "stratified"}, 4),
    ({"type": "stratified", "jitter": False}, 16),
    ({"type": "multijitter"}, 16), ({"type": "multijitter"}, 4),
    ({"type": "ldsampler"}, 16), ({"type": "ldsampler"}, 4),
    ({"type": "orthogonal", "strength": 2}, 25),
    ({"type": "orthogonal", "strength": 2}, 5),
    ({"type": "orthogonal", "strength": 3}, 25),
]


@pytest.fixture(scope="module")
def jit_kensler():
    """The JAX samplers' Kensler permutation under jax.jit (sample count
    static). It is integer arithmetic, exact under jit; eagerly, each call
    compiles its own while loop. The samplers' float arithmetic stays
    eager: under jit, XLA turns a division by a constant into a product
    with its rounded reciprocal (the orthogonal sampler divides by its
    prime resolution), where the function, and the port, divide."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(js, "permute_kensler",
                   jax.jit(jrng.permute_kensler, static_argnums=1))
        yield


@pytest.mark.parametrize("d,spw", SAMPLERS, ids=[
    "-".join(str(v) for v in d.values()) + f"-spw{spw}"
    for d, spw in SAMPLERS])
def test_sampler_draws_bitwise(jit_kensler, d, spw):
    """next_1d, next_2d and next_1d_time twice each under an active mask
    (six dimensions deep), then ``advance`` and the same again."""
    d = {**d, "sample_count": 16, "seed": 5}
    sj_, st_ = mj.load_dict(dict(d)), mt.load_dict(dict(d))
    for s in (sj_, st_):
        s.set_sample_count(16)
        s.set_samples_per_wavefront(spw)
    assert sj_.sample_count == st_.sample_count
    sj, st = sj_.seed(3, N), st_.seed(3, N)
    _same_state(sj, st)
    act = np.random.default_rng(spw).random(N) < 0.7
    aj, at = jnp.asarray(act), torch.from_numpy(act)
    for p in range(2):
        for k in ("next_1d", "next_2d", "next_1d_time") * 2:
            vj, sj = getattr(sj_, k)(sj, aj)
            vt, st = getattr(st_, k)(st, at)
            vj = vj if isinstance(vj, tuple) else (vj,)
            vt = vt if isinstance(vt, tuple) else (vt,)
            for a, b in zip(vj, vt):
                assert b.dtype == torch.float32
                assert np.array_equal(np.asarray(a), b.numpy()), (p, k)
            _same_state(sj, st)
        sj, st = sj_.advance(sj), st_.advance(st)


# ---------------------------------------------------------------------------
# renders against the JAX package
# ---------------------------------------------------------------------------

SIZE = dict(spp=4, resx=16, resy=16)


def _thinlens_scene(pkg):
    """The canonical scene through a thin lens focused at the back wall,
    with the timestratified sampler and the mitchell filter."""
    d = pkg.xml_to_dict(CANONICAL, {k: str(v) for k, v in SIZE.items()},
                        is_file=True)
    key = next(k for k, v in d.items()
               if isinstance(v, dict) and v.get("type") == "perspective")
    sensor = dict(d[key], type="thinlens", aperture_radius=0.08,
                  focus_distance=4.5)
    for k, v in list(sensor.items()):
        if isinstance(v, dict) and v.get("type") == "correlated":
            sensor[k] = {"type": "timestratified", "sample_count": 4}
        elif isinstance(v, dict) and v.get("type") == "hdrfilm":
            sensor[k] = {fk: ({"type": "mitchell"} if isinstance(fv, dict)
                              else fv) for fk, fv in v.items()}
    d[key] = sensor
    return d


def _render(pkg, which):
    kw = {"device": "cpu"} if pkg is mt else {}
    if which == "thinlens":
        scene = pkg.load_dict(_thinlens_scene(pkg), **kw)
        integ = scene.integrator
    else:
        scene = pkg.load_file(CANONICAL, **kw, **SIZE)
        integ = pkg.load_dict({"type": which, **(
            {"time": 0.0015} if which == "velocity" else {})})
    img = integ.render(scene, spp=4, seed=0)
    return np.asarray(img) if pkg is mj else img.numpy()


@pytest.mark.parametrize("which", ["velocity", "depth", "thinlens"])
def test_render_matches_jax(which):
    ref = _render(mj, which)
    img = _render(mt, which)
    assert img.shape == ref.shape == (16, 16, 3)
    assert np.isfinite(img).all()
    scale = np.abs(ref).max()
    assert scale > 0.0
    close = np.isclose(img, ref, rtol=1e-4, atol=1e-4 * scale)
    assert close.all(), [tuple(int(i) for i in ix)
                         for ix in np.argwhere(~close)[:10]]


# ---------------------------------------------------------------------------
# timeout, cancel() and checkpoints (port only)
# ---------------------------------------------------------------------------

SMALL = dict(spp=4, resx=8, resy=8)
STRIP_LANES = 2 * 8 * 4          # two pixel rows at full spp: 4 passes


def _small(**integrator):
    scene = mt.load_file(CANONICAL, device="cpu", **SMALL)
    for k, v in integrator.items():
        setattr(scene.integrator, k, v)
    return scene


def _render_small(render_kw=None, **integrator):
    scene = _small(**integrator)
    return scene.integrator.render(scene, seed=0, **(render_kw or {}))


def test_timeout_stops_after_first_pass():
    """A timeout keeps spp slicing (four passes of 1 spp here), stops
    after the first pass and develops a finite, weight-normalized image."""
    scene = _small(timeout=1e-9, samples_per_pass=1)
    integ = scene.integrator
    stops = []

    def should_stop(start_time):
        stops.append(type(integ).should_stop(integ, start_time))
        return stops[-1]

    integ.should_stop = should_stop
    block = integ.render(scene, seed=0, develop_film=False)
    assert stops == [True]
    full = _render_small({"develop_film": False}, samples_per_pass=1)
    # one pass of the four: a quarter of the weight
    assert abs(float(block[3].sum() / full[3].sum()) - 0.25) < 0.03
    img = mt.films.develop(block, False)
    assert torch.isfinite(img).all() and float(img.abs().max()) > 0.0
    # a timed render never takes strip passes: its first pass covers
    # every pixel
    block = _render_small({"max_lanes": STRIP_LANES, "develop_film": False},
                          timeout=1e-9)
    assert bool((block[3] > 0.0).all())


def test_cancel_before_render_is_a_noop():
    scene = _small()
    scene.integrator.cancel()
    img = scene.integrator.render(scene, seed=0, max_lanes=STRIP_LANES)
    assert torch.equal(img, _render_small({"max_lanes": STRIP_LANES}))


@pytest.mark.parametrize("mode", ["strip", "spp_sliced"])
def test_checkpoint_resume_bitwise(tmp_path, mode):
    """Stopped after 2 of 4 passes (a cancel() that arrives at the second
    pass boundary) and resumed from the checkpoint, the render equals the
    uninterrupted one bit for bit."""
    kw = ({"max_lanes": STRIP_LANES} if mode == "strip" else {})
    setup = {} if mode == "strip" else {"samples_per_pass": 1}
    full = _render_small(kw, **setup)

    ck = str(tmp_path / "ck.npz")
    scene = _small(**setup)
    integ = scene.integrator
    boundaries = []

    def cancel_at_second(start_time):
        boundaries.append(start_time)
        if len(boundaries) == 2:
            integ.cancel()
        return type(integ).should_stop(integ, start_time)

    integ.should_stop = cancel_at_second
    partial = integ.render(scene, seed=0, checkpoint_path=ck,
                           checkpoint_every=1, **kw)
    with np.load(ck) as f:
        assert sorted(f.files) == ["block", "pass_idx", "seed", "spp",
                                   "strip"]
        assert int(f["pass_idx"]) == 2
        assert bool(f["strip"]) == (mode == "strip")
    assert not torch.equal(partial, full)

    scene2 = _small(**setup)
    resumed = scene2.integrator.render(scene2, seed=0, checkpoint_path=ck,
                                       **kw)
    assert torch.equal(resumed, full)
    with np.load(ck) as f:
        assert int(f["pass_idx"]) == 4
