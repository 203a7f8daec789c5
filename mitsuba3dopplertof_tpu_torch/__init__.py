"""mitsuba3dopplertof_tpu_torch — the Doppler Time-of-Flight renderer in
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

A port of the JAX package ``mitsuba3dopplertof_tpu`` (the reference it is
tested against), module for module. It imports torch and never jax.

    import mitsuba3dopplertof_tpu_torch as mi
    mi.set_variant("cuda_rgb")     # or "cuda_spectral", "cuda_mono",
                                   # "cuda_rgb_polarized",
                                   # "cuda_spectral_polarized"
    scene = mi.load_file("scenes/canonical/scene.xml")
    img = mi.render(scene, spp=1024, seed=0)      # (H, W, 3) tensor

Scenes load and render on the CUDA card unless the caller asks for the
CPU, with ``set_device("cpu")`` or the ``device="cpu"`` argument of
``load_file``/``load_dict``/``render``. Without a card, loading a scene on
the default device raises: nothing falls back to the CPU on its own.
Importing the package needs no card.
"""

from __future__ import annotations

__version__ = "0.1.0"

import os as _os

import torch as _torch

# plugin registration side effects
from . import shapes as _shapes            # noqa: F401
from . import bsdfs as _bsdfs              # noqa: F401
from . import emitters as _emitters        # noqa: F401
from . import sensors as _sensors          # noqa: F401
from . import films as _films              # noqa: F401
from . import rfilters as _rfilters        # noqa: F401
from . import samplers as _samplers        # noqa: F401
from . import integrators as _integrators  # noqa: F401
from . import textures as _textures        # noqa: F401
from . import spectra as _spectra          # noqa: F401
from . import media as _media              # noqa: F401
from . import volumes as _volumes          # noqa: F401
from .integrators import volpath as _volpath  # noqa: F401
from .integrators import extras as _extras    # noqa: F401
from .integrators import ptracer as _ptracer  # noqa: F401
from .integrators import polarized as _polarized  # noqa: F401
from .core import mueller
from .core.mueller import fresnel_polarized

from .core.fresolver import file_resolver
from .io.dict_loader import load_dict as _load_dict
from .io.xml import xml_to_dict
from .render.scene import Scene

_DEVICE = _torch.device("cuda")

# the JAX package's counterparts are tpu_rgb, tpu_spectral, tpu_mono,
# tpu_rgb_polarized and tpu_spectral_polarized
_VARIANTS = ("cuda_rgb", "cuda_spectral", "cuda_mono", "cuda_rgb_polarized",
             "cuda_spectral_polarized")
_VARIANT = "cuda_rgb"


def set_device(device) -> _torch.device:
    """Select the device scenes compile to and render on by default
    ("cuda" unless set)."""
    global _DEVICE
    _DEVICE = _torch.device(device)
    return _DEVICE


def get_device() -> _torch.device:
    return _DEVICE


def variants():
    return list(_VARIANTS)


def variant() -> str:
    return _VARIANT


def set_variant(*names) -> str:
    """Select the rendering variant (the reference's mitsuba.set_variant):
    ``cuda_rgb`` (the default), ``cuda_spectral`` (hero-wavelength
    triplets with sigmoid spectral upsampling and analytic CIE
    conversion), ``cuda_mono`` (luminance), ``cuda_rgb_polarized`` or
    ``cuda_spectral_polarized`` (Mueller-matrix transport: the film holds
    S0, and the ``stokes`` integrator adds S0..S3). It shapes the scenes
    compiled afterwards."""
    global _VARIANT
    for n in names:
        if n in _VARIANTS:
            _VARIANT = n
            return n
    raise RuntimeError(f"No supported variant in {names}; "
                       f"available: {list(_VARIANTS)}")


def load_dict(d, device=None) -> Scene:
    """Build a scene from the nested-dict description (mi.load_dict)."""
    return _load_dict(d, device=device)


def load_file(path: str, device=None, **params) -> Scene:
    """Parse and build a scene from Mitsuba XML (reference xml.cpp:1483).
    ``params`` override the file's ``<default>`` values; the file's
    directory is searched for relative asset names."""
    str_params = {k: str(v) for k, v in params.items()}
    with file_resolver().scoped(_os.path.dirname(_os.path.abspath(path))):
        return _load_dict(xml_to_dict(path, str_params, is_file=True),
                          device=device)


def load_string(text: str, device=None, **params) -> Scene:
    """Parse and build a scene from Mitsuba XML given as a string
    (reference xml.cpp:1437 load_string); ``params`` override its
    ``<default>`` values."""
    str_params = {k: str(v) for k, v in params.items()}
    return _load_dict(xml_to_dict(text, str_params, is_file=False),
                      device=device)


def dict_to_xml(*args, **kwargs):
    """The JAX package's ``mi.dict_to_xml`` (its ``io/xml_writer.py``) is
    not ported yet."""
    raise NotImplementedError(
        "dict_to_xml is not ported yet (ROADMAP Queue A item 3)")


def render(scene: Scene, spp: int = 0, seed: int = 0, sensor=None,
           integrator=None, device=None) -> _torch.Tensor:
    """Render ``scene`` with its own integrator or ``integrator``; returns
    the developed (H, W, C) image on the render device."""
    integ = integrator if integrator is not None else scene.integrator
    if integ is None:
        raise RuntimeError("No integrator: pass one or add it to the scene")
    return integ.render(scene, sensor=sensor, seed=seed, spp=spp,
                        device=device)


__all__ = ["load_file", "load_string", "load_dict", "dict_to_xml", "render",
           "Scene", "set_variant", "variant", "variants", "set_device",
           "get_device", "xml_to_dict", "mueller", "fresnel_polarized",
           "__version__"]
