"""Scenes of the polarized variants, as dicts and XML that both packages
load (the port's own copies of the JAX package's test scenes).

  * ``plate_scene``: a constant sky seen through a stack of polarizing
    plates (polarizer, retarder, circular) under ``stokes(path)``, the
    JAX package's ``tests/test_polarized.py`` plate scene;
  * ``rayleigh_cube_scene``: a Rayleigh medium cube lit from the side
    over rough copper, under ``stokes(volpath)``;
  * ``polarizing_canonical_xml``: the canonical stand-in
    (``scenes/canonical/scene.xml``) with a rough copper floor, a smooth
    gold back wall and a glass small box in place of three diffuse
    surfaces, optionally under ``stokes``; load it with either package's
    ``load_string(text, spp=..., resx=..., resy=...)``.

    from mitsuba3dopplertof_tpu_torch.utils import polarized_scenes as ps
    mi.set_variant("cuda_rgb_polarized")
    scene = mi.load_string(ps.polarizing_canonical_xml(), spp=64)
"""

from __future__ import annotations

import os
import re

CANONICAL = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "scenes", "canonical", "scene.xml")

# quarter-wave plate at 45 degrees behind a horizontal polarizer: circular
QUARTER_WAVE = [({"type": "polarizer", "theta": 0.0}, 2.0),
                ({"type": "retarder", "theta": 45.0, "delta": 90.0}, 1.0)]
# the three elements in one frame: the quarter-wave stack on the left
# half, a tilted circular polarizer on the right (max_depth 3 suffices)
ELEMENTS = [({"type": "polarizer", "theta": 0.0}, 2.0, -1.0),
            ({"type": "retarder", "theta": 45.0, "delta": 90.0}, 1.0, -1.0),
            ({"type": "circular", "theta": 10.0}, 1.5, 1.0)]


def plate_scene(plates, spp: int = 32, res: int = 2, tf=None,
                max_depth: int = 8) -> dict:
    """Rectangles (2 x 2) at z = zpos with the given BSDFs (``plates``: a
    list of (bsdf dict, zpos) or (bsdf dict, zpos, x offset)) between the
    camera at z = -2 and a constant sky of radiance 1, rendered by
    ``stokes(path)``. Through two ideal linear
    polarizers S0 follows Malus's law, 0.5 cos^2 of their angle; behind
    ``QUARTER_WAVE`` the light is circular (|S3| = S0)."""
    if tf is None:
        from ..core import transform as tf
    d = {
        "type": "scene",
        "emitter": {"type": "constant",
                    "radiance": {"type": "rgb", "value": 1.0}},
        "sensor": {"type": "perspective", "fov": 10,
                   "to_world": tf.look_at([0, 0, -2], [0, 0, 1], [0, 1, 0]),
                   "film": {"type": "hdrfilm", "width": res, "height": res},
                   "sampler": {"type": "independent", "sample_count": spp}},
        "integrator": {"type": "stokes",
                       "nested": {"type": "path", "max_depth": max_depth}},
    }
    for i, (bsdf, zpos, *x) in enumerate(plates):
        d[f"p{i}"] = {"type": "rectangle",
                      "to_world": tf.translate([x[0] if x else 0.0, 0, zpos]),
                      "bsdf": bsdf}
    return d


def stokes_channels(img):
    """(S0, S1, S2, S3), each the channel mean, of a ``stokes`` film: rgb
    then the 12 AOVs S0..S3 x RGB."""
    return [img[..., 3 + i * 3: 6 + i * 3].mean(axis=-1) for i in range(4)]


def rayleigh_cube_scene(spp: int, res: int = 8, tf=None,
                        max_depth: int = 3) -> dict:
    """A null-bounded unit cube of a homogeneous medium (sigma_t 0.4,
    albedo 0.9, Rayleigh phase) lit from the side by a directional light and
    seen from +z: single scattering reaches the camera at about 90
    degrees, so its glow is strongly polarized (the JAX package's
    ``test_rayleigh_medium_polarizes_side_scatter``); ``stokes(volpath)``,
    with a rough copper floor below the cube."""
    if tf is None:
        from ..core import transform as tf
    return {
        "type": "scene",
        "integrator": {"type": "stokes",
                       "nested": {"type": "volpath",
                                  "max_depth": max_depth}},
        "sensor": {"type": "perspective", "fov": 40,
                   "to_world": tf.look_at([0, 0, 4], [0, 0, 0], [0, 1, 0]),
                   "film": {"type": "hdrfilm", "width": res, "height": res,
                            "rfilter": {"type": "box"}},
                   "sampler": {"type": "independent", "sample_count": spp}},
        "medium_box": {"type": "cube", "bsdf": {"type": "null"},
                       "interior": {"type": "homogeneous",
                                    "sigma_t": {"type": "rgb", "value": 0.4},
                                    "albedo": {"type": "rgb", "value": 0.9},
                                    "phase": {"type": "rayleigh"}}},
        "floor": {"type": "rectangle",
                  "to_world": tf.translate([0, -1.2, 0])
                  @ tf.rotate([1, 0, 0], -90) @ tf.scale([3, 3, 1]),
                  "bsdf": {"type": "roughconductor", "alpha": 0.2,
                           "material": "Cu"}},
        "light": {"type": "directional", "direction": [1, -0.3, 0],
                  "irradiance": {"type": "rgb", "value": 10.0}},
    }


_SURFACES = {
    "floor": '<bsdf type="roughconductor"><string name="material" '
             'value="Cu"/><float name="alpha" value="0.2"/></bsdf>',
    "back": '<bsdf type="conductor"><string name="material" value="Au"/>'
            '</bsdf>',
    "small-box": '<bsdf type="dielectric"><float name="int_ior" '
                 'value="1.5"/></bsdf>',
}


def polarizing_canonical_xml(stokes: bool = True, integrator: str = None,
                             max_depth: int = None) -> str:
    """The canonical scene's XML with the floor, the back wall and the
    small box polarizing (``_SURFACES``), wrapped in ``stokes`` unless
    ``stokes`` is False. ``integrator``: an XML ``<integrator>`` element
    that replaces the scene's dopplertofpath (then nested in stokes);
    ``max_depth``: the dopplertofpath's, in place of 4."""
    with open(CANONICAL) as f:
        text = f.read()
    if max_depth is not None:
        text = text.replace('<integer name="max_depth" value="4"/>',
                            f'<integer name="max_depth" value="{max_depth}"/>')
    for shape_id, bsdf in _SURFACES.items():
        pat = (r'(<shape type="\w+" id="' + re.escape(shape_id)
               + r'">.*?)<ref id="\w+"/>')
        text, n = re.subn(pat, lambda m: m.group(1) + bsdf, text, count=1,
                          flags=re.S)
        assert n == 1, shape_id
    if integrator is not None:
        text = re.sub(r"<integrator .*?</integrator>", integrator, text,
                      count=1, flags=re.S)
    if stokes:
        text = re.sub(r"(<integrator .*?</integrator>)",
                      r'<integrator type="stokes">\1</integrator>', text,
                      count=1, flags=re.S)
    return text


__all__ = ["plate_scene", "stokes_channels", "polarizing_canonical_xml",
           "rayleigh_cube_scene", "ELEMENTS",
           "QUARTER_WAVE", "CANONICAL"]
