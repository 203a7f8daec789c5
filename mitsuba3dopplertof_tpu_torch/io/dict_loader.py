"""``load_dict`` — build the object graph from the nested-dict scene
description (the mi.load_dict API shape; reference src/python + the
instantiation semantics of src/core/xml.cpp, including <ref> resolution and
unqueried-property validation).

Child objects (nested dicts with a plugin ``type``) are constructed first
and passed to the parent through its Properties, exactly like the
reference's instantiate_node ordering; ``{'type': 'ref', 'id': ...}`` nodes
resolve against previously-built ids.
"""

from __future__ import annotations

from typing import Any, Dict, List

from ..core.properties import Properties, create_plugin, plugin_exists

_CATEGORIES = ["integrator", "sensor", "sampler", "film", "rfilter", "shape",
               "bsdf", "emitter", "texture", "medium", "phase", "volume",
               "spectrum"]


# plugins of the JAX package that the port does not have yet, by the
# ROADMAP.md Queue A item that ports them
_DEFERRED = {
    "ROADMAP Queue A item 3": ("ply", "serialized", "shapegroup",
                               "instance"),
    "ROADMAP Queue A item 9": ("checkerboard", "bitmap", "roughplastic",
                               "conductor", "null", "envmap",
                               "heterogeneous", "homogeneous", "gridvolume"),
    "ROADMAP Queue A item 11": ("specfilm",),
}


def _deferred_item(type_name: str) -> str:
    for item, names in _DEFERRED.items():
        if type_name in names:
            return item
    return "ROADMAP Queue A item 10"


def _category_of(type_name: str):
    for cat in _CATEGORIES:
        if plugin_exists(cat, type_name):
            return cat
    return None


class _Builder:
    def __init__(self):
        self.by_id: Dict[str, Any] = {}

    def build(self, d: Dict[str, Any], key_hint: str = ""):
        t = d["type"]
        if t == "ref":
            rid = d["id"]
            if rid not in self.by_id:
                raise RuntimeError(f"<ref id='{rid}'>: unresolved reference")
            return self.by_id[rid]
        if t in ("rgb", "spectrum"):
            return d
        cat = _category_of(t)
        if cat is None:
            raise NotImplementedError(
                f"Plugin type '{t}' is unknown or not ported to the PyTorch "
                f"package yet ({_deferred_item(t)})")
        props = Properties(t)
        props.id = d.get("id", key_hint)
        for k, v in d.items():
            if k in ("type", "id", "_base_dir"):
                continue
            if isinstance(v, dict) and v.get("type") not in (None, "rgb", "spectrum"):
                props[k] = self.build(v, key_hint=k)
                props.mark_queried(k)   # object children are wired by ctors
            else:
                props[k] = v
        obj = create_plugin(cat, props)
        props.raise_if_unqueried()
        rid = d.get("id") or key_hint
        if rid:
            self.by_id.setdefault(rid, obj)
        obj._category = cat
        return obj


def load_dict(d: Dict[str, Any], device=None):
    """Build a Scene (for {'type':'scene', ...}) or a single plugin object.
    ``device`` is where the scene's tables live once compiled (default:
    the package device, see ``set_device``). Shape groups and instances
    are not ported yet (ROADMAP Queue A item 3)."""
    from ..shapes import Shape
    from ..emitters import Emitter
    from ..sensors import Sensor
    from ..integrators import Integrator
    from ..render.scene import Scene

    builder = _Builder()

    if d.get("type") != "scene":
        return builder.build(dict(d))

    shapes: List[Shape] = []
    emitters: List[Emitter] = []
    sensors: List[Sensor] = []
    integrator = None

    for key, v in d.items():
        if key in ("type", "_base_dir") or not isinstance(v, dict):
            continue
        obj = builder.build(dict(v), key_hint=key)

        if isinstance(obj, Shape):
            shapes.append(obj)
            if obj.emitter is not None:
                emitters.append(obj.emitter)
            if obj.sensor is not None:
                sensors.append(obj.sensor)
        elif isinstance(obj, Emitter):
            emitters.append(obj)
        elif isinstance(obj, Sensor):
            sensors.append(obj)
        elif isinstance(obj, Integrator):
            integrator = obj

    if not sensors:
        raise RuntimeError("Scene contains no sensor")
    return Scene(shapes, emitters, sensors, integrator, device=device)


__all__ = ["load_dict"]
