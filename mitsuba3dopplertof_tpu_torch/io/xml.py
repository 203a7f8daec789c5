"""Mitsuba-compatible XML scene parser.

Parses the reference's scene format (reference src/core/xml.cpp:1483
load_file / :1437 load_string) into the nested-dict form consumed by
``load_dict`` — the same two-entry API surface the reference exposes
(mi.load_file / mi.load_dict), so existing user scripts port unchanged.

Supported tags: scene, default, $var substitution, integer/float/boolean/
string/rgb/spectrum/vector/point, transform (matrix/translate/rotate/scale/
lookat), animation with per-keyframe <transform time=...> (the fork's
extension, reference xml.cpp:882-1007), ref, include, alias, and all object
tags (integrator/sensor/sampler/film/rfilter/shape/bsdf/emitter/texture/
medium/phase/volume).
"""

from __future__ import annotations

import os
import re
import xml.etree.ElementTree as ET
from typing import Any, Dict, List, Optional

import numpy as np

from ..core import transform as tf

_OBJECT_TAGS = {
    "integrator", "sensor", "sampler", "film", "rfilter", "shape", "bsdf",
    "emitter", "texture", "medium", "phase", "volume", "spectrum_obj",
}


def _subst(value: str, params: Dict[str, str]) -> str:
    def repl(m):
        key = m.group(1)
        if key not in params:
            raise RuntimeError(f"Undefined scene parameter ${key}")
        return str(params[key])
    return re.sub(r"\$(\w+)", repl, value)


def _parse_float_list(s: str) -> List[float]:
    return [float(x) for x in re.split(r"[,\s]+", s.strip()) if x]


def _parse_transform_children(elem, params) -> np.ndarray:
    """Fold <matrix>/<translate>/<rotate>/<scale>/<lookat> children left-to-
    right the way the reference does: each op pre-multiplies the accumulated
    matrix (later tags apply after earlier ones in world space)."""
    m = tf.identity()
    for child in elem:
        tag = child.tag
        a = {k: _subst(v, params) for k, v in child.attrib.items()}
        if tag == "matrix":
            vals = _parse_float_list(a["value"])
            mm = np.asarray(vals, dtype=np.float64).reshape(4, 4)
            m = mm @ m
        elif tag == "translate":
            v = _xyz(a, default=0.0)
            m = tf.translate(v) @ m
        elif tag == "scale":
            if "value" in a:
                vals = _parse_float_list(a["value"])
                v = vals * 3 if len(vals) == 1 else vals
            else:
                v = _xyz(a, default=1.0)
            m = tf.scale(v) @ m
        elif tag == "rotate":
            axis = _xyz(a, default=0.0)
            angle = float(a.get("angle", 0.0))
            m = tf.rotate(axis, angle) @ m
        elif tag == "lookat":
            origin = _parse_float_list(a["origin"])
            target = _parse_float_list(a["target"])
            up = _parse_float_list(a.get("up", "0 1 0"))
            m = tf.look_at(origin, target, up) @ m
        else:
            raise RuntimeError(f"Unknown transform child <{tag}>")
    return m


def _xyz(a: Dict[str, str], default: float) -> List[float]:
    if "value" in a:
        vals = _parse_float_list(a["value"])
        return vals * 3 if len(vals) == 1 else vals
    return [float(a.get("x", default)), float(a.get("y", default)),
            float(a.get("z", default))]


def _parse_value(elem, params) -> Any:
    tag = elem.tag
    a = {k: _subst(v, params) for k, v in elem.attrib.items()}
    if tag == "integer":
        return int(float(a["value"]))
    if tag == "float":
        return float(a["value"])
    if tag == "boolean":
        return a["value"].strip().lower() == "true"
    if tag == "string":
        return a["value"]
    if tag in ("rgb", "spectrum"):
        vals = _parse_float_list(a["value"])
        if tag == "rgb":
            if len(vals) == 1:
                vals = vals * 3
            return {"type": "rgb", "value": vals}
        return {"type": "spectrum", "value": vals}
    if tag in ("vector", "point"):
        return np.asarray(_xyz(a, default=0.0), dtype=np.float64)
    if tag == "transform":
        return _parse_transform_children(elem, params)
    if tag == "animation":
        keyframes = []
        for child in elem:
            if child.tag != "transform":
                raise RuntimeError(
                    f"<animation> may only contain <transform time=...> "
                    f"children, found <{child.tag}>")
            t = float(_subst(child.attrib["time"], params))
            keyframes.append((t, _parse_transform_children(child, params)))
        return tf.AnimatedTransform(keyframes=keyframes)
    raise RuntimeError(f"Unknown value tag <{tag}>")


def _parse_object(elem, params, base_dir) -> Dict[str, Any]:
    a = {k: _subst(v, params) for k, v in elem.attrib.items()}
    d: Dict[str, Any] = {"type": a["type"]}
    if "id" in a:
        d["id"] = a["id"]
    anon = 0
    for child in elem:
        tag = child.tag
        ca = {k: _subst(v, params) for k, v in child.attrib.items()}
        if tag == "ref":
            name = ca.get("name", f"_ref_{anon}")
            anon += 1
            d[name] = {"type": "ref", "id": ca["id"]}
        elif tag in _OBJECT_TAGS:
            name = ca.get("name", ca.get("id", f"_arg_{anon}"))
            anon += 1
            d[name] = _parse_object(child, params, base_dir)
        elif tag in ("transform", "animation"):
            d[ca.get("name", "to_world")] = _parse_value(child, params)
        else:
            d[ca["name"]] = _parse_value(child, params)
    return d


def xml_to_dict(path_or_string: str, params: Optional[Dict[str, str]] = None,
                is_file: bool = True) -> Dict[str, Any]:
    """Parse scene XML into the load_dict nested form."""
    params = dict(params or {})
    if is_file:
        tree = ET.parse(path_or_string)
        root = tree.getroot()
        base_dir = os.path.dirname(os.path.abspath(path_or_string))
    else:
        root = ET.fromstring(path_or_string)
        base_dir = os.getcwd()

    if root.tag != "scene":
        # single-object fragment (load_string on e.g. a bsdf)
        return _parse_object(root, params, base_dir)

    result: Dict[str, Any] = {"type": "scene"}
    anon = 0
    # first pass: defaults (CLI -D overrides win: only set if absent)
    for child in root:
        if child.tag == "default":
            name = child.attrib["name"]
            if name not in params:
                params[name] = child.attrib["value"]
    for child in root:
        tag = child.tag
        if tag == "default":
            continue
        if tag == "include":
            sub_path = os.path.join(base_dir, _subst(child.attrib["filename"], params))
            sub = xml_to_dict(sub_path, params, is_file=True)
            for k, v in sub.items():
                if k != "type":
                    result[k] = v
            continue
        if tag in _OBJECT_TAGS:
            obj = _parse_object(child, params, base_dir)
            key = obj.get("id", f"_{tag}_{anon}")
            anon += 1
            obj.setdefault("_base_dir", base_dir)
            result[key] = obj
        elif tag == "alias":
            result[child.attrib["as"]] = {"type": "ref", "id": child.attrib["id"]}
        elif tag == "path":
            # <path value="..."/> appends a file-resolver search path
            # (reference xml.cpp Tag::Resource), relative to the scene dir
            from ..core.fresolver import file_resolver
            p = _subst(child.attrib["value"], params)
            if not os.path.isabs(p):
                p = os.path.join(base_dir, p)
            file_resolver().append(p)
        else:
            raise RuntimeError(f"Unexpected top-level tag <{tag}>")
    result["_base_dir"] = base_dir
    return result


__all__ = ["xml_to_dict"]
