"""Typed key->value bag used to construct plugins, plus the plugin registry.

Mirrors the behavior of the reference's Properties (src/core/properties.cpp)
and PluginManager (src/core/plugin.cpp): plugins are instantiated by string
name from a registry; unqueried keys raise at scene-load time, which catches
typos in scene files the same way the reference's xml.cpp:1204-1223 does.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np


class Properties:
    def __init__(self, plugin_name: str = "", data: Optional[Dict[str, Any]] = None):
        self.plugin_name = plugin_name
        self.id = ""
        self._data: Dict[str, Any] = dict(data or {})
        self._queried = set()

    # -- mutation ----------------------------------------------------------
    def __setitem__(self, key: str, value: Any):
        self._data[key] = value

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def has_property(self, key: str) -> bool:
        return key in self._data

    # -- typed getters -----------------------------------------------------
    def get(self, key: str, default: Any = None):
        if key in self._data:
            self._queried.add(key)
            return self._data[key]
        if default is None:
            raise KeyError(
                f"Property '{key}' has not been specified for plugin "
                f"'{self.plugin_name}'")
        return default

    def get_float(self, key: str, default: Optional[float] = None) -> float:
        v = self.get(key, default)
        return float(v)

    def get_int(self, key: str, default: Optional[int] = None) -> int:
        v = self.get(key, default)
        return int(v)

    def get_bool(self, key: str, default: Optional[bool] = None) -> bool:
        v = self.get(key, default)
        if isinstance(v, str):
            return v.strip().lower() == "true"
        return bool(v)

    def get_string(self, key: str, default: Optional[str] = None) -> str:
        return str(self.get(key, default))

    def get_color(self, key: str, default=None) -> np.ndarray:
        v = self.get(key, default)
        a = np.asarray(v, dtype=np.float64).reshape(-1)
        if a.size == 1:
            a = np.repeat(a, 3)
        return a[:3]

    def get_vector(self, key: str, default=None) -> np.ndarray:
        v = self.get(key, default)
        return np.asarray(v, dtype=np.float64).reshape(3)

    def get_transform(self, key: str, default=None) -> np.ndarray:
        from .transform import AnimatedTransform
        v = self.get(key, default)
        if isinstance(v, AnimatedTransform):
            return v.static_matrix if not v.animated else v.matrices()[0]
        return np.asarray(v, dtype=np.float64).reshape(4, 4)

    def get_animated_transform(self, key: str, default=None):
        """Fork extension (reference properties.cpp:428-498): returns an
        AnimatedTransform whether the stored value is animated or static."""
        from .transform import AnimatedTransform
        v = self.get(key, default)
        if isinstance(v, AnimatedTransform):
            return v
        return AnimatedTransform(static_matrix=np.asarray(v, dtype=np.float64).reshape(4, 4))

    def objects(self):
        """Iterate (key, value) pairs whose value is a plugin object,
        marking only those as queried — scalar typos stay detectable
        (reference xml.cpp:1204-1223 semantics)."""
        out = []
        for k, v in self._data.items():
            if hasattr(v, "plugin_category"):
                self._queried.add(k)
                out.append((k, v))
        return out

    # -- validation --------------------------------------------------------
    def keys(self):
        return self._data.keys()

    def mark_queried(self, key: str):
        self._queried.add(key)

    def unqueried(self):
        return [k for k in self._data if k not in self._queried]

    def raise_if_unqueried(self):
        bad = self.unqueried()
        if bad:
            raise RuntimeError(
                f"Unreferenced property/properties {bad} in plugin "
                f"'{self.plugin_name}' — likely a typo in the scene "
                f"description (matching reference xml.cpp:1204-1223)")

    def __repr__(self):
        return f"Properties[{self.plugin_name}, {self._data}]"


# ---------------------------------------------------------------------------
# Plugin registry — the stand-in for PluginManager::create_object
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Dict[str, Callable]] = {}


def register_plugin(category: str, name: str):
    """Class decorator: register a plugin constructor under (category, name)."""
    def deco(cls):
        _REGISTRY.setdefault(category, {})[name] = cls
        cls.plugin_category = category
        cls.plugin_name = name
        return cls
    return deco


def create_plugin(category: str, props: Properties):
    cat = _REGISTRY.get(category, {})
    if props.plugin_name not in cat:
        known = sorted(cat.keys())
        raise RuntimeError(
            f"Plugin '{props.plugin_name}' (category '{category}') not found. "
            f"Available: {known}")
    obj = cat[props.plugin_name](props)
    return obj


def plugin_exists(category: str, name: str) -> bool:
    return name in _REGISTRY.get(category, {})


def registered_plugins(category: str):
    return sorted(_REGISTRY.get(category, {}).keys())


__all__ = [
    "Properties", "register_plugin", "create_plugin", "plugin_exists",
    "registered_plugins",
]
