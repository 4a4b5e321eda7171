"""YAML config loading: the reference's YAML schema (UPPER_CASE nested keys,
registry-key strings) as a frozen, hashable, attribute-accessible node.

The port's copy of ``openvivqa_tpu/config.py``.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Optional

import yaml


class ConfigNode(Mapping):
    """Immutable, hashable, attribute-accessible nested config."""

    __slots__ = ("_data", "_hash")

    def __init__(self, data: Optional[Dict[str, Any]] = None):
        object.__setattr__(self, "_data", {})
        object.__setattr__(self, "_hash", None)
        if data:
            for key, value in data.items():
                self._data[key] = self._wrap(value)

    @staticmethod
    def _wrap(value: Any) -> Any:
        if isinstance(value, ConfigNode):
            return value
        if isinstance(value, dict):
            return ConfigNode(value)
        if isinstance(value, list):
            return tuple(ConfigNode._wrap(v) for v in value)
        return value

    # -- mapping protocol ---------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        return self._data[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    # -- attribute access ---------------------------------------------------
    def __getattr__(self, key: str) -> Any:
        if key.startswith("_"):
            raise AttributeError(key)
        try:
            return self._data[key]
        except KeyError:
            raise AttributeError(
                f"Config key '{key}' not found; available: {sorted(self._data)}"
            ) from None

    def __setattr__(self, key: str, value: Any) -> None:
        raise TypeError("ConfigNode is immutable")

    def __reduce__(self):
        # the raising __setattr__ + __slots__ otherwise break pickle and
        # copy.deepcopy (slot-state restoration writes attributes); rebuild
        # from the plain dict instead
        return (ConfigNode, (self.to_dict(),))

    def get(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, default)

    # -- hashing / equality (needed for jit static args) --------------------
    def _freeze(self) -> tuple:
        return tuple(sorted((k, v) for k, v in self._data.items()))

    def __hash__(self) -> int:
        if self._hash is None:
            object.__setattr__(self, "_hash", hash(self._freeze()))
        return self._hash

    def __eq__(self, other: Any) -> bool:
        if not isinstance(other, ConfigNode):
            return NotImplemented
        return self._data == other._data

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for key, value in self._data.items():
            if isinstance(value, ConfigNode):
                out[key] = value.to_dict()
            elif isinstance(value, tuple):
                out[key] = [
                    v.to_dict() if isinstance(v, ConfigNode) else v for v in value
                ]
            else:
                out[key] = value
        return out

    def merged(self, overrides: Dict[str, Any]) -> "ConfigNode":
        """Return a new node with `overrides` (nested dict) merged in."""
        base = self.to_dict()

        def merge(dst: Dict[str, Any], src: Dict[str, Any]) -> Dict[str, Any]:
            for key, value in src.items():
                if key in dst and isinstance(dst[key], dict) and isinstance(value, dict):
                    merge(dst[key], value)
                else:
                    dst[key] = value
            return dst

        return ConfigNode(merge(base, overrides))

    def __repr__(self) -> str:
        return f"ConfigNode({self._data!r})"


def get_config(yaml_file: str, opts: Optional[Dict[str, Any]] = None) -> ConfigNode:
    """Load a reference-schema YAML config (configs/utils.py:4-5 parity)."""
    with open(yaml_file, "r") as handle:
        data = yaml.safe_load(handle)
    node = ConfigNode(data)
    if opts:
        node = node.merged(opts)
    return node
