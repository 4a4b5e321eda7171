"""Name -> object registries used for config-driven dependency injection:
every component (task, model, dataset, vocab, word embedding) is wired
through string keys in the YAML configs.

The port's copy of ``openvivqa_tpu/registry.py``.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Tuple


class Registry:
    """A simple name -> object map with decorator-style registration."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._entries: Dict[str, Any] = {}

    def register(self, obj: Optional[Any] = None, *, name: Optional[str] = None):
        if obj is None:

            def decorate(target: Any) -> Any:
                self._add(name or target.__name__, target)
                return target

            return decorate
        self._add(name or obj.__name__, obj)
        return obj

    def _add(self, name: str, obj: Any) -> None:
        if name in self._entries:
            raise KeyError(
                f"'{name}' is already registered in the '{self.name}' registry"
            )
        self._entries[name] = obj

    def get(self, name: str) -> Any:
        try:
            return self._entries[name]
        except KeyError:
            known = ", ".join(sorted(self._entries)) or "<empty>"
            raise KeyError(
                f"No entry '{name}' in the '{self.name}' registry. Known: {known}"
            ) from None

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def __iter__(self) -> Iterator[Tuple[str, Any]]:
        return iter(self._entries.items())

    def keys(self):
        return self._entries.keys()

    def __repr__(self) -> str:
        return f"Registry({self.name}: {sorted(self._entries)})"
