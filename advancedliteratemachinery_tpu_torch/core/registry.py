"""Minimal name→factory registries (models, codecs, pipeline modules),
the port's copy of `advancedliteratemachinery_tpu/core/registry.py`. The
port's components register under the JAX package's names."""

from __future__ import annotations

from typing import Callable, Dict, Generic, Iterator, TypeVar

V = TypeVar("V")


class Registry(Generic[V]):
    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, V] = {}

    def register(self, name: str) -> Callable[[V], V]:
        def deco(obj: V) -> V:
            if name in self._entries:
                raise KeyError(f"{self.kind} '{name}' already registered")
            self._entries[name] = obj
            return obj

        return deco

    def get(self, name: str) -> V:
        if name not in self._entries:
            raise KeyError(
                f"unknown {self.kind} '{name}'; available: "
                f"{sorted(self._entries)}")
        return self._entries[name]

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def __iter__(self) -> Iterator[str]:
        return iter(sorted(self._entries))


MODELS: Registry = Registry("model")
CODECS: Registry = Registry("codec")
PIPELINE_MODULES: Registry = Registry("pipeline module")
