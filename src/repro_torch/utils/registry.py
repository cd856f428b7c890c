"""Minimal string-keyed registry used for architectures, workloads, tuners."""
from __future__ import annotations

from typing import Callable, Dict, Generic, Iterator, TypeVar

T = TypeVar("T")


class Registry(Generic[T]):
    """A named registry mapping string keys to factories/objects.

    Used for: architecture configs (``--arch <id>``), workload generators,
    tuner strategies, and ML model families. Registration is idempotent only
    when re-registering the identical object; otherwise it raises, catching
    accidental double-definitions early.
    """

    def __init__(self, kind: str):
        self.kind = kind
        self._items: Dict[str, T] = {}

    def register(self, name: str, item: T | None = None) -> Callable[[T], T] | T:
        if item is not None:
            self._set(name, item)
            return item

        def deco(fn: T) -> T:
            self._set(name, fn)
            return fn

        return deco

    def _set(self, name: str, item: T) -> None:
        if name in self._items and self._items[name] is not item:
            raise KeyError(f"{self.kind} registry: duplicate key {name!r}")
        self._items[name] = item

    def get(self, name: str) -> T:
        try:
            return self._items[name]
        except KeyError:
            known = ", ".join(sorted(self._items))
            raise KeyError(
                f"{self.kind} registry: unknown key {name!r}. Known: {known}"
            ) from None

    def __contains__(self, name: str) -> bool:
        return name in self._items

    def __iter__(self) -> Iterator[str]:
        return iter(sorted(self._items))

    def keys(self):
        return sorted(self._items)

    def items(self):
        return [(k, self._items[k]) for k in sorted(self._items)]
