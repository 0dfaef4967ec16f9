"""Identity-keyed memo for shared immutable objects on hot paths.

The port of ``gome_tpu/utils/cache.py``. The columnar wire decoder returns
the SAME list object for a dictionary region it has seen before, which lets
downstream stages memo per-dictionary derived values (lane maps) by object
identity instead of re-deriving them every frame. The subtlety this class
centralizes: id() values are reused after garbage collection, so every entry
pins the key object with a strong reference and every hit re-verifies `is`.
"""

from __future__ import annotations


class IdentityCache:
    """Maps a shared, immutable-by-contract object to a derived value.

    `get` returns None on miss (values must not be None); `put` returns
    the value for call-chaining. The whole cache clears past `cap`
    entries — the expected working set is a handful of long-lived
    dictionary objects, so wholesale eviction is simpler than LRU and
    never wrong."""

    __slots__ = ("cap", "_d")

    def __init__(self, cap: int = 32):
        self.cap = cap
        self._d: dict = {}

    def get(self, obj):
        ent = self._d.get(id(obj))
        if ent is not None and ent[0] is obj:
            return ent[1]
        return None

    def put(self, obj, value):
        if len(self._d) >= self.cap:
            self._d.clear()
        self._d[id(obj)] = (obj, value)
        return value

    def clear(self) -> None:
        self._d.clear()
