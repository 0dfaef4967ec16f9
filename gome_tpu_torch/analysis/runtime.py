"""Opt-in runtime lock-discipline assertions (the dynamic half of GL4xx).

The port of ``gome_tpu/analysis/runtime.py`` (a copy).

The static checker (analysis.locks) proves *lexical* discipline; this
module catches what lexical analysis cannot — a method called on the
wrong thread, a callback invoked after the lock was released — by making
violations raise at the exact write instead of losing an update silently.
It is test-harness machinery: nothing in the production paths imports it.

Usage:

    lock = OwnedLock()
    obj = Thing(lock=lock)
    instrument(obj, ("counter", "items"), lock_attr="_lock")
    obj.bump()          # fine: bump() takes the lock
    obj.counter = 7     # raises LockDisciplineError: write off-lock

`instrument` swaps the instance's lock for an :class:`OwnedLock` (when it
is not one already) and rebinds the instance to a dynamic subclass whose
``__setattr__`` asserts the lock is held by the current thread for the
watched attributes. Reads are not intercepted (a ``__getattribute__``
hook would tax every attribute access in the hot path the test drives;
GL402 covers reads statically).
"""

from __future__ import annotations

import threading


class LockDisciplineError(AssertionError):
    """A watched attribute was written without holding its declared lock."""


class OwnedLock:
    """A (non-reentrant) lock that knows its owner thread. Context-manager
    compatible with threading.Lock so it drops into any `with self._lock:`
    site; `held_by_me()` is the assertion primitive."""

    def __init__(self):
        self._lock = threading.Lock()
        self._owner: int | None = None

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._lock.acquire(blocking, timeout)
        if got:
            self._owner = threading.get_ident()
        return got

    def release(self) -> None:
        self._owner = None
        self._lock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def held_by_me(self) -> bool:
        return self._owner == threading.get_ident()

    def locked(self) -> bool:
        return self._lock.locked()


def instrument(obj, attrs, lock_attr: str = "_lock"):
    """Arm runtime write-assertions on `obj` for the named attributes.

    Replaces ``getattr(obj, lock_attr)`` with an OwnedLock when needed
    (same interface, so the object's own `with self._lock:` sites work
    unchanged) and rebinds ``obj.__class__`` to a one-off subclass whose
    ``__setattr__`` raises :class:`LockDisciplineError` on an off-lock
    write to a watched attribute. Returns the OwnedLock so the test can
    assert with it directly. Idempotent per instance."""
    lock = getattr(obj, lock_attr)
    if not isinstance(lock, OwnedLock):
        lock = OwnedLock()
        object.__setattr__(obj, lock_attr, lock)
    watched = frozenset(attrs)
    cls = type(obj)
    if getattr(cls, "_gomelint_instrumented", False):
        object.__setattr__(obj, "_gomelint_watched", watched)
        return lock

    def __setattr__(self, name, value, _base=cls):
        if name in getattr(self, "_gomelint_watched", ()):  # pragma: no branch
            guard = getattr(self, lock_attr, None)
            if isinstance(guard, OwnedLock) and not guard.held_by_me():
                raise LockDisciplineError(
                    f"write to {_base.__name__}.{name} without holding "
                    f"{lock_attr} (runtime lock-discipline assertion)"
                )
        super(sub, self).__setattr__(name, value)

    sub = type(
        f"{cls.__name__}@gomelint", (cls,),
        {"__setattr__": __setattr__, "_gomelint_instrumented": True},
    )
    object.__setattr__(obj, "__class__", sub)
    object.__setattr__(obj, "_gomelint_watched", watched)
    return lock
