"""``@guarded_by`` and ``@invalidated_by``: declared lock ownership and
cache invalidation for shared mutable state, ``nos_tpu/utils/guards.py``
for the port.

Each decorator is a declaration only: it stores one class attribute
(``__guarded_by__`` / ``__invalidated_by__``, field -> lock or event)
and changes no behaviour.  The JAX package's static checker and
runtime lock checker read the same tables; the port keeps the
declarations so its classes state the same contracts.  Lock, event and
field names must be non-empty strings; a field declared under two
locks (or two events) raises at import time.  Subclasses inherit and
may extend a table.
"""

from __future__ import annotations

from typing import TypeVar

T = TypeVar("T", bound=type)


def _all_names(head: str, fields: tuple[str, ...]) -> bool:
    return (isinstance(head, str) and bool(head) and bool(fields)
            and all(isinstance(f, str) and f for f in fields))


def _declare(table_attr: str, what: str, head: str, fields: tuple[str, ...]):
    if not _all_names(head, fields):
        raise ValueError(f"{table_attr.strip('_')} needs a {what} name and "
                         "at least one field, all non-empty strings")

    def decorate(cls: T) -> T:
        # copy-on-extend: never mutate a base class's table in place
        table = dict(getattr(cls, table_attr, {}))
        for f in fields:
            prior = table.get(f)
            if prior is not None and prior != head:
                raise ValueError(
                    f"{cls.__name__}.{f} declared under both {prior!r} "
                    f"and {head!r} — one {what} per field")
            table[f] = head
        setattr(cls, table_attr, table)
        return cls

    return decorate


def guarded_by(lock_attr: str, *fields: str):
    """Declare that ``fields`` may only be written with
    ``self.<lock_attr>`` held."""
    return _declare("__guarded_by__", "lock", lock_attr, fields)


def guarded_fields(cls: type) -> dict[str, str]:
    """The declared field -> lock-attribute table ({} when undeclared)."""
    return dict(getattr(cls, "__guarded_by__", {}))


def invalidated_by(event: str, *fields: str):
    """Declare that in-place mutations of ``fields`` feed a derived cache
    whose coherence signal is ``event``: a method of the class, or a
    counter attribute every mutator bumps."""
    return _declare("__invalidated_by__", "event", event, fields)


def invalidated_fields(cls: type) -> dict[str, str]:
    """The declared field -> invalidation-event table ({} when undeclared)."""
    return dict(getattr(cls, "__invalidated_by__", {}))
