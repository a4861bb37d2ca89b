"""Frozen dataclasses registered as JAX pytrees.

Every preconditioner state and the optimizer state are such classes:
array fields are pytree children, fields declared with `field(static=True)`
live in the treedef (hashable, trace-time constants), and `.replace(**kw)`
returns an updated copy.
"""
from __future__ import annotations

import dataclasses

import jax


def field(*, static: bool = False, **kwargs):
    """A dataclass field; `static=True` keeps it out of the pytree leaves."""
    return dataclasses.field(metadata={"static": static}, **kwargs)


def dataclass(cls):
    """Make `cls` a frozen dataclass and register it as a pytree node."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields if not f.metadata.get("static")],
        meta_fields=[f.name for f in fields if f.metadata.get("static")],
    )
    cls.replace = lambda self, **changes: dataclasses.replace(self, **changes)
    return cls
