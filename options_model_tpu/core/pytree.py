"""Frozen dataclasses registered as JAX pytrees.

``pytree_dataclass`` makes a class a frozen dataclass (hashable, compared by
value) whose fields are pytree leaves, except those declared with
``static_field`` (``metadata={"static": True}``), which travel in the treedef.
``.replace(**updates)`` returns a modified copy.
"""

from __future__ import annotations

import dataclasses

import jax


def static_field(default=dataclasses.MISSING, **kwargs):
    """A field kept out of the pytree's leaves (part of its structure)."""
    return dataclasses.field(default=default, metadata={"static": True},
                             **kwargs)


def pytree_dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields if not f.metadata.get("static")],
        meta_fields=[f.name for f in fields if f.metadata.get("static")])

    def replace(self, **updates):
        return dataclasses.replace(self, **updates)

    cls.replace = replace
    return cls
