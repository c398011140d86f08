"""Frozen dataclasses that are JAX pytrees.

`@dataclass` makes a frozen dataclass whose fields are pytree children,
except those declared with `field(pytree_node=False)`, which become static
metadata: part of the tree structure, hashed into jit's cache key, never
traced. Instances get `.replace(**changes)`.
"""
from __future__ import annotations

import dataclasses

import jax


def field(pytree_node: bool = True, **kwargs):
    """A dataclass field; `pytree_node=False` marks it static."""
    metadata = dict(kwargs.pop("metadata", None) or {})
    metadata["static"] = not pytree_node
    return dataclasses.field(metadata=metadata, **kwargs)


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def dataclass(cls):
    """Register `cls` as a frozen dataclass pytree with `.replace`."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    data, meta = [], []
    for f in dataclasses.fields(cls):
        (meta if f.metadata.get("static") else data).append(f.name)
    cls.replace = _replace
    return jax.tree_util.register_dataclass(cls, data_fields=data,
                                            meta_fields=meta)
