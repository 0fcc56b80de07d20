"""Frozen dataclasses registered as JAX pytrees.

`@struct.dataclass` makes every field a pytree leaf (so instances pass
through jit/vmap/scan/shard_map) and adds `.replace(**changes)`. It needs
nothing beyond JAX itself.
"""

from __future__ import annotations

import dataclasses

import jax


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def dataclass(cls):
    """Frozen dataclass + pytree registration with all fields as data."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    names = [f.name for f in dataclasses.fields(cls)]
    jax.tree_util.register_dataclass(cls, data_fields=names, meta_fields=[])
    cls.replace = _replace
    return cls
