"""Field-wise maps over the port's tensor dataclasses.

The JAX package threads ``flax.struct`` pytrees through ``jax.tree_util``;
the port's state types are plain dataclasses of tensors, and these two
helpers cover the tree operations it needs (broadcasting a state over K,
freezing a state behind a done latch).
"""
from __future__ import annotations

import dataclasses

import torch


def tree_map(fn, obj, *others):
    """New dataclass with ``fn(field, *other_fields)`` on every tensor field;
    ``None`` fields stay ``None``."""
    changes = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if torch.is_tensor(v):
            changes[f.name] = fn(v, *(getattr(o, f.name) for o in others))
    return dataclasses.replace(obj, **changes)


def tree_where(cond: torch.Tensor, a, b):
    """Field-wise ``torch.where(cond, a, b)`` with a scalar condition."""
    return tree_map(lambda x, y: torch.where(cond, x, y), a, b)
