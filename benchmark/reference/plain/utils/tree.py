"""Field-wise maps over the port's tensor dataclasses.

The JAX package threads ``flax.struct`` pytrees through ``jax.tree_util``;
the port's state types are plain dataclasses of tensors, and these helpers
cover the tree operations it needs (broadcasting a state over K, stacking B
seeded states along a leading seed axis, freezing a state behind a done
latch).
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


def tree_stack(trees):
    """One dataclass whose tensor fields stack the ``trees``' fields along a
    new leading axis (the seed axis of a batch)."""
    first, *rest = trees
    return tree_map(lambda *xs: torch.stack(xs), first, *rest)


def tree_where(cond: torch.Tensor, a, b):
    """Field-wise ``torch.where(cond, a, b)``.  ``cond`` is a scalar, or a
    [B] per-seed mask that selects whole seeds of [B, ...] fields."""

    def where(x, y):
        c = cond.reshape(cond.shape + (1,) * (x.dim() - cond.dim()))
        return torch.where(c, x, y)

    return tree_map(where, a, b)
