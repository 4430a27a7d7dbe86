"""The Euclidean norm of the plain step and costs, with the JAX package's
gradient.

``torch.linalg.vector_norm`` gives the norm of a zero vector the gradient 0;
``jnp.linalg.norm`` differentiates as ``sqrt(sum(x * x))`` and gives NaN
there (``x / |x|`` at 0), even where a ``where`` discards the branch.  The
gradient refinement of the planner (``mppi._grad_refine``) differentiates
the plain step and costs and zeroes non-finite entries, so which entries
are NaN decides its step: this norm keeps the JAX package's.  Its value is
``torch.linalg.vector_norm``'s bit for bit, and without autograd it is that
call alone.
"""
from __future__ import annotations

import torch


class _Norm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, keepdim):
        n = torch.linalg.vector_norm(x, dim=dim, keepdim=keepdim)
        ctx.save_for_backward(x, n)
        ctx.dim, ctx.keepdim = dim, keepdim
        return n

    @staticmethod
    def backward(ctx, g):
        x, n = ctx.saved_tensors
        if not ctx.keepdim:
            g, n = g.unsqueeze(ctx.dim), n.unsqueeze(ctx.dim)
        return g * x / n, None, None  # NaN where |x| = 0, as jax.grad of sqrt(sum(x * x))


def vector_norm(x: torch.Tensor, dim: int = -1, keepdim: bool = False) -> torch.Tensor:
    """``torch.linalg.vector_norm(x, dim=dim, keepdim=keepdim)``, whose
    gradient is NaN at a zero vector as ``jnp.linalg.norm``'s is."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Norm.apply(x, dim, keepdim)
    return torch.linalg.vector_norm(x, dim=dim, keepdim=keepdim)
