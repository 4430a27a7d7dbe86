"""Control-sequence utilities: squashing and discounted cost-to-go, in torch.

Port of ``m3p2i_aip_tpu/ops/control.py`` (itself the reference's
``utils/mppi_utils.py`` scale_ctrl:29-44 and cost_to_go:106-113, and
``skill_utils._ensure_non_zero``:3-4).
"""
from __future__ import annotations

import torch


def scale_ctrl(ctrl, u_min, u_max, squash_fn: str = "clamp"):
    """Squash controls into [u_min, u_max]. Parity: mppi_utils.scale_ctrl:29-44."""
    if squash_fn == "clamp":
        return torch.maximum(torch.minimum(ctrl, u_max), u_min)
    half = (u_max - u_min) / 2.0
    mid = (u_max + u_min) / 2.0
    if squash_fn == "clamp_rescale":
        ctrl = torch.clamp(ctrl, -1.0, 1.0)
    elif squash_fn == "tanh":
        ctrl = torch.tanh(ctrl)
    elif squash_fn == "identity":
        return ctrl
    else:
        raise ValueError(f"unknown squash_fn {squash_fn!r}")
    return mid + ctrl * half


def cost_to_go(cost_seq: torch.Tensor, gamma_seq: torch.Tensor) -> torch.Tensor:
    """Discounted cost-to-go along the last axis (mppi_utils.cost_to_go:106-113):
    scale by gamma^t, reversed cumsum, unscale."""
    scaled = gamma_seq * cost_seq
    ctg = torch.flip(torch.cumsum(torch.flip(scaled, dims=(-1,)), dim=-1), dims=(-1,))
    return ctg / gamma_seq


def discounted_traj_cost(cost_seq: torch.Tensor, gamma_seq: torch.Tensor) -> torch.Tensor:
    """``cost_to_go(...)[..., 0]``: the plain discounted sum over the horizon."""
    return torch.sum(cost_seq * gamma_seq, dim=-1)


def ensure_non_zero(cost: torch.Tensor, beta, factor) -> torch.Tensor:
    """exp(-factor * (cost - beta)). Parity: skill_utils._ensure_non_zero:3-4."""
    return torch.exp(-factor * (cost - beta))
