"""M3P2I multi-modal importance weights: plain PyTorch version and the
wrapper of its CUDA kernel (``csrc/multimodal_weights.cu``).

Port of ``m3p2i_aip_tpu/ops/pallas_kernels.py::_weights_kernel`` (and the
XLA ``MPPI._multi_modal_exp_util`` it replaces): discounted cost-to-go over
the horizon, a per-group min shift, and three masked adaptive-beta searches
(mode 0 = ``k < half_K``, mode 1, global).  Each search starts at beta = 1 on
every call (the reference never persists the tuned betas, mirrored) and
multiplies beta by 0.9 or 1.2 until eta is in [eta_l, eta_u], at most 64
times.

The batched pair (``multimodal_weights_batched`` and its plain version) is
the port of the kernel's ``grid=(B,)`` call (``pallas_kernels.py:173``, the
``custom_vmap`` rule ``_mmw_vmap``): [B, K, T] costs of B seeds, one shared
discount, and each seed's own beta search and early exit.
"""
from __future__ import annotations


import numpy as np
import torch


BETA_ITERS = 64
MAX_B = 65535  # seeds one launch takes (a block each); any K goes
SMEM_MAX_K = 49152  # the kernel keeps the [K] cost-to-go in shared memory up to here, above in a global scratch

# Number of CUDA kernel launches made by ``multimodal_weights`` and by
# ``multimodal_weights_batched`` (CPU calls run the plain versions and do
# not count).
weights_launches = 0
weights_batched_launches = 0


def _shifted_costs(cost, gamma, half_K: int):
    """[3, K] (or [..., 3, K] for [..., K, T] costs): each group's discounted
    cost-to-go shifted by the group's minimum, +inf outside the group.

    The cost-to-go is summed in horizon order, one multiply and one add a
    step, as the kernel sums it: on panda costs the search drives beta down
    to ~1e-3 where samples tie, and there a few ulps of cost-to-go from
    another summation order move the weights by 1e-5.
    """
    K = cost.shape[-2]
    tc = cost[..., 0] * gamma[0]  # [..., K]
    for t in range(1, cost.shape[-1]):
        tc = tc + cost[..., t] * gamma[t]
    k = torch.arange(K, device=cost.device)
    mask = torch.stack([k < half_K, k >= half_K, torch.ones_like(k, dtype=torch.bool)])
    c3 = torch.where(mask, tc[..., None, :], torch.inf)
    return c3 - torch.amin(c3, dim=-1, keepdim=True)  # per-group min shift


def multimodal_weights_plain(cost, gamma, half_K: int, eta_u: float = 10.0, eta_l: float = 3.0):
    """(w_mode0, w_mode1, w_global), each [K], from [K, T] costs (or each
    [..., K] from [..., K, T] costs, every leading index searched alone).

    The search runs all 64 rounds with the update masked to out-of-bounds
    groups: a group inside [eta_l, eta_u] keeps its beta, so this equals the
    early-exit loop without a host sync per round.
    """
    c3 = _shifted_costs(cost, gamma, half_K)
    beta = torch.ones(c3.shape[:-1] + (1,), dtype=cost.dtype, device=cost.device)
    for _ in range(BETA_ITERS):
        eta = torch.sum(torch.exp(-c3 / beta), dim=-1, keepdim=True)
        beta = torch.where(eta > eta_u, beta * 0.9, torch.where(eta < eta_l, beta * 1.2, beta))
    e = torch.exp(-c3 / beta)
    w = e / torch.sum(e, dim=-1, keepdim=True)
    return w[..., 0, :], w[..., 1, :], w[..., 2, :]


def beta_rounds(cost, gamma, half_K: int, eta_u: float = 10.0, eta_l: float = 3.0):
    """Each group's beta search on [..., K, T] costs, round by round with
    the plain version's arithmetic: (rounds, turns, beta), arrays [..., 3].

    ``rounds`` counts the updates of beta before eta lay inside [eta_l,
    eta_u] (BETA_ITERS where it never did: the cap, after which the final
    beta is 0.9 or 1.2 to the 64th power, formed by repeated products);
    ``turns`` counts the changes of direction among those updates, and
    ``beta`` is each group's final beta.  The
    sums over K are PyTorch's, so near a bound a count can differ from the
    kernel's by its order of summation.
    """
    c3 = _shifted_costs(cost, gamma, half_K)
    beta = torch.ones(c3.shape[:-1] + (1,), dtype=cost.dtype, device=cost.device)
    steps = []
    for _ in range(BETA_ITERS):
        eta = torch.sum(torch.exp(-c3 / beta), dim=-1, keepdim=True)
        high, low = eta > eta_u, eta < eta_l
        steps.append(torch.where(high, -1, torch.where(low, 1, 0))[..., 0])  # down, up, or inside
        beta = torch.where(high, beta * 0.9, torch.where(low, beta * 1.2, beta))
    steps = torch.stack(steps, dim=-1).cpu().numpy()  # [..., 3, BETA_ITERS], one host copy
    inside = steps == 0
    rounds = np.where(inside.any(-1), inside.argmax(-1), BETA_ITERS)
    live = np.arange(BETA_ITERS - 1) < rounds[..., None] - 1  # consecutive updates of the search
    turns = ((steps[..., 1:] != steps[..., :-1]) & live).sum(-1)
    return rounds, turns, beta[..., 0].cpu().numpy()


def _check_batch(fn: str, cost, gamma) -> None:
    """Raise unless [B, K, T] costs and a [T] discount are contiguous
    float32 tensors on one device."""
    if cost.dim() != 3 or gamma.shape != (cost.shape[2],):
        raise ValueError(f"{fn}: cost {tuple(cost.shape)} / gamma {tuple(gamma.shape)}")
    for name, x in (("cost", cost), ("gamma", gamma)):
        if x.dtype != torch.float32 or not x.is_contiguous() or x.device != cost.device:
            raise ValueError(f"{fn}: {name} must be contiguous float32 on {cost.device}")


def multimodal_weights(cost, gamma, half_K: int, eta_u: float = 10.0, eta_l: float = 3.0):
    """The multi-modal weights of [K, T] costs under discount ``gamma`` [T].

    A CPU tensor runs :func:`multimodal_weights_plain`; a CUDA tensor launches
    the kernel on the current stream (one block: the batched kernel with one
    seed) or raises.
    """
    return multimodal_weights_plain(cost, gamma, half_K, eta_u, eta_l)


def multimodal_weights_batched_plain(cost, gamma, half_K: int, eta_u: float = 10.0, eta_l: float = 3.0):
    """(w_mode0, w_mode1, w_global), each [B, K], from [B, K, T] costs: the
    single plain version per seed, stacked."""
    per_seed = [multimodal_weights_plain(c, gamma, half_K, eta_u, eta_l) for c in cost]
    return tuple(torch.stack(ws) for ws in zip(*per_seed))


def multimodal_weights_batched(cost, gamma, half_K: int, eta_u: float = 10.0, eta_l: float = 3.0):
    """The multi-modal weights of B seeds' [B, K, T] costs under one
    discount ``gamma`` [T].

    The inputs are checked on either device; then a CPU tensor runs
    :func:`multimodal_weights_batched_plain` and a CUDA tensor launches the
    kernel once for the whole batch (one block per seed) or raises.
    """
    _check_batch("multimodal_weights_batched", cost, gamma)
    return multimodal_weights_batched_plain(cost, gamma, half_K, eta_u, eta_l)
