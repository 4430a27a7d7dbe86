"""What decides ``correct``: the program's ticks against the plain
reference, after the window.

A sample of the window's checkpoints, drawn from the run's seed, is
recomputed by the plain reference that the cell's configuration file names
(``"reference"``: ``benchmark/reference/<name>.py``, found by name through
``spec.reference``) from the same inputs, and each view row the program
wrote for that tick is compared with the reference's.  For every tick the
mix checks (an episode's start and each later chunk start it names), the
sample takes ``per_tick`` of the window's checkpoints there; in a seed
batch, of seeds that no earlier checked tick of the run took, so a run
checks ``per_tick`` x ticks distinct seeds.  The
number compared is ``view_gap``: the widest absolute difference, over the
sampled ticks and the row's entries (positions in m, velocities in m/s,
quaternion components, a contact force), between the two.  A row that is
missing or not finite reads as infinitely far.  Its limit lies in
``benchmark/limits/<cell>.json``.

With ``count_live`` the reference also gives, through its module's
``bounds``, the yardstick's bound of each kernel call of each sampled tick,
by kind (``{"rollout": [ms, ...], ...}``); the kinds are the reference's
own, and a per-layer reader asks for the kind it reads
(``layers.roofline_pct``).
"""
from __future__ import annotations

import math
from typing import List, Optional

import numpy as np

from benchmark import spec as spec_mod


def sample(checkpoints: List[dict], per_tick: int, seed: int) -> List[dict]:
    """For each checked tick, ``per_tick`` of the checkpoints there, drawn
    from ``seed``; in a seed batch (checkpoints with a ``seed`` slot), of
    slots not drawn at an earlier tick while any are left."""
    rng = np.random.default_rng([seed, 1])
    out, used = [], set()
    for i in sorted({c["i"] for c in checkpoints}):
        here = [c for c in checkpoints if c["i"] == i]
        fresh = [c for c in here if c.get("seed") not in used] or here
        picked = [fresh[j] for j in sorted(rng.choice(len(fresh), size=min(per_tick, len(fresh)), replace=False))]
        used |= {c["seed"] for c in picked if "seed" in c}
        out += picked
    return out


def view_gap(program_view, reference_view) -> float:
    """The widest absolute difference between two view rows; inf when the
    program's row is missing, of another length or not finite."""
    if program_view is None:
        return math.inf
    p = np.asarray(program_view, dtype=np.float64)
    r = np.asarray(reference_view, dtype=np.float64)
    if p.shape != r.shape or not np.all(np.isfinite(p)):
        return math.inf
    return float(np.max(np.abs(p - r)))


def reference_views(cfg_file: dict, cks: List[dict], device, precision: Optional[str] = None,
                    count_live: bool = False, seeds_per_tick: int = 1):
    """The view row for each checkpoint of the reference that ``cfg_file``
    names (in ``precision`` for a control), and the bounds of their kernel
    calls by kind when ``count_live``."""
    ref = spec_mod.reference(cfg_file.get("reference"))
    scene = ref.Scene(cfg_file, device, precision=precision, count_live=count_live)
    views, bounds = [], {}
    for ck in cks:
        views.append(scene.tick(ck).cpu().numpy())
        if count_live:
            for k, v in ref.bounds(scene, seeds_per_tick).items():
                bounds.setdefault(k, []).extend(v)
        scene.calls = []
    return views, bounds


def compare(cfg_file: dict, checkpoints: List[dict], per_tick: int, seed: int, limits: dict, device,
            count_live: bool = False, seeds_per_tick: int = 1) -> dict:
    """{"numbers": {name: {"value", "limit"}}, "correct", "checked",
    "bounds"}: the sampled ticks against the reference, each number beside
    its limit."""
    cks = sample(checkpoints, per_tick, seed)
    refs, bounds = reference_views(cfg_file, cks, device, count_live=count_live, seeds_per_tick=seeds_per_tick)
    gaps = [view_gap(ck["view"], r) for ck, r in zip(cks, refs)]
    gap = max(gaps) if gaps else math.inf  # nothing checked is no evidence
    numbers = {"view_gap": {"value": gap, "limit": float(limits["view_gap"])}}
    correct = all(v["value"] <= v["limit"] for v in numbers.values())
    return {"numbers": numbers, "correct": correct, "checked": len(cks), "gaps": gaps, "bounds": bounds}
