"""The n=20 quality campaign on the port: every seeded batch of the
repository's ``scripts/run_quality_campaign.sh`` and
``scripts/run_quality_campaign_r3.sh``, and the rows of ``RESULTS.md`` that
the repository's chain scripts ran beside them (the albert push_reach, the
push under friction noise, the two-corner scenes, the single-mode corner
rows, the boxer ablation), through the port's ``run_experiments``.

Every row writes its log under ``results_h100/`` (``results_h100/point/``,
``panda/``, ``albert/``), never under ``plot/``, where the JAX package's
logs are.  A row runs as one seed batch (``parallel_seeds=True``) unless it
carries a scripted perturbation or domain noise, which ``run_experiments``
runs serially (the panda reactive pick, the push with ``fric_noise=0.4``).
Rows are listed in the order of ROADMAP.md's n=20 queue: the rows the port
has not yet reproduced first.

    python -m m3p2i_aip_tpu_torch.scripts.run_quality_campaign --list
    python -m m3p2i_aip_tpu_torch.scripts.run_quality_campaign [--only ROW[,ROW...]] [overrides...]

Further arguments (``device=cpu``, ``n_runs=2``, config overrides) are
appended to every row's command.
"""
from __future__ import annotations

import os
import sys

from m3p2i_aip_tpu_torch.analysis.bench_record import RESULTS_DIR
from m3p2i_aip_tpu_torch.scripts import run_experiments

N20 = ["n_runs=20", "chunked=10"]
CORNER = 'goal=[-3.75,-3.75]'
HYBRID = ["task=push_pull", "multi_modal=True", CORNER]
CORNER2 = ['actors=["box"]', "initial_actor_positions=[[3.75,3.75]]"]
SERIAL = ("reactive_pick", "push_fricnoise")  # run_experiments refuses these under parallel_seeds

# name: (family directory, the row's arguments); the name is the log's file name
ROWS = {
    "push_reach": ("albert", ["-cn", "config_albert", "task=push_reach", "goal=[3.0,0.0,0.6]", *N20]),
    "shelf_pick_mm": ("panda", ["-cn", "config_panda", "multi_modal=True", "cube_on_shelf=True", *N20]),
    "shelf_pick_mm_b": ("panda", ["-cn", "config_panda", "multi_modal=True", "cube_on_shelf=True", *N20,
                                  "seed_offset=100"]),
    "reactive_pick": ("panda", ["-cn", "config_panda", "reactive_perturb=0.15", *N20]),
    "case2_push": ("point", ["task=push", "goal=[-1,-1]", *N20]),
    "case2_pull": ("point", ["task=pull", "goal=[0,0]", *N20]),
    "push_fricnoise": ("point", ["task=push", "goal=[-1,-1]", "fric_noise=0.4", *N20]),
    "corner2_hybrid": ("point", [*HYBRID, *CORNER2, "n_runs=20", "chunked=4"]),
    "heijn_corner2_hybrid": ("point", ["-cn", "config_heijn", *HYBRID, *CORNER2, "n_runs=20", "chunked=4"]),
    "boxer_corner2_hybrid": ("point", ["-cn", "config_boxer", *HYBRID, *CORNER2, "n_runs=20", "chunked=4"]),
    "corner1_push": ("point", ["task=push", CORNER, *N20]),
    "corner1_pull": ("point", ["task=pull", CORNER, *N20]),
    "corner2_push": ("point", ["task=push", CORNER, *CORNER2, *N20]),
    "corner2_pull": ("point", ["task=pull", CORNER, *CORNER2, *N20]),
    "normal_pick_parity": ("panda", ["-cn", "config_panda", "mppi=panda_parity", *N20]),
    "boxer_corner_hybrid_parity": ("point", ["-cn", "config_boxer", "mppi=boxer_parity", *HYBRID, *N20]),
    # reproduced by the port in PRs 4-9
    "corner1_hybrid": ("point", [*HYBRID, *N20]),
    "ee_reach": ("albert", ["-cn", "config_albert", "n_runs=20"]),
    "heijn_push": ("point", ["-cn", "config_heijn", "task=push", "goal=[-1,-1]", *N20]),
    "heijn_pull": ("point", ["-cn", "config_heijn", "task=pull", "goal=[0,0]", *N20]),
    "heijn_corner_hybrid": ("point", ["-cn", "config_heijn", *HYBRID, *N20]),
    "boxer_push": ("point", ["-cn", "config_boxer", "task=push", "goal=[-1,-1]", *N20]),
    "boxer_pull": ("point", ["-cn", "config_boxer", "task=pull", "goal=[0,0]", *N20]),
    "boxer_corner_hybrid": ("point", ["-cn", "config_boxer", *HYBRID, *N20]),
    # the rest of the two scripts' rows
    "normal_pick": ("panda", ["-cn", "config_panda", *N20]),
    "corner1_hybrid_b": ("point", [*HYBRID, *N20, "seed_offset=100"]),
    "corner1_hybrid_parity": ("point", ["task=push_pull", "multi_modal=True", "mppi=point_parity", CORNER, *N20]),
    "corner1_hybrid_permode_cov": ("point", [*HYBRID, "mppi.update_cov_per_mode=True", *N20]),
}


def command(name: str, extra=()) -> list:
    """The ``run_experiments`` arguments of row ``name``, ``extra`` appended."""
    family, args = ROWS[name]
    batch = [] if name in SERIAL else ["parallel_seeds=True"]
    return [*args, *batch, f"out={os.path.join(RESULTS_DIR, family, name + '.npy')}", *extra]


def main(argv) -> None:
    argv = list(argv)
    if "--list" in argv:
        for name in ROWS:
            print(f"{name}: {' '.join(command(name))}")
        return
    names = list(ROWS)
    if "--only" in argv:
        i = argv.index("--only")
        names = argv[i + 1].split(",")
        del argv[i : i + 2]
        unknown = [n for n in names if n not in ROWS]
        if unknown:
            raise SystemExit(f"run_quality_campaign: no row {unknown}; --list shows them")
    for name in names:
        cmd = command(name, argv)
        print(f"=== {name}: run_experiments {' '.join(cmd)}", flush=True)
        run_experiments.main(cmd)


if __name__ == "__main__":
    main(sys.argv[1:])
