"""Planner server: terminal 1 of the reference's two-terminal workflow.

Port of ``scripts/reactive_tamp.py`` (run_reactive_tamp:89-94): serves
``ReactiveTAMPServer`` on ``tcp://127.0.0.1:4242`` (``M3P2I_RPC_HOST=0.0.0.0``
opens it to a sim terminal on another host), with the same argv grammar plus
``device=`` (``cuda``, the default, or ``cpu``) and ``--eager``: each
``run_tamp`` call is one replay of the planner's compiled command by
default (``tamp/graph_tick.py``), an eager call with ``--eager``.  Run from the repository
root, then start ``m3p2i_aip_tpu_torch.scripts.sim`` (or the JAX package's
``scripts/sim.py``: the wire format is the same) in a second terminal:

    python -m m3p2i_aip_tpu_torch.scripts.reactive_tamp task=push goal="[-1, -1]"
    python -m m3p2i_aip_tpu_torch.scripts.reactive_tamp -cn config_panda

Prefer the single-process ``m3p2i_aip_tpu_torch.scripts.run_tamp`` unless
the planner and the actuated sim must be separate processes.
"""
from __future__ import annotations

import os
import sys

from m3p2i_aip_tpu_torch.config.config_store import load_config_from_argv
from m3p2i_aip_tpu_torch.scripts.run_tamp import pop_flag, pop_option
from m3p2i_aip_tpu_torch.tamp.reactive_tamp import ReactiveTAMPServer
from m3p2i_aip_tpu_torch.utils import rpc

PORT = 4242


def run_reactive_tamp(argv) -> None:
    device, argv = pop_option(argv, "device", "cuda")
    eager, argv = pop_flag(argv, "--eager")
    host = os.environ.get("M3P2I_RPC_HOST", "127.0.0.1")
    cfg = load_config_from_argv(argv, default_config="config_point")
    server = rpc.Server(ReactiveTAMPServer(cfg, device=device, graphs=False if eager else None), host, PORT)
    print(f"planner listening on tcp://{host}:{PORT}")
    server.run()


if __name__ == "__main__":
    run_reactive_tamp(sys.argv[1:])
