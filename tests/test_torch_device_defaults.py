"""The port's entry points run on the card unless the caller asks for the CPU.

``SimLoop``, ``BatchSimLoop``, ``ReactiveTAMP``, ``make_env``, ``M3P2I``,
``run_sim``, ``ReactiveTAMPServer`` and ``load_checkpoint`` default to
``device="cuda"``; on a host without CUDA a call that names no device raises
instead of quietly running on the CPU.
"""
import inspect
import os
import tempfile

import pytest
import torch

from m3p2i_aip_tpu_torch.config.config_store import load_config
from m3p2i_aip_tpu_torch.envs import make_env
from m3p2i_aip_tpu_torch.planners.motion_planner.m3p2i import M3P2I
from m3p2i_aip_tpu_torch.planners.motion_planner.mppi import MPPI
from m3p2i_aip_tpu_torch.tamp.batch_loop import BatchSimLoop
from m3p2i_aip_tpu_torch.tamp.reactive_tamp import ReactiveTAMP, ReactiveTAMPServer
from m3p2i_aip_tpu_torch.tamp.sim_loop import SimLoop, run_sim
from m3p2i_aip_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint


def _load_onto_the_default(cfg):
    """A checkpoint of a CPU loop, loaded with the default device."""
    loop = SimLoop(cfg, device="cpu")
    with tempfile.TemporaryDirectory() as d:
        path = save_checkpoint(os.path.join(d, "ckpt"), loop.tamp, loop.state)
        return load_checkpoint(path, loop.tamp, loop.state)


ENTRY_POINTS = {
    "SimLoop": (SimLoop.__init__, lambda cfg: SimLoop(cfg)),
    "BatchSimLoop": (BatchSimLoop.__init__, lambda cfg: BatchSimLoop(cfg, [0, 1])),
    "ReactiveTAMP": (ReactiveTAMP.__init__, lambda cfg: ReactiveTAMP(cfg)),
    "make_env": (make_env, lambda cfg: make_env(cfg)),
    "M3P2I": (MPPI.__init__, lambda cfg: M3P2I(cfg, rollout=None)),
    "run_sim": (run_sim, lambda cfg: run_sim(cfg, n_steps=1, warmup=0)),
    "ReactiveTAMPServer": (ReactiveTAMPServer.__init__, lambda cfg: ReactiveTAMPServer(cfg)),
    "load_checkpoint": (load_checkpoint, _load_onto_the_default),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
@pytest.mark.parametrize("config", ["config_point", "config_panda", "config_albert"])
def test_entry_point_defaults_to_the_card(name, config):
    fn, call = ENTRY_POINTS[name]
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        return  # the default call would run on the card
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        call(load_config(config))
