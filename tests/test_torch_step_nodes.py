"""The tracer's counters and the compiled tick's part marker
(``graph_tick.part``, the counter ``graph.step_nodes``).

On the CPU: a counter's count, total and newest value; the marker does
nothing outside a capture, so a compiled (static-buffer) albert chunk and a
panda chunk leave no ``graph.step_nodes``.  On the card
(``M3P2I_TEST_CUDA=1``): the albert's and the panda's captured ticks count
their real-env step's nodes, a positive number below the tick's, equal to
the nodes of ``env.step`` captured alone; the point tick keeps its 131
nodes with the marker in place.
"""
import os

import pytest
import torch

from m3p2i_aip_tpu_torch.config.config_store import load_config
from m3p2i_aip_tpu_torch.tamp import graph_tick
from m3p2i_aip_tpu_torch.tamp.reactive_tamp import ReactiveTAMP
from m3p2i_aip_tpu_torch.utils import profiling

ALBERT = ["task=push_reach", "goal=[3.0,0.0,0.6]"]
POINT_MAIN = ["task=push_pull", "multi_modal=True", "goal=[-3.75,-3.75]"]
SMALL = ["mppi.num_samples=8", "mppi.horizon=3"]


def test_a_counter_keeps_its_count_total_and_newest_value():
    tr = profiling.Tracer(capacity=16)
    assert tr.snapshot()["counters"] == {}
    for v in (5, 7, 3):
        tr.count("graph.x_nodes", v)
    assert tr.snapshot()["counters"] == {"graph.x_nodes": {"count": 3, "total": 15, "last": 3}}
    tr.reset()
    assert tr.snapshot()["counters"] == {}


def test_the_module_counter_is_the_shared_tracers():
    assert profiling.count == profiling.TRACER.count
    assert "counters" in profiling.snapshot()


def _settled(tamp, device, n=3):
    env = tamp.env
    state = env.init_state()
    for _ in range(n):
        state = env.step(state, torch.zeros(env.nu, device=device), env.zero_ext())
    return state


def _albert_chunk(tamp, device, length=2):
    state = _settled(tamp, device)
    return tamp._run_chunk_impl(tamp.mppi_state, state, tamp.tamp_interface(state), 0, length, gate=False)


def _panda_chunk(tamp, device, length=2):
    state = _settled(tamp, device)
    return tamp.run_chunk_panda(tamp.mppi_state, state, 0, tamp.zup_zs0(), length)


def test_the_part_marker_does_nothing_on_the_cpu():
    for cfg, chunk in ((load_config("config_albert", ALBERT + SMALL), _albert_chunk),
                       (load_config("config_panda", ["multi_modal=True"] + SMALL), _panda_chunk)):
        tamp = ReactiveTAMP(cfg, device="cpu")
        chunk(tamp, torch.device("cpu"))
        assert tamp.ticks.mode == graph_tick.STATIC
    assert "graph.step_nodes" not in profiling.snapshot()["counters"]
    with graph_tick.part("step"):
        pass
    assert "graph.step_nodes" not in profiling.snapshot()["counters"]


@pytest.fixture(scope="module")
def cuda():
    if os.environ.get("M3P2I_TEST_CUDA", "") != "1":
        pytest.skip("CUDA tests run with M3P2I_TEST_CUDA=1")
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _step_alone_nodes(env, state, device) -> int:
    """Nodes of ``env.step`` captured alone from ``state`` with a zero action."""
    u, ext = torch.zeros(env.nu, device=device), env.zero_ext()
    env.step(state, u, ext)  # the lazy per-device tables, outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        env.step(state, u, ext)
    return graph_tick.graph_nodes(graph)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["albert", "panda"])
def test_a_captured_tick_counts_its_steps_nodes(cuda, family):
    if family == "albert":
        tamp = ReactiveTAMP(load_config("config_albert", ALBERT), device=cuda)
        _albert_chunk(tamp, cuda)
    else:
        tamp = ReactiveTAMP(load_config("config_panda", ["multi_modal=True"]), device=cuda)
        _panda_chunk(tamp, cuda)
    (prog,) = [p for p in tamp.ticks.programs.values() if p.key[0] in ("open", "panda")]
    step = profiling.snapshot()["counters"]["graph.step_nodes"]["last"]
    print(f"{family}: step {step} of {prog.stats['nodes']} nodes")
    assert 0 < step < prog.stats["nodes"]
    assert step == _step_alone_nodes(tamp.env, _settled(tamp, cuda), cuda)


@pytest.mark.cuda
def test_the_point_tick_keeps_its_nodes_with_the_marker(cuda):
    tamp = ReactiveTAMP(load_config("config_point", POINT_MAIN), device=cuda)
    _albert_chunk(tamp, cuda)  # the point family's chunk is the same call
    (prog,) = tamp.ticks.programs.values()
    step = profiling.snapshot()["counters"]["graph.step_nodes"]["last"]
    print(f"point: step {step} of {prog.stats['nodes']} nodes")
    assert prog.stats["nodes"] == 131 and 0 < step < 131
