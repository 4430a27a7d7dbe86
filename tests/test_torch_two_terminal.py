"""The two-terminal workflow of the port: RPC transport, planner server and
sim client, against the JAX package's.

The reference runs the planner and the actuated sim as two processes over
RPC (reactive_tamp.py:92-94, sim.py:29-58).  Here the port's ``rpc.Server``
serves ``ReactiveTAMPServer`` in a thread on an ephemeral localhost port and
the port's sim client (``scripts/sim.py`` ``drive``) ticks against it; six
ticks equal the JAX package's server and client at ``ATOL`` with
``mppi.exploration_noise=0``.  The wire format is the JAX package's byte for
byte, so the JAX package's client drives the port's server.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m3p2i_aip_tpu.config.config_store import load_config as jax_load_config
from m3p2i_aip_tpu.envs import make_env as jax_make_env
from m3p2i_aip_tpu.envs import update_dyn_obs as jax_update_dyn_obs
from m3p2i_aip_tpu.tamp.reactive_tamp import ReactiveTAMPServer as JaxReactiveTAMPServer
from m3p2i_aip_tpu.tamp.sim_loop import real_suction_ext as jax_real_suction_ext
from m3p2i_aip_tpu.utils import data_transfer as jax_data_transfer
from m3p2i_aip_tpu.utils import rpc as jax_rpc
from m3p2i_aip_tpu_torch.config.config_store import load_config
from m3p2i_aip_tpu_torch.scripts.sim import drive
from m3p2i_aip_tpu_torch.tamp.reactive_tamp import ReactiveTAMPServer
from m3p2i_aip_tpu_torch.utils import data_transfer, rpc

OVERRIDES = ["task=push", "goal=[-1,-1]", "mppi.num_samples=16", "mppi.exploration_noise=0"]
ATOL = 1e-3  # tests/test_torch_slice.py:31-36, over six closed-loop ticks
TICKS = 6


def _serve(server):
    """Run ``server`` in a daemon thread; the thread's exception, if any,
    lands in the returned list."""
    raised = []

    def target():
        try:
            server.run()
        except Exception as e:
            raised.append(e)

    thread = threading.Thread(target=target, daemon=True)
    thread.start()
    return thread, raised


class _Recording:
    """A planner stub in front of an RPC client that keeps every action."""

    def __init__(self, client):
        self.client, self.actions = client, []

    def run_tamp(self, dof, root):
        action = self.client.run_tamp(dof, root)
        self.actions.append(action)
        return action

    def get_suction(self):
        return self.client.get_suction()

    def get_trajs(self):
        return self.client.get_trajs()


def _port_run(client_cls, n: int):
    """``n`` ticks of the port's sim client against a fresh port server;
    returns (actions, the client's final state, its env, the server)."""
    server = rpc.Server(ReactiveTAMPServer(load_config("config_point", OVERRIDES), device="cpu"), "127.0.0.1", 0)
    _serve(server)
    client = client_cls().connect("127.0.0.1", server.port)
    planner = _Recording(client)
    try:
        env, state, rpc_s, tick_s = drive(load_config("config_point", OVERRIDES), planner, n_ticks=n, pace=False,
                                          device="cpu")
    finally:
        client.close()
        server.close()
    assert len(rpc_s) == len(tick_s) == n and all(0 < r < t for r, t in zip(rpc_s, tick_s))
    return planner.actions, state, env, server


def _jax_run(n: int):
    """``n`` ticks of the JAX package's server and a client with the body of
    its ``scripts/sim.py`` (warm-up 150, dyn-obs, ``run_tamp``,
    ``get_suction``, real suction, step)."""
    cfg = jax_load_config("config_point", OVERRIDES)
    server = jax_rpc.Server(JaxReactiveTAMPServer(jax_load_config("config_point", OVERRIDES)), "127.0.0.1", 0)
    _serve(server)
    client = jax_rpc.Client().connect("127.0.0.1", server._sock.getsockname()[1])
    env = jax_make_env(cfg)
    step = jax.jit(env.step)
    state = env.init_state()
    for _ in range(150):
        state = step(state, jnp.zeros(env.nu), env.zero_ext())
    actions = []
    for i in range(n):
        state = jax_update_dyn_obs(env, state, i)
        action = client.run_tamp(np.asarray(env.dof_state_view(state)), np.asarray(env.root_state_view(state)))
        actions.append(action)
        cfg.suction_active = bool(client.get_suction())
        action = jnp.asarray(action)
        state = step(state, action, jax_real_suction_ext(cfg, env, state, action))
    client.close()
    server.close()
    return actions, state, env


class _Service:
    def run_tamp(self, a):
        return a * 2.0

    def get_suction(self):
        return 7

    def get_trajs(self):
        return None


def test_rpc_roundtrip_and_allow_list():
    """Twin of tests/test_utils.py:30-53 on the port's transport."""
    server = rpc.Server(_Service(), "127.0.0.1", 0)
    assert server.port > 0
    _serve(server)
    client = rpc.Client().connect("127.0.0.1", server.port)
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    assert np.array_equal(client.call("run_tamp", x), x * 2)
    assert client.get_suction() == 7
    assert client.get_trajs() is None
    with pytest.raises(RuntimeError, match="not allowed"):
        client.call("__init__")
    assert np.array_equal(client.run_tamp(torch.as_tensor(x)), x * 2)  # a tensor goes over the wire too
    client.close()
    server.close()


def test_method_error_reaches_the_client_and_stops_the_server():
    """A failing planner (a kernel that does not build or launch) is not
    carried past: the client raises with its error and the server thread
    ends with it."""

    class Failing:
        def run_tamp(self, dof, root):
            raise RuntimeError("CUDA error: the kernel did not launch")

    server = rpc.Server(Failing(), "127.0.0.1", 0)
    thread, raised = _serve(server)
    client = rpc.Client().connect("127.0.0.1", server.port)
    with pytest.raises(RuntimeError, match="did not launch"):
        client.run_tamp(np.zeros(4, np.float32), np.zeros((1, 13), np.float32))
    thread.join(timeout=10)
    assert not thread.is_alive() and "did not launch" in str(raised[0])
    server.close()


@pytest.mark.parametrize("x", [np.arange(12, dtype=np.float32).reshape(4, 3), np.float32(2.5), np.arange(3)])
def test_wire_format_is_the_jax_package_s(x):
    blob = data_transfer.array_to_bytes(x)
    assert blob == jax_data_transfer.array_to_bytes(x)
    assert blob == data_transfer.array_to_bytes(torch.as_tensor(x))
    t = data_transfer.bytes_to_tensor(jax_data_transfer.array_to_bytes(x), "cpu")
    assert t.device.type == "cpu" and np.array_equal(t.numpy(), np.asarray(x))


def test_server_and_sim_client_match_jax_package():
    """Six ticks of the port's planner server and sim client equal six ticks
    of the JAX package's: each tick's action, and the final dof and root
    states of the client's real env."""
    pact, pstate, penv, server = _port_run(rpc.Client, TICKS)
    jact, jstate, jenv = _jax_run(TICKS)
    assert len(pact) == len(jact) == TICKS
    np.testing.assert_allclose(np.stack(pact), np.stack(jact), atol=ATOL, rtol=0)
    np.testing.assert_allclose(penv.dof_state_view(pstate).numpy(), np.asarray(jenv.dof_state_view(jstate)),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(penv.root_state_view(pstate).numpy(), np.asarray(jenv.root_state_view(jstate)),
                               atol=ATOL, rtol=0)
    assert np.linalg.norm(penv.dof_state_view(pstate).numpy()[0::2]) > 0.05  # the robot moved
    trajs = server._obj.get_trajs()
    assert trajs.shape == (16, server._obj.tamp.motion_planner.T, 2) and np.isfinite(trajs).all()


def test_jax_client_drives_the_port_server():
    """The JAX package's ``rpc.Client`` against the port's ``rpc.Server``
    for three ticks: the same actions as the port's own client."""
    via_jax, _, _, _ = _port_run(jax_rpc.Client, 3)
    via_port, _, _, _ = _port_run(rpc.Client, 3)
    assert len(via_jax) == len(via_port) == 3
    for a, b in zip(via_jax, via_port):
        assert a.dtype == b.dtype and np.array_equal(a, b)
