"""Real-system loop: the single "actuated" env driven by the TAMP planner.

Port of ``m3p2i_aip_tpu/tamp/sim_loop.py`` (point family, panda and albert,
per tick, in serial chunks and with one chunk in flight).  The same engine
runs the rollouts and the real env, in one process.  ``run`` ticks one
replan+step at a time, with one device->host transfer a tick (the view) and
the host task planner on every tick (the panda's active-inference planner
too), optionally paced to real time and open to live keyboard shoves;
``run_sim`` is the one-process replacement of the reference's two
terminals.  The chunked loop syncs with the device once per chunk: one
transfer brings back the chunk's per-tick views with the latch scalars;
pipelined, that transfer is a non-blocking copy the host waits on only
after it has enqueued the next chunk.

Every tick, per tick or in a chunk, runs compiled by default: one replay of
a CUDA graph on the card (``tamp/graph_tick.py``); ``graphs=False`` runs the
eager tick.  So do the warm-up and the settle: ``n`` replays of one env
step's graph (``graph_tick.env_steps``, the JAX package's jitted ``env.step``
and settle scan).  The loop's ``state`` and ``tamp.mppi_state`` are host-owned
copies of the graphs' carry, copied in before and out after each chunk or
tick, so a checkpoint, a shove or a new plan between chunks reaches the next
replay and nothing the host holds is overwritten by one.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import List, Optional

import torch

from m3p2i_aip_tpu_torch.envs import Env, command_world_vel
from m3p2i_aip_tpu_torch.models.panda_env import DYN_NAMES
from m3p2i_aip_tpu_torch.tamp.graph_tick import env_steps
from m3p2i_aip_tpu_torch.tamp.reactive_tamp import ReactiveTAMP
from m3p2i_aip_tpu_torch.utils import profiling, skill_utils

_STAGE_TASK = ("reach", "pick", "place")


def real_suction_ext(cfg, env: Env, state, action):
    """The real env's suction forces (threshold 1.5, not the rollouts' 1.8:
    a reference quirk), or zero forces (sim_loop.py:22): applied only on a
    point-family scene with a box, for a pull-family task with suction
    granted, the robot within 0.6 m of the box and the commanded velocity
    pointing away from it.  Host-side: it reads the state back."""
    ext = env.zero_ext()
    if env.env_type != "point_env" or "box" not in env.params.actor_names:
        return ext
    box_pos = state.dyn_pos[env.box_slot]
    robot_pos = state.q[:2]  # the 3-dof bases carry their yaw in q[2]
    cmd_vel = command_world_vel(env.params, state.q, action)
    if not skill_utils.check_suction_condition(cfg.task, bool(cfg.suction_active), robot_pos, box_pos, cmd_vel):
        return ext
    f_box, f_robot = skill_utils.calculate_suction(box_pos, robot_pos, float(cfg.kp_suction), threshold=1.5)
    dyn = ext.dyn.clone()
    dyn[env.box_slot] = f_box
    return dataclasses.replace(ext, robot=f_robot, dyn=dyn)


def real_suction_ext_device(cfg, env: Env, state, action, suction: torch.Tensor):
    """:func:`real_suction_ext` as tensor work, for a compiled step: the
    planner's grant ``suction`` is a device bool (an input of the step,
    never a value frozen at capture); the task (``cfg.task``) and the scene
    are static.  The forces are :func:`real_suction_ext`'s bit for bit."""
    ext = env.zero_ext()
    if env.env_type != "point_env" or "box" not in env.params.actor_names or cfg.task not in ("pull", "push_pull"):
        return ext
    box_pos = state.dyn_pos[env.box_slot]
    robot_pos = state.q[:2]
    dir_rb = robot_pos - box_pos
    cmd_vel = command_world_vel(env.params, state.q, action)
    on = suction & (torch.sum(cmd_vel[..., :2] * dir_rb) > 0) & (torch.linalg.vector_norm(dir_rb) < 0.6)
    f_box, f_robot = skill_utils.calculate_suction(box_pos, robot_pos, float(cfg.kp_suction), threshold=1.5)
    dyn = torch.stack([torch.where(on, f_box, 0.0) if d == env.box_slot else ext.dyn[d] for d in range(ext.dyn.shape[0])])
    return dataclasses.replace(ext, robot=torch.where(on, f_robot, 0.0), dyn=dyn)


def _seconds(t0_ns: int, until: str) -> float:
    """Seconds from ``t0_ns`` to the end of the newest closed span
    ``until``: a log row's time, read off the spans."""
    return (profiling.last_span(until)[1] - t0_ns) / 1e9


def _pack_chunk(views: torch.Tensor, n_ticks, dev_done) -> torch.Tensor:
    """A chunk's views flattened, followed by its latch scalars (n_ticks,
    done) when the gate is on: what one device->host copy brings back."""
    if not torch.is_tensor(n_ticks):  # gates off: the chunk length and "not done" are known on the host
        return views.reshape(-1)
    return torch.cat([views.reshape(-1), torch.stack([n_ticks.float(), dev_done.float()])])


def _unpack_chunk(packed, chunk: int, n_ticks) -> tuple:
    """(views [chunk, nv], n_ticks, done) of a packed chunk on the host;
    ``n_ticks`` is the chunk's own return (a tensor when gated)."""
    if not torch.is_tensor(n_ticks):
        return packed.reshape(chunk, -1), n_ticks, False
    return packed[:-2].reshape(chunk, -1), int(packed[-2]), bool(packed[-1])


@dataclass
class TickLog:
    """Per-run statistics in the reference's log spirit (plot_point.py:26-34)."""

    robot_pos: List = field(default_factory=list)
    robot_vel: List = field(default_factory=list)
    box_pos: List = field(default_factory=list)
    task: List = field(default_factory=list)
    replan_s: List = field(default_factory=list)
    sim_s: List = field(default_factory=list)
    collisions: int = 0
    steps: int = 0
    success_step: Optional[int] = None


class SimLoop:
    """Owns the real env state and the TAMP planner; steps them in lock-step."""

    def __init__(self, cfg, tamp: Optional[ReactiveTAMP] = None, device="cuda", graphs: Optional[bool] = None) -> None:
        """``graphs`` goes to the ``ReactiveTAMP`` made here (None: compiled
        ticks, False: eager; see ``graph_tick``)."""
        self.cfg = cfg
        self.tamp = tamp if tamp is not None else ReactiveTAMP(cfg, device=device, graphs=graphs)
        self.env = self.tamp.env
        self.state = self.env.init_state()
        self.log = TickLog()
        self._view: Optional[dict] = None  # host copy of the current observation
        self._panda_stage = 0  # the panda AIF stage and stall carry persist
        self._panda_zs = None  # across run_chunked calls (reactive scenarios)

    def reset(self, seed_val: Optional[int] = None) -> None:
        """Reset for a fresh seeded run without rebuilding the planner: the
        generator is re-seeded in place and the fresh states are copied into
        the compiled ticks' buffers at the next tick, so nothing re-captures."""
        if seed_val is not None:
            self.cfg.mppi.seed_val = seed_val
            self.tamp.motion_planner.reseed(seed_val)
        self.tamp.mppi_state = self.tamp.motion_planner.init_state()
        self.tamp.task_planner.reset_plan()
        self.tamp.task_success = False
        self.state = self.env.init_state()
        self.log = TickLog()
        self._view = None
        self._panda_stage = 0
        self._panda_zs = None

    def warmup(self, n: int = 150) -> None:
        """Settle the scene with zero actions before planning (sim.py:32-33):
        ``n`` replays of the compiled step (eager steps with ``graphs=False``)."""
        zero_u = torch.zeros(self.env.nu, dtype=torch.float32, device=self.env.device)
        self.state = env_steps(self.tamp.ticks, self.env, self.state, zero_u, self.env.zero_ext(), n)
        self._view = self.env.view(self.state)

    def _record(self, i: int, view: dict, replan_s: float, sim_s: float) -> bool:
        self.log.steps += 1
        self.log.replan_s.append(replan_s)
        self.log.sim_s.append(sim_s)
        self.log.task.append(self.tamp.task_planner.task)
        if self.env.env_type == "point_env":
            self.log.robot_pos.append(view["robot_pos"])
            self.log.robot_vel.append(view["robot_vel"])
            self.log.box_pos.append(view["box_pos"])
            if view.get("dynobs_contact", 0.0) > 0.1:
                self.log.collisions += 1
        if self.tamp.task_success and self.log.success_step is None:
            self.log.success_step = i
        return bool(self.tamp.task_success)

    def tick(self, i: int) -> bool:
        """One control tick with one device->host transfer (the view): the
        ``tamp.plan`` and ``tamp.tick`` spans, then ``loop.fetch`` and
        ``loop.observe``, all with the request ``i``; the log's replan
        seconds run from the plan's start to the fetch's end."""
        if self._view is None:
            self._view = self.env.view(self.state)
        task_params = self.tamp.tamp_interface_view(self._view, i)
        if self.tamp.task_success:
            return self._record(i, self._view, 0.0, 0.0)
        _, self.tamp.mppi_state, self.state, vvec = self.tamp.tick_fused(
            self.tamp.mppi_state, self.state, task_params, i
        )
        with profiling.span("loop.fetch", i):
            vvec = vvec.cpu().numpy()
        replan_s = _seconds(profiling.last_span("tamp.plan")[0], "loop.fetch")
        with profiling.span("loop.observe", i):
            self._view = self.env.view_unpack(vvec)
            # gate on the fresh post-step view, so success is logged at the
            # crossing tick itself (the chunked latch uses the same convention)
            self.tamp.task_success = self.tamp.task_planner.check_task_success(self._view)
            return self._record(i, self._view, replan_s, replan_s)

    def run(self, n_steps: int = 1000, realtime: bool = False, verbose: bool = False, interactive: bool = False):
        """Tick until success or ``n_steps`` (sim_loop.py:154; sim.py:36-58).

        ``realtime`` paces each tick to the control period ``cfg.sim.dt``
        (``verbose`` prints the achieved rate).  ``interactive`` polls the
        terminal each tick so a human can disturb the scene while the
        planner runs: i/j/k/l shove the box (point family) or cubeA (panda),
        v toggles a live ASCII view with the planned top trajectories, q
        quits.  Off a tty it is a plain run.
        """
        from m3p2i_aip_tpu_torch.utils.teleop import SHOVE_KEYS, KeyboardTeleop

        if self.env.env_type == "panda_env":
            shove_target = "cubeA"
        else:  # the albert scene may ship no box
            shove_target = "box" if "box" in self.env.params.actor_names else None
        show_view = False
        t = time.time()
        with KeyboardTeleop(enabled=interactive) as keys:
            if interactive and keys.active:
                shove = f"i/j/k/l shove the {shove_target}, " if shove_target is not None else ""
                print(f"interactive: {shove}v toggles the live view, q quits")
            for i in range(n_steps):
                if interactive:
                    for key in keys.poll():
                        if key == "q":
                            return self.log
                        if key == "v":
                            show_view = not show_view
                        elif key in SHOVE_KEYS and shove_target is not None:
                            self.perturb_body(shove_target, list(SHOVE_KEYS[key]) + [0.0])
                done = self.tick(i)
                if interactive and show_view and self.env.env_type == "point_env":
                    from m3p2i_aip_tpu_torch.utils.render import render_point_env

                    trajs = self.tamp.get_trajs()
                    trajs = None if trajs is None else trajs.cpu().numpy()
                    print("\x1b[2J\x1b[H" + render_point_env(self.env, self.state, trajs=trajs))
                if realtime:
                    t = skill_utils.time_tracking(t, self.cfg.sim.dt, verbose=verbose)
                if done:
                    break
        return self.log

    def run_chunked(self, n_steps: int, chunk: int = 10, pipelined: bool = False) -> TickLog:
        """``chunk`` full replan+step ticks per device round trip.

        The symbolic plan is refreshed between chunks, so a task switch waits
        at most ``chunk - 1`` ticks; the device latch stops state at the
        success tick inside a chunk.  ``pipelined`` keeps one chunk in flight
        (:meth:`_run_chunked_pipelined`); the panda takes its own chunk loop
        either way, its plan being decided on the device every tick.
        """
        if self._view is None:
            self.warmup(0)
        if self.env.env_type == "panda_env":
            return self._run_chunked_panda(n_steps, chunk)
        if pipelined:
            return self._run_chunked_pipelined(n_steps, chunk)
        i = 0
        while i < n_steps:
            task_params = self.tamp.tamp_interface_view(self._view, i)
            if self.tamp.task_success:
                self._record(i, self._view, 0.0, 0.0)
                break
            ms, rs, views, n_ticks, dev_done = self.tamp.run_chunk(
                self.tamp.mppi_state, self.state, task_params, i, chunk
            )
            # ONE device->host transfer: the views and the latch scalars together
            with profiling.span("loop.fetch", i):
                packed = _pack_chunk(views, n_ticks, dev_done).cpu().numpy()
            self.tamp.mppi_state, self.state = ms, rs
            done_at = self._drain_chunk(i, *_unpack_chunk(packed, chunk, n_ticks),
                                        _seconds(profiling.last_span("tamp.plan")[0], "loop.fetch"))
            if done_at is not None:
                break
            i += chunk
        return self.log

    def _enqueue_chunk(self, i: int, chunk: int, host: Optional[torch.Tensor]) -> tuple:
        """Plan chunk ``i`` from the newest host view and enqueue it with no
        host sync: its carry becomes the loop's state, and its packed views
        start a copy into the host buffer ``host`` (pinned; made here when
        None or of another size), after which a CUDA event is recorded.  On
        the CPU the copy is a plain one and there is no event.  Returns
        (i, host buffer, event, chunk's n_ticks, the end of its ``tamp.chunk``
        span in ns)."""
        task_params = self.tamp.tamp_interface_view(self._view, i)
        ms, rs, views, n_ticks, dev_done = self.tamp.run_chunk(self.tamp.mppi_state, self.state, task_params, i, chunk)
        self.tamp.mppi_state, self.state = ms, rs  # chunk i + chunk chains on this carry
        packed = _pack_chunk(views, n_ticks, dev_done)
        on_card = packed.device.type == "cuda"
        if host is None or host.numel() != packed.numel():
            host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=on_card)
        host.copy_(packed, non_blocking=on_card)
        event = None
        if on_card:
            event = torch.cuda.Event()
            event.record()
        return i, host, event, n_ticks, profiling.last_span("tamp.chunk")[1]

    def _run_chunked_pipelined(self, n_steps: int, chunk: int) -> TickLog:
        """Chunks with one in flight (sim_loop.py:344): chunk N+1 is enqueued
        from chunk N's device carry before N's views are fetched and
        drained, so the host's drain and planning overlap the device's work.
        The plan then reacts one chunk later (at most ``2 * chunk - 1``
        ticks); a chunk enqueued past success is discarded unfetched, its
        carry committed, as in the JAX package.  Two pinned host buffers
        alternate, so N+1's copy never lands in the buffer N is read from.
        A chunk's log seconds run from its ``tamp.chunk`` span's end to its
        ``loop.fetch`` span's end."""
        buffers: List[Optional[torch.Tensor]] = [None, None]
        pending = None
        i, slot = 0, 0
        while True:
            nxt = None
            if i < n_steps and not self.tamp.task_success:
                nxt = self._enqueue_chunk(i, chunk, buffers[slot])
                buffers[slot] = nxt[1]
                slot ^= 1
                i += chunk
            if pending is not None:
                i0, host, event, n_ticks, t0 = pending
                with profiling.span("loop.fetch", i0):
                    if event is not None:
                        event.synchronize()
                    packed = host.numpy().copy()  # the log keeps rows past the buffer's reuse
                elapsed = _seconds(t0, "loop.fetch")
                if self._drain_chunk(i0, *_unpack_chunk(packed, chunk, n_ticks), elapsed) is not None:
                    break
            if nxt is None:
                if pending is None:
                    break
                pending = None
            else:
                pending = nxt
        return self.log

    def _drain_chunk(self, i: int, views, n_ticks: int, dev_done: bool, elapsed: float) -> Optional[int]:
        """Host-side processing of one fetched chunk (a ``loop.drain``
        span): unpack views, run the host success check per tick, record
        log rows.  Returns the success tick index, or None."""
        with profiling.span("loop.drain", i):
            per = elapsed / max(n_ticks, 1)
            done_at = None
            tp = self.tamp.task_planner
            for k in range(n_ticks):
                self._view = self.env.view_unpack(views[k])
                if hasattr(tp, "observe"):
                    tp.observe(self._view)  # tick-granular stall bookkeeping
                self.tamp.task_success = tp.check_task_success(self._view)
                self._record(i + k, self._view, per, 0.0)
                if self.tamp.task_success:
                    done_at = i + k
                    break
            if done_at is None and dev_done:
                # the device latch fired but the host check disagreed at the
                # float boundary: trust the device (its state is frozen there)
                self.tamp.task_success = True
                done_at = i + n_ticks - 1
                self.log.success_step = done_at
            return done_at

    def _run_chunked_panda(self, n_steps: int, chunk: int) -> TickLog:
        """Chunked panda execution (sim_loop.py:386): the AIF gate runs on
        the device inside the chunk, so stage switches are exact per tick.
        The stage and the stall carry persist on the loop, so a run
        interrupted to perturb the scene resumes its plan.  Every chunk runs
        its full length (the done latch zeroes the action); the log stops at
        the success tick."""
        stage = self._panda_stage
        zs = self.tamp.zup_zs0() if self._panda_zs is None else self._panda_zs
        i = 0
        while i < n_steps:
            ms, rs, stage, zs, _, views, stages, dones = self.tamp.run_chunk_panda(
                self.tamp.mppi_state, self.state, stage, zs, chunk
            )
            # ONE device->host transfer: views, stages and latches together
            with profiling.span("loop.fetch", i):
                packed = torch.cat([views.reshape(-1), stages.float(), dones.float()]).cpu().numpy()
            nv = views.shape[-1]
            views = packed[: chunk * nv].reshape(chunk, nv)
            stages = packed[chunk * nv : chunk * (nv + 1)].astype(int)
            dones = packed[chunk * (nv + 1) :] > 0.5
            self.tamp.mppi_state, self.state = ms, rs
            self._panda_stage, self._panda_zs = stage, zs  # device tensors
            per = _seconds(profiling.last_span("tamp.chunk")[0], "loop.fetch") / chunk
            done_at = None
            for k in range(chunk):
                self._view = self.env.view_unpack(views[k])
                self.tamp.task_planner.task = _STAGE_TASK[stages[k]]  # keep the log's task in step
                self._record(i + k, self._view, per, 0.0)
                if dones[k]:
                    done_at = i + k
                    break  # stop at the success tick so _view and the log match it
            if done_at is not None:
                self.tamp.task_success = True
                self.log.success_step = done_at
                break
            i += chunk
        return self.log

    def settle(self, n: int = 100) -> None:
        """Free-run ``n`` zero-action env steps and refresh the view
        (sim_loop.py:215): the reference's logged rows come from a released,
        settled cube.  The panda keeps the place stage's OPEN gripper command,
        or the fingers never travel and the cube never releases.  Compiled as
        :meth:`warmup`."""
        zero_u = torch.zeros(self.env.nu, dtype=torch.float32, device=self.env.device)
        if self.env.env_type == "panda_env":
            zero_u[7:9] = 1.5
        self.state = env_steps(self.tamp.ticks, self.env, self.state, zero_u, self.env.zero_ext(), n)
        self._view = self.env.view(self.state)

    def perturb_body(self, name: str, dpos) -> None:
        """Displace a named dynamic body of the real env (sim_loop.py:241):
        the scripted form of the reference's interactive cube shove, for
        the reactive scenarios."""
        if self.env.env_type == "panda_env":
            pos = self.state.body_pos.clone()
            pos[DYN_NAMES.index(name)] += torch.as_tensor(dpos, dtype=torch.float32, device=pos.device)
            self.state = dataclasses.replace(self.state, body_pos=pos)
        elif self.env.env_type == "albert_env":  # the scene's one dynamic body: its box
            dxy = torch.as_tensor(dpos[:2], dtype=torch.float32, device=self.state.box_pos.device)
            self.state = dataclasses.replace(self.state, box_pos=self.state.box_pos + dxy)
        else:
            slot = self.env.params.dyn_actor_idx.index(list(self.env.params.actor_names).index(name))
            pos = self.state.dyn_pos.clone()
            pos[slot] += torch.as_tensor(dpos[:2], dtype=torch.float32, device=pos.device)
            self.state = dataclasses.replace(self.state, dyn_pos=pos)
        self._view = self.env.view(self.state)


def run_sim(cfg, n_steps: Optional[int] = None, warmup: int = 150, device="cuda", graphs: Optional[bool] = None,
            **kwargs) -> TickLog:
    """Build everything from ``cfg`` on ``device``, settle the scene and
    tick until success or ``n_steps`` (``cfg.n_steps`` if None): the
    one-process reactive TAMP (sim_loop.py:435).  ``graphs`` as
    :class:`SimLoop`'s; ``kwargs`` go to :meth:`SimLoop.run`.  Returns the
    TickLog."""
    loop = SimLoop(cfg, device=device, graphs=graphs)
    loop.warmup(warmup)
    return loop.run(n_steps or cfg.n_steps, **kwargs)
