"""Batched seed evaluation: B seeded runs advanced together, one chunk at a
time.

Port of ``m3p2i_aip_tpu/tamp/batch_loop.py`` (``BatchSimLoop``) without its
sharded mode.  The JAX package vmaps the chunk program over the seeds; here
every state carries an explicit leading seed axis B instead: the planner
state (``MPPI.init_state_batch``: each seed's Halton deltas, friction scales
and exploration generator), the real-env state and the per-seed
``TaskParams``.  Each rollout of a tick is ONE launch of a batched kernel
for the whole batch (``ops/rollout.py``, ``ops/panda_rollout.py``,
``ops/albert_rollout.py``: the seed on the grid's y axis) and each
multi-modal weight update one launch of the batched weights kernel (one
block per seed), so a batch of B costs about the host dispatch of one
serial tick per tick.

The host keeps B independent symbolic planners (their latches and stall
detectors are per-run state) and drains B logs at each chunk boundary from
ONE device-to-host transfer.  Seeds finish at different ticks: the chunk's
success gate takes a ``done0`` pre-latch per seed
(``ReactiveTAMP._run_chunk_impl`` / ``_run_chunk_panda_impl``), so a
finished seed's state is frozen mid-batch as if the host had stopped
dispatching it.

Parity: the logs equal those of B serial ``SimLoop.run_chunked`` runs at the
same chunk size, seed b drawing its exploration noise from a generator
seeded as the serial run with seed b seeds its own.
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from m3p2i_aip_tpu_torch.planners.motion_planner.mppi import TASK_IDS, TaskParams
from m3p2i_aip_tpu_torch.tamp.reactive_tamp import ReactiveTAMP, build_task_planner
from m3p2i_aip_tpu_torch.tamp.sim_loop import _STAGE_TASK, SimLoop, TickLog
from m3p2i_aip_tpu_torch.utils.tree import tree_map


class BatchSimLoop:
    """B independent seeded runs, one batched device chunk at a time.

    Parity: B sequential ``SimLoop`` runs of ``run_chunked(n, chunk)``:
    same seeds, same logs, B-fold fewer kernel launches.
    """

    def __init__(self, cfg, seeds: Sequence[int], shard: bool = False, device="cuda") -> None:
        if shard:
            raise NotImplementedError("a seed batch sharded over devices is not ported yet: see ROADMAP.md M11")
        self.cfg = cfg
        self.tamp = ReactiveTAMP(cfg, device=device)
        self.env = self.tamp.env
        self.device = self.tamp.device
        self.is_panda = self.env.env_type == "panda_env"
        self.reset(seeds)

    # ------------------------------------------------------------------ setup
    def reset(self, seeds: Optional[Sequence[int]] = None) -> None:
        """A fresh seeded batch without rebuilding the planner: seed b's
        Halton deltas, friction scales and exploration generator are those of
        a serial ``SimLoop.reset(seeds[b])``."""
        if seeds is not None:
            self.seeds = list(seeds)
        B = len(self.seeds)
        # per-seed host symbolic planners (their latches are mutable state);
        # the panda runs its AIF gate on the device and only needs the labels
        self.planners = [build_task_planner(self.cfg, self.env, self.tamp.objective) for _ in range(B)]
        self.mppi_state = self.tamp.motion_planner.init_state_batch(self.seeds)
        self.state = None  # set by warmup()
        self.logs: List[TickLog] = [TickLog() for _ in range(B)]
        self.views: List[Optional[dict]] = [None] * B  # frozen at success
        self.done = np.zeros(B, dtype=bool)
        if self.is_panda:
            self._stage = torch.zeros(B, dtype=torch.int32, device=self.device)
            self._zs = self.tamp.zup_zs0().expand(B, 4).clone()

    def warmup(self, n: int = 20) -> None:
        """Settle ONE scene and give every seed a copy: the warmup is
        zero-action and deterministic, so every seed starts from the same
        settled state, as ``SimLoop.warmup`` gives each serial run.  The
        copies are materialised (no stride-0 broadcast), so a later in-place
        write reaches one seed only."""
        single = SimLoop(self.cfg, tamp=self.tamp)
        single.warmup(n)
        B = len(self.seeds)
        self.state = tree_map(lambda x: x.expand((B,) + x.shape).clone(), single.state)
        self.views = [single._view] * B

    # --------------------------------------------------------------- internals
    def _stacked_task_params(self) -> TaskParams:
        """The seeds' symbolic decisions as ONE batched TaskParams (four
        host-to-device copies per chunk boundary, not 4 B)."""
        B = len(self.planners)
        ids = np.zeros(B, np.int32)
        goals = np.zeros((B, 7), np.float32)
        zups = np.zeros(B, np.float32)
        for b, tp in enumerate(self.planners):
            ids[b] = TASK_IDS[tp.task]
            g = np.asarray(tp.curr_goal, np.float32).reshape(-1)
            goals[b, : g.shape[0]] = g
            zups[b] = float(getattr(tp, "zup_gate", 0.0))
        return TaskParams(
            task_id=torch.as_tensor(ids, device=self.device),
            goal=torch.as_tensor(goals, device=self.device),
            gripper=torch.zeros(B, dtype=torch.int32, device=self.device),  # point / albert: "none"
            zup_gate=torch.as_tensor(zups, device=self.device),
        )

    def _drain_seed(self, b: int, i: int, views_b, n_ticks: int, dev_done: bool, per: float) -> None:
        """Host-side processing of one seed's slice of a fetched chunk: the
        per-seed twin of ``SimLoop._drain_chunk``."""
        tp = self.planners[b]
        log = self.logs[b]
        for k in range(n_ticks):
            view = self.env.view_unpack(views_b[k])
            self.views[b] = view
            if hasattr(tp, "observe"):
                tp.observe(view)  # tick-granular stall bookkeeping
            success = tp.check_task_success(view)
            log.steps += 1
            log.replan_s.append(per)
            log.sim_s.append(per)
            log.task.append(tp.task)
            if self.env.env_type == "point_env":
                log.robot_pos.append(view["robot_pos"])
                log.robot_vel.append(view["robot_vel"])
                log.box_pos.append(view["box_pos"])
                if view.get("dynobs_contact", 0.0) > 0.1:
                    log.collisions += 1
            if success:
                log.success_step = i + k
                self.done[b] = True
                return  # freeze the log and view at the success tick
        if dev_done and not self.done[b]:
            # the device latch fired but the host check disagreed at the
            # float boundary: trust the device (its state is frozen there)
            log.success_step = i + n_ticks - 1
            self.done[b] = True

    # ---------------------------------------------------------------- running
    def run_chunked(self, n_steps: int, chunk: int = 10) -> List[TickLog]:
        """Run every seed to success or ``n_steps``; returns the B TickLogs
        (``self.views`` holds each seed's success-tick observation)."""
        if self.state is None:
            self.warmup(0)
        if self.is_panda:
            return self._run_chunked_panda(n_steps, chunk)
        B = len(self.seeds)
        i = 0
        while i < n_steps and not self.done.all():
            t0 = time.perf_counter()
            for b in range(B):
                if not self.done[b]:
                    self.planners[b].update_plan(self.views[b])
            task = self._stacked_task_params()
            done0 = torch.as_tensor(self.done, device=self.device)
            ms, rs, views, n_ticks, dev_done = self.tamp._run_chunk_impl(
                self.mppi_state, self.state, task, i, chunk, gate=True, done0=done0
            )
            # ONE device-to-host transfer: every seed's views and latches
            nv = views.shape[-1]
            packed = torch.cat([views.reshape(-1), n_ticks.float(), dev_done.float()]).cpu().numpy()
            t1 = time.perf_counter()
            views = packed[: B * chunk * nv].reshape(B, chunk, nv)
            n_ticks = packed[B * chunk * nv : B * chunk * nv + B].astype(int)
            dev_done = packed[B * chunk * nv + B :] > 0.5
            self.mppi_state, self.state = ms, rs
            per = (t1 - t0) / max(int(n_ticks.sum()), 1)  # B seeds share one dispatch
            for b in range(B):
                if not self.done[b] and n_ticks[b] > 0:
                    self._drain_seed(b, i, views[b], int(n_ticks[b]), bool(dev_done[b]), per)
            i += chunk
        return self._finish_logs()

    def _run_chunked_panda(self, n_steps: int, chunk: int) -> List[TickLog]:
        """Batched panda chunks: the AIF stage gate, the replan and the step
        run on the device per seed.  A finished seed freezes through the
        ``done0`` pre-latch; its post-success zero-action ticks match the
        serial path's within-chunk freeze."""
        B = len(self.seeds)
        i = 0
        while i < n_steps and not self.done.all():
            t0 = time.perf_counter()
            done0 = torch.as_tensor(self.done, device=self.device)
            ms, rs, stage, zs, _, views, stages, dones = self.tamp._run_chunk_panda_impl(
                self.mppi_state, self.state, self._stage, self._zs, chunk, done0=done0
            )
            # ONE device-to-host transfer: views, stages and latches together
            nv = views.shape[-1]
            packed = torch.cat([views.reshape(-1), stages.float().reshape(-1), dones.float().reshape(-1)])
            packed = packed.cpu().numpy()
            t1 = time.perf_counter()
            n_view = B * chunk * nv
            views = packed[:n_view].reshape(B, chunk, nv)
            stages = packed[n_view : n_view + B * chunk].reshape(B, chunk).astype(int)
            dones = packed[n_view + B * chunk :].reshape(B, chunk) > 0.5
            self.mppi_state, self.state = ms, rs
            self._stage, self._zs = stage, zs
            live = max(int((~self.done).sum()), 1)
            per = (t1 - t0) / (chunk * live)
            for b in range(B):
                if self.done[b]:
                    continue
                log = self.logs[b]
                for k in range(chunk):
                    self.views[b] = self.env.view_unpack(views[b, k])
                    log.steps += 1
                    log.replan_s.append(per)
                    log.sim_s.append(per)
                    log.task.append(_STAGE_TASK[stages[b, k]])
                    if dones[b, k]:
                        log.success_step = i + k
                        self.done[b] = True
                        break  # freeze the log and view at the success tick
            i += chunk
        return self._finish_logs()

    def _finish_logs(self) -> List[TickLog]:
        for log in self.logs:
            if not log.sim_s:  # a seed done before its first drained tick
                log.sim_s.append(1e-9)
                log.replan_s.append(1e-9)
        return self.logs

    def settle(self, n: int = 150) -> None:
        """Batched twin of ``SimLoop.settle``: ``n`` zero-action steps for
        every seed at once (the panda with the place stage's open gripper,
        so the cube releases), then every seed's view refreshed from ONE
        transfer.  Call before logging panda rows: the reference logs the
        released, settled cube."""
        B = len(self.seeds)
        zero_u = torch.zeros(B, self.env.nu, dtype=torch.float32, device=self.device)
        if self.is_panda:
            zero_u[:, 7:9] = 1.5
        ext = self.env.zero_ext((B,))
        for _ in range(n):
            self.state = self.env.step(self.state, zero_u, ext)
        views = self.env.view_vec(self.state).cpu().numpy()
        self.views = [self.env.view_unpack(views[b]) for b in range(B)]
