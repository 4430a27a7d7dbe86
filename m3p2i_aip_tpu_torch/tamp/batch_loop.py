"""Batched seed evaluation: B seeded runs advanced together, one chunk at a
time, optionally with the seeds split over a device mesh.

Port of ``m3p2i_aip_tpu/tamp/batch_loop.py`` (``BatchSimLoop``).  The JAX
package vmaps the chunk program over the seeds; here every state carries an
explicit leading seed axis B instead: the planner state
(``MPPI.init_state_batch``: each seed's Halton deltas, friction scales and
exploration generator), the real-env state and the per-seed ``TaskParams``.
Each rollout of a tick is ONE launch of a batched kernel for the whole
batch (``ops/rollout.py``, ``ops/panda_rollout.py``,
``ops/albert_rollout.py``: the seed on the grid's y axis) and each
multi-modal weight update one launch of the batched weights kernel (one
block per seed), so a batch of B costs about the host dispatch of one
serial tick per tick.

The host keeps B independent symbolic planners (their latches and stall
detectors are per-run state) and drains B logs at each chunk boundary.
Seeds finish at different ticks: the chunk's success gate takes a ``done0``
pre-latch per seed (``ReactiveTAMP._run_chunk_impl`` /
``_run_chunk_panda_impl``), so a finished seed's state is frozen mid-batch
as if the host had stopped dispatching it.

``shard`` (``True`` for ``parallel.make_mesh()``, or a ``parallel`` Mesh)
lays the seed axis over the mesh's devices: shard i holds seeds
i B/n .. (i+1) B/n - 1 with their own ``ReactiveTAMP`` on its device (its
planner's generators are those seeds'), so each chunk launches the batched
kernels once per shard on that shard's seeds.  Every shard's chunk is
enqueued before any shard's views are fetched (one device-to-host transfer
per shard), so on several cards they overlap.  No cross-shard collective
is needed: a chunk has a fixed length and a per-seed done latch.  Unlike
the JAX package, whose sharded batch falls back to the XLA rollout (GSPMD
cannot partition a ``pallas_call``), every shard keeps the batched kernels.

Compiled ticks (``tamp/graph_tick.py``): a shard's B-seed tick is one CUDA
graph, captured at the first chunk with every seed's generator registered,
and the done pre-latch a buffer of its carry; ``reset`` with as many seeds
re-seeds the same generators, so the graph is kept.  The warm-up (one scene,
``SimLoop.warmup``) and each shard's settle at its seed count replay an env
step's graph (``graph_tick.env_steps``), as the JAX package jits them.

Parity: the logs equal those of B serial ``SimLoop.run_chunked`` runs at the
same chunk size, seed b drawing its exploration noise from a generator
seeded as the serial run with seed b seeds its own, however the seeds are
sharded.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from m3p2i_aip_tpu_torch.parallel.mesh import Mesh, make_mesh
from m3p2i_aip_tpu_torch.planners.motion_planner.mppi import TASK_IDS, MPPIState, TaskParams
from m3p2i_aip_tpu_torch.tamp.graph_tick import env_steps
from m3p2i_aip_tpu_torch.tamp.reactive_tamp import ReactiveTAMP, build_task_planner
from m3p2i_aip_tpu_torch.tamp.sim_loop import _STAGE_TASK, SimLoop, TickLog, _seconds
from m3p2i_aip_tpu_torch.utils import profiling
from m3p2i_aip_tpu_torch.utils.tree import tree_map


@dataclass
class _Shard:
    """One device's slice of the batch: seeds ``seeds`` (a slice of the
    batch), its planner and device states (panda: AIF stage and stall carry)."""

    tamp: ReactiveTAMP
    seeds: slice
    mppi_state: Optional[MPPIState] = None
    state: object = None
    stage: Optional[torch.Tensor] = None
    zs: Optional[torch.Tensor] = None


class BatchSimLoop:
    """B independent seeded runs, one batched device chunk at a time.

    Parity: B sequential ``SimLoop`` runs of ``run_chunked(n, chunk)``:
    same seeds, same logs, B-fold fewer kernel launches.
    """

    def __init__(self, cfg, seeds: Sequence[int], shard: Union[bool, Mesh] = False, device="cuda",
                 graphs: Optional[bool] = None) -> None:
        """``shard=True`` takes ``make_mesh()`` (every visible card) on a
        CUDA ``device`` and a one-device mesh of ``device`` otherwise; a Mesh
        is taken as it is, and its devices replace ``device``.  ``graphs``
        goes to each shard's ``ReactiveTAMP``: by default each shard's
        B/n-seed tick is compiled (one CUDA graph a shard), False eager."""
        self.cfg = cfg
        self.mesh = None
        if isinstance(shard, Mesh):
            self.mesh = shard
        elif shard:
            self.mesh = make_mesh(None if torch.device(device).type == "cuda" else [device])
        if self.mesh is not None:
            self._check_batch(len(seeds))
        devices = self.mesh.devices if self.mesh is not None else (device,)
        self._tamps = [ReactiveTAMP(cfg, device=d, graphs=graphs) for d in devices]
        self.tamp = self._tamps[0]
        self.env = self.tamp.env
        self.device = self.tamp.device
        self.is_panda = self.env.env_type == "panda_env"
        self.reset(seeds)

    def _check_batch(self, B: int) -> None:
        n = self.mesh.size
        if B % n != 0:
            raise ValueError(
                f"B={B} seeds must divide the {n}-device mesh; pad the seed list (pad rows are cheap: drop their logs)"
            )

    # ------------------------------------------------------------------ setup
    def reset(self, seeds: Optional[Sequence[int]] = None) -> None:
        """A fresh seeded batch without rebuilding the planners: seed b's
        Halton deltas, friction scales and exploration generator are those of
        a serial ``SimLoop.reset(seeds[b])``, whichever shard holds it."""
        if seeds is not None:
            self.seeds = list(seeds)
        B = len(self.seeds)
        if self.mesh is not None:
            self._check_batch(B)
        # per-seed host symbolic planners (their latches are mutable state);
        # the panda runs its AIF gate on the device and only needs the labels
        self.planners = [build_task_planner(self.cfg, self.env, self.tamp.objective) for _ in range(B)]
        per = B // len(self._tamps)
        self._shards = []
        for i, tamp in enumerate(self._tamps):
            part = slice(i * per, (i + 1) * per)
            shard = _Shard(tamp, part, mppi_state=tamp.motion_planner.init_state_batch(self.seeds[part]))
            if self.is_panda:
                shard.stage = torch.zeros(per, dtype=torch.int32, device=tamp.device)
                shard.zs = tamp.zup_zs0().expand(per, 4).clone()
            self._shards.append(shard)
        self.logs: List[TickLog] = [TickLog() for _ in range(B)]
        self.views: List[Optional[dict]] = [None] * B  # frozen at success
        self.done = np.zeros(B, dtype=bool)

    def warmup(self, n: int = 20) -> None:
        """Settle ONE scene and give every seed a copy on its shard's device:
        the warmup is zero-action and deterministic, so every seed starts
        from the same settled state, as ``SimLoop.warmup`` gives each serial
        run.  The copies are materialised (no stride-0 broadcast), so a later
        in-place write reaches one seed only."""
        single = SimLoop(self.cfg, tamp=self.tamp)
        single.warmup(n)
        for shard in self._shards:
            per = shard.seeds.stop - shard.seeds.start
            shard.state = tree_map(lambda x: x.to(shard.tamp.device).expand((per,) + x.shape).clone(), single.state)
        self.views = [single._view] * len(self.seeds)

    # ------------------------------------------------------ one shard's states
    def _one_shard(self) -> _Shard:
        if len(self._shards) != 1:
            raise AttributeError("a sharded batch keeps its states per shard (_shards)")
        return self._shards[0]

    def _shard_field(name: str):  # noqa: N805 (a class-body helper)
        """The batch's ``name`` state (planner, env, panda stage or stall
        carry) for an unsharded batch: its one shard's."""
        return property(lambda self: getattr(self._one_shard(), name),
                        lambda self, value: setattr(self._one_shard(), name, value))

    mppi_state = _shard_field("mppi_state")
    state = _shard_field("state")
    _stage = _shard_field("stage")
    _zs = _shard_field("zs")
    del _shard_field

    # --------------------------------------------------------------- internals
    def _stacked_task_params(self, seeds: slice = slice(None), device=None) -> TaskParams:
        """The symbolic decisions of the seeds ``seeds`` as ONE batched
        TaskParams on ``device`` (the batch's by default): four
        host-to-device copies per shard and chunk boundary, not four a seed."""
        planners = self.planners[seeds]
        device = self.device if device is None else device
        B = len(planners)
        ids = np.zeros(B, np.int32)
        goals = np.zeros((B, 7), np.float32)
        zups = np.zeros(B, np.float32)
        for b, tp in enumerate(planners):
            ids[b] = TASK_IDS[tp.task]
            g = np.asarray(tp.curr_goal, np.float32).reshape(-1)
            goals[b, : g.shape[0]] = g
            zups[b] = float(getattr(tp, "zup_gate", 0.0))
        return TaskParams(
            task_id=torch.as_tensor(ids, device=device),
            goal=torch.as_tensor(goals, device=device),
            gripper=torch.zeros(B, dtype=torch.int32, device=device),  # point / albert: "none"
            zup_gate=torch.as_tensor(zups, device=device),
        )

    def _drain_seed(self, b: int, i: int, views_b, n_ticks: int, dev_done: bool, per: float) -> None:
        """Host-side processing of one seed's slice of a fetched chunk: the
        per-seed twin of ``SimLoop._drain_chunk`` (inside its ``loop.drain``
        span)."""
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
    @staticmethod
    def _fetch(*tensors) -> np.ndarray:
        """One device-to-host transfer of a shard's chunk outputs, flat."""
        return torch.cat([t.float().reshape(-1) for t in tensors]).cpu().numpy()

    def run_chunked(self, n_steps: int, chunk: int = 10) -> List[TickLog]:
        """Run every seed to success or ``n_steps``; returns the B TickLogs
        (``self.views`` holds each seed's success-tick observation)."""
        if self._shards[0].state is None:
            self.warmup(0)
        if self.is_panda:
            return self._run_chunked_panda(n_steps, chunk)
        i = 0
        while i < n_steps and not self.done.all():
            with profiling.span("tamp.plan", i):  # the host planners, then each shard's TaskParams
                for b, tp in enumerate(self.planners):
                    if not self.done[b]:
                        tp.update_plan(self.views[b])
                inputs = [
                    (self._stacked_task_params(sh.seeds, sh.tamp.device),
                     torch.as_tensor(self.done[sh.seeds], device=sh.tamp.device))
                    for sh in self._shards
                ]
            t0 = profiling.last_span("tamp.plan")[0]
            # every shard's chunk enqueued before any shard's views are fetched
            outs = [
                sh.tamp._run_chunk_impl(sh.mppi_state, sh.state, task, i, chunk, gate=True, done0=done0)
                for sh, (task, done0) in zip(self._shards, inputs)
            ]
            with profiling.span("loop.fetch", i):
                packed = [self._fetch(views, n_ticks, dev_done) for _, _, views, n_ticks, dev_done in outs]
            seeds = []
            for sh, (ms, rs, views, _, _), flat in zip(self._shards, outs, packed):
                sh.mppi_state, sh.state = ms, rs
                per, nv = sh.seeds.stop - sh.seeds.start, views.shape[-1]
                n_view = per * chunk * nv
                views_h = flat[:n_view].reshape(per, chunk, nv)
                n_ticks = flat[n_view : n_view + per].astype(int)
                dev_done = flat[n_view + per :] > 0.5
                for j, b in enumerate(range(sh.seeds.start, sh.seeds.stop)):
                    seeds.append((b, views_h[j], int(n_ticks[j]), bool(dev_done[j])))
            # the seeds share one dispatch
            per_tick = _seconds(t0, "loop.fetch") / max(sum(n for _, _, n, _ in seeds), 1)
            with profiling.span("loop.drain", i):
                for b, views_b, n, dev_done in seeds:
                    if not self.done[b] and n > 0:
                        self._drain_seed(b, i, views_b, n, dev_done, per_tick)
            i += chunk
        return self._finish_logs()

    def _run_chunked_panda(self, n_steps: int, chunk: int) -> List[TickLog]:
        """Batched panda chunks: the AIF stage gate, the replan and the step
        run on the device per seed.  A finished seed freezes through the
        ``done0`` pre-latch; its post-success zero-action ticks match the
        serial path's within-chunk freeze."""
        i = 0
        while i < n_steps and not self.done.all():
            done0 = [torch.as_tensor(self.done[sh.seeds], device=sh.tamp.device) for sh in self._shards]
            # every shard's chunk enqueued before any shard's views are fetched
            outs, t0 = [], None
            for sh, d in zip(self._shards, done0):
                outs.append(sh.tamp._run_chunk_panda_impl(sh.mppi_state, sh.state, sh.stage, sh.zs, chunk, done0=d))
                t0 = t0 or profiling.last_span("tamp.chunk")[0]  # the first shard's chunk began the dispatch
            with profiling.span("loop.fetch", i):
                packed = [self._fetch(views, stages, dones) for *_, views, stages, dones in outs]
            live = max(int((~self.done).sum()), 1)
            per_tick = _seconds(t0, "loop.fetch") / (chunk * live)
            for sh, (ms, rs, stage, zs, _, views, _, _), flat in zip(self._shards, outs, packed):
                sh.mppi_state, sh.state, sh.stage, sh.zs = ms, rs, stage, zs
                per, nv = sh.seeds.stop - sh.seeds.start, views.shape[-1]
                n_view = per * chunk * nv
                views_h = flat[:n_view].reshape(per, chunk, nv)
                stages = flat[n_view : n_view + per * chunk].reshape(per, chunk).astype(int)
                dones = flat[n_view + per * chunk :].reshape(per, chunk) > 0.5
                for j, b in enumerate(range(sh.seeds.start, sh.seeds.stop)):
                    if self.done[b]:
                        continue
                    log = self.logs[b]
                    for k in range(chunk):
                        self.views[b] = self.env.view_unpack(views_h[j, k])
                        log.steps += 1
                        log.replan_s.append(per_tick)
                        log.sim_s.append(per_tick)
                        log.task.append(_STAGE_TASK[stages[j, k]])
                        if dones[j, k]:
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
        transfer per shard.  Call before logging panda rows: the reference
        logs the released, settled cube.  Each shard's ``n`` steps are ``n``
        replays of its compiled step at its seed count (eager with
        ``graphs=False``)."""
        for sh in self._shards:
            env, per = sh.tamp.env, sh.seeds.stop - sh.seeds.start
            zero_u = torch.zeros(per, env.nu, dtype=torch.float32, device=sh.tamp.device)
            if self.is_panda:
                zero_u[:, 7:9] = 1.5
            sh.state = env_steps(sh.tamp.ticks, env, sh.state, zero_u, env.zero_ext((per,)), n)
        views = np.concatenate([sh.tamp.env.view_vec(sh.state).cpu().numpy() for sh in self._shards])
        self.views = [self.env.view_unpack(v) for v in views]
