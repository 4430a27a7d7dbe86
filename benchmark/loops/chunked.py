"""``chunked``: one robot, chunks of compiled ticks.

The point family runs through the program's own loop,
``SimLoop.run_chunked(pipelined=True)`` (one chunk in flight), its public
chunk entry ``ReactiveTAMP.run_chunk`` wrapped to mark the chunk clock and
keep checkpoints.  The panda runs its public chunk entry
``ReactiveTAMP.run_chunk_panda`` chained on device carries, the next chunk
enqueued before the last one's views are fetched: the program's own panda
loop (``SimLoop._run_chunked_panda``) fetches each chunk before it
enqueues the next and stops at success, so it has no gates-off pipelined
form to drive (``PERF.md``, Open questions).
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.loops import Loop, cloned, port_config
from benchmark.yardstick.rates import ChunkClock

_STAGE_TASK = ("reach", "pick", "place")


class Chunked(Loop):
    def _build(self) -> None:
        from m3p2i_aip_tpu_torch.tamp.sim_loop import SimLoop

        self.loop = loop = SimLoop(port_config(self.cfg_file), device=self.device)
        self.tamp = loop.tamp
        loop.tamp.task_planner.check_task_success = lambda view: False
        loop.tamp.device_gate = False
        loop.warmup(int(self.cfg_file["settle_steps"]))
        self.settled = loop.state
        self.panda = loop.env.env_type == "panda_env"
        if self.panda:
            self.stage0 = torch.zeros((), dtype=torch.int32, device=self.device)
            self.zs0 = loop.tamp.zup_zs0()
            self._host = [None, None]
        else:
            self._wrap_run_chunk()

    def _wrap_run_chunk(self) -> None:
        tamp = self.tamp
        run_chunk = tamp.run_chunk

        def recorded(mppi_state, real_state, task, i0, length):
            ck = None
            if self.recording:
                self.clock.mark()
                if i0 in self.check_ticks:
                    ck = self._checkpoint(i0, self._seed_val, task=task, mppi_state=mppi_state,
                                          real_state=real_state,
                                          generator=tamp.motion_planner.generator.get_state())
            out = run_chunk(mppi_state, real_state, task, i0, length)
            if ck is not None:
                ck["_views"] = (out[2], 0)
                self._pending.append(ck)
            if self.recording and i0 + length >= self.E:
                self.clock.mark()  # the episode's last chunk
            return out

        tamp.run_chunk = recorded

    def _episode(self, deadline=None) -> None:
        self.episode += 1
        self._seed_val = self._draw()
        self.loop.reset(self._seed_val)
        self.loop.state = cloned(self.settled)
        self.clock = ChunkClock(self.device)
        if self.panda:
            self._panda_chunks(self.E, self.C, record=self.recording)
        else:
            self.loop.run_chunked(self.E, chunk=self.C, pipelined=True)
        self._fetch_pending()
        if self.recording:
            self.chunk_s += self.clock.periods_s()
            self.ticks += self.E

    # -- the panda: run_chunk_panda chained, one chunk in flight
    def _panda_chunks(self, n: int, chunk: int, record: bool) -> None:
        loop, tamp = self.loop, self.loop.tamp
        ms, rs, stage, zs = tamp.mppi_state, loop.state, self.stage0, self.zs0.clone()
        on_card = self.device.type == "cuda"
        pending = None
        for slot, i in enumerate(range(0, n, chunk)):
            ck = None
            if record:
                self.clock.mark()
                if i in self.check_ticks:
                    ck = self._checkpoint(i, self._seed_val, mppi_state=ms, real_state=rs, stage=stage, zs=zs,
                                          done=False, generator=tamp.motion_planner.generator.get_state())
            ms, rs, stage, zs, _, views, stages, dones = tamp.run_chunk_panda(ms, rs, stage, zs, chunk)
            packed = torch.cat([views.reshape(-1), stages.float(), dones.float()])
            host = self._host[slot % 2]
            if host is None or host.numel() != packed.numel():
                host = self._host[slot % 2] = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=on_card)
            host.copy_(packed, non_blocking=on_card)
            event = None
            if on_card:
                event = torch.cuda.Event()
                event.record()
            if pending is not None:
                self._panda_drain(*pending)
            pending = (host, event, chunk, views.shape[-1], ck)
        if record:
            self.clock.mark()
        self._panda_drain(*pending)
        tamp.mppi_state, loop.state = ms, rs

    def _panda_drain(self, host, event, chunk, nv, ck) -> None:
        """The host's side of a fetched panda chunk, as the program's panda
        loop has it: the views unpacked, the stage labels kept."""
        if event is not None:
            event.synchronize()
        packed = host.numpy().copy()
        views = packed[: chunk * nv].reshape(chunk, nv)
        stages = packed[chunk * nv: chunk * (nv + 1)].astype(int)
        for k in range(chunk):
            self.loop._view = self.loop.env.view_unpack(views[k])
            self.loop.tamp.task_planner.task = _STAGE_TASK[stages[k]]
        if ck is not None:
            ck["view"] = np.array(views[0], dtype=np.float32)
            self.checkpoints.append(ck)

    def _trace_run(self, n: int) -> None:
        if self.panda:
            self._panda_chunks(n, n, record=False)
        else:
            self.loop.run_chunked(n, chunk=n, pipelined=True)


LOOP = Chunked
