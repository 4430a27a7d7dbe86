"""``pertick``: one robot, one tick per host round trip through the
program's ``SimLoop.tick`` (the host task planner, one compiled tick, one
view fetch), its public tick entry ``ReactiveTAMP.tick_fused`` wrapped to
keep checkpoints."""
from __future__ import annotations

import time

from benchmark.loops import Loop, cloned, port_config


class PerTick(Loop):
    def _build(self) -> None:
        from m3p2i_aip_tpu_torch.tamp.sim_loop import SimLoop

        self.loop = loop = SimLoop(port_config(self.cfg_file), device=self.device)
        self.tamp = loop.tamp
        loop.tamp.task_planner.check_task_success = lambda view: False
        loop.tamp.device_gate = False
        loop.warmup(int(self.cfg_file["settle_steps"]))
        self.settled = loop.state
        self._want = False
        tick_fused = self.tamp.tick_fused

        def recorded(mppi_state, real_state, task, i):
            ck = None
            if self._want:
                ck = self._checkpoint(i, self._seed_val, task=task, mppi_state=mppi_state, real_state=real_state,
                                      generator=self.tamp.motion_planner.generator.get_state())
            out = tick_fused(mppi_state, real_state, task, i)
            if ck is not None:
                ck["_views"] = (out[3], slice(None))
                self._pending.append(ck)
            return out

        self.tamp.tick_fused = recorded

    def _episode(self, deadline=None) -> None:
        loop = self.loop
        self.episode += 1
        self._seed_val = self._draw()
        loop.reset(self._seed_val)
        loop.state = cloned(self.settled)
        for i in range(self.E):
            if deadline is not None and time.perf_counter() >= deadline:
                break
            self._want = self.recording and i in self.check_ticks
            t0 = time.perf_counter()
            loop.tick(i)
            t1 = time.perf_counter()
            if self.recording:
                self.tick_s.append(t1 - t0)
                self.ticks += 1
        self._want = False
        self._fetch_pending()

    def _trace_run(self, n: int) -> None:
        for i in range(n):
            self.loop.tick(i)


LOOP = PerTick
