"""``batch``: ``seeds`` runs as one ``BatchSimLoop``, each chunk its
batched ticks with the success gate off, its views fetched and drained into
the host planners.  ``BatchSimLoop.run_chunked`` fixes the gate on, so this
loop makes the same calls it makes, with ``gate=False``: the host planners'
``update_plan``, ``_stacked_task_params``, ``ReactiveTAMP._run_chunk_impl``
and the views into each planner's ``observe`` (``PERF.md``, Open
questions)."""
from __future__ import annotations

import dataclasses

import numpy as np

from benchmark.loops import Loop, cloned, port_config
from benchmark.yardstick.rates import ChunkClock


class Batch(Loop):
    def _build(self) -> None:
        from m3p2i_aip_tpu_torch.tamp.batch_loop import BatchSimLoop

        self.B = int(self.traffic["seeds"])
        self.seeds_per_tick = self.B
        self._seeds = self._draw(self.B)
        self.batch = batch = BatchSimLoop(port_config(self.cfg_file), self._seeds, device=self.device)
        self.tamp = batch.tamp
        batch.warmup(int(self.cfg_file["settle_steps"]))
        self.settled, self.settled_views = batch.state, list(batch.views)

    def _episode(self, deadline=None) -> None:
        batch = self.batch
        self.episode += 1
        seeds = self._seeds if self.episode == 1 else self._draw(self.B)  # the batch was built with the first's
        batch.reset(seeds)
        batch.state, batch.views = cloned(self.settled), list(self.settled_views)
        clock = ChunkClock(self.device)
        for i in range(0, self.E, self.C):
            if self.recording:
                clock.mark()
            self._chunk(i, self.C, self.recording and i in self.check_ticks)
        if self.recording:
            clock.mark()
            self.chunk_s += clock.periods_s()
            self.ticks += self.E

    def _chunk(self, i: int, chunk: int, keep: bool) -> None:
        batch, tamp = self.batch, self.batch.tamp
        for b, tp in enumerate(batch.planners):
            tp.update_plan(batch.views[b])
        task = batch._stacked_task_params()
        cks = []
        if keep:  # the batch's carry and task once; each seed's rows after the window (``window``)
            gens = [g.get_state() for g in tamp.motion_planner.seed_generators]
            shared = self._checkpoint(i, None, task=task, mppi_state=batch.mppi_state, real_state=batch.state)
            cks = [dict(shared, seed_val=batch.seeds[b], seed=b, generator=gens[b]) for b in range(self.B)]
        ms, rs, views, _, _ = tamp._run_chunk_impl(batch.mppi_state, batch.state, task, i, chunk, gate=False)
        batch.mppi_state, batch.state = ms, rs
        views = views.reshape(-1).cpu().numpy().reshape(self.B, chunk, -1)
        for b, tp in enumerate(batch.planners):
            for k in range(chunk):
                view = batch.env.view_unpack(views[b, k])
                if hasattr(tp, "observe"):
                    tp.observe(view)
            batch.views[b] = view
        for b, ck in enumerate(cks):
            ck["view"] = np.array(views[b, 0], dtype=np.float32)
        self.checkpoints += cks

    def window(self, seconds: float, time_replays: bool = False) -> float:
        """The window; then each checkpoint's rows of its seed."""
        elapsed = super().window(seconds, time_replays)
        for ck in self.checkpoints:
            b = ck["seed"]
            ck["task"] = {k: v[b] for k, v in ck["task"].items()}
            for name in ("mppi_state", "real_state"):
                if name in ck:
                    ck[name] = _row(ck[name], b)
        return elapsed

    def _trace_run(self, n: int) -> None:
        self._chunk(0, n, False)


def _row(tree, b: int):
    """Seed ``b``'s slice of a batched dataclass of tensors (a field that is
    None stays None)."""
    return dataclasses.replace(tree, **{f.name: None if getattr(tree, f.name) is None else getattr(tree, f.name)[b]
                                        for f in dataclasses.fields(tree)})


LOOP = Batch
