"""plan_ms_p50.pertick: the median `tamp.plan` span of the window's ticks, the host task planner's tick
(update_plan, the gripper, the success check, the TaskParams) (ms)."""
from benchmark import spans


def read(ctx):
    return spans.read("spans", "tamp.plan", "p50_s", 1e3, spans.ticks(ctx))
