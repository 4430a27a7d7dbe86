"""The wedged-pick stall detector's thresholds, shared by the host task
planner and the device AIF gate (frozen copy of the port's
``planners/task_planner/task_planner.py:34-36``)."""

ZUP_STALL_TICKS = 30
ZUP_IMPROVE_M = 0.005
ZUP_RELEASE_M = 0.05
