"""Non-blocking terminal keyboard input for live interaction with a run.

Port of ``m3p2i_aip_tpu/utils/teleop.py`` (stdlib only).  The reference lets
a human disturb the scene while the planner runs: shove or drag the cube
from the viewer (``isaacgym_wrapper.py:413-437`` ``play_with_cube``).  A
headless host has no viewer, so the surface is the terminal:
:class:`KeyboardTeleop` puts stdin in cbreak mode and drains the pending
keys once per control tick without ever blocking the loop.

When stdin is not a tty (a pipe, a test, a batch job) the context manager is
an inert reader (``active`` False, ``poll()`` always empty), so the same
code path runs headless.
"""
from __future__ import annotations

import select
import sys
from typing import List


class KeyboardTeleop:
    """Context manager yielding a per-tick non-blocking key drain."""

    def __init__(self, enabled: bool = True) -> None:
        self.enabled = enabled
        self.active = False
        self._old_attrs = None

    def __enter__(self) -> "KeyboardTeleop":
        if not self.enabled:
            return self
        try:
            import termios
            import tty

            fd = sys.stdin.fileno()
            self._old_attrs = termios.tcgetattr(fd)
            tty.setcbreak(fd)
            self.active = True
        except Exception:  # not a tty, or no termios: stay inert
            self.active = False
        return self

    def __exit__(self, *exc) -> None:
        if self._old_attrs is not None:
            import termios

            termios.tcsetattr(sys.stdin.fileno(), termios.TCSADRAIN, self._old_attrs)
        self.active = False

    def poll(self) -> List[str]:
        """Every key pressed since the last poll (lower-cased), never blocking."""
        if not self.active:
            return []
        keys = []
        while select.select([sys.stdin], [], [], 0)[0]:
            ch = sys.stdin.read(1)
            if not ch:  # EOF or hang-up: select stays "readable" forever
                self.active = False
                break
            keys.append(ch.lower())
        return keys


# Shove displacements of the disturbance keys (play_with_cube's arrow-key
# cube dragging, as discrete shoves): i/k = +/-y, j/l = -/+x.
SHOVE_KEYS = {
    "i": (0.0, 0.3),
    "k": (0.0, -0.3),
    "j": (-0.3, 0.0),
    "l": (0.3, 0.0),
}
