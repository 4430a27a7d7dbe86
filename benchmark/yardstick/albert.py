"""The least time the H100 could take for the albert's kernel, K4
(``csrc/albert_rollout.cu``), frozen for the benchmark: a copy of the
port's ``analysis/roofline.py`` count ``albert_rollout_ops``, on the peaks
and the byte count of ``roofline.py`` beside this file.

K4 projects both base-vs-box contact passes of every substep whether the
contact is live or not (only ``resolve``'s three divisions are skipped for a
dead one), so its count, unlike the point rollout's, does not depend on the
data.
"""
from __future__ import annotations

from benchmark.yardstick.roofline import CIRCLE_TEST_OPS, PANDA_FK_OPS, RESOLVE_OPS, rollout_bound_ms

CIRCLE_CONTACT_OPS = CIRCLE_TEST_OPS + RESOLVE_OPS  # a contact the albert kernel always projects


def albert_rollout_ops(spec, K: int) -> float:
    """K4: per substep the base and arm drive with the clip, and with a box
    its ground friction, integration and two base-vs-box contact passes; per
    step the base-composed FK and the costs."""
    per_sub = 87 + (26 + 2 * (2 + CIRCLE_CONTACT_OPS) if spec.env_params.has_box else 0)
    return K * spec.T * (spec.env_params.substeps * per_sub + 2 + PANDA_FK_OPS + 60)


def albert_rollout_bound_ms(spec, inputs, K: int) -> float:
    """K4 on K samples: its parameter buffer and ``inputs`` (task vector,
    start state, actions) read, the costs and points written,
    :func:`albert_rollout_ops`."""
    return rollout_bound_ms(spec, inputs, K, albert_rollout_ops(spec, K))
