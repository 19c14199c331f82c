"""gym_step_ms.p50: the median of the window's Gym step samples
(``action_masks()`` plus ``step(action)``), in ms."""

import numpy as np


def read(r):
    ms = r.window["step_ms"]
    return float(np.percentile(ms, 50)) if len(ms) else None
