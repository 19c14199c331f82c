"""gym.host_syncs_per_step: the port's counted device-to-host reads
(``core/rng.HOST_SYNCS``) over the window, per Gym step."""


def read(r):
    steps = r.window["steps"]
    return r.window["host_syncs"] / steps if steps else None
