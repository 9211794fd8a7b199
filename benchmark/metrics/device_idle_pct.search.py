"""Share of the traced window in which no operation ran on the card:
100·(1 − the union of the device operations' intervals / the window's wall),
the window from the host's start to the end of its last synchronisation,
every host gap and sync inside it; on rank 0 where there are ranks."""


def read(r):
    if r.trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - r.trace["busy_s"] / r.trace["window_s"])
