"""device_idle_pct.<cell kind>: the share of the traced window in which
nothing ran on the card (no kernel, copy or set), from the union of the
profiler's device intervals."""


def read(trace):
    return trace.idle_pct()
