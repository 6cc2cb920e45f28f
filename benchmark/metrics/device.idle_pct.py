"""device.idle_pct (device): 100 x (1 - the union of device activity / the
wall time of the traced window)."""


def read(trace):
    if trace.window_s <= 0 or not trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
