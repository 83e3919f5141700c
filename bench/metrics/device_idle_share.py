"""device_idle_share: the share (%) of the traced steps' wall time in which
no compute kernel ran on the device (copies do not count as compute)."""


def read(trace):
    busy = trace.union_s(lambda name, group: group != "copy")
    if busy <= 0 or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - busy / trace.window_s)
