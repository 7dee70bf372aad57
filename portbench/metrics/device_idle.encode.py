"""device_idle.encode: device_idle (the share of the traced call's wall in
which nothing ran on the device, in %: 1 - (union of kernel, memcpy and
memset spans) / the call's span on the host) of an encode cell's traced
batch."""


def read(r):
    if r.trace is None or r.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
