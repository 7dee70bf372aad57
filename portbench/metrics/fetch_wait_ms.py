"""fetch_wait_ms: milliseconds a train's host waits on the device's
results: the program's phases ``train.fetch_records`` (each block's
records) and ``train.final_fetch`` (the final state, and the host's
symbol lists built from it)."""


def read(r):
    return r.phase_ms("train.fetch_records", "train.final_fetch")
