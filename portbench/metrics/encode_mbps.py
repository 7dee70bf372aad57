"""encode_mbps: encode throughput, MB/s: the UTF-8 bytes of the batches
the window's calls encoded, over the sum of those calls' own times (each
from its start to its return; the check's digest between calls is
outside them), in 10^6 bytes a second."""


def read(r):
    if not r.kept or not r.call_s:
        return None
    done = sum(r.task.batch_bytes[i] for i, _ in r.kept)
    return done / sum(r.call_s) / 1e6
