"""kernel_us_per_merge: microseconds of kernel time a learned merge
costs: every kernel span of the traced train, over the merges it
learned."""


def read(r):
    if r.trace is None or not r.traced_work or not r.trace.kernels:
        return None
    return sum(s for _, s in r.trace.kernels.values()) / r.traced_work * 1e6
