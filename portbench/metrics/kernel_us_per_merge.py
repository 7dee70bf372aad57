"""kernel_us_per_merge: microseconds of kernel time a learned merge
costs: every kernel span of the traced train, over the merges it
learned."""


def read(r):
    if r.trace is None or not r.traced or not r.traced[0] or \
            not r.trace.kernels:
        return None
    return sum(s for _, s in r.trace.kernels.values()) / len(r.traced[0]) \
        * 1e6
