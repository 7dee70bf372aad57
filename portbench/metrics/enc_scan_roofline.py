"""enc_scan_roofline: the share of FastWP's fused scan's least time in its
traced time, in %. The least time is that of the traced batch's distinct
chunks, each scanned once (portbench/roofline.scan_work, over the rows,
steps, nodes and edges the plain encoder's walk of the same chunks
counts); the traced time is that of the kernels named in ``SCAN``.
Without them in the trace it reads nothing."""
from portbench import roofline

SCAN = ("scan_compact_kernel",)


def read(r):
    if r.trace is None or r.traced is None or r.reference is None:
        return None
    traced = r.kernel_s(*SCAN)
    if not traced:
        return None
    work = roofline.scan_work(**r.reference.scan_work(r.traced[0]))
    return 100.0 * roofline.least_s(*work) / traced
