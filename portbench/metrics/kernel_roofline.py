"""kernel_roofline: the share of the step kernels' least time in their
traced time, in %. The least time is the sum over the merges learned of
K1's, K2's and K3's least times at each step's state (portbench/
roofline.py, the plain trainer's states: live slots, live pairs,
symbols); the traced time is that of the kernels named in ``STEP``.
Steps the program runs past the last merge count in the traced time
only. Without those kernels in the trace it reads nothing."""
from portbench import roofline

# K1, K2, K3 of the flat route, by a part of their names
STEP = ("pair_insert_kernel", "select_kernel", "merge_tiles_kernel")


def read(r):
    if r.trace is None or r.reference is None or not r.reference.states:
        return None
    traced = r.kernel_s(*STEP)
    if not traced:
        return None
    least = roofline.steps_least_s(r.reference.states, r.reference.n_final,
                                   r.task.wordpiece)
    return 100.0 * least / traced
