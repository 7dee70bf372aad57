"""kernel_ps_per_slot: picoseconds of step-kernel time a live slot costs:
K1's, K2's and K3's kernel spans in the traced train (the kernels named
as ``kernel_roofline`` names them) over the program's
``train.live_slots`` counter of the phase-timed train, the live slots
its steps read summed over the merges learned. Both trains of a run
learn the same merges on the same corpus, so the two are of one train.
A state that outgrows the card's cache shows here as a dearer slot,
where ``kernel_us_per_merge`` cannot tell more work from slower work.
Nothing without the counter (a program that keeps none, or a route
whose records carry no live count) or without those kernels."""

# K1, K2, K3 of the flat route, by a part of their names
STEP = ("pair_insert_kernel", "select_kernel", "merge_tiles_kernel")


def read(r):
    if r.trace is None or not r.phases:
        return None
    slots = r.phases.get("train.live_slots", {}).get("count")
    traced = r.kernel_s(*STEP)
    if not slots or not traced:
        return None
    return traced / slots * 1e12
