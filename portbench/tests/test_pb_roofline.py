"""The per-step byte counts of kernel_roofline."""
from portbench import roofline
from portbench.reference import trainer


def ms2(n_bytes_ops):
    """The least time in ms, to two significant digits."""
    return float(f"{roofline.least_s(*n_bytes_ops) * 1e3:.2g}")


def test_initial_state_gives_the_smoke_bounds(source_counts):
    """At the 8k corpus's initial state, K1, K2 and K3 as the functions
    need them give PERF.md's bounds (rows 11a, 12a, 11b: 0.00091,
    0.0000068 and 0.0018 ms), which chip_smoke.py evaluates there."""
    got = trainer.train(source_counts, 80, wordpiece=False,
                        record_states=True)
    (n, p, s), (n_next, _, _) = got.states[:2]
    assert (p, s) == (915, 78)
    k1, k2, k3 = roofline.step_work(n, n_next, p, s, wordpiece=False)
    assert (ms2(k1), ms2(k2), ms2(k3)) == (0.00091, 0.0000068, 0.0018)


def test_states_shrink_and_the_sum_adds_steps(source_counts):
    got = trainer.train(source_counts, 400, wordpiece=True,
                        record_states=True)
    assert len(got.states) == len(got.merges)
    slots = [st[0] for st in got.states] + [got.n_final]
    assert all(a >= b for a, b in zip(slots, slots[1:]))
    assert [st[2] for st in got.states] == list(
        range(got.states[0][2], got.states[0][2] + len(got.merges)))
    one = roofline.steps_least_s(got.states[:1], got.states[1][0], True)
    total = roofline.steps_least_s(got.states, got.n_final, True)
    assert 0 < one < total < len(got.states) * one
