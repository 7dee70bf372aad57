"""vocab_s: seconds to a vocabulary, the measured window's wall clock
(from the first train's call to the last one's return) over the trains
run in it."""


def read(r):
    return r.window_s / r.calls if r.calls else None
