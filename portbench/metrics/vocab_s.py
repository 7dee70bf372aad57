"""vocab_s: seconds to a vocabulary: the window's trains' own times (each
from its call to its return; what is kept between trains is outside),
summed, over the trains run in the window. A train's output is kept as
it is, so the sum is the window's wall clock, from the first train's
call to the last one's return, but for microseconds."""


def read(r):
    return sum(r.call_s) / r.calls if r.calls else None
