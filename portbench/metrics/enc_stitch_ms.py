"""enc_stitch_ms: milliseconds the phase-timed batch spends in
``encode.stitch``: the token lists built from the stream, a sentence's
from its chunks' (_native/stitch.cpp)."""


def read(r):
    return r.phase_ms("encode.stitch")
