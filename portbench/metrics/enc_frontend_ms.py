"""enc_frontend_ms: milliseconds the phase-timed batch spends in FastWP's
native front end: ``encode.native_prep`` (lower-casing, the split on
whitespace and the dedup of the chunks, _native/encode_prep.cpp) and
``encode.pack_u16`` (the unique chunks packed into the scan's 16-bit
character words)."""


def read(r):
    return r.phase_ms("encode.native_prep", "encode.pack_u16")
