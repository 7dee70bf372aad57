"""frontend_ms: milliseconds a train spends in the program's phase
``train.frontend``: lower-casing, the pre-tokenizer's split and the count
of word types (frontend/, _native/, through
models/base.preprocessing_batch)."""


def read(r):
    return r.phase_ms("train.frontend")
