"""corpus_ms: milliseconds a train spends in the program's phase
``train.corpus``: symbol interning, the flat state and its copy to the
card (core/corpus.py, ops/flat.build_flat)."""


def read(r):
    return r.phase_ms("train.corpus")
