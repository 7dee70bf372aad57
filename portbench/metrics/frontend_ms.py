"""frontend_ms: milliseconds a train spends in the program's phase
``train.frontend``: lower-casing, the pre-tokenizer's split and the count
of word types (core/corpus.train_words: one threaded native pass,
_native/count_words.cpp, or its fallback for an injected tokenizer or
U+0130 / U+03A3)."""


def read(r):
    return r.phase_ms("train.frontend")
