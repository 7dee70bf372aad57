"""tail_ms: milliseconds a train spends on the host after its device
loop: the program's spans ``train.final_copy`` (the final state's copy
to the host), ``train.close`` (the block in flight drained and the CUDA
graphs released), ``train.symbols`` (the symbol lists,
``corpus_as_symbols``), ``train.ranks`` (FastBPE's rank map) and
``train.trie`` (FastWP's trie). ``train.final_copy`` and
``train.symbols`` lie inside ``train.final_fetch``, which
``fetch_wait_ms`` reads too. Nothing where the program has none of these
spans."""

TAIL = ("train.final_copy", "train.close", "train.symbols", "train.ranks",
        "train.trie")


def read(r):
    if not r.phases or not any(n in r.phases for n in TAIL):
        return None
    return r.phase_ms(*TAIL)
