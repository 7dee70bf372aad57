"""Training, written once: ``train`` of NaiveBPE and FastBPE
(models/bpe.py) and of NaiveWP and FastWP (models/wordpiece.py), on
every route. Its results are the JAX package's ``models/bpe.py`` and
``models/wordpiece.py`` results exactly (``merges_list`` or
``_merge_log``, ``vocab``, ``corpus_as_symbols``, the checkpoint's
files), and it raises their errors. The path, with its profiling spans
(benchmarks/profiling.py):

1. one threaded C++ pass over the sentences lowers and pre-splits them
   and counts the word types in first-occurrence order
   (``train.frontend``, core/corpus.train_words), and the corpus's
   symbol occurrences are counted (``train.alphabet``);
2. the word types become the flat state (ops/flat.py), interned
   symbol by symbol in scan order (``train.corpus``), and go to
   ``device``; the vocabulary starts as the symbols interned; a resumed
   train replays the checkpoint's merges over it (``train.resume``);
3. ops/train_loop.run_fused runs blocks of K merge steps, each step
   kernel K1 (pair counts), K2 (selection and hash unification) and K3
   (merge and compaction), then checks the block's records on the host
   (``train.loop_setup``, ``train.device_block``, ``train.capture``,
   ``train.fetch_records``, ``train.verify``, ``train.close``);
4. on a hash collision the run is redone on the exact per-step path
   (``train.per_step``: K1, K2's selection only, host interning, K3);
5. the final state comes back in one copy (``train.final_fetch``,
   holding ``train.final_copy``), and becomes ``corpus_as_symbols``
   (``train.symbols``, inside ``train.final_fetch``: one native pass,
   core/corpus.symbol_lists); FastBPE then ranks the merges
   (``train.ranks``), FastWP builds its trie (``train.trie``).

Under a mesh (parallel/mesh.py) a second ``train.corpus`` span shards
the word types (parallel/train.ShardedTrainer), and steps 3-4 are the
per-step loop on the mesh: the tiered selection, the same host
interning and K3p on every shard (``train.sharded``; the trainer's
graphs released in ``train.close``). There is no fused block loop under
a mesh, as in the JAX package.

BPE interns a word as its characters; with an end-of-word suffix
(the model's ``end_of_word_suffix``, GPT-1's ``"</w>"``) the last one
carries it, and the merges whose right symbol carries it are counted as
``train.eow.merges`` at the end. WordPiece (the model's ``_WORDPIECE``)
interns a word as its first character and ``"##" + ch`` for every later
one, selects the pair of largest exact score
``count / (freq_a * freq_b)`` over per-symbol weights that kernel K4
counts, and merges into ``a + b[2:]`` (ops/train_loop.join).
``SWT_SKIP_COMPACT`` (and, for WordPiece, ``SWT_WP_TOURNAMENT``) choose
the other routes of step 3, with the same merges, as in the JAX package
(ops/train_loop.run_fused); unset, every step compacts.

What a model gives ``train``: ``_WORDPIECE``; ``_DOMAIN``, its ceiling
of symbol occurrences and the name of the domain in its error;
``_TYPE_ERRORS``, the texts of its two TypeErrors; ``_LABEL``, the
progress bar's; ``_LOG``, the name of its merge log;
``_build_corpus(words, freq, table)`` (core/corpus.py);
``_train_words(corpus)``, core/corpus.train_words by
the name its module imports; ``_save_checkpoint()``; and
``_saved_merges()``, the merges of the checkpoint in ``_resume_dir``.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import utils
from ..benchmarks import profiling
from ..core.corpus import symbol_lists
from ..core.symbols import SymbolTable
from ..ops import train_loop
from ..ops.flat import build_flat

# WordPiece's scores are wide (fa * fb may reach 2**53) from this many
# symbol occurrences on; below it the tournament may select.
WIDE_SCORE_MIN = 1 << 26


def train(tok, corpus, max_vocab: int, checkpoint_dir, checkpoint_every: int,
          resume: bool, progress: bool) -> None:
    """Train ``tok`` (models/base.SubwordTokenizer.train, whose
    arguments these are) on ``corpus``."""
    corpus_error, vocab_error = tok._TYPE_ERRORS
    if not isinstance(corpus, list) or not all(
            isinstance(example, str) for example in corpus):
        raise TypeError(corpus_error)
    if not isinstance(max_vocab, int):
        raise TypeError(vocab_error)

    wp = tok._WORDPIECE
    tok.reset()
    tok._checkpoint_dir = checkpoint_dir
    tok._checkpoint_every = max(int(checkpoint_every), 1)
    tok._resume_dir = checkpoint_dir if resume else None
    tok._progress = progress
    log = getattr(tok, tok._LOG)
    log.clear()

    with profiling.phase("train.frontend"):
        words, freq = tok._train_words(corpus)
    if wp and not words:
        return
    with profiling.phase("train.alphabet"):
        total_tokens = int((np.array([len(w) for w in words],
                                     dtype=np.int64) * freq).sum())
    if not words:
        return
    max_tokens, domain = tok._DOMAIN
    if total_tokens >= max_tokens:
        raise ValueError(
            f"corpus exceeds the {domain} domain "
            f"({total_tokens} symbol occurrences >= 2**52)")
    wide_score = wp and total_tokens >= WIDE_SCORE_MIN

    dev = tok.device
    table = SymbolTable()
    with profiling.phase("train.corpus", dev):
        arrays = tok._build_corpus(words, freq, table)
        if tok.mesh is None:
            state = train_loop.FlatState(*build_flat(arrays.sym,
                                                     arrays.freq), dev)
    tok.vocab |= set(table.strings())  # the initial symbols
    trainer = None
    if tok.mesh is not None:
        from ..parallel.train import ShardedTrainer
        with profiling.phase("train.corpus", dev):
            trainer = ShardedTrainer(
                tok.mesh, arrays.sym, arrays.freq,
                sym_cap=train_loop.sym_capacity(table, max_vocab)
                if wp else None, wide_score=wide_score,
                force_tier=getattr(tok, "_force_tier", None))
        tok._sel_stats = trainer.sel_stats
        tok._topk_fallbacks = 0
        tok._graph_stats = trainer.graph_stats
        select, apply = trainer.select, trainer.merge
    else:
        rec = torch.zeros(6, dtype=torch.int32, device=dev)

        def select():
            return train_loop.select_ids(state, rec, wp)

        def apply(a, b, new_id):
            train_loop.merge_host_ids(state, a, b, new_id, rec)

    def on_merge(sa, sb, merged):
        tok.vocab.add(merged)
        log.append((sa, sb))

    def merge(a, b):
        """Intern the merge of symbols ``a`` and ``b`` on the host and
        apply it with the host's ids."""
        sa, sb = table.string(a), table.string(b)
        merged = train_loop.join(sa, sb, wp)
        on_merge(sa, sb, merged)
        apply(a, b, table.intern(merged))

    since = 0  # merges since the last checkpoint

    def checkpoint(steps):
        nonlocal since
        since += steps
        if since >= tok._checkpoint_every:
            since = 0
            tok._save_checkpoint()

    ckpt = checkpoint if tok._checkpoint_dir is not None else None
    pbar = None
    sym_host = None  # the final state, when run_fused returns it
    try:
        if tok._resume_dir is not None:
            # Training is deterministic: replaying the checkpointed
            # merges rebuilds the interrupted state exactly.
            with profiling.phase("train.resume", dev):
                for sa, sb in tok._saved_merges():
                    a, b = table.get(sa), table.get(sb)
                    if a is None or b is None:
                        raise ValueError(
                            "checkpoint does not match this corpus: "
                            f"unknown symbol in merge ({sa!r}, {sb!r})")
                    merge(a, b)
        if tok._progress:
            pbar = utils.Progress(total=max_vocab - len(tok.vocab),
                                  desc=tok._LABEL)
        bar = pbar.update if pbar is not None else None

        if trainer is None and not tok._force_per_step:
            try:
                sym_host = train_loop.run_fused(
                    state, table, max_vocab, arrays.sym.shape[1], on_merge,
                    checkpoint_cb=ckpt, progress_cb=bar, wordpiece=wp,
                    wide_score=wide_score)
            except train_loop.HashCollision:
                # A double-hash collision: redo the whole run on the
                # exact per-step path.
                if pbar is not None:
                    pbar.close()
                tok._force_per_step = True
                try:
                    return tok.train(
                        corpus, max_vocab,
                        checkpoint_dir=tok._checkpoint_dir,
                        checkpoint_every=tok._checkpoint_every,
                        resume=tok._resume_dir is not None,
                        progress=tok._progress)
                finally:
                    tok._force_per_step = False
        else:
            with profiling.phase("train.per_step" if trainer is None
                                 else "train.sharded", dev):
                if trainer is None and wp:
                    state.count_symbols(train_loop.sym_capacity(table,
                                                                max_vocab))
                while len(tok.vocab) < max_vocab:
                    got = select()
                    if got is None:
                        break
                    merge(*got)
                    profiling.count("train.merges")
                    if bar is not None:
                        bar(1)
                    if ckpt is not None:
                        ckpt(1)
    finally:
        if trainer is not None:
            tok._topk_fallbacks = trainer.topk_fallbacks
            with profiling.phase("train.close"):
                trainer.close()
    if pbar is not None:
        pbar.close()
    if tok._checkpoint_dir is not None:
        tok._save_checkpoint()

    with profiling.phase("train.final_fetch"):
        if sym_host is None:
            with profiling.phase("train.final_copy"):
                sym_host = (state.padded() if trainer is None
                            else trainer.host())
        with profiling.phase("train.symbols"):
            tok.corpus_as_symbols = symbol_lists(sym_host, arrays.freq,
                                                 table)
    suffix = None if wp else tok.end_of_word_suffix
    if suffix is not None:
        profiling.count("train.eow.merges",
                        sum(1 for _, sb in log if sb.endswith(suffix)))
