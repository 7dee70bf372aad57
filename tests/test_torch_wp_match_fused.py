"""Kernel 6's fused form of the PyTorch port
(ops/wp_encode.wp_match_compact: NaiveWP's greedy longest match with
kernel 2's compaction in its epilogue) against the JAX package's
``wp_match_encode_stacked``, on the CPU, where the wrapper runs its plain
PyTorch version. Also the tables the kernel reads (the step records
against ``goto`` and ``accept``, the 17 '#' jumps against the vocab's
strings), a per-word walk with those jumps (the kernel's algorithm)
against the plain lockstep version and its step counts, the wrapper's
checks, and NaiveWP's call through the fused form. Inputs come from
numpy seeds; exact equality."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import emitted, match_rows, wp_random_case
from subword_tokenizers_tpu.core.symbols import SymbolTable as JaxTable
from subword_tokenizers_tpu.models.trie import MatchTrie as JaxMatchTrie
from subword_tokenizers_tpu.ops import wp_encode as jwe
from subword_tokenizers_tpu_torch import NaiveWP
from subword_tokenizers_tpu_torch.core.symbols import SymbolTable
from subword_tokenizers_tpu_torch.models.state import MatchState
from subword_tokenizers_tpu_torch.models.trie import MatchTrie
from subword_tokenizers_tpu_torch.ops import wp_encode as twe

torch.set_num_threads(1)

# the random vocabs of chip_smoke's phase 9: (alphabet, tokens, L)
RANDOM_CASES = [("abc", 12, 8), ("abcd", 40, 16), ("ab#", 15, 9),
                ("a#", 6, 33), ("abcdefgh", 120, 24)]


def _tries(vocab):
    jt, pt = JaxTable(), SymbolTable()
    jt.intern("[UNK]")
    pt.intern("[UNK]")
    return (JaxMatchTrie.build(sorted(vocab), jt),
            MatchTrie.build(sorted(vocab), pt), pt)


def _inputs(vocab, words, L):
    """(JAX trie, port trie, port output table, words int32[W, L],
    lengths int32[W], hash_aid)."""
    jtrie, ptrie, table = _tries(vocab)
    wmat, wlen = match_rows(ptrie.alpha, ptrie.n_alpha, words, L)
    return jtrie, ptrie, table, wmat, wlen, int(ptrie.alpha[ord("#")])


def _fused_vs_jax(vocab, words, L):
    """The fused plain version against JAX's wp_match_encode_stacked:
    offsets, total, flags and the emitted ids. Returns the port's (ids,
    head) and the JAX out_n."""
    jtrie, ptrie, _, wmat, wlen, hash_aid = _inputs(vocab, words, L)
    _, j_ids, j_out_n, j_flags, j_total = (
        np.asarray(a) for a in jwe.wp_match_encode_stacked(
            jnp.asarray(wmat[None]), jnp.asarray(wlen[None]),
            jnp.asarray(jtrie.goto), jnp.asarray(jtrie.accept), hash_aid))
    ids, head = twe.wp_match_compact(
        torch.from_numpy(wmat), torch.from_numpy(wlen),
        torch.from_numpy(ptrie.goto), torch.from_numpy(ptrie.accept),
        hash_aid)
    W = wmat.shape[0]
    offs = np.concatenate([[0], np.cumsum(j_out_n)[:-1]]).astype(np.int32)
    assert np.array_equal(head[:W].numpy(), offs)
    assert int(head[W]) == int(j_total)
    assert np.array_equal(head[W + 1:].numpy(), j_flags.astype(np.int32))
    out_n = torch.from_numpy(j_out_n.astype(np.int32))
    cap = L + 4
    want = emitted(torch.from_numpy(j_ids.astype(np.int32)), head, out_n,
                   cap)
    assert torch.equal(emitted(ids, head, out_n, cap), want)
    return ids, head, j_out_n


@pytest.mark.parametrize("seed,case", list(enumerate(RANDOM_CASES)))
def test_fused_equals_jax_stacked(seed, case):
    """chip_smoke's five random vocabs ('#'-bearing ones included): words
    with characters outside the vocab, empty words, [UNK] and overflow."""
    alphabet, n_tokens, L = case
    rng = np.random.default_rng(100 + seed)
    vocab, words = wp_random_case(rng, 300, L, alphabet, n_tokens)
    _, head, j_out_n = _fused_vs_jax(vocab, words, L)
    if "#" in alphabet:
        assert (head[301:] & 1).any()


@pytest.mark.parametrize("tail", [16, 17])
def test_fused_inject_cap_equals_jax(tail):
    """'#' without '##': the word ends exactly at the cap of 16 pending
    '#' with a token of 16 '#', and overflows with 17; "q" is [UNK]."""
    vocab = {"a", "#", "#" * tail + "b"}
    _, head, j_out_n = _fused_vs_jax(vocab, ["ab", "q", ""], 16)
    assert head[4:].tolist() == [tail == 17, 0, 0]
    assert j_out_n.tolist()[1:] == [1, 0]


@pytest.mark.parametrize("W", [1, 127, 128, 129, 257])
def test_fused_tile_edges_equal_jax(W):
    """Batches at the kernel's tile edges (128 words a block), a fifth of
    the words empty."""
    rng = np.random.default_rng(200 + W)
    vocab, words = wp_random_case(rng, W, 12, "abcd", 30)
    words = ["" if rng.random() < 0.2 else w for w in words]
    _fused_vs_jax(vocab, words, 16)


def test_fused_step_cap_equals_jax():
    """Words that run to the step cap: "#" and "##" without "##a" make a
    restart from "a" emit "##" and restart again, forever, in cycles of
    three steps (two '#', one dead end), so the cap falls inside the '#'
    run for some lengths and outside it for others."""
    vocab = {"a", "b", "#", "##", "ab"}
    L = 8
    words = ["aa", "aaa", "ba", "aba", "abba", "a", "b", "bb"]
    _, head, _ = _fused_vs_jax(vocab, words, L)
    _, ptrie, _, wmat, wlen, hash_aid = _inputs(vocab, words, L)
    steps, _ = twe.wp_match_steps(
        torch.from_numpy(wmat), torch.from_numpy(wlen),
        torch.from_numpy(ptrie.goto), torch.from_numpy(ptrie.accept),
        hash_aid)
    max_iter = twe.match_params(L)[1]
    capped = steps.numpy() == max_iter
    assert capped.sum() >= 3 and not capped.all()
    assert np.array_equal(head[len(words) + 1:].numpy() & 1, capped)


def test_fused_long_words_equal_jax():
    """L = 1000: rows too wide for the kernel to stage in shared memory."""
    rng = np.random.default_rng(300)
    vocab, words = wp_random_case(rng, 6, 1000, "abcd", 40)
    words[0] = "abcd" * 250
    _fused_vs_jax(vocab, words, 1000)


@pytest.fixture(scope="module")
def real():
    """The golden 8,000-token vocab and the word types of train-85k's
    first 2,000 sentences, as NaiveWP builds them."""
    import json
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "tests", "golden",
                           "port_t85k_v8000_wp_vocab.json"),
              encoding="utf-8") as f:
        vocab = json.load(f)["vocab"]
    with open(os.path.join(root, "data", "train-85k.json"),
              encoding="utf-8") as f:
        corpus = json.load(f)[:2000]
    from subword_tokenizers_tpu_torch.core.corpus import unique_words
    tok = NaiveWP(device="cpu")
    tok.vocab = set(vocab)
    words = unique_words(tok.preprocessing_batch(corpus))[0]
    return vocab, words


def test_fused_real_vocab_equals_jax(real):
    vocab, words = real
    L = -(-max(len(w) for w in words) // 8) * 8
    _, head, j_out_n = _fused_vs_jax(vocab, words, L)
    assert int(head[len(words)]) > len(words)
    assert not head[len(words) + 1:].any()


def test_match_records_equal_goto_and_accept(real):
    """Every entry: (goto, accept[goto]) where there is a child, (-1, -1)
    where there is none; on the real trie and on random ones."""
    vocab, _ = real
    for v in (vocab, wp_random_case(np.random.default_rng(5), 1, 4, "ab#",
                                    15)[0]):
        _, ptrie, _ = _tries(v)
        rec = twe.match_records(torch.from_numpy(ptrie.goto),
                                torch.from_numpy(ptrie.accept)).numpy()
        goto, accept = ptrie.goto, ptrie.accept
        assert rec.shape == goto.shape + (2,) and rec.dtype == np.int32
        assert np.array_equal(rec[..., 0], goto)
        for node in range(goto.shape[0]):
            for aid in range(goto.shape[1]):
                child = goto[node, aid]
                want = accept[child] if child >= 0 else -1
                assert rec[node, aid, 1] == want


@pytest.mark.parametrize("vocab", [
    {"a", "##a", "##b", "b"},               # the usual '##' continuations
    {"a", "#", "ab"},                        # '#' without '##'
    {"a", "#", "##", "###", "#" * 7 + "x"},  # a '#' run of 7 nodes
    {"a", "#" * 20},                         # deeper than the cap
    {"a", "b"},                              # no '#' at all
])
def test_jumps_equal_hash_prefixes(vocab):
    """jump[k]: the '#' run from the root is as deep as the longest '#'
    prefix of a token, up to k; its deepest accept is the longest token of
    '#' alone within that; the node is the trie's node of that prefix."""
    _, ptrie, table = _tries(vocab)
    hash_aid = int(ptrie.alpha[ord("#")])
    jumps = twe.match_jumps(torch.from_numpy(ptrie.goto),
                            torch.from_numpy(ptrie.accept), hash_aid)
    assert jumps.shape == (twe.MAX_INJECT + 1, 4)
    for k, (steps, node, tok, depth) in enumerate(jumps.tolist()):
        d = max((n for n in range(k + 1)
                 if any(t.startswith("#" * n) for t in vocab)), default=0)
        acc = [n for n in range(1, d + 1) if "#" * n in vocab]
        assert steps == d
        assert depth == (acc[-1] if acc else 0)
        assert tok == (table.strings().index("#" * acc[-1]) if acc else -1)
        want = 0
        for _ in range(d):
            want = int(ptrie.goto[want, hash_aid])
        assert node == want


def _walk(word, goto, accept, hash_aid, L, jumps=None):
    """One word's greedy match, step by step as the JAX program counts
    steps, or with the '#' runs taken from ``jumps`` in one move as the
    kernel takes them. Returns (tokens, unk, ovf, steps, '#' steps)."""
    cap, max_iter = twe.match_params(L)
    wl = len(word)
    pos = inject = node = ptr = acc_pos = acc_inj = it = hashed = 0
    acc_tok = -1
    running, unk, ovf, out = wl > 0, False, False, []
    while running and it < max_iter:
        it += 1
        aid = hash_aid if inject else word[pos] if pos < wl else None
        child = -1 if aid is None else int(goto[node, aid])
        if child >= 0:
            if inject:
                inject -= 1
                hashed += 1
            else:
                pos += 1
            node = child
            if accept[child] >= 0:
                acc_tok, acc_pos, acc_inj = int(accept[child]), pos, inject
            continue
        if acc_tok < 0:
            unk, running = True, False
            break
        if ptr < cap:
            out.append(acc_tok)
        else:
            ovf = True
        ptr += 1
        if acc_pos >= wl and acc_inj == 0:
            running = False
            break
        ovf |= 2 + acc_inj > twe.MAX_INJECT
        k = min(2 + acc_inj, twe.MAX_INJECT)
        pos, node, inject, acc_tok = acc_pos, 0, k, -1
        if jumps is not None:
            d, j_node, j_tok, j_depth = jumps[k]
            if it + d >= max_iter:  # the cap falls inside the run
                hashed += max_iter - it
                it = max_iter
                break
            it += d
            hashed += d
            node, inject, acc_tok, acc_inj = j_node, k - d, j_tok, k - j_depth
    if unk:
        out = [0]
    return out, unk, ovf or running, it, hashed


STEP_CASES = RANDOM_CASES + [("ab#", 40, 12), ("a#", 12, 20)]


@pytest.mark.parametrize("seed,case", list(enumerate(STEP_CASES)))
def test_steps_and_jumps_equal_python_walk(seed, case):
    """wp_match_steps equals the step-by-step walk's counts, and the walk
    with the '#' runs taken from match_jumps (the kernel's algorithm)
    gives the plain version's outputs and the same counts."""
    alphabet, n_tokens, L = case
    rng = np.random.default_rng(400 + seed)
    vocab, words = wp_random_case(rng, 200, L, alphabet, n_tokens)
    vocab |= {"#" * int(n) for n in rng.integers(1, 4, size=2)}
    _, ptrie, _, wmat, wlen, hash_aid = _inputs(vocab, words, L)
    args = (torch.from_numpy(wmat), torch.from_numpy(wlen),
            torch.from_numpy(ptrie.goto), torch.from_numpy(ptrie.accept),
            hash_aid)
    out, out_n, unk, ovf = twe.wp_match_encode_ref(*args)
    steps, hashed = twe.wp_match_steps(*args)
    jumps = twe.match_jumps(*args[2:]).tolist()
    max_iter = twe.match_params(L)[1]
    n_capped = 0
    for r in range(len(words)):
        word = wmat[r, :wlen[r]].tolist()
        plain = _walk(word, ptrie.goto, ptrie.accept, hash_aid, L)
        jumped = _walk(word, ptrie.goto, ptrie.accept, hash_aid, L, jumps)
        assert plain == jumped, r
        toks, w_unk, w_ovf, w_steps, w_hashed = plain
        assert (w_steps, w_hashed) == (int(steps[r]), int(hashed[r])), r
        assert (w_unk, w_ovf) == (bool(unk[r]), bool(ovf[r])), r
        n = min(int(out_n[r]), L + 4)
        assert n == len(toks) and out[r, :n].tolist() == toks, r
        n_capped += w_steps == max_iter
    if "#" in alphabet:
        assert n_capped and hashed.any()


def test_match_state_holds_the_tables():
    vocab = {"a", "##b", "#", "ab"}
    _, ptrie, _ = _tries(vocab)
    st = MatchState.build(ptrie, "cpu")
    hash_aid = int(ptrie.alpha[ord("#")])
    assert st.hash_aid == hash_aid
    assert torch.equal(st.rec, twe.match_records(st.goto, st.accept))
    assert torch.equal(st.jumps, twe.match_jumps(st.goto, st.accept,
                                                 hash_aid))
    assert np.array_equal(st.goto.numpy(), ptrie.goto)


def test_fused_empty_batch():
    _, ptrie, _ = _tries({"a"})
    ids, head = twe.wp_match_compact(
        torch.zeros(0, 8, dtype=torch.int32),
        torch.zeros(0, dtype=torch.int32), torch.from_numpy(ptrie.goto),
        torch.from_numpy(ptrie.accept), ptrie.n_alpha)
    assert ids.shape == (0,) and head.tolist() == [0]


def test_fused_rejects_bad_input():
    w = torch.zeros(2, 4, dtype=torch.int32)
    n = torch.ones(2, dtype=torch.int32)
    g = torch.full((3, 5), -1, dtype=torch.int32)
    acc = torch.full((3,), -1, dtype=torch.int32)
    rec = twe.match_records(g, acc)
    jumps = twe.match_jumps(g, acc, 4)
    with pytest.raises(TypeError):
        twe.wp_match_compact(w.to(torch.int64), n, g, acc, 4)
    with pytest.raises(TypeError):
        twe.wp_match_compact(w, n, g, acc.to(torch.int16), 4)
    with pytest.raises(ValueError):
        twe.wp_match_compact(w, n[:1], g, acc, 4)
    for bad in (5, -1):
        with pytest.raises(ValueError):
            twe.wp_match_compact(w, n, g, acc, bad)
    with pytest.raises(ValueError):
        twe.wp_match_compact(*(t.to("meta") for t in (w, n, g, acc)), 4)
    with pytest.raises(ValueError):  # a record of the wrong shape
        twe.wp_match_compact(w, n, g, acc, 4, rec=rec[:2].contiguous(),
                             jumps=jumps)
    with pytest.raises(ValueError):  # a record off an 8-byte boundary
        flat = torch.zeros(rec.numel() + 1, dtype=torch.int32)
        twe.wp_match_compact(w, n, g, acc, 4, rec=flat[1:].view(rec.shape),
                             jumps=jumps)
    with pytest.raises(ValueError):  # jumps of the wrong shape
        twe.wp_match_compact(w, n, g, acc, 4, rec=rec, jumps=jumps[:4])
    with pytest.raises(ValueError):  # tables on another device
        twe.wp_match_compact(w, n, g, acc, 4, rec=rec.to("meta"),
                             jumps=jumps)


def _spy(monkeypatch, module, name, calls):
    fn = getattr(module, name)

    def spy(*a, **k):
        calls[name] = calls.get(name, 0) + 1
        return fn(*a, **k)

    monkeypatch.setattr(module, name, spy)


def test_naivewp_calls_the_fused_match(monkeypatch):
    """NaiveWP.tokenize_batch makes one fused call with the state's tables
    and no call of the rows form or of kernel 2; its overflow still
    raises."""
    from subword_tokenizers_tpu_torch.models import base, wordpiece
    calls, seen = {}, {}
    real_fused = twe.wp_match_compact

    def fused(*a, **k):
        seen.update(k)
        calls["wp_match_compact"] = calls.get("wp_match_compact", 0) + 1
        return real_fused(*a, **k)

    monkeypatch.setattr(wordpiece, "wp_match_compact", fused)
    _spy(monkeypatch, twe, "wp_match_encode", calls)
    _spy(monkeypatch, base, "compact_ids", calls)
    tok = NaiveWP(device="cpu")
    tok.vocab = {"a", "ab", "##b", "##c", "x"}
    got = tok.tokenize_batch(["ab abc abd", "", "q", "a-b x!"])
    assert got == [tok.tokenize(s) for s in ["ab abc abd", "", "q",
                                             "a-b x!"]]
    assert calls == {"wp_match_compact": 1}, calls
    st = tok._match_device()
    assert seen["rec"] is st.rec and seen["jumps"] is st.jumps
    calls.clear()
    hang = NaiveWP(device="cpu")
    hang.vocab = {"a", "b", "#"}
    with pytest.raises(RuntimeError, match="wp_match_encode overflow"):
        hang.tokenize_batch(["a", "ab"])
    assert calls == {"wp_match_compact": 1}, calls
