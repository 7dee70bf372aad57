"""Kernel 6 of the PyTorch port (ops/wp_encode.wp_match_encode, NaiveWP's
greedy longest match) and the port's NaiveWP encoder against the JAX
package, on the CPU, where the wrapper runs its plain PyTorch version.

Inputs come from numpy seeds and go to both sides as the same arrays;
the JAX side runs its jitted program on its CPU backend, and its
``[UNK]`` rows get the substitution of ``wp_match_encode_stacked``
(token 0, count 1), which the port's kernel writes itself. Every
comparison is exact. The whole-corpus digest is the JAX package's,
written by ``tools/gen_port_encode_fixtures.py``."""
import hashlib
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import match_rows, wp_random_case
from subword_tokenizers_tpu import NaiveWP as JaxNaiveWP
from subword_tokenizers_tpu.core.symbols import SymbolTable as JaxTable
from subword_tokenizers_tpu.models.trie import MatchTrie as JaxMatchTrie
from subword_tokenizers_tpu.ops import wp_encode as jwe
from subword_tokenizers_tpu_torch import FastWP, NaiveWP
from subword_tokenizers_tpu_torch.core.symbols import SymbolTable
from subword_tokenizers_tpu_torch.models.trie import MatchTrie
from subword_tokenizers_tpu_torch.ops import wp_encode as twe

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")
with open(os.path.join(GOLDEN, "port_t85k_encode_expect.json")) as _f:
    EXPECT = json.load(_f)["NaiveWP_golden"]
N = 3000
OVERFLOW = ("wp_match_encode overflow: vocabulary drives the greedy "
            "matcher into unbounded '#' growth (the reference would not "
            "terminate on this input)")


def _digest(token_lists):
    return hashlib.sha256(json.dumps(token_lists, ensure_ascii=False)
                          .encode("utf-8")).hexdigest()


@pytest.fixture(scope="module")
def corpus():
    with open(os.path.join(ROOT, "data", "train-85k.json"),
              encoding="utf-8") as f:
        return json.load(f)


@pytest.fixture(scope="module")
def pair():
    """(JAX NaiveWP, port NaiveWP on the CPU) with the golden WP vocab."""
    with open(os.path.join(GOLDEN, "port_t85k_v8000_wp_vocab.json"),
              encoding="utf-8") as f:
        vocab = json.load(f)["vocab"]
    return _pair(vocab)


def _pair(vocab):
    jax_tok, port = JaxNaiveWP(), NaiveWP(device="cpu")
    jax_tok.vocab, port.vocab = set(vocab), set(vocab)
    return jax_tok, port


def _tries(vocab):
    jt, pt = JaxTable(), SymbolTable()
    jt.intern("[UNK]")
    pt.intern("[UNK]")
    return (JaxMatchTrie.build(sorted(vocab), jt),
            MatchTrie.build(sorted(vocab), pt), jt, pt)


def _both(vocab, words, L):
    """(JAX outputs with the [UNK] substitution, port outputs) of one
    batch of words padded to width L."""
    jtrie, ptrie, _, _ = _tries(vocab)
    wmat, wlen = match_rows(ptrie.alpha, ptrie.n_alpha, words, L)
    hash_aid = int(ptrie.alpha[ord("#")])
    out, out_n, unk, ovf = (np.asarray(a) for a in jwe.wp_match_encode(
        jnp.asarray(wmat), jnp.asarray(wlen), jnp.asarray(jtrie.goto),
        jnp.asarray(jtrie.accept), hash_aid))
    out, out_n = out.copy(), out_n.copy()
    out[unk, 0] = 0
    out_n[unk] = 1
    got = twe.wp_match_encode(torch.from_numpy(wmat),
                              torch.from_numpy(wlen),
                              torch.from_numpy(ptrie.goto),
                              torch.from_numpy(ptrie.accept), hash_aid)
    return (out, out_n, unk, ovf), tuple(t.numpy() for t in got)


def _assert_same(want, got):
    for name, a, b in zip(("out", "out_n", "unk", "ovf"), want, got):
        assert a.shape == b.shape, name
        assert np.array_equal(a.astype(np.int64), b.astype(np.int64)), name


@pytest.mark.parametrize("vocab", [
    {"a", "ab", "##b", "##c", "abc", "[UNK]"},
    {"#", "a", "##a", "#a#", "ża", "##ółć"},
    set(),
])
def test_match_trie_equals_jax(vocab):
    jtrie, ptrie, jt, pt = _tries(vocab)
    for field in ("edge_keys", "edge_vals", "accept", "goto", "alpha"):
        a, b = getattr(jtrie, field), getattr(ptrie, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    assert (jtrie.n_nodes, jtrie.n_alpha) == (ptrie.n_nodes, ptrie.n_alpha)
    assert jt.strings() == pt.strings()


@pytest.mark.parametrize("seed,alphabet,n_tokens,L", [
    (0, "abc", 12, 8), (1, "abcd", 40, 16), (2, "ab#", 15, 9),
    (3, "a#", 6, 33), (4, "abcdefgh", 120, 24), (5, "ab", 3, 1)])
def test_matcher_equals_jax(seed, alphabet, n_tokens, L):
    """Random vocabs ('#'-bearing ones included) and words with
    characters outside the vocab, empty words and lengths up to L: all
    four outputs equal."""
    rng = np.random.default_rng(seed)
    vocab, words = wp_random_case(rng, 300, L, alphabet, n_tokens)
    want, got = _both(vocab, words, L)
    _assert_same(want, got)


def test_random_cases_raise_every_flag():
    seen = np.zeros(3, dtype=np.int64)  # unk, ovf, empty
    for seed, alphabet, n_tokens, L in [(0, "abc", 12, 8), (2, "ab#", 15, 9),
                                        (3, "a#", 6, 33)]:
        rng = np.random.default_rng(seed)
        vocab, words = wp_random_case(rng, 300, L, alphabet, n_tokens)
        _, (_, _, unk, ovf) = _both(vocab, words, L)
        seen += [unk.sum(), ovf.sum(), sum(not w for w in words)]
    assert seen.all(), seen


@pytest.mark.parametrize("tail,ovf", [(16, False), (17, True)])
def test_max_inject_edge(tail, ovf):
    """'#' in the vocab without '##': each restart pends one more '#'.
    With a token of 16 '#' the word ends exactly at the cap of 16; with
    17 it passes the cap and overflows."""
    vocab = {"a", "#", "#" * tail + "b"}
    want, got = _both(vocab, ["ab"], 16)
    _assert_same(want, got)
    assert bool(got[3][0]) is ovf
    if not ovf:
        toks = got[0][0, :got[1][0]].tolist()
        port = NaiveWP(device="cpu")
        port.vocab = vocab
        strings = port._build_match_trie()[1].strings()
        assert [strings[t] for t in toks] == port.encode_word("ab")
        assert len(toks) == 16


def test_output_width_and_step_cap():
    """A word of L one-character tokens fills L of the L+4 columns; '#'
    growth passes them. The step cap (L+18)(L+22)+32 is the JAX one."""
    vocab = {"a", "##a", "#"}
    want, got = _both(vocab, ["a" * 8, "a" * 5], 8)
    _assert_same(want, got)
    assert not got[3].any() and got[1].tolist() == [8, 5]
    want, got = _both({"a", "#"}, ["aa"], 8)
    _assert_same(want, got)
    assert got[3].all()
    assert twe.match_params(8) == (12, 26 * 30 + 32)


def test_wrapper_checks():
    w = torch.zeros(2, 4, dtype=torch.int32)
    n = torch.ones(2, dtype=torch.int32)
    g = torch.full((3, 5), -1, dtype=torch.int32)
    acc = torch.full((3,), -1, dtype=torch.int32)
    with pytest.raises(TypeError):
        twe.wp_match_encode(w.to(torch.int64), n, g, acc, 4)
    with pytest.raises(ValueError):
        twe.wp_match_encode(w, n[:1], g, acc, 4)
    with pytest.raises(ValueError):
        twe.wp_match_encode(w, n, g, acc, 5)
    with pytest.raises(ValueError):
        twe.wp_match_encode(*(t.to("meta") for t in (w, n, g, acc)), 4)


def test_tokenize_batch_equals_jax(pair, corpus):
    jax_tok, port = pair
    got = port.tokenize_batch(corpus[:N])
    assert got == jax_tok.tokenize_batch(corpus[:N])
    assert _digest(got) == EXPECT["small_sha256"]


def test_whole_corpus_equals_jax_digest(pair, corpus):
    _, port = pair
    got = port.tokenize_batch(corpus)
    assert sum(map(len, got)) == EXPECT["full_tokens"] == 4_785_224
    assert _digest(got) == EXPECT["full_sha256"]
    assert EXPECT["full_sha256"].startswith("e42b9c73ddd8")


def test_tokenize_and_encode_word_equal_jax(pair, corpus):
    jax_tok, port = pair
    batch = port.tokenize_batch(corpus[:40])
    for i, s in enumerate(corpus[:40]):
        assert port.tokenize(s) == jax_tok.tokenize(s) == batch[i]
    for w in ["", "a", "zażółć", "unaffable", "1999", "ß♥x", "##"]:
        assert port.encode_word(w) == jax_tok.encode_word(w)


def test_unk_empty_and_odd_sentences():
    jax_tok, port = _pair({"a", "ab", "##b", "##c", "x"})
    batch = ["ab abc abd", "", "  \t", "q", "a-b x!", "ΣΟΦΙΑ", "abbbbb"]
    got = port.tokenize_batch(batch)
    assert got == jax_tok.tokenize_batch(batch)
    assert got == [port.tokenize(s) for s in batch]
    assert ["[UNK]"] == got[3]
    assert port.tokenize_batch([]) == jax_tok.tokenize_batch([]) == []


def test_overflow_raises_the_jax_error():
    """'#' without '##': the batch raises the JAX package's overflow
    error, and the host encoder its non-termination error."""
    jax_tok, port = _pair({"a", "b", "#"})
    for tok in (jax_tok, port):
        with pytest.raises(RuntimeError) as e:
            tok.tokenize_batch(["a", "ab"])
        assert str(e.value) == OVERFLOW
    with pytest.raises(RuntimeError) as e_port:
        port.tokenize("ab")
    with pytest.raises(RuntimeError) as e_jax:
        jax_tok.tokenize("ab")
    assert str(e_port.value) == str(e_jax.value)
    assert "does not terminate" in str(e_port.value)


def test_reset_and_load_resources_drop_stale_tables(tmp_path):
    port = NaiveWP(device="cpu")
    with open(tmp_path / "vocab.json", "w", encoding="utf-8") as f:
        json.dump(["ab", "##c", "x"], f)
    port.load_resources(str(tmp_path))
    assert port.tokenize_batch(["abc x"]) == [["ab", "##c", "x"]]
    assert port.tokenize("abc") == ["ab", "##c"]
    stale = port._match_device()
    with open(tmp_path / "vocab.json", "w", encoding="utf-8") as f:
        json.dump(["a", "##b", "##c"], f)
    port.load_resources(str(tmp_path))
    assert port._match_state is None and port._encode_cache == {}
    assert port.tokenize_batch(["abc x"]) == [["a", "##b", "##c", "[UNK]"]]
    assert port.tokenize("abc") == ["a", "##b", "##c"]
    assert port._match_device() is not stale
    port.reset()
    assert port.tokenize_batch(["abc"]) == [["[UNK]"]]
    assert port.tokenize("abc") == ["[UNK]"]


def test_fastwp_keeps_its_own_encoders():
    assert FastWP.tokenize is not NaiveWP.tokenize
    assert FastWP.tokenize_batch is not NaiveWP.tokenize_batch
    fast = FastWP(device="cpu")
    fast.vocab = {"ab", "##c"}
    fast._build_e2e()
    assert fast.tokenize_batch(["abc q"]) == [["ab", "##c", "['UNK']"]]
    assert fast.tokenize("abc q") == ["ab", "##c", "['UNK']"]
