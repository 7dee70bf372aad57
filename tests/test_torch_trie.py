"""The PyTorch port's host tables against the JAX package's: the
end-to-end trie (the port's native build against the JAX package's
Python one), the character classes, and the device state built from
either trie. Exact equality: every table is integer or string."""
import json
import os
import random

import numpy as np
import pytest
import torch

import subword_tokenizers_tpu.frontend.charclass as jcc
from subword_tokenizers_tpu.core.symbols import SymbolTable as JaxTable
from subword_tokenizers_tpu.models.trie import E2ETrie as JaxTrie
from subword_tokenizers_tpu_torch import FastWP
from subword_tokenizers_tpu_torch.benchmarks import profiling
from subword_tokenizers_tpu_torch.core.symbols import SymbolTable
from subword_tokenizers_tpu_torch.frontend import charclass as tcc
from subword_tokenizers_tpu_torch.models.state import e2e_state_from_numpy
from subword_tokenizers_tpu_torch.models.trie import E2ETrie

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")
TOY = ["a", "##b", "ab", "b", "##a", "x", "!", "##!", "abx", "ß", "##ß"]
ARRAYS = ("edge_keys", "edge_vals", "goto", "alpha", "fail", "pops_off",
          "pops_flat")
SCALARS = ("root", "root_p", "root_sharp", "n_nodes", "n_alpha",
           "has_ws_token", "max_pops")
# Edge cases: (vocab, the output table's strings before the build).
EDGE = {
    "sharp_in_vocab": (["##", "a", "##a", "#", "#a", "###", "a#b", "##a#"],
                       ["['UNK']"]),
    "punctuation": (["!", "?!", "...", "##!", "##.", "##?!", "a", "a.b",
                     "##a!", "!a", "-", "##-"], ["['UNK']"]),
    "whitespace": (["a b", "a", "##b", " ", "##\t", "b"], ["['UNK']"]),
    "non_bmp": (["\U0001F600", "##\U0001F600", "a\U0001F600",
                 "\U0001D518\U0001D52B", "##\U0001D52B", "a", "##a"],
                ["['UNK']"]),
    "preseeded": (["a", "ab", "##b", "b", "abc", "##c"], ["['UNK']", "ab"]),
    "sharp_alone": (["##"], ["['UNK']"]),
    "empty": ([], []),
}
# Random vocabularies: a third of the characters punctuation, "#" among
# them; about half the tokens "##"-prefixed.
ALPHABET = "abcdefghijklmnopqrstuvwxyz0123ßé" + "!?.,-'#()·"


def _vocab(name):
    if name == "toy":
        return TOY
    with open(os.path.join(GOLDEN, name), encoding="utf-8") as f:
        return sorted(json.load(f))


def _assert_same_tables(jt, pt):
    for field in ARRAYS:
        a, b = getattr(jt, field), getattr(pt, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    for field in SCALARS:
        assert getattr(jt, field) == getattr(pt, field), field


def _assert_trie_equal(vocab, seeded=()):
    """The native build of ``vocab`` equals the JAX package's on every
    table and in its output table's order; returns the port's trie."""
    jt_out, pt_out = JaxTable(seeded), SymbolTable(seeded)
    pt = E2ETrie.build(vocab, pt_out)
    _assert_same_tables(JaxTrie.build(vocab, jt_out), pt)
    assert jt_out.strings() == pt_out.strings()
    return pt


def _random_vocab(seed):
    """Up to 30,000 distinct tokens of 1-9 characters, log-spread sizes."""
    rng = random.Random(seed)
    size = int(round(30_000 ** (seed / 19)))
    vocab = set()
    while len(vocab) < size:
        word = "".join(rng.choice(ALPHABET)
                       for _ in range(rng.randint(1, 9)))
        vocab.add("##" + word if rng.random() < 0.5 else word)
    return list(vocab)


@pytest.mark.parametrize("name", ["toy", "sub200_v600_wp_vocab.json",
                                  "train5k_v1000_wp_vocab.json",
                                  "port_t85k_fastwp_vocab.json"])
def test_e2e_trie_equals_jax(name):
    pt = _assert_trie_equal(_vocab(name))
    if name == "port_t85k_fastwp_vocab.json":
        assert (pt.n_nodes, pt.n_alpha + 1, pt.max_pops) == (20840, 80, 3)


@pytest.mark.parametrize("order", ["set", "sorted"])
def test_e2e_trie_equals_jax_at_20000_entries(order):
    """The encode cell's 20,000-entry vocabulary, in a set's iteration
    order (as ``FastWP.train`` passes its vocab) and sorted; the output
    ids follow the level order either way."""
    with open(os.path.join(ROOT, "portbench", "vocab", "wp-v20000",
                           "vocab.json"), encoding="utf-8") as f:
        vocab = json.load(f)
    vocab = list(set(vocab)) if order == "set" else sorted(vocab)
    pt = _assert_trie_equal(vocab, ["['UNK']"])
    assert (pt.n_nodes, pt.n_alpha + 1, len(pt.pops_flat)) == (
        51455, 80, 51614)


@pytest.mark.parametrize("case", list(EDGE) + [f"random{k}"
                                               for k in range(20)])
def test_e2e_trie_edge_cases_equal_jax(case):
    if case in EDGE:
        vocab, seeded = EDGE[case]
    else:
        vocab, seeded = _random_vocab(int(case[6:])), ["['UNK']"]
    pt = _assert_trie_equal(vocab, seeded)
    assert pt.has_ws_token == (case == "whitespace")
    if case == "empty":
        assert (pt.n_nodes, len(pt.pops_flat)) == (4, 0)


def test_e2e_trie_takes_a_list_of_str():
    with pytest.raises(TypeError):
        E2ETrie.build(["a", 3], SymbolTable())


def test_fastwp_train_builds_its_trie_natively_once():
    """A small CPU train of FastWP counts one native trie build, of as
    many nodes as the trie it keeps, whose tables equal the JAX
    package's build over the same vocab in the same order."""
    with open(os.path.join(ROOT, "data", "train-85k.json"),
              encoding="utf-8") as f:
        corpus = json.load(f)[:300]
    profiling.reset()
    try:
        tok = FastWP(device="cpu")
        tok.train(corpus, 220)
        counted = profiling.counters("trie.")
    finally:
        profiling.reset()
    trie, out = tok._trie()
    assert counted == {"trie.native": 1, "trie.nodes": trie.n_nodes}
    jt_out = JaxTable(["['UNK']"])
    _assert_same_tables(JaxTrie.build(list(tok.vocab), jt_out), trie)
    # FastWP interns the tokens of its "##" sequence after the build
    assert out.strings()[:len(jt_out)] == jt_out.strings()


def test_charclass_tables_equal_jax():
    for name in ("WS_PY", "ALNUM_PY", "PUNC_PY", "LOWER", "LOWER_SPECIAL"):
        a, b = getattr(jcc, name), getattr(tcc, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    for text in ("Zażółć GĘŚLĄ jaźń!", "İstanbul ΣΟΦΙΑ", "", "a\tb c"):
        assert np.array_equal(jcc.codepoints(text), tcc.codepoints(text))
        want, got = jcc.lower_codepoints(text), tcc.lower_codepoints(text)
        assert (want is None) == (got is None)
        if want is not None:
            assert np.array_equal(want, got)


def test_state_from_jax_trie_equals_own():
    """One JAX trie fed through e2e_state_from_numpy gives the tables the
    port's own trie gives."""
    vocab = _vocab("train5k_v1000_wp_vocab.json")
    jt = JaxTrie.build(vocab, JaxTable(["['UNK']"]))
    pt = E2ETrie.build(vocab, SymbolTable(["['UNK']"]))
    states = [e2e_state_from_numpy(t.goto, t.alpha, t.fail, t.pops_off,
                                   t.pops_flat, t.root_p, t.root_sharp, 0,
                                   (3, 4), "cpu") for t in (jt, pt)]
    for field in ("goto", "fail", "pops_off", "pops_flat", "sharp"):
        a, b = (getattr(s, field) for s in states)
        assert a.dtype == torch.int32 and torch.equal(a, b), field
    assert states[0].sharp.tolist() == [3, 4]
    assert states[0].max_pops == jt.max_pops
    hang = e2e_state_from_numpy(pt.goto, pt.alpha, pt.fail, pt.pops_off,
                                pt.pops_flat, pt.root_p, pt.root_sharp, 0,
                                None, "cpu")
    assert hang.sharp.tolist() == [-2]
