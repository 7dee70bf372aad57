"""The PyTorch port's host tables against the JAX package's: the
end-to-end trie, the character classes, and the device state built from
either trie. Exact equality: every table is integer or string."""
import json
import os

import numpy as np
import pytest
import torch

import subword_tokenizers_tpu.frontend.charclass as jcc
from subword_tokenizers_tpu.core.symbols import SymbolTable as JaxTable
from subword_tokenizers_tpu.models.trie import E2ETrie as JaxTrie
from subword_tokenizers_tpu_torch.core.symbols import SymbolTable
from subword_tokenizers_tpu_torch.frontend import charclass as tcc
from subword_tokenizers_tpu_torch.models.state import e2e_state_from_numpy
from subword_tokenizers_tpu_torch.models.trie import E2ETrie

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
TOY = ["a", "##b", "ab", "b", "##a", "x", "!", "##!", "abx", "ß", "##ß"]


def _vocab(name):
    if name == "toy":
        return TOY
    with open(os.path.join(GOLDEN, name), encoding="utf-8") as f:
        return sorted(json.load(f))


@pytest.mark.parametrize("name", ["toy", "sub200_v600_wp_vocab.json",
                                  "train5k_v1000_wp_vocab.json",
                                  "port_t85k_fastwp_vocab.json"])
def test_e2e_trie_equals_jax(name):
    vocab = _vocab(name)
    jt_out, pt_out = JaxTable(), SymbolTable()
    jt = JaxTrie.build(vocab, jt_out)
    pt = E2ETrie.build(vocab, pt_out)
    for field in ("edge_keys", "edge_vals", "goto", "alpha", "fail",
                  "pops_off", "pops_flat"):
        a, b = getattr(jt, field), getattr(pt, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    for field in ("root", "root_p", "root_sharp", "n_nodes", "n_alpha",
                  "has_ws_token", "max_pops"):
        assert getattr(jt, field) == getattr(pt, field), field
    assert jt_out.strings() == pt_out.strings()
    if name == "port_t85k_fastwp_vocab.json":
        assert (pt.n_nodes, pt.n_alpha + 1, pt.max_pops) == (20840, 80, 3)


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
