"""Kernel 5 of the PyTorch port (ops/bpe_encode.bpe_encode, the BPE merge
loop) and the port's FastBPE / NaiveBPE encoders against the JAX
package, on the CPU, where the wrapper runs its plain PyTorch version.

Inputs come from numpy seeds and go to both sides as the same arrays;
the JAX side runs its jitted programs on its CPU backend. Every
comparison is exact (integers and token lists). The whole-corpus
digests are the JAX package's, written by
``tools/gen_port_encode_fixtures.py``."""
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import bpe_random_case, merge_lists, self_pair_case
from subword_tokenizers_tpu import FastBPE as JaxFastBPE
from subword_tokenizers_tpu import NaiveBPE as JaxNaiveBPE
from subword_tokenizers_tpu.ops import bpe_encode as jbe
from subword_tokenizers_tpu_torch import FastBPE, NaiveBPE
from subword_tokenizers_tpu_torch.models import bpe as port_bpe
from subword_tokenizers_tpu_torch.ops import bpe_encode as tbe

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

with open(os.path.join(ROOT, "tests", "golden",
                       "port_t85k_encode_expect.json")) as _f:
    EXPECT = json.load(_f)
N = EXPECT["small_n"]
CLASSES = {"FastBPE": (JaxFastBPE, FastBPE),
           "NaiveBPE": (JaxNaiveBPE, NaiveBPE)}


def _digest(token_lists):
    return hashlib.sha256(json.dumps(token_lists, ensure_ascii=False)
                          .encode("utf-8")).hexdigest()


@pytest.fixture(scope="module")
def corpus():
    with open(os.path.join(ROOT, "data", "train-85k.json"),
              encoding="utf-8") as f:
        return json.load(f)


@pytest.fixture(scope="module")
def lists():
    return merge_lists()


def _pair(name, merges):
    """(JAX tokenizer, port tokenizer on the CPU) holding ``merges``."""
    jax_cls, port_cls = CLASSES[name]
    jax_tok, port = jax_cls(), port_cls(device="cpu")
    for tok in (jax_tok, port):
        tok.merges_list = [tuple(m) for m in merges]
        if name == "FastBPE":
            tok._bpe_ranks = {p: i for i, p in enumerate(tok.merges_list)}
    return jax_tok, port


def _jax_encode(sym, entries, monotone):
    hkeys, hrank, hout, max_probe = jbe.build_rank_hash(entries)
    merged = jbe.bpe_encode(jnp.asarray(sym), jnp.asarray(hkeys),
                            jnp.asarray(hrank), jnp.asarray(hout),
                            monotone, max_probe)
    return np.asarray(merged)


def _port_encode(sym, entries, monotone, fn=tbe.bpe_encode):
    hkeys, hrank, hout, max_probe = tbe.build_rank_hash(entries)
    merged, out_n = fn(
        *(torch.from_numpy(a) for a in (sym, hkeys, hrank, hout)),
        monotone, max_probe)
    return merged.numpy(), out_n.numpy()


def _ref_encode(sym, entries, monotone):
    return _port_encode(sym, entries, monotone, fn=tbe.bpe_encode_ref)


@pytest.mark.parametrize("seed,n", [(0, 1), (1, 7), (2, 300), (3, 5000)])
def test_build_rank_hash_equals_jax(seed, n):
    rng = np.random.default_rng(seed)
    keys = rng.choice(1 << 40, size=n, replace=False)
    entries = [(int(k), i, int(rng.integers(0, 1 << 20)))
               for i, k in enumerate(keys)]
    want = jbe.build_rank_hash(entries)
    got = tbe.build_rank_hash(entries)
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert got[3] == want[3]


@pytest.mark.parametrize("monotone", [True, False])
@pytest.mark.parametrize("seed,W,L,n_sym,n_merges", [
    (10, 400, 12, 5, 30), (11, 300, 33, 4, 60), (12, 200, 8, 2, 6),
    (13, 64, 1, 3, 4), (14, 500, 24, 9, 200)])
def test_merge_loop_equals_jax(monotone, seed, W, L, n_sym, n_merges):
    """Random rows with runs, PAD at the end, unseen ids and lengths 0, 1
    and L through the wrapper: merged rows equal, and out_n counts them.
    Rows with PAD inside too through the plain version, which keeps the
    JAX program's lockstep loop for them."""
    rng = np.random.default_rng(seed)
    sym, entries = bpe_random_case(rng, W, L, n_sym, n_merges)
    want = _jax_encode(sym, entries, monotone)
    merged, out_n = _port_encode(sym, entries, monotone)
    assert np.array_equal(merged, want)
    assert np.array_equal(out_n, (want >= 0).sum(axis=1))
    sym, entries = bpe_random_case(rng, W, L, n_sym, n_merges,
                                   inner_pad=True)
    want = _jax_encode(sym, entries, monotone)
    merged, out_n = _ref_encode(sym, entries, monotone)
    assert np.array_equal(merged, want)
    assert np.array_equal(out_n, (want >= 0).sum(axis=1))


@pytest.mark.parametrize("monotone", [True, False])
@pytest.mark.parametrize("L", [1, 2, 31, 32, 33, 64, 65])
def test_widths_equal_jax(monotone, L):
    """The kernel's layouts by width (a row in registers up to 32, 64 and
    128 columns a warp): random rows through the wrapper, exactly as JAX
    merges them."""
    rng = np.random.default_rng(L)
    sym, entries = bpe_random_case(rng, 300, L, 4, 40)
    want = _jax_encode(sym, entries, monotone)
    merged, out_n = _port_encode(sym, entries, monotone)
    assert np.array_equal(merged, want)
    assert np.array_equal(out_n, (want >= 0).sum(axis=1))


@pytest.mark.parametrize("monotone", [True, False])
@pytest.mark.parametrize("L", [33, 40, 70, 130])
def test_long_self_pair_runs(monotone, L):
    """Runs of one symbol longer than a warp's 32 columns, merged
    pairwise again and again: the parity rule across chunks of 32,
    exactly as JAX merges them."""
    sym, entries = self_pair_case(np.random.default_rng(L), 64, L)
    assert (sym == 0).sum(axis=1).max() == L
    want = _jax_encode(sym, entries, monotone)
    merged, out_n = _port_encode(sym, entries, monotone)
    assert np.array_equal(merged, want)
    assert np.array_equal(out_n, (want >= 0).sum(axis=1))
    assert (want[0] >= 0).sum() <= (L + 1) // 2  # the full run merged


def test_greedy_and_monotone_differ_on_random_ranks():
    rng = np.random.default_rng(14)
    sym, entries = bpe_random_case(rng, 500, 24, 9, 200)
    assert not np.array_equal(_port_encode(sym, entries, True)[0],
                              _port_encode(sym, entries, False)[0])


@pytest.mark.parametrize("monotone", [True, False])
def test_self_pair_runs(monotone):
    """Runs a^k of odd and even k: only pairs at even offsets of a run
    merge, as the reference's left-to-right pass does; in the plain
    version a PAD inside a row ends a run too."""
    L = 12
    sym = np.full((L + 3, L), -1, dtype=np.int32)
    for k in range(1, L + 1):
        sym[k, :k] = 0
    sym[L + 1, :8] = [1, 0, 0, 0, 1, 0, 0, 0]
    sym[L + 2, :9] = [1, 0, 0, 0, 1, 0, 0, -1, 0]
    entries = [((0 << 21) | 0, 0, 2), ((2 << 21) | 2, 1, 3)]
    want = _jax_encode(sym, entries, monotone)
    assert np.array_equal(_ref_encode(sym, entries, monotone)[0], want)
    merged, _ = _port_encode(sym[:L + 2], entries, monotone)
    assert np.array_equal(merged, want[:L + 2])
    # a^5: greedy merges (aa)(aa)a, then (aaaa)a; monotone stops after
    # rank 1 as well
    assert merged[5].tolist()[:3] == [3, 0, -1]


def test_wrapper_checks():
    sym = torch.zeros(2, 4, dtype=torch.int32)
    hk, hr, ho, mp = (torch.from_numpy(a) if isinstance(a, np.ndarray)
                      else a for a in tbe.build_rank_hash([(1, 0, 2)]))
    with pytest.raises(TypeError):
        tbe.bpe_encode(sym.to(torch.int64), hk, hr, ho, True, mp)
    with pytest.raises(ValueError):
        tbe.bpe_encode(sym, hk[:6], hr[:6], ho[:6], True, mp)
    with pytest.raises(ValueError):
        tbe.bpe_encode(sym.to("meta"), hk.to("meta"), hr.to("meta"),
                       ho.to("meta"), True, mp)
    # the rows' layout: PAD (-1) only at the right end
    for row in ([0, -1, 0, -1], [-1, 0, 0, 0], [0, 0, -2, -1]):
        bad = torch.tensor([[0, 0, -1, -1], row], dtype=torch.int32)
        with pytest.raises(ValueError, match="PAD before an id"):
            tbe.bpe_encode(bad, hk, hr, ho, False, mp)
    tbe.bpe_encode(torch.tensor([[0, 0, -1, -1], [-1] * 4],
                                dtype=torch.int32), hk, hr, ho, False, mp)
    # wider rows: an id below -1, a PAD before an id within and across
    # the chunks of 32 columns the kernel loads
    wide = torch.zeros(3, 70, dtype=torch.int32)
    wide[1, 60:] = -1
    tbe.bpe_encode(wide, hk, hr, ho, True, mp)
    for cols, v in ((slice(50, 51), -2), (slice(40, 41), -1),
                    (slice(10, 32), -1), (slice(0, 1), -1)):
        bad = wide.clone()
        bad[2, cols] = v
        with pytest.raises(ValueError, match="PAD before an id"):
            tbe.bpe_encode(bad, hk, hr, ho, True, mp)


@pytest.mark.parametrize("name", ["FastBPE", "NaiveBPE"])
@pytest.mark.parametrize("order", ["golden", "shuffled"])
def test_tokenize_batch_equals_jax(corpus, lists, name, order):
    """The first 3,000 sentences: equal to the JAX package's token lists
    and to its digest."""
    jax_tok, port = _pair(name, lists[order])
    got = port.tokenize_batch(corpus[:N])
    assert got == jax_tok.tokenize_batch(corpus[:N])
    exp = EXPECT[f"{name}_{order}"]
    assert _digest(got) == exp["small_sha256"]
    assert sum(map(len, got)) == exp["small_tokens"]


@pytest.mark.parametrize("name", ["FastBPE", "NaiveBPE"])
@pytest.mark.parametrize("order", ["golden", "shuffled"])
def test_whole_corpus_equals_jax_digest(corpus, lists, name, order):
    _, port = _pair(name, lists[order])
    got = port.tokenize_batch(corpus)
    exp = EXPECT[f"{name}_{order}"]
    assert sum(map(len, got)) == exp["full_tokens"]
    assert _digest(got) == exp["full_sha256"]


def test_golden_counts():
    """The JAX package's whole-corpus goldens; the two encoders agree on
    the trained order and not on the shuffled one."""
    assert EXPECT["NaiveBPE_golden"]["full_tokens"] == 1_707_179
    assert EXPECT["FastBPE_golden"]["full_sha256"].startswith("5b853c3105ba")
    assert EXPECT["NaiveBPE_golden"] == EXPECT["FastBPE_golden"]
    assert (EXPECT["NaiveBPE_shuffled"]["small_tokens"],
            EXPECT["FastBPE_shuffled"]["small_tokens"]) == (115_230, 102_348)


@pytest.mark.parametrize("name", ["FastBPE", "NaiveBPE"])
def test_tokenize_and_encode_word_equal_jax(corpus, lists, name):
    jax_tok, port = _pair(name, lists["shuffled"])
    batch = port.tokenize_batch(corpus[:40])
    for i, s in enumerate(corpus[:40]):
        assert port.tokenize(s) == jax_tok.tokenize(s) == batch[i]
    for w in ["", "a", "zażółć", "aaaaaaa", "1999", "ß♥x", "naïve"]:
        assert port.encode_word(w) == jax_tok.encode_word(w)


@pytest.mark.parametrize("name", ["FastBPE", "NaiveBPE"])
def test_unseen_characters_and_edges(lists, name):
    """Characters no merge knows get fresh ids and merge with nothing;
    empty and whitespace-only sentences give empty lists."""
    jax_tok, port = _pair(name, lists["golden"])
    batch = ["ß♥ ünïcødé 😀x", "", "   \t ", "the the theory", "ab" * 20,
             "a-b,c.d", "ΣΟΦΙΑ σας"]
    got = port.tokenize_batch(batch)
    assert got == jax_tok.tokenize_batch(batch)
    assert got == [port.tokenize(s) for s in batch]
    assert port.tokenize_batch([]) == jax_tok.tokenize_batch([]) == []
    assert port.tokenize_batch(["", " "]) == [[], []]


def test_duplicate_merges_take_the_host_route(corpus, lists, monkeypatch):
    """NaiveBPE with a merge listed twice encodes on the host (applying
    every merge in order is then not the cursor rule): the merge-loop
    wrapper is not called, and the output equals the JAX digest."""
    calls = []
    real = port_bpe.bpe_encode

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(port_bpe, "bpe_encode", spy)
    _, port = _pair("NaiveBPE", lists["duplicated"])
    got = port.tokenize_batch(corpus[:N])
    assert not calls
    assert _digest(got) == EXPECT["NaiveBPE_duplicated"]["small_sha256"]
    # FastBPE ranks by dict: the same list keeps the kernel route
    _, fast = _pair("FastBPE", lists["duplicated"])
    fast.tokenize_batch(corpus[:10])
    assert calls


@pytest.mark.parametrize("name", ["FastBPE", "NaiveBPE"])
def test_reset_and_load_resources_drop_stale_tables(tmp_path, name):
    port = CLASSES[name][1](device="cpu")
    port.save_resources(str(tmp_path / "none"))
    with open(tmp_path / "merges.json", "w", encoding="utf-8") as f:
        json.dump([["a", "b"], ["ab", "c"]], f)
    port.load_resources(str(tmp_path))
    assert port.tokenize_batch(["abc ab"]) == [["abc", "ab"]]
    assert port.tokenize("abc") == ["abc"]
    stale = port._device_tables()
    port.load_resources(str(tmp_path / "none"))
    assert port._bpe_state is None and port._encode_cache == {}
    assert port.tokenize_batch(["abc ab"]) == [["a", "##b", "##c",
                                                 "a", "##b"]]
    assert port.tokenize("abc") == ["a", "##b", "##c"]
    assert port._device_tables() is not stale
    port.load_resources(str(tmp_path))
    port.reset()
    assert port.tokenize_batch(["ab"]) == [["a", "##b"]]
    # FastBPE's host encoder keeps the loaded ranks after reset, as the
    # JAX package's does; NaiveBPE's has no merge left
    assert port.tokenize("ab") == (["ab"] if name == "FastBPE"
                                   else ["a", "##b"])


def test_port_encoders_import_no_jax():
    code = (
        "import sys\n"
        "from subword_tokenizers_tpu_torch import FastBPE, NaiveBPE, "
        "NaiveWP\n"
        "for cls in (FastBPE, NaiveBPE):\n"
        "    t = cls(device='cpu')\n"
        "    t.merges_list = [('a', 'b'), ('ab', 'c')]\n"
        "    assert t.tokenize_batch(['abc x']) == [['abc', 'x']]\n"
        "wp = NaiveWP(device='cpu')\n"
        "wp.vocab = {'ab', '##c', 'x'}\n"
        "assert wp.tokenize_batch(['abc y']) == [['ab', '##c', '[UNK]']]\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'subword_tokenizers_tpu.')) or m == "
        "'subword_tokenizers_tpu']\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
