"""Kernel 1 of the PyTorch port (ops/wp_encode_e2e.wp_e2e_scan, and
ops/wp_encode.wp_e2e_encode on the general route) against the JAX
package's scan programs, on the CPU, where the wrapper runs its plain
PyTorch version. Inputs come from numpy seeds and go to both sides as
the same arrays; the JAX side gets its packed node table, the port the
CSR pops. All five outputs (out, out_n, ovf, stuck, crash) must be
equal exactly."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import random_case
from subword_tokenizers_tpu import FastWP as JaxFastWP
from subword_tokenizers_tpu.frontend.charclass import PUNC_PY, WS_PY, \
    codepoints
from subword_tokenizers_tpu.ops import wp_encode as jwe
from subword_tokenizers_tpu.ops import wp_encode_e2e as je2e
from subword_tokenizers_tpu_torch.models.state import e2e_state_from_numpy
from subword_tokenizers_tpu_torch.ops import wp_encode as twe
from subword_tokenizers_tpu_torch.ops import wp_encode_e2e as te2e

torch.set_num_threads(1)


def _jax_fastwp(vocab):
    tok = JaxFastWP()
    tok.vocab = set(vocab)
    tok._build_e2e()
    return tok


def _state(tok):
    """The JAX FastWP's trie, fed into the port's device state."""
    trie, _ = tok._trie()
    return trie, e2e_state_from_numpy(
        trie.goto, trie.alpha, trie.fail, trie.pops_off, trie.pops_flat,
        trie.root_p, trie.root_sharp, tok._unk_id, tok._sharp_seq, "cpu")


def _rows(texts, T=None):
    """Padded codepoint rows of ``text + ' '`` and their lengths."""
    slen = np.array([len(t) + 1 for t in texts], dtype=np.int32)
    T = T or int(slen.max()) + 1
    cps = np.full((len(texts), T), 32, dtype=np.uint32)
    for r, t in enumerate(texts):
        cps[r, :len(t)] = codepoints(t)
    return cps, slen


def _seeded_texts(seed, alphabet, n, max_len):
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(list(alphabet), size=rng.integers(0, max_len)))
            for _ in range(n)]


def _assert_same(jax_out, port_out):
    names = ("out", "out_n", "ovf", "stuck", "crash")
    for name, a, b in zip(names, jax_out, port_out):
        a = np.asarray(a)
        b = b.numpy()
        assert a.shape == b.shape, name
        assert np.array_equal(a.astype(np.int64), b.astype(np.int64)), name


def _packed_both(tok, cps, slen):
    """JAX wp_e2e_scan and wp_e2e_scan_u16 vs the port's scan on the same
    packed rows; returns the port's outputs."""
    trie, st = _state(tok)
    n_pops = max(trie.max_pops, 1)
    info = je2e.pack_node_info(trie.fail, trie.pops_off, trie.pops_flat,
                               n_pops)
    sharp = tok._sharp_seq if tok._sharp_seq is not None else (-2,)
    classes = (trie.alpha[cps], WS_PY[cps], PUNC_PY[cps])
    pchar = je2e.pack_chars(*classes)
    t_pchar = te2e.pack_chars(*classes)
    assert np.array_equal(t_pchar, pchar)
    jargs = (jnp.asarray(trie.goto), jnp.asarray(info), trie.root_p,
             trie.root_sharp, tok._unk_id, tuple(sharp), n_pops)
    targs = (st.goto, st.fail, st.pops_off, st.pops_flat, st.root_p,
             st.root_sharp, st.unk_id, st.sharp)
    slen_t = torch.from_numpy(slen)
    want = je2e.wp_e2e_scan(jnp.asarray(pchar), jnp.asarray(slen), *jargs)
    got = te2e.wp_e2e_scan(torch.from_numpy(t_pchar), slen_t, *targs)
    _assert_same(want, got)
    p16 = je2e.pack_u16(pchar)
    t_p16 = te2e.pack_u16(t_pchar)
    assert t_p16.dtype == np.uint16 and np.array_equal(t_p16, p16)
    want16 = je2e.wp_e2e_scan_u16(jnp.asarray(p16), jnp.asarray(slen),
                                  *jargs)
    got16 = te2e.wp_e2e_scan(torch.from_numpy(t_p16.view(np.int16)), slen_t,
                             *targs)
    _assert_same(want16, got16)
    return got


def _general_both(tok, cps, slen):
    trie, st = _state(tok)
    sharp = tok._sharp_seq if tok._sharp_seq is not None else (-2,)
    acp, is_sp, is_pc = trie.alpha[cps], WS_PY[cps], PUNC_PY[cps]
    want = jwe.wp_e2e_encode(
        jnp.asarray(acp), jnp.asarray(is_sp), jnp.asarray(is_pc),
        jnp.asarray(slen), jnp.asarray(trie.goto), jnp.asarray(trie.fail),
        jnp.asarray(trie.pops_off), jnp.asarray(trie.pops_flat),
        trie.root_p, trie.root_sharp, tok._unk_id, tuple(sharp),
        max(trie.max_pops, 1))
    got = twe.wp_e2e_encode(
        *(torch.from_numpy(a) for a in (acp, is_sp, is_pc, slen)),
        st.goto, st.fail, st.pops_off, st.pops_flat, st.root_p,
        st.root_sharp, st.unk_id, st.sharp)
    _assert_same(want, got)
    return got


TOY = {"a", "##b", "ab", "b", "##a", "x", "!", "##!", "abx", "##", "ß"}


def test_packed_route_seeded_rows():
    """OOV, punctuation, '#' and the '##' corner on the packed route."""
    tok = _jax_fastwp(TOY)
    texts = _seeded_texts(1, "abx!#ßqz.", 300, 14) + ["##", "a##", "q!"]
    cps, slen = _rows(texts)
    got = _packed_both(tok, cps, slen)
    assert int(got[1].max()) > 0


def test_packed_route_sharp_hang_marker():
    """encode_word('##') would not terminate: the scan emits -2."""
    tok = _jax_fastwp({"#", "s", "a"})
    assert tok._sharp_seq is None
    cps, slen = _rows(["##", "s ## a", "a", "#s"])
    got = _packed_both(tok, cps, slen)
    assert (got[0] == -2).any()


def test_general_route_wide_pops():
    tok = _jax_fastwp({"a", "##a", "a" * 12 + "z", "!"})
    assert tok._trie()[0].max_pops == 11
    texts = _seeded_texts(2, "aaaaz! ¤", 200, 40)
    cps, slen = _rows(texts)
    got = _general_both(tok, cps, slen)
    assert got[3].any()  # '¤' rows get stuck


def test_general_route_seeded_rows():
    tok = _jax_fastwp(TOY)
    cps, slen = _rows(_seeded_texts(3, "abx!#ß q", 200, 20))
    _general_both(tok, cps, slen)


def test_hang_row():
    """Vocab {'a'} and '¤': the reference loops forever; stuck is set."""
    tok = _jax_fastwp({"a"})
    cps, slen = _rows(["¤", "a", "a ¤"])
    for got in (_packed_both(tok, cps, slen),
                _general_both(tok, cps, slen)):
        assert got[3].tolist() == [True, False, True]


def test_crash_row():
    """A whitespace-bearing token lets the match eat the trailing space:
    the boundary check past the end would crash the reference."""
    tok = _jax_fastwp({"a ", "a", "b"})
    cps, slen = _rows(["a", "b", "b a", "a!"])
    for got in (_packed_both(tok, cps, slen),
                _general_both(tok, cps, slen)):
        assert got[4].any() and not got[4].all()


def _random_both(seed, general):
    rng = np.random.default_rng(seed)
    words, slen, tables, roots = random_case(
        rng, S=384, W=24, n_nodes=96, A=40, max_pops=11,
        hang_sharp=seed % 2 == 1)
    goto, fail, pops_off, pops_flat, sharp = tables
    n_pops = int(np.diff(pops_off).max())
    targs = [torch.from_numpy(t) for t in tables]
    rargs = (roots["root_p"], roots["root_sharp"], roots["unk_id"])
    if general:
        T = words.shape[1] - 1
        aid = words[:, :T] & te2e.AID_MASK
        is_sp = (words[:, :T] & te2e.SP_BIT) != 0
        is_pc = (words[:, :T] & te2e.PC_BIT) != 0
        slen = np.minimum(slen, T)
        want = jwe.wp_e2e_encode(
            jnp.asarray(aid), jnp.asarray(is_sp), jnp.asarray(is_pc),
            jnp.asarray(slen), *(jnp.asarray(t) for t in tables[:4]),
            *rargs, tuple(int(x) for x in sharp), n_pops)
        got = twe.wp_e2e_encode(
            *(torch.from_numpy(a) for a in (aid, is_sp, is_pc, slen)),
            *targs[:4], *rargs, targs[4])
    else:
        info = je2e.pack_node_info(fail, pops_off, pops_flat, n_pops)
        want = je2e.wp_e2e_scan(
            jnp.asarray(words), jnp.asarray(slen), jnp.asarray(goto),
            jnp.asarray(info), *rargs, tuple(int(x) for x in sharp), n_pops)
        got = te2e.wp_e2e_scan(torch.from_numpy(words),
                               torch.from_numpy(slen), *targs[:4], *rargs,
                               targs[4])
    _assert_same(want, got)
    return got


@pytest.mark.parametrize("general", [False, True])
@pytest.mark.parametrize("seed", [11, 12])
def test_random_tables_every_flag(seed, general):
    """Random tries with failure cycles and wide pops: overflow and stuck
    rows, and the '##' corner, against JAX on both routes."""
    out, out_n, ovf, stuck, crash = _random_both(seed, general)
    assert stuck.any() and crash.any() and (~stuck).any()
    if not general:
        assert ovf.any()


def test_empty_batch():
    tok = _jax_fastwp(TOY)
    _, st = _state(tok)
    got = te2e.wp_e2e_scan(torch.zeros(0, 8, dtype=torch.int16),
                           torch.zeros(0, dtype=torch.int32), st.goto,
                           st.fail, st.pops_off, st.pops_flat, st.root_p,
                           st.root_sharp, st.unk_id, st.sharp)
    assert [tuple(t.shape) for t in got] == [(0, 12), (0,), (0,), (0,),
                                             (0,)]


def test_wrapper_rejects_bad_input():
    tok = _jax_fastwp(TOY)
    _, st = _state(tok)
    args = (st.goto, st.fail, st.pops_off, st.pops_flat, st.root_p,
            st.root_sharp, st.unk_id, st.sharp)
    slen = torch.ones(2, dtype=torch.int32)
    with pytest.raises(TypeError):
        te2e.wp_e2e_scan(torch.zeros(2, 8, dtype=torch.int64), slen, *args)
    with pytest.raises(ValueError):
        te2e.wp_e2e_scan(torch.zeros(8, 2, dtype=torch.int32).t(), slen,
                         *args)
    with pytest.raises(ValueError):
        te2e.wp_e2e_scan(torch.zeros(3, 8, dtype=torch.int32), slen, *args)
