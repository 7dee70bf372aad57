"""FastWP's fused scan of the PyTorch port
(ops/wp_encode_e2e.wp_e2e_scan_compact: kernel 1 with kernel 2's
compaction in its epilogue) against the JAX package's
``wp_e2e_scan_u16_stacked`` at one slice, and, for i32 words and the
general route's parameters, against its ``wp_e2e_scan`` /
``wp_e2e_encode`` followed by ``ops/fetch.compact_ids``, on the CPU,
where the wrapper runs its plain PyTorch version. Also the node records
the kernel reads against JAX's ``pack_node_info``, the wrapper's checks,
and the models' routes through it. Inputs come from numpy seeds; exact
equality."""
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import emitted, random_case
from subword_tokenizers_tpu import FastWP as JaxFastWP
from subword_tokenizers_tpu.ops import fetch as jfetch
from subword_tokenizers_tpu.ops import wp_encode as jwe
from subword_tokenizers_tpu.ops import wp_encode_e2e as je2e
from subword_tokenizers_tpu_torch import FastWP
from subword_tokenizers_tpu_torch._native import binding
from subword_tokenizers_tpu_torch.models.state import e2e_state_from_numpy
from subword_tokenizers_tpu_torch.ops import wp_encode_e2e as te2e
from subword_tokenizers_tpu_torch.ops.wp_encode import pack_words

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")


def _flags(ovf, stuck, crash, out2d, out_n):
    """The flags byte of JAX outputs (numpy), sawneg2 over the emitted
    prefix."""
    out2d, out_n = np.asarray(out2d), np.asarray(out_n)
    cols = np.arange(out2d.shape[1])[None, :]
    neg2 = ((cols < out_n[:, None]) & (out2d == -2)).any(axis=1)
    return (np.asarray(ovf).astype(np.int32)
            | (np.asarray(stuck).astype(np.int32) << 1)
            | (np.asarray(crash).astype(np.int32) << 2)
            | (neg2.astype(np.int32) << 3))


def _assert_stream(ids, head, out_n, cap, j_ids, j_offs, j_total, j_flags,
                   mask=None):
    """The port's (ids, head) equal JAX's stream, offsets, total and flags;
    ``mask`` compares the ids in JAX's u16."""
    R = out_n.shape[0]
    out_n = torch.from_numpy(np.asarray(out_n).astype(np.int32))
    assert np.array_equal(head[:R].numpy(), np.asarray(j_offs))
    assert int(head[R]) == int(j_total)
    assert np.array_equal(head[R + 1:].numpy(),
                          np.asarray(j_flags).astype(np.int32))
    j_ids = torch.from_numpy(np.asarray(j_ids).astype(np.int32))
    got = emitted(ids, head, out_n, cap)
    want = emitted(j_ids, head, out_n, cap)
    if mask is not None:
        got = got & mask
    assert torch.equal(got, want)


def _case(seed, S=384, W=24, hang=False, max_pops=6):
    rng = np.random.default_rng(seed)
    words, slen, tables, roots = random_case(
        rng, S=S, W=W, n_nodes=96, A=40, max_pops=max_pops,
        hang_sharp=hang)
    return words, slen, tables, roots


def _port_fused(chars, slen, tables, roots, **kw):
    return te2e.wp_e2e_scan_compact(
        torch.from_numpy(chars), torch.from_numpy(slen),
        *(torch.from_numpy(t) for t in tables[:4]), roots["root_p"],
        roots["root_sharp"], roots["unk_id"], torch.from_numpy(tables[4]),
        **kw)


@pytest.mark.parametrize("hang", [False, True])
@pytest.mark.parametrize("seed", [31, 32])
def test_fused_equals_jax_stacked(seed, hang):
    """u16 words on the packed route against wp_e2e_scan_u16_stacked:
    every flag (and the '##' hang marker's sawneg2) set on some row."""
    words, slen, tables, roots = _case(seed, hang=hang)
    goto, fail, pops_off, pops_flat, sharp = tables
    n_pops = int(np.diff(pops_off).max())
    info = je2e.pack_node_info(fail, pops_off, pops_flat, n_pops)
    mat16 = je2e.pack_u16(words)
    j_ids, j_out_n, j_flags, j_total = je2e.wp_e2e_scan_u16_stacked(
        jnp.asarray(mat16[None]), jnp.asarray(slen[None]),
        jnp.asarray(goto), jnp.asarray(info), roots["root_p"],
        roots["root_sharp"], roots["unk_id"], tuple(int(x) for x in sharp),
        n_pops)
    ids, head = _port_fused(mat16.view(np.int16), slen, tables, roots)
    j_out_n = np.asarray(j_out_n)
    offs = np.concatenate([[0], np.cumsum(j_out_n)[:-1]]).astype(np.int32)
    _assert_stream(ids, head, j_out_n, words.shape[1] + 4, j_ids, offs,
                   j_total, j_flags, mask=0xFFFF)
    flags = head[words.shape[0] + 1:].numpy()
    assert all((flags >> b & 1).any() for b in range(4 if hang else 3))


@pytest.mark.parametrize("general", [False, True])
@pytest.mark.parametrize("seed", [33, 34])
def test_fused_i32_and_general_equal_jax(seed, general):
    """i32 words on the packed route (JAX wp_e2e_scan) and the general
    route's parameters over wide pops (JAX wp_e2e_encode), each followed
    by JAX compact_ids."""
    words, slen, tables, roots = _case(seed, max_pops=11, hang=seed == 34)
    goto, fail, pops_off, pops_flat, sharp = tables
    n_pops = int(np.diff(pops_off).max())
    rargs = (roots["root_p"], roots["root_sharp"], roots["unk_id"])
    sharp_t = tuple(int(x) for x in sharp)
    if general:
        T = words.shape[1] - 1
        w = words[:, :T]
        slen = np.minimum(slen, T)
        res = jwe.wp_e2e_encode(
            jnp.asarray(w & te2e.AID_MASK),
            jnp.asarray((w & te2e.SP_BIT) != 0),
            jnp.asarray((w & te2e.PC_BIT) != 0), jnp.asarray(slen),
            *(jnp.asarray(t) for t in tables[:4]), *rargs, sharp_t, n_pops)
        params = te2e.route_params(T, general=True)
    else:
        info = je2e.pack_node_info(fail, pops_off, pops_flat, n_pops)
        res = je2e.wp_e2e_scan(jnp.asarray(words), jnp.asarray(slen),
                               jnp.asarray(goto), jnp.asarray(info), *rargs,
                               sharp_t, n_pops)
        params = te2e.route_params(words.shape[1], general=False)
    out2d, out_n, ovf, stuck, crash = res
    cap = params[0]
    assert out2d.shape[1] == cap
    j_ids, j_total = jfetch.compact_ids(out2d, out_n)
    j_out_n = np.asarray(out_n)
    offs = np.concatenate([[0], np.cumsum(j_out_n)[:-1]]).astype(np.int32)
    if general:
        # the general route's 2T+4 columns over the words [S, T+1]
        chars = pack_words(*(torch.from_numpy(a) for a in (
            w & te2e.AID_MASK, (w & te2e.SP_BIT) != 0,
            (w & te2e.PC_BIT) != 0))).numpy()
    else:
        chars = words
    ids, head = _port_fused(chars, slen, tables, roots, cap=cap,
                            max_steps=params[1], unk_ovf=params[2])
    _assert_stream(ids, head, j_out_n, cap, j_ids, offs, j_total,
                   _flags(ovf, stuck, crash, out2d, out_n), mask=0xFFFF)
    flags = head[words.shape[0] + 1:].numpy()
    assert (flags & 2).any() and (flags & 4).any()


@pytest.fixture(scope="module")
def real():
    """JAX FastWP with the port fixture vocab, the port's state of its
    trie, and the unique chunks of train-85k's first 2,000 sentences as
    u16 rows."""
    with open(os.path.join(GOLDEN, "port_t85k_fastwp_vocab.json"),
              encoding="utf-8") as f:
        vocab = json.load(f)
    with open(os.path.join(ROOT, "data", "train-85k.json"),
              encoding="utf-8") as f:
        corpus = json.load(f)[:2000]
    tok = JaxFastWP()
    tok.vocab = set(vocab)
    tok._build_e2e()
    trie, _ = tok._trie()
    st = e2e_state_from_numpy(
        trie.goto, trie.alpha, trie.fail, trie.pops_off, trie.pops_flat,
        trie.root_p, trie.root_sharp, tok._unk_id, tok._sharp_seq, "cpu")
    _, _, buf, off, ln = binding.encode_prep(corpus)
    Lc = -(-(int(ln.max()) + 2) // 8) * 8
    mat16 = binding.pack_u16_rows(buf, off, ln, Lc, st.alpha)
    return tok, trie, st, mat16, (ln + 1).astype(np.int32)


def test_fused_real_trie_equals_jax_stacked(real):
    """A real FastWP trie (the 8,043-token vocab) over the chunks of a
    slice of train-85k: the stream, offsets, total and flags."""
    tok, trie, st, mat16, slen = real
    n_pops = max(trie.max_pops, 1)
    info = je2e.pack_node_info(trie.fail, trie.pops_off, trie.pops_flat,
                               n_pops)
    sharp = tok._sharp_seq if tok._sharp_seq is not None else (-2,)
    j_ids, j_out_n, j_flags, j_total = je2e.wp_e2e_scan_u16_stacked(
        jnp.asarray(mat16[None]), jnp.asarray(slen[None]),
        jnp.asarray(trie.goto), jnp.asarray(info), trie.root_p,
        trie.root_sharp, tok._unk_id, tuple(sharp), n_pops)
    ids, head = te2e.wp_e2e_scan_compact(
        torch.from_numpy(mat16.view(np.int16)), torch.from_numpy(slen),
        st.goto, st.fail, st.pops_off, st.pops_flat, st.root_p,
        st.root_sharp, st.unk_id, st.sharp, rec=st.rec)
    j_out_n = np.asarray(j_out_n)
    offs = np.concatenate([[0], np.cumsum(j_out_n)[:-1]]).astype(np.int32)
    _assert_stream(ids, head, j_out_n, mat16.shape[1] + 4, j_ids, offs,
                   j_total, j_flags)
    assert int(head[mat16.shape[0]]) > mat16.shape[0]


def _assert_records(rec, fail, pops_off, pops_flat):
    n_pops = max(int(np.diff(pops_off).max()), te2e.REC_POPS)
    info = je2e.pack_node_info(fail, pops_off, pops_flat, n_pops)
    rec = rec.numpy()
    assert rec.shape == (fail.shape[0], te2e.REC_INTS)
    assert np.array_equal(rec[:, 0], info[:, 0])  # fail
    assert np.array_equal(rec[:, 1], info[:, 1])  # pop count
    assert np.array_equal(rec[:, 2], pops_off[:-1])
    assert np.array_equal(rec[:, 3:], info[:, 2:2 + te2e.REC_POPS])


def test_node_records_equal_jax_node_info(real):
    """Every node's record: fail, count and the inline pops equal JAX's
    pack_node_info columns, the CSR offset beside them; on the real trie
    and on random tables with pops wider than the record."""
    _, trie, st, _, _ = real
    _assert_records(st.rec, trie.fail, trie.pops_off, trie.pops_flat)
    for seed in (35, 36):
        _, _, tables, _ = _case(seed, max_pops=11)
        _, fail, pops_off, pops_flat, _ = tables
        assert np.diff(pops_off).max() > te2e.REC_POPS
        rec = te2e.node_records(*(torch.from_numpy(t) for t in
                                  (fail, pops_off, pops_flat)))
        _assert_records(rec, fail, pops_off, pops_flat)
    # a trie with no pops at all
    fail = np.array([-1, 0], dtype=np.int32)
    pops_off = np.zeros(3, dtype=np.int32)
    rec = te2e.node_records(torch.from_numpy(fail),
                            torch.from_numpy(pops_off),
                            torch.zeros(0, dtype=torch.int32))
    assert rec.tolist() == [[-1] + [0] * 7, [0] * 8]


def test_tile_layout():
    """A block's rows: 128 at the main path's 32 x 36 u16, fewer as rows
    widen, 0 (staging in device memory) past one warp's rows; strides of
    an odd count of 4-byte words, at least a row wide."""
    assert te2e.tile_layout(32, 36, 2) == (128, 34, 37)
    assert te2e.tile_layout(40, 84, 4)[0] == 128
    assert te2e.tile_layout(300, 304, 2)[0] == 96
    assert te2e.tile_layout(700, 704, 2)[0] == 32
    assert te2e.tile_layout(1100, 1104, 2)[0] == 0
    for W in (7, 8, 64, 300, 1001, 5000):
        for wb in (2, 4):
            rows, ws, st = te2e.tile_layout(W, W + 4, wb)
            assert rows % 32 == 0 and 0 <= rows <= te2e.MAX_TILE_ROWS
            assert ws >= W and st >= W + 4 and st % 2 == 1
            assert (ws * wb // 4) % 2 == 1 and ws * wb % 4 == 0


def test_fused_empty_batch(real):
    _, _, st, _, _ = real
    ids, head = te2e.wp_e2e_scan_compact(
        torch.zeros(0, 8, dtype=torch.int16),
        torch.zeros(0, dtype=torch.int32), st.goto, st.fail, st.pops_off,
        st.pops_flat, st.root_p, st.root_sharp, st.unk_id, st.sharp)
    assert ids.shape == (0,) and head.tolist() == [0]


def test_fused_rejects_bad_input(real):
    _, _, st, _, _ = real
    args = (st.goto, st.fail, st.pops_off, st.pops_flat, st.root_p,
            st.root_sharp, st.unk_id, st.sharp)
    slen = torch.ones(2, dtype=torch.int32)
    chars = torch.zeros(2, 8, dtype=torch.int16)
    with pytest.raises(TypeError):
        te2e.wp_e2e_scan_compact(chars.to(torch.int64), slen, *args)
    with pytest.raises(ValueError):
        te2e.wp_e2e_scan_compact(torch.zeros(8, 2, dtype=torch.int32).t(),
                                 slen, *args)
    with pytest.raises(ValueError):
        te2e.wp_e2e_scan_compact(torch.zeros(3, 8, dtype=torch.int16), slen,
                                 *args)
    with pytest.raises(ValueError):  # a record of the wrong width
        te2e.wp_e2e_scan_compact(chars, slen, *args, rec=st.rec[:, :4]
                                 .contiguous())
    with pytest.raises(ValueError):  # a record off a 16-byte boundary
        flat = torch.zeros(st.rec.numel() + 1, dtype=torch.int32)
        te2e.wp_e2e_scan_compact(chars, slen, *args,
                                 rec=flat[1:].view(st.rec.shape))


def _spy(monkeypatch, module, name, calls):
    fn = getattr(module, name)

    def spy(*a, **k):
        calls[name] = calls.get(name, 0) + 1
        return fn(*a, **k)

    monkeypatch.setattr(module, name, spy)


def test_models_call_the_fused_scan(monkeypatch):
    """FastWP's packed route and its sharded route each make one fused
    call a device and no call of the rows form or of kernel 2; the
    whole-sentence route keeps the rows form and kernel 2."""
    from subword_tokenizers_tpu_torch.models import base, wordpiece
    from subword_tokenizers_tpu_torch.ops import wp_encode
    from subword_tokenizers_tpu_torch.parallel import encode
    from subword_tokenizers_tpu_torch.parallel.mesh import make_data_mesh
    calls = {}
    _spy(monkeypatch, wordpiece, "wp_e2e_scan_compact", calls)
    _spy(monkeypatch, encode, "wp_e2e_scan_compact", calls)
    _spy(monkeypatch, wp_encode, "wp_e2e_scan", calls)
    _spy(monkeypatch, base, "compact_ids", calls)
    vocab = {"a", "##b", "ab", "b", "##a", "x", "!", "##!"}
    texts = ["ab a! x", "b ab", "qq ab", "a"]
    want = None
    for mesh in (None, make_data_mesh(4, devices=["cpu"] * 4)):
        tok = FastWP(mesh=mesh, device="cpu")
        tok.vocab = set(vocab)
        tok._build_e2e()
        calls.clear()
        got = tok.tokenize_batch(texts)
        n = 1 if mesh is None else 4
        assert calls == {"wp_e2e_scan_compact": n}, calls
        want = want or got
        assert got == want
    tok = FastWP(device="cpu")
    tok.vocab = {"a b", "a", "b", "##b", "!", "c"}
    tok._build_e2e()
    calls.clear()
    tok.tokenize_batch(["a b!", "c a b !", "", "b c!"])
    assert calls == {"wp_e2e_scan": 1, "compact_ids": 1}, calls
