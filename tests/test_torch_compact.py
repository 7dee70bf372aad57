"""Kernel 2 of the PyTorch port (ops/fetch.compact_ids) against the JAX
package's compaction (ops/fetch.compact_ids) and the flags byte of its
fused scan (ops/wp_encode_e2e.wp_e2e_scan_u16_stacked), on the CPU,
where the wrapper runs its plain PyTorch version. Exact equality."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import emitted, random_case
from subword_tokenizers_tpu._native import binding as jbinding
from subword_tokenizers_tpu.ops import fetch as jfetch
from subword_tokenizers_tpu.ops import wp_encode_e2e as je2e
from subword_tokenizers_tpu_torch._native import binding as tbinding
from subword_tokenizers_tpu_torch.ops import fetch as tfetch
from subword_tokenizers_tpu_torch.ops import wp_encode_e2e as te2e

torch.set_num_threads(1)


def _port(out2d, out_n):
    no_flag = torch.zeros(out2d.shape[0], dtype=torch.bool)
    return tfetch.compact_ids(torch.from_numpy(out2d),
                              torch.from_numpy(out_n), no_flag, no_flag,
                              no_flag)


@pytest.mark.parametrize("R,cap,hi", [(300, 12, 12), (257, 9, 15),
                                      (40, 6, 0)])
def test_compact_equals_jax(R, cap, hi):
    """Dense stream and total; hi > cap makes overflowing counts, whose
    rows leave gaps, and hi = 0 gives total 0."""
    rng = np.random.default_rng(R)
    out2d = rng.integers(0, 5000, size=(R, cap)).astype(np.int32)
    out_n = rng.integers(0, hi + 1, size=R).astype(np.int32)
    j_ids, j_total = jfetch.compact_ids(jnp.asarray(out2d),
                                        jnp.asarray(out_n))
    ids, head = _port(out2d, out_n)
    total = int(head[R])
    assert total == int(j_total) == int(out_n.sum())
    assert torch.equal(head[:R], torch.from_numpy(
        np.concatenate([[0], np.cumsum(out_n)[:-1]]).astype(np.int32)))
    j_ids = torch.from_numpy(np.asarray(j_ids).astype(np.int32))
    n_t = torch.from_numpy(out_n)
    assert torch.equal(emitted(ids, head, n_t, cap),
                       emitted(j_ids, head, n_t, cap))
    if hi <= cap:
        assert torch.equal(ids[:total], j_ids[:total])
    assert not head[R + 1:].any()


@pytest.mark.parametrize("R", [1, 255, 256, 257, 3 * 256 + 7])
def test_compact_tile_edges_equal_jax(R):
    """Row counts at and across kernel 2's tiles of 256 rows
    (ops/fetch.TILE_ROWS), with rows that overflow their cap on both
    sides of a tile boundary: offsets, total and the emitted stream
    against JAX, the flags byte from the flags passed (None is false)."""
    cap = 7
    rng = np.random.default_rng(1000 + R)
    out2d = rng.integers(-3, 5000, size=(R, cap)).astype(np.int32)
    out_n = rng.integers(0, cap + 1, size=R).astype(np.int32)
    for r in (254, 255, 256, 257, 511, 512, R - 1):
        if 0 <= r < R:
            out_n[r] = cap + 5  # leaves a gap in the stream
    j_ids, j_total = jfetch.compact_ids(jnp.asarray(out2d),
                                        jnp.asarray(out_n))
    flags = [rng.random(R) < 0.3 for _ in range(3)]
    n_t = torch.from_numpy(out_n)
    j_ids = torch.from_numpy(np.asarray(j_ids).astype(np.int32))
    for passed in (flags, [None, flags[1], None]):
        ids, head = tfetch.compact_ids(
            torch.from_numpy(out2d), n_t,
            *(None if f is None else torch.from_numpy(f) for f in passed))
        assert int(head[R]) == int(j_total) == int(out_n.sum())
        assert torch.equal(head[:R], torch.from_numpy(np.concatenate(
            [[0], np.cumsum(out_n)[:-1]]).astype(np.int32)))
        assert torch.equal(emitted(ids, head, n_t, cap) & 0xFFFF,
                           emitted(j_ids, head, n_t, cap))
        want = sum((np.zeros(R, np.int32) if f is None else
                    f.astype(np.int32)) << b for b, f in enumerate(passed))
        cols = np.arange(cap)[None, :]
        want |= (((cols < out_n[:, None]) & (out2d == -2)).any(axis=1)
                 .astype(np.int32) << 3)
        assert np.array_equal(head[R + 1:].numpy(), want)


def test_compact_empty_batch():
    j_ids, j_total = jfetch.compact_ids(jnp.zeros((0, 8), jnp.int32),
                                        jnp.zeros((0,), jnp.int32))
    ids, head = _port(np.zeros((0, 8), np.int32), np.zeros(0, np.int32))
    assert ids.shape == (0,) and np.asarray(j_ids).shape == (0,)
    assert head.tolist() == [0] and int(j_total) == 0


@pytest.mark.parametrize("seed", [21, 22])
def test_flags_equal_jax_stacked_scan(seed):
    """Scan + compact against wp_e2e_scan_u16_stacked: flags byte
    (ovf | stuck<<1 | crash<<2 | sawneg2<<3), counts, total and the
    stream."""
    rng = np.random.default_rng(seed)
    words, slen, tables, roots = random_case(
        rng, S=256, W=24, n_nodes=96, A=40, max_pops=6,
        hang_sharp=seed % 2 == 0)
    goto, fail, pops_off, pops_flat, sharp = tables
    n_pops = int(np.diff(pops_off).max())
    info = je2e.pack_node_info(fail, pops_off, pops_flat, n_pops)
    mat16 = je2e.pack_u16(words)
    rargs = (roots["root_p"], roots["root_sharp"], roots["unk_id"])
    j_ids, j_out_n, j_flags, j_total = je2e.wp_e2e_scan_u16_stacked(
        jnp.asarray(mat16[None]), jnp.asarray(slen[None]),
        jnp.asarray(goto), jnp.asarray(info), *rargs,
        tuple(int(x) for x in sharp), n_pops)
    out = te2e.wp_e2e_scan(torch.from_numpy(mat16.view(np.int16)),
                           torch.from_numpy(slen),
                           *(torch.from_numpy(t) for t in tables[:4]),
                           *rargs, torch.from_numpy(sharp))
    ids, head = tfetch.compact_ids(*out)
    R = words.shape[0]
    flags = head[R + 1:].numpy()
    assert np.array_equal(flags, np.asarray(j_flags).astype(np.int32))
    hang = seed % 2 == 0  # sawneg2 needs the -2 marker
    assert all((flags >> b & 1).any() for b in range(4 if hang else 3))
    assert np.array_equal(out[1].numpy(), np.asarray(j_out_n))
    assert int(head[R]) == int(j_total)
    cap = out[0].shape[1]
    j_ids = torch.from_numpy(np.asarray(j_ids).astype(np.int32))
    assert torch.equal(emitted(ids, head, out[1], cap) & 0xFFFF,
                       emitted(j_ids, head, out[1], cap))


def test_stitch_of_compacted_stream_equals_jax():
    """The port's stream stitched by (offset, count) gives the token
    lists that the JAX package's padded-matrix stitch gives."""
    rng = np.random.default_rng(5)
    U, cap, S = 50, 7, 20
    strings = [f"t{i}" for i in range(100)]
    out2d = rng.integers(0, 100, size=(U, cap)).astype(np.int32)
    out_n = rng.integers(0, cap + 1, size=U).astype(np.int32)
    inverse = rng.integers(0, U, size=90).astype(np.int32)
    bounds = np.concatenate([[0], np.sort(rng.integers(0, 91, size=S - 1)),
                             [90]]).astype(np.int64)
    want = jbinding.stitch(strings, out2d, out_n, inverse, bounds)
    ids, head = _port(out2d, out_n)
    offs = head[:U + 1].numpy().astype(np.int64)
    got = tbinding.stitch_flat(strings, ids[:int(offs[U])].numpy(),
                               offs[:U], np.diff(offs).astype(np.int32),
                               inverse, bounds)
    assert got == want
    assert tbinding.stitch(strings, out2d, out_n, inverse, bounds) == want


def test_compact_rejects_bad_input():
    out2d = torch.zeros(4, 6, dtype=torch.int32)
    n = torch.zeros(4, dtype=torch.int32)
    b = torch.zeros(4, dtype=torch.bool)
    with pytest.raises(TypeError):
        tfetch.compact_ids(out2d.to(torch.int64), n, b, b, b)
    with pytest.raises(ValueError):
        tfetch.compact_ids(out2d, n[:3], b, b, b)


def test_stream_scratch_epochs():
    """The look-back words of the stream kernels: one scratch a device,
    grown (and zeroed) when a call has more tiles, its epoch new a call
    and back to 1, with the words zeroed, when it wraps."""
    sc = tfetch.stream_scratch(torch.device("cpu"))
    assert tfetch.stream_scratch(torch.device("cpu")) is sc
    words, e1 = sc.take(3)
    assert words.shape[0] >= 2 + 2 * 3
    _, e2 = sc.take(3)
    assert e2 == e1 + 1
    words, e3 = sc.take(500)
    assert words.shape[0] >= 2 + 2 * 500 and e3 == 1
    assert not words.any()
    words[5] = 7
    sc.epoch = tfetch.EPOCH_MAX
    words, e4 = sc.take(500)
    assert e4 == 1 and not words.any()
