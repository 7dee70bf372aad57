"""K3 (ops/flat.py ``merge_apply``) with the scratch its kernel keeps
between calls: a :class:`MergeScratch` owned by the flat state (the
merge's weight word, two tickets and a look-back status word a tile,
each call's words carrying a new epoch, one past the scratch's epoch
word on the device, which the call advances), so that a training step
allocates and clears nothing and a replayed block takes no host epoch. The kernel runs only on the card; here the
wrapper's plain version runs with the same scratch (its ``n_rep`` word
written each call) and is held against the JAX package's ``flat_apply``
and the carried update of ``flat_train_steps``; the wrapper's checks, the
epoch's wrap and the training loop's use of the state's scratch are
tested, and whole CPU trains equal the JAX package's merges. Every
comparison is exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from subword_tokenizers_tpu import NaiveBPE as JaxNaiveBPE
from subword_tokenizers_tpu import NaiveWP as JaxNaiveWP
from subword_tokenizers_tpu.ops import flat as jax_flat
from subword_tokenizers_tpu_torch import NaiveBPE, NaiveWP
from subword_tokenizers_tpu_torch.ops import flat, train_loop
from subword_tokenizers_tpu_torch.ops.flat import (EPOCH, EPOCH_MAX, GATE,
                                                   N_LIVE, TILE,
                                                   MergeScratch,
                                                   merge_apply)
from subword_tokenizers_tpu_torch.ops.pairstats import symbol_freqs
from test_torch_bpe_kernels import STATES, _merge_cases, random_state
from test_torch_flat_k1 import CORPUS

torch.set_num_threads(1)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("cfg", STATES)
def test_merge_with_scratch_matches_jax_flat_apply(cfg):
    """Each merge case twice on one scratch and one second buffer: the
    state, the live count and the weight word equal JAX's flat_apply."""
    fs, wid, wgt = random_state(**cfg)
    new_id = int(fs.max()) + 7
    sc = MergeScratch(fs.shape[0], "cpu")
    out = tuple(torch.empty_like(x) for x in _t(fs, wid, wgt))
    for a, b in _merge_cases(fs, wid, wgt):
        want = jax_flat.flat_apply(jnp.asarray(fs), jnp.asarray(wid),
                                   jnp.asarray(wgt), a, b, new_id)
        for _ in range(2):
            rec = torch.tensor([a, b, new_id, 0, 1, 0], dtype=torch.int32)
            got = merge_apply(*_t(fs, wid, wgt), rec, out=out, scratch=sc)
            for g, w in zip(got[:3], want[:3]):
                assert np.array_equal(g.numpy(), np.asarray(w)), (a, b)
            assert all(g is o for g, o in zip(got, out))
            assert int(rec[N_LIVE]) == int((np.asarray(want[0]) >= 0).sum())
            assert got[3].data_ptr() == sc.words.data_ptr()
            assert int(sc.n_rep) == int(want[3])


@pytest.mark.parametrize("cfg", STATES[:4])
def test_carried_weights_with_scratch(cfg):
    """WordPiece's carried update through the scratch path: n_rep off a
    and b, onto new_id, equal to a recount of the merged state and to
    JAX's n_rep; an inactive step leaves the weights alone."""
    fs, wid, wgt = random_state(**cfg)
    cap = int(fs.max()) + 12
    new_id = cap - 2
    sc = MergeScratch(fs.shape[0], "cpu")
    for a, b in _merge_cases(fs, wid, wgt):
        for active in (1, 0):
            sf = symbol_freqs(*_t(fs, wgt), cap)
            before = sf.clone()
            rec = torch.tensor([a, b, new_id, 0, active, 0],
                               dtype=torch.int32)
            nfs, _, nwgt, n_rep = merge_apply(*_t(fs, wid, wgt), rec,
                                              sym_freq=sf, scratch=sc)
            if active:
                want = jax_flat.flat_apply(jnp.asarray(fs), jnp.asarray(wid),
                                           jnp.asarray(wgt), a, b, new_id)
                assert int(n_rep) == int(want[3])
                assert sf.tolist() == symbol_freqs(nfs, nwgt, cap).tolist()
            else:
                assert int(n_rep) == 0 and sf.tolist() == before.tolist()


def test_weight_word_is_rewritten():
    """The returned weight is the scratch's word: the next call rewrites
    it (the caller keeps no earlier step's)."""
    fs, wid, wgt = _t(*random_state(seed=1))
    sc = MergeScratch(fs.shape[0], "cpu")
    a, b = _merge_cases(*(x.numpy() for x in (fs, wid, wgt)))[0]
    first = merge_apply(fs, wid, wgt, torch.tensor(
        [a, b, 50, 0, 1, 0], dtype=torch.int32), scratch=sc)[3]
    assert int(first) > 0
    merge_apply(fs, wid, wgt, torch.tensor([a, b, 50, 0, 0, 0],
                                           dtype=torch.int32), scratch=sc)
    assert int(first) == 0


@pytest.mark.parametrize("F,words", [(2, 6), (TILE, 6), (TILE + 1, 8),
                                     (5 * TILE, 14)])
def test_scratch_size(F, words):
    """Four words and two a tile of 2,048 slots (its look-back status and
    weight); a scratch for a narrower state is refused."""
    sc = MergeScratch(F, "cpu")
    assert sc.words.shape == (words,) and sc.words.dtype == torch.int64
    assert not sc.words.any() and sc.epoch == 0
    fs = torch.full((F + TILE,), -1, dtype=torch.int32)
    wid = torch.full_like(fs, flat.WID_PAD)
    wgt = torch.zeros(F + TILE, dtype=torch.int64)
    rec = torch.zeros(6, dtype=torch.int32)
    with pytest.raises(ValueError, match="scratch for a width below"):
        merge_apply(fs, wid, wgt, rec, scratch=sc)
    got = merge_apply(fs[:F], wid[:F], wgt[:F], rec, scratch=sc)
    assert got[0].tolist() == [-1] * F and int(rec[N_LIVE]) == 0


def test_scratch_checks():
    """A scratch of another type or on another device is refused."""
    fs, wid, wgt = _t(*random_state(seed=2))
    rec = torch.zeros(6, dtype=torch.int32)
    with pytest.raises(TypeError, match="MergeScratch"):
        merge_apply(fs, wid, wgt, rec, scratch=torch.zeros(
            8, dtype=torch.int64))
    other = MergeScratch(fs.shape[0], "meta")
    with pytest.raises(ValueError, match="scratch on meta"):
        merge_apply(fs, wid, wgt, rec, scratch=other)


def test_epochs_wrap_and_clear_status_words():
    """Each merge takes the epoch one past the device's epoch word and
    advances it, 1 .. EPOCH_MAX, and closes the gate; the host counts the
    calls, and before one could pass EPOCH_MAX the epochs restart: the
    epoch word and the status words are zeroed (the weight word, the
    ticket and the gate word are not touched)."""
    sc = MergeScratch(3 * TILE, "cpu")
    fs = torch.full((3 * TILE,), -1, dtype=torch.int32)
    state = (fs, torch.full_like(fs, flat.WID_PAD),
             torch.zeros(3 * TILE, dtype=torch.int64))
    rec = torch.zeros(6, dtype=torch.int32)
    epochs = []
    for _ in range(3):
        merge_apply(*state, rec, scratch=sc)
        epochs.append(sc.epoch)
    assert epochs == [1, 2, 3] and sc.calls == 3
    sc.words[:] = 7
    sc.words[EPOCH] = EPOCH_MAX - 1
    sc.calls = EPOCH_MAX - 1
    merge_apply(*state, rec, scratch=sc)
    assert sc.epoch == EPOCH_MAX and sc.calls == EPOCH_MAX
    assert int(sc.words[4:].min()) == 7 and int(sc.words[GATE]) == 0
    sc.words[GATE] = 5
    sc.advance()  # the next call could pass EPOCH_MAX: a restart first
    assert sc.calls == 1 and sc.epoch == 0
    assert sc.words[4:].tolist() == [0] * 6
    assert sc.words[:4].tolist() == [0, 7, 0, 5]
    merge_apply(*state, rec, scratch=sc)
    assert sc.epoch == 1


def test_flat_state_merges_with_its_scratch(monkeypatch):
    """FlatState builds one scratch for its width and passes it to every
    merge, across the shrink."""
    fs, wid, wgt = random_state(seed=3, n_words=300)
    st = train_loop.FlatState(fs, wid, wgt, "cpu")
    assert isinstance(st.scratch, MergeScratch)
    assert st.scratch.words.shape[0] == 4 + 2 * -(-st.F // TILE)
    seen = []
    real = train_loop.merge_apply

    def spy(*args, **kwargs):
        seen.append(kwargs.get("scratch"))
        return real(*args, **kwargs)

    monkeypatch.setattr(train_loop, "merge_apply", spy)
    a, b = _merge_cases(fs, wid, wgt)[0]
    rec = torch.tensor([a, b, 60, 0, 1, 0], dtype=torch.int32)
    st.merge(rec)
    st.F //= 2
    st.merge(torch.tensor([a, b, 61, 0, 0, 0], dtype=torch.int32))
    assert seen == [st.scratch, st.scratch]


@pytest.mark.parametrize("cls,jcls", [(NaiveBPE, JaxNaiveBPE),
                                      (NaiveWP, JaxNaiveWP)])
def test_trainers_merge_with_the_state_scratch(cls, jcls, monkeypatch):
    """A whole CPU train through run_fused: every merge gets the state's
    scratch, one scratch is built a state, and the merges equal the JAX
    package's."""
    built, seen = [], []

    class Counted(MergeScratch):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            built.append(self)

    real = train_loop.merge_apply

    def spy(*args, **kwargs):
        seen.append(kwargs.get("scratch"))
        return real(*args, **kwargs)

    monkeypatch.setattr(train_loop, "MergeScratch", Counted)
    monkeypatch.setattr(train_loop, "merge_apply", spy)
    tok = cls(device="cpu")
    tok.train(CORPUS, 60)
    want = jcls()
    want.train(CORPUS, 60)
    if cls is NaiveBPE:
        assert tok.merges_list == want.merges_list
    else:
        assert tok._merge_log == want._merge_log
    assert len(built) == 1 and len(seen) >= 10
    assert all(s is built[0] for s in seen)
