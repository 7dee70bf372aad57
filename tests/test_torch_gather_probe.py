"""The gather probe (``tools/gather_probe.py``): the plain versions of
its two kernels at the TPU probe's full shapes against the TPU probe's
own NumPy references (``tools/pallas_probe.py``, re-stated here) and
against its kernel bodies' ``jnp.take_along_axis`` steps run by JAX on
the CPU outside Pallas; the int32 edge cases; the wrappers' checks; and
``main`` on the CPU. The CUDA kernels are held against the plain
versions on the card by ``chip_smoke.py`` (phase 16)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from subword_tokenizers_tpu_torch.tools import gather_probe as gp

N_TAB, ITERS = gp.LOOP_N_TAB, gp.LOOP_ITERS


def _take_numpy(tab, idx, col):
    # tools/pallas_probe.py:44
    return np.asarray(tab)[np.asarray(idx), np.asarray(col)]


def _loop_numpy(tab, idx):
    # tools/pallas_probe.py:84-87 (its table is [N_TAB, 1])
    t = np.asarray(tab)
    v = np.asarray(idx)
    for c in range(ITERS):
        v = (t[(v + c) % N_TAB] + v) % N_TAB
    return v


def _take_jax(tab, idx, col):
    # the body of probe_take's kernel, tools/pallas_probe.py:22-28
    tab, idx, col = jnp.asarray(tab), jnp.asarray(idx), jnp.asarray(col)
    idx2 = jnp.broadcast_to(idx[:, None], (idx.shape[0], tab.shape[1]))
    rows = jnp.take_along_axis(tab, idx2, axis=0)
    return np.asarray(jnp.take_along_axis(rows, col[:, None], axis=1)[:, 0])


def _loop_jax(tab, idx):
    # the body of probe_loop_gather's kernel, tools/pallas_probe.py:61-69
    tab = jnp.asarray(tab)[:, None]

    def body(c, st):
        g = jnp.take_along_axis(tab, ((st + c) % N_TAB)[:, None],
                                axis=0)[:, 0]
        return (g + st) % N_TAB

    return np.asarray(jax.lax.fori_loop(0, ITERS, body, jnp.asarray(idx)))


@pytest.mark.parametrize("seed", [gp.SEED, 0, 1])
def test_take2d_plain_equals_tpu_references(seed):
    tab, idx, col = gp.take_inputs(seed)
    assert tab.shape == (4096, 128) and idx.shape == col.shape == (1024,)
    got = gp.gather_take2d(*(torch.from_numpy(a) for a in (tab, idx, col)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _take_numpy(tab, idx, col))
    np.testing.assert_array_equal(got.numpy(), _take_jax(tab, idx, col))


@pytest.mark.parametrize("seed", [gp.SEED, 0, 1])
def test_loop_plain_equals_tpu_references(seed):
    tab, idx = gp.loop_inputs(seed)
    assert tab.shape == (50_000,) and idx.shape == (2048,)
    tab_t, idx_t = torch.from_numpy(tab), torch.from_numpy(idx)
    want = _loop_numpy(tab, idx)
    for shared in (False, True):
        got = gp.gather_loop(tab_t, idx_t, shared=shared)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, _loop_jax(tab, idx))
    # every value stays below 2 * N_TAB + ITERS: no int32 overflow
    assert int(want.max()) < N_TAB and int(want.min()) >= 0


def test_loop_plain_int32_edges():
    """Inputs outside the probe's range: int32 adds that wrap and floor
    remainders, as NumPy's int32 arithmetic gives them."""
    rng = np.random.default_rng(5)
    n = 97
    tab = rng.integers(-2 ** 31, 2 ** 31, size=n, dtype=np.int32)
    tab[:4] = [2 ** 31 - 1, -2 ** 31, -1, 0]
    idx = rng.integers(-2 ** 31, 2 ** 31, size=300, dtype=np.int32)
    idx[:3] = [2 ** 31 - 1, -2 ** 31, -5]
    got = gp.gather_loop(torch.from_numpy(tab), torch.from_numpy(idx), 40)
    v = idx.copy()
    with np.errstate(over="ignore"):
        for c in range(40):
            v = (tab[(v + np.int32(c)) % n] + v) % n
    np.testing.assert_array_equal(got.numpy(), v)


def test_take2d_outside_gives_minus_one():
    tab = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    idx = torch.tensor([0, 2, 3, -1, 1], dtype=torch.int32)
    col = torch.tensor([1, 3, 0, 0, 4], dtype=torch.int32)
    assert gp.gather_take2d(tab, idx, col).tolist() == [1, 11, -1, -1, -1]


def test_cpu_launches_nothing():
    before = (gp.gather_take2d.launches, gp.gather_loop.launches,
              gp.gather_loop.shared_launches)
    tab, idx = (torch.from_numpy(a) for a in gp.loop_inputs(3))
    gp.gather_loop(tab, idx, 4, shared=True)
    gp.gather_loop(tab, idx, 4)
    gp.gather_take2d(*(torch.from_numpy(a) for a in gp.take_inputs(3)))
    assert (gp.gather_take2d.launches, gp.gather_loop.launches,
            gp.gather_loop.shared_launches) == before


@pytest.mark.parametrize("call,error", [
    (lambda: gp.gather_loop(torch.zeros(60_000, dtype=torch.int32),
                            torch.zeros(4, dtype=torch.int32), 1, True),
     "shared memory"),
    (lambda: gp.gather_loop(torch.zeros(8, dtype=torch.int64),
                            torch.zeros(4, dtype=torch.int32)), "expected"),
    (lambda: gp.gather_loop(torch.zeros(0, dtype=torch.int32),
                            torch.zeros(4, dtype=torch.int32)), "range"),
    (lambda: gp.gather_loop(torch.zeros(8, dtype=torch.int32),
                            torch.zeros(4, dtype=torch.int32), -1), "range"),
    (lambda: gp.gather_take2d(torch.zeros(8, dtype=torch.int32),
                              torch.zeros(4, dtype=torch.int32),
                              torch.zeros(4, dtype=torch.int32)),
     "expected"),
    (lambda: gp.gather_take2d(torch.zeros((2, 2), dtype=torch.int32),
                              torch.zeros(4, dtype=torch.int32),
                              torch.zeros(3, dtype=torch.int32)),
     "indices"),
    (lambda: gp.gather_take2d(torch.zeros((2, 2), dtype=torch.int32),
                              torch.zeros(4, dtype=torch.int32),
                              torch.zeros(4, dtype=torch.int32,
                                          device="meta")), "meta"),
])
def test_wrapper_checks(call, error):
    with pytest.raises((TypeError, ValueError), match=error):
        call()


def test_shared_table_fits():
    """The probe's table, 200,000 bytes, fits a block's 232,448."""
    assert N_TAB * 4 == 200_000 <= gp.SHARED_MAX_BYTES


def test_main_on_cpu(capsys):
    res = gp.main(["--reps", "2"], device="cpu")
    out = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in out] == [
        "take-2d", "loop-gather (global)", "loop-gather (shared)"]
    assert all("correct = True" in ln and "host clock" in ln for ln in out)
    for k in ("take2d", "loop_global", "loop_shared"):
        assert res[k]["correct"] and res[k]["us_per_call"] > 0
