"""The per-shard pieces of data-parallel selection (parallel/train.py).

Each shard of a data mesh counts its pairs with K1 (ops/pairstats.py)
into its own table, positions local to the shard (``row * L + j``); a
shard adds its fixed base ``first_row * L`` to every position it reports,
so positions order pairs across shards as one device's do. On that table:

- :func:`nominate_tables`: each shard's top ``k`` entries by count (BPE)
  or by the exact score bits over the global symbol weights (WordPiece,
  the scorer of ops/bitmath.py), ties to the lower key, and its K-th best
  entry (metric, count, key), which bounds every pair it did not
  nominate (kernel ``swt_nominate``, one launch for all of the device's
  shards; phase 1 of the JAX package's ``sharded_bpe_select_topk`` and
  ``sharded_wp_select_topk``, ``parallel/train.py:263-275`` and
  ``:326-341``); :func:`nominate` is its one-table case;
- :func:`lookup_reduce`: each gathered candidate's count summed over
  the shards of one device and its least position (kernel
  ``swt_lookup_reduce``, one launch for all of the device's shards; the
  JAX package's ``_lookup_runs`` binary search,
  ``parallel/train.py:105``, with the mesh's sum and minimum over those
  shards); :func:`lookup_runs` is its one-table case;
- :func:`compact_tables`: each shard's live entries as at most ``cap``
  dense runs, in the gathered layout, and the OR of their overflow flags
  (kernel ``swt_compact_tables``, one launch for all of the device's
  shards, its epoch read from the :class:`TableSet`'s epoch word on the
  device; the JAX package's ``compact_cands``,
  ``ops/pairstats.py:162``, as its compact tier uses it);
  :func:`compact_table` is its one-table case;
- :func:`certificate_ref`: the Σ-threshold certificate of the top-K tier
  (``parallel/train.py:287-290`` for BPE, ``:336-365`` and ``:383-400``
  for WordPiece), written into the step's record as its one flag read
  back. On the card the step runs it inside K2's launch
  (ops/train_loop.select_host_ids with ``kth``; ``csrc/certificate.cuh``);
  :func:`certificate` launches the same device functions alone, for the
  checks (kernel ``swt_certificate``), and no training path calls it.

The kernels are in ``csrc/shard_select.cu`` and, the nomination's,
``csrc/nominate.cu``. The plain versions take
either form of K1's table (its hash table, or the sorted form of the
plain ``pair_stats``).
"""
from __future__ import annotations

import torch

from . import check_tensor
from .bitmath import score_bits_ref
from .flat import EPOCH_MAX
from .pairstats import EMPTY_KEY

POS_MAX = 2 ** 31 - 1   # the position of an absent candidate
MAX_LOCAL_SHARDS = 1024  # tables of one grouped launch (the lookup keeps
                         # their descriptor rows in shared memory)
ROUND_SPAN = 1 << 17    # table entries of one compaction cluster
MAX_NOMINATE = 256      # the most entries a shard nominates in one call
SCALE_BITS = 36         # the WordPiece certificate's scale, as in JAX
SAT = 1 << 55           # its per-shard saturation
LOW32 = 0xFFFFFFFF


def _check_table(table, dev):
    keys, counts, pos = table
    check_tensor("keys", keys, (torch.int64,), 1, dev)
    check_tensor("counts", counts, (torch.int64,), 1, dev)
    check_tensor("pos", pos, (torch.int32, torch.int64), 1, dev)
    T = keys.shape[0]
    if counts.shape[0] != T or pos.shape[0] != T:
        raise ValueError("inconsistent pair table")
    if dev.type == "cuda" and (pos.dtype != torch.int32 or T < 2
                               or T & (T - 1)):
        raise ValueError("the kernels take K1's table: a power-of-two "
                         "size and int32 positions")
    return T


def nominate_tables_ref(tables, k: int, sym_freq=None):
    """Plain PyTorch version of :func:`nominate_tables`: each table's live
    entries ordered by key with one sort, then by metric descending with a
    stable sort (so equal metrics keep the key order)."""
    cands, kths = [], []
    for keys, counts, _ in tables:
        live = keys != EMPTY_KEY
        key, order = torch.sort(keys[live])
        cnt = counts[live][order]
        metric = cnt if sym_freq is None else score_bits_ref(
            cnt, sym_freq[key >> 32], sym_freq[key & LOW32])
        metric, order = torch.sort(metric, descending=True, stable=True)
        metric, key, cnt = metric[:k], key[order[:k]], cnt[order[:k]]
        n = key.shape[0]
        # A BPE count of 0 nominates nothing; every live score is positive.
        ok = metric > 0 if sym_freq is None else metric >= 0
        cand = torch.full((k,), EMPTY_KEY, dtype=torch.int64,
                          device=keys.device)
        cand[:n] = torch.where(ok, key, EMPTY_KEY)
        cands.append(cand)
        kths.append(torch.stack([metric[k - 1], cnt[k - 1], key[k - 1]])
                    if n == k else torch.tensor([-1, 0, EMPTY_KEY],
                                                dtype=torch.int64,
                                                device=keys.device))
    return torch.cat(cands), torch.cat(kths)


def nominate_tables(tables, k: int, sym_freq=None, tset=None, out=None):
    """The top-K tier's nomination over the pair tables of one device's
    shards: (cand int64[D * k], kth int64[3 * D]), shard i's at ``[i * k,
    (i + 1) * k)`` and ``[3 i, 3 i + 3)``, the gathered layout.

    Each shard's live entries are ranked by metric descending, then key
    ascending (``jax.lax.top_k`` over the JAX package's key-sorted runs):
    the metric is the count, or with ``sym_freq`` (int64 over the symbol
    ids, the mesh's sum) the exact score bits of count / (fa * fb).
    ``cand`` holds the keys of the ``k`` best, EMPTY_KEY past the live
    entries and where a BPE count is 0; ``kth`` the (metric, count, key)
    of the k-th best, which bounds every entry not nominated, or (-1, 0,
    EMPTY_KEY) when the shard has fewer than ``k`` live entries.
    ``tables`` are K1's tables of the shards, 1 <= ``k`` <= 256; ``tset``,
    if given, their :class:`TableSet` (else one is built for the call);
    ``out``, if given, the two outputs to write (reused across calls).

    Launches ``swt_nominate`` once for CUDA tensors, whatever the number
    of tables, runs the PyTorch version for CPU tensors, and raises for
    any other device."""
    D = len(tables)
    dev = tables[0][0].device if tables else None
    _check_tables(tables, [0] * D, dev, "nominate_tables")
    if not 1 <= k <= MAX_NOMINATE:
        raise ValueError(f"nominate_tables: k {k} outside 1 .. "
                         f"{MAX_NOMINATE}")
    if sym_freq is not None:
        check_tensor("sym_freq", sym_freq, (torch.int64,), 1, dev)
    if tset is not None and not tset.covers(tables):
        raise ValueError("nominate_tables: the TableSet is not that of "
                         "these tables")
    if out is not None:
        for name, t, n in (("cand", out[0], D * k), ("kth", out[1], 3 * D)):
            check_tensor(f"out {name}", t, (torch.int64,), 1, dev)
            if t.shape[0] != n:
                raise ValueError(f"nominate_tables: out {name} has "
                                 f"{t.shape[0]} entries, expected {n}")
    if dev.type == "cpu":
        got = nominate_tables_ref(tables, k, sym_freq)
        if out is None:
            return got
        for o, g in zip(out, got):
            o.copy_(g)
        return tuple(out)
    if dev.type != "cuda":
        raise ValueError(f"nominate_tables: no kernel for device {dev}")
    _check_vector_keys(tables, "nominate_tables")
    if out is None:
        out = (torch.empty(D * k, dtype=torch.int64, device=dev),
               torch.empty(3 * D, dtype=torch.int64, device=dev))
    tset = tset or TableSet(tables, [0] * D)
    from . import _cuda
    with torch.cuda.device(dev):
        _cuda.launch("swt_nominate", tset.desc.data_ptr(), D, k,
                     None if sym_freq is None else sym_freq.data_ptr(),
                     out[0].data_ptr(), out[1].data_ptr())
    nominate_tables.launches += 1
    return tuple(out)


nominate_tables.launches = 0


def nominate(table, k: int, sym_freq=None):
    """(cand int64[k], kth int64[3]) of one shard's table:
    :func:`nominate_tables` of the one table."""
    return nominate_tables([table], k, sym_freq)


def lookup_runs_ref(cand, table, base: int):
    """Plain PyTorch version of :func:`lookup_runs` (int64 positions)."""
    keys, counts, pos = table
    live = keys != EMPTY_KEY
    k, order = torch.sort(keys[live])
    c = counts[live][order]
    p = pos[live].to(torch.int64)[order]
    if k.numel() == 0:
        return (torch.zeros_like(cand),
                torch.full_like(cand, POS_MAX))
    j = torch.searchsorted(k, cand).clamp(max=k.numel() - 1)
    found = (k[j] == cand) & (cand != EMPTY_KEY)
    return (torch.where(found, c[j], 0),
            torch.where(found, p[j] + base, POS_MAX))


def _check_vector_keys(tables, name: str) -> None:
    """The tables a cluster kernel reads keys of as 16-byte vectors: each
    keys 16-byte aligned, fewer than 2**31 entries."""
    if any(t[0].data_ptr() % 16 for t in tables):
        raise ValueError(f"{name}: the kernel reads keys as 16-byte "
                         "vectors; a table's keys are not 16-byte aligned")
    if any(t[0].shape[0] >= 2 ** 31 for t in tables):
        raise ValueError(f"{name}: a table of 2**31 entries or more")


def _check_tables(tables, bases, dev, name: str) -> None:
    if not tables or len(tables) != len(bases):
        raise ValueError(f"{name}: {len(tables)} tables, {len(bases)} bases")
    if len(tables) > MAX_LOCAL_SHARDS:
        raise ValueError(f"{name}: more than {MAX_LOCAL_SHARDS} tables")
    for table, base in zip(tables, bases):
        _check_table(table, dev)
        if base < 0:
            raise ValueError(f"{name}: base {base} < 0")


class TableSet:
    """One device's pair tables as the grouped kernels take them, built
    once for a set of tables (``parallel/train.ShardBlock`` keeps two a
    group of the mesh, whose K1 tables are allocated once) so that a step
    copies nothing to the device. ``desc`` is int64[6 * D + 1 + D + C *
    D + 1] on the tables' device: per table its keys, counts and pos
    pointers, T, base and a slot for the compaction's overflow flag; then
    the compaction's ticket, a cluster counter a table, C look-back
    status words a table (C = ceil(max T / ROUND_SPAN), the compaction's
    clusters a table) and the epoch word (:attr:`EPOCH`: the last
    compaction's epoch). The ticket and the counters are 0 between calls.

    No compaction takes its epoch from the host: each call's epoch is one
    past the epoch word, which every cluster reads before it publishes
    and the call's last cluster advances, and each status word carries
    it, so a word of an earlier call is never read as this call's and no
    memset runs between calls. So a CUDA graph of a compaction
    (parallel/train.ShardedTrainer) replays with the epoch the device
    holds. ``calls`` counts on the host the compactions queued since the
    epochs last restarted, at least the epoch word: :meth:`advance`
    restarts them before they would pass ``EPOCH_MAX``. ``tables`` keeps
    the tables themselves (so the pointers stay valid), and
    ``k1_checked`` records that ops/pairstats.pair_rows has checked
    them."""

    def __init__(self, tables, bases):
        self.tables = tuple(tables)
        self.k1_checked = False
        self.rows = self.rows_of(tables, bases)
        self.D = len(tables)
        self.clusters = max(-(-t[0].shape[0] // ROUND_SPAN) for t in tables)
        self.desc = torch.tensor(
            list(self.rows) + [0] * (1 + self.D + self.D * self.clusters + 1),
            dtype=torch.int64).to(tables[0][0].device)
        self.calls = 0

    @property
    def EPOCH(self) -> int:
        """The index of the epoch word in ``desc`` (its last word)."""
        return self.desc.shape[0] - 1

    @property
    def status(self) -> torch.Tensor:
        """The look-back status words, C a table (a view of ``desc``)."""
        start = 6 * self.D + 1 + self.D
        return self.desc[start:start + self.D * self.clusters]

    @property
    def epoch(self) -> int:
        """The epoch word: the last compaction's epoch (a read of the
        device)."""
        return int(self.desc[self.EPOCH])

    @staticmethod
    def rows_of(tables, bases) -> tuple:
        rows = []
        for (keys, counts, pos), base in zip(tables, bases):
            rows += [keys.data_ptr(), counts.data_ptr(), pos.data_ptr(),
                     keys.shape[0], base, 0]
        return tuple(rows)

    def holds(self, tables, bases) -> bool:
        """Whether this set was built for exactly these tables and bases."""
        return self.rows == self.rows_of(tables, bases)

    def covers(self, tables) -> bool:
        """Whether this set describes exactly these tables, whatever its
        bases (the very tuples it keeps, or tensors at their addresses)."""
        if len(tables) != self.D:
            return False
        if all(t is u for t, u in zip(tables, self.tables)):
            return True
        return all(self.rows[6 * i:6 * i + 4] == (
            keys.data_ptr(), counts.data_ptr(), pos.data_ptr(),
            keys.shape[0]) for i, (keys, counts, pos) in enumerate(tables))

    def room(self, n: int) -> None:
        """Make room for ``n`` more compactions: when they could take the
        epoch word past ``EPOCH_MAX``, restart the epochs now (the status
        words and the epoch word zeroed on the device, queued before the
        calls), so no word of an earlier call carries a new epoch. A
        restart inside a CUDA graph's capture would be replayed with it,
        so it raises there: make room before one."""
        if self.calls + n <= EPOCH_MAX:
            return
        if (self.desc.device.type == "cuda"
                and torch.cuda.is_current_stream_capturing()):
            raise RuntimeError("TableSet: the epochs would restart inside a "
                               "capture")
        self.desc[6 * self.D + 1 + self.D:].zero_()
        self.calls = 0

    def advance(self, n: int = 1) -> None:
        """Count ``n`` compactions about to be queued (one call, or a
        replayed graph's), after :meth:`room` for them."""
        self.room(n)
        self.calls += n


def _check_table_set(tset, tables, name: str) -> None:
    if tset is not None and (tset.D != len(tables)
                             or tset.desc.device != tables[0][0].device):
        raise ValueError(f"{name}: a TableSet of {tset.D} tables on "
                         f"{tset.desc.device} for {len(tables)} on "
                         f"{tables[0][0].device}")


def lookup_reduce_ref(cand, tables, bases):
    """Plain PyTorch version of :func:`lookup_reduce`: the one-table
    lookups summed and their positions' minimum (int64 positions)."""
    looked = [lookup_runs_ref(cand, t, b) for t, b in zip(tables, bases)]
    return (torch.stack([c for c, _ in looked]).sum(0),
            torch.stack([p for _, p in looked]).amin(0))


def lookup_reduce(cand, tables, bases, tset=None, out=None):
    """Each candidate key's count summed over the pair tables of one
    device's shards and its least position + base over them, or (0,
    POS_MAX) when the key is absent from every table or EMPTY_KEY.
    ``cand`` int64[M]; ``tables`` K1's (keys, counts, pos) of each shard,
    ``bases`` their position bases; ``tset``, if given, their
    :class:`TableSet` (else one is built for the call); ``out``, if
    given, the two outputs to write (reused across calls). Returns (count
    int64[M], position int32[M]; int64 on the CPU).

    Launches ``swt_lookup_reduce`` once for CUDA tensors, whatever the
    number of tables, runs the PyTorch version for CPU tensors, and raises
    for any other device."""
    dev = cand.device
    check_tensor("cand", cand, (torch.int64,), 1, dev)
    _check_tables(tables, bases, dev, "lookup_reduce")
    _check_table_set(tset, tables, "lookup_reduce")
    M = cand.shape[0]
    if out is not None:
        pos_dtype = torch.int64 if dev.type == "cpu" else torch.int32
        for name, t, dt in (("count", out[0], torch.int64),
                            ("pos", out[1], pos_dtype)):
            check_tensor(f"out {name}", t, (dt,), 1, dev)
            if t.shape[0] != M:
                raise ValueError(f"lookup_reduce: out {name} has "
                                 f"{t.shape[0]} entries, expected {M}")
    if dev.type == "cpu":
        got = lookup_reduce_ref(cand, tables, bases)
        if out is None:
            return got
        for o, g in zip(out, got):
            o.copy_(g)
        return tuple(out)
    if dev.type != "cuda":
        raise ValueError(f"lookup_reduce: no kernel for device {dev}")
    cnt, pos = out if out is not None else (
        torch.empty(M, dtype=torch.int64, device=dev),
        torch.empty(M, dtype=torch.int32, device=dev))
    if M == 0:
        return cnt, pos
    tset = tset or TableSet(tables, bases)
    from . import _cuda
    with torch.cuda.device(dev):
        _cuda.launch("swt_lookup_reduce", cand.data_ptr(), M,
                     tset.desc.data_ptr(), len(tables), cnt.data_ptr(),
                     pos.data_ptr())
    lookup_reduce.launches += 1
    return cnt, pos


lookup_reduce.launches = 0


def lookup_runs(cand, table, base: int):
    """Each candidate key's local (count, position + ``base``) in one
    shard's pair table, or (0, POS_MAX) when the key is absent or
    EMPTY_KEY: :func:`lookup_reduce` of the one table."""
    return lookup_reduce(cand, [table], [base])


def compact_table_ref(table, cap: int, base: int):
    """Plain PyTorch version of :func:`compact_table` (int64 positions;
    the live entries in table order)."""
    keys, counts, pos = table
    dev = keys.device
    idx = torch.nonzero(keys != EMPTY_KEY).flatten()
    n = idx.numel()
    take = idx[:cap]
    out_k = torch.full((cap,), EMPTY_KEY, dtype=torch.int64, device=dev)
    out_c = torch.zeros(cap, dtype=torch.int64, device=dev)
    out_p = torch.full((cap,), POS_MAX, dtype=torch.int64, device=dev)
    m = take.numel()
    out_k[:m] = keys[take]
    out_c[:m] = counts[take]
    out_p[:m] = pos[take].to(torch.int64) + base
    return out_k, out_c, out_p, torch.tensor([int(n > cap)],
                                             dtype=torch.int32, device=dev)


def compact_tables_ref(tables, bases, cap: int, tset=None):
    """Plain PyTorch version of :func:`compact_tables`: the one-table
    compactions concatenated and their flags' OR (int64 positions). With
    ``tset`` it writes the descriptor's words as the kernel leaves them
    (:func:`publish_ref`)."""
    runs = [compact_table_ref(t, cap, b) for t, b in zip(tables, bases)]
    if tset is not None:
        publish_ref(tset, cap)
    return tuple(torch.cat([r[j] for r in runs]) for j in range(3)) + (
        torch.stack([r[3] for r in runs]).amax(0),)


K_INCLUSIVE = 2 << 62  # a look-back status word's state (csrc/lookback.cuh)


def publish_ref(tset, cap: int) -> None:
    """The descriptor's words as one compaction over ``tset`` leaves
    them: this call's epoch, one past the epoch word (``EPOCH_MAX`` wraps
    to 0, which the host's restart precedes), in the epoch word; each
    table's overflow flag (live entries > ``cap``); each of its clusters'
    status words inclusive, with the epoch and the live entries of the
    table up to the cluster's end; the ticket and the counters 0."""
    epoch = (tset.epoch + 1) & EPOCH_MAX
    desc = tset.desc
    status = tset.status.view(tset.D, tset.clusters)
    for i, (keys, _, _) in enumerate(tset.tables):
        live = keys != EMPTY_KEY
        desc[6 * i + 5] = int(int(live.sum()) > cap)
        T = keys.shape[0]
        for c in range(-(-T // ROUND_SPAN)):
            n = int(live[:min((c + 1) * ROUND_SPAN, T)].sum())
            w = K_INCLUSIVE | epoch << 32 | n
            status[i, c] = w - (1 << 64) if w >= 1 << 63 else w
    desc[6 * tset.D:6 * tset.D + 1 + tset.D] = 0
    desc[tset.EPOCH] = epoch


def compact_tables(tables, bases, cap: int, out=None, tset=None):
    """The live pairs of one device's shards, each shard's as at most
    ``cap`` dense runs in table order, in the gathered layout (shard i at
    ``[i * cap, (i + 1) * cap)``): (keys int64[D * cap], counts int64[D *
    cap], positions + base int32[D * cap] (int64 on the CPU), overflow
    int32[1]). Unused entries are (EMPTY_KEY, 0, POS_MAX); the overflow
    flag is 1 when some shard has more than ``cap`` live entries (its runs
    are then incomplete). ``tables`` are K1's tables of the shards,
    ``bases`` their position bases; ``out``, if given, the four outputs
    to write (reused across calls); ``tset``, if given, the tables'
    :class:`TableSet` (else one is built for the call), whose words the
    call advances (its epoch word, the flags, the status words): on the
    card the kernel reads its epoch there, so the call takes none from
    the host, and for CPU tensors the plain version writes them as the
    kernel does.

    Launches ``swt_compact_tables`` once for CUDA tensors, whatever the
    number of tables, runs the PyTorch version for CPU tensors, and raises
    for any other device."""
    dev = tables[0][0].device if tables else None
    _check_tables(tables, bases, dev, "compact_tables")
    _check_table_set(tset, tables, "compact_tables")
    if tset is not None and not tset.covers(tables):
        raise ValueError("compact_tables: the TableSet is not that of "
                         "these tables")
    if cap < 1:
        raise ValueError(f"compact_tables: cap {cap} < 1")
    D = len(tables)
    pos_dtype = torch.int64 if dev.type == "cpu" else torch.int32
    if out is not None:
        for name, t, n, dt in (("keys", out[0], D * cap, torch.int64),
                               ("counts", out[1], D * cap, torch.int64),
                               ("pos", out[2], D * cap, pos_dtype),
                               ("ovf", out[3], 1, torch.int32)):
            check_tensor(f"out {name}", t, (dt,), 1, dev)
            if t.shape[0] != n:
                raise ValueError(f"compact_tables: out {name} has "
                                 f"{t.shape[0]} entries, expected {n}")
    if dev.type == "cpu":
        if tset is not None:
            tset.advance()
        runs = compact_tables_ref(tables, bases, cap, tset)
        if out is None:
            return runs
        for o, r in zip(out, runs):
            o.copy_(r)
        return tuple(out)
    if dev.type != "cuda":
        raise ValueError(f"compact_tables: no kernel for device {dev}")
    _check_vector_keys(tables, "compact_tables")
    if out is None:
        out = (torch.empty(D * cap, dtype=torch.int64, device=dev),
               torch.empty(D * cap, dtype=torch.int64, device=dev),
               torch.empty(D * cap, dtype=torch.int32, device=dev),
               torch.empty(1, dtype=torch.int32, device=dev))
    tset = tset or TableSet(tables, bases)
    tset.advance()
    from . import _cuda
    with torch.cuda.device(dev):
        _cuda.launch("swt_compact_tables", tset.desc.data_ptr(), D,
                     tset.clusters, cap, *(t.data_ptr() for t in out))
    compact_tables.launches += 1
    return tuple(out)


compact_tables.launches = 0


def compact_table(table, cap: int, base: int):
    """One shard's live pairs as at most ``cap`` dense runs: (keys int64
    [cap], counts int64[cap], positions + ``base`` int32[cap] (int64 on
    the CPU), overflow int32[1]): :func:`compact_tables` of the one
    table."""
    return compact_tables([table], [base], cap)


def _bitlen(x: int) -> int:
    return x.bit_length()


def certificate_ref(kth, cand, g_cnt, rec, sym_freq=None,
                    wide_score: bool = False) -> None:
    """Plain version of :func:`certificate`, in Python integers."""
    wordpiece = sym_freq is not None
    rows = kth.view(-1, 3).tolist()
    a, b, _, _, active = rec[:5].tolist()
    key = (a << 32) | b
    best_cnt = -1
    if active:
        hit = (cand == key) & (cand != EMPTY_KEY) & (g_cnt > 0)
        if bool(hit.any()):
            best_cnt = int(g_cnt[hit].max())

    def freqs(k):
        return int(sym_freq[k >> 32]), int(sym_freq[k & LOW32])

    def unsafe(fa, fb):
        return wide_score and _bitlen(max(fa, 1)) + _bitlen(max(fb, 1)) > 62

    sum_t, any_sat = 0, False
    for metric, c, k in rows:
        if not wordpiece:
            sum_t += max(metric, 0)
            continue
        if metric < 0:
            continue
        c = max(c, 0)
        fa, fb = freqs(k)
        bad = unsafe(fa, fb)
        if bad:
            fa = fb = c = 1
        q = (c << SCALE_BITS) // max(fa * fb, 1)
        t = q + (q >> 50) + 2
        any_sat = any_sat or t >= SAT or bad
        sum_t += min(t, SAT)
    if not wordpiece:
        proven = best_cnt > sum_t or sum_t == 0
    else:
        fa, fb = freqs(key)
        bad = unsafe(fa, fb)
        if bad:
            fa = fb = 1
        lhs = (max(best_cnt, 0) << SCALE_BITS) // max(fa * fb, 1)
        proven = (lhs > sum_t + (sum_t >> 50) + 2 and not any_sat
                  and not bad) or sum_t == 0
    rec[5] = int(proven)


def certificate(kth, cand, g_cnt, rec, sym_freq=None,
                wide_score: bool = False) -> None:
    """Write the top-K tier's ``proven`` flag into ``rec[5]``.

    ``kth`` int64[3 * D]: each shard's K-th best (metric, count, key)
    (:func:`nominate_tables`); ``cand``/``g_cnt`` int64[M]: the gathered
    candidates and their summed counts; ``rec`` int32[6]: K2's record of
    the winner over them (a, b, active). BPE (``sym_freq`` None): proven
    when the winner's count exceeds Σ max(metric_i, 0), or that sum is
    0 (every run everywhere was nominated). WordPiece (``sym_freq`` the
    summed symbol weights): each shard's bound t_i = min(q + (q >> 50) +
    2, 2^55), q = (c << 36) // (fa fb) of its K-th entry; proven when
    (count << 36) // (fa fb) of the winner exceeds Σ t_i + (Σ t_i >> 50)
    + 2 and no shard saturated, or Σ t_i == 0; with ``wide_score`` a
    denominator of more than 62 bits vetoes (K-th entries and winner).
    Exact where the JAX package's int64 arithmetic does not overflow.

    The check launcher of the device functions that K2 runs in its last
    block on the training step (``csrc/certificate.cuh``): launches
    ``swt_certificate`` for CUDA tensors, runs the Python version for CPU
    tensors, and raises for any other device."""
    dev = kth.device
    check_tensor("kth", kth, (torch.int64,), 1, dev)
    check_tensor("cand", cand, (torch.int64,), 1, dev)
    check_tensor("g_cnt", g_cnt, (torch.int64,), 1, dev)
    check_tensor("rec", rec, (torch.int32,), 1, dev)
    if sym_freq is not None:
        check_tensor("sym_freq", sym_freq, (torch.int64,), 1, dev)
    if (kth.shape[0] % 3 or kth.shape[0] == 0 or rec.shape[0] != 6
            or g_cnt.shape[0] != cand.shape[0]):
        raise ValueError("certificate: inconsistent shapes")
    if dev.type == "cpu":
        return certificate_ref(kth, cand, g_cnt, rec, sym_freq, wide_score)
    if dev.type != "cuda":
        raise ValueError(f"certificate: no kernel for device {dev}")
    from . import _cuda
    with torch.cuda.device(dev):
        _cuda.launch("swt_certificate", kth.data_ptr(), kth.shape[0] // 3,
                     cand.data_ptr(), g_cnt.data_ptr(), cand.shape[0],
                     rec.data_ptr(),
                     sym_freq.data_ptr() if sym_freq is not None else None,
                     int(sym_freq is not None), int(wide_score))
    certificate.launches += 1


certificate.launches = 0
