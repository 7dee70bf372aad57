"""Data-parallel training: word types shard across a mesh, and each
merge is chosen by an exact, deterministic reduction over the shards,
equal to one device's choice (the JAX package's ``parallel/train.py``).

Each shard holds the padded state of its block of rows
(ops/train_loop.PaddedState), and the shards of one device lie
contiguously in one block (:class:`ShardBlock`). K1 counts each shard's
pairs into its own table at local positions ``row * L + j``, one launch
a device (ops/pairstats.pair_rows), and the shard adds its fixed base
``first_row * L``, so positions order pairs across shards exactly as the
padded layout of one device does, and never move as words shrink. Rows
are padded to a multiple of the mesh size with all-PAD, zero-weight rows
at the end (:func:`shard_corpus`).

A step picks its merge through three exact tiers, as in the JAX package:

1. **top-K** (:func:`sharded_select_topk`): every shard nominates its
   ``TOPK`` best entries by local count (BPE) or local exact score over
   the global symbol weights (WordPiece), one launch a device over the
   tables of its shards; the K·D candidates are gathered, one launch a
   device looks up every one in the tables of its shards, summing the
   counts and taking the least positions, the mesh
   finishes that reduction across devices and processes, K2 picks
   the winner among them and, in the same launch, a Σ-threshold
   certificate proves that no pair outside the candidates can win
   (``csrc/certificate.cuh``; ops/shard_select.certificate_ref). The
   flag is the one value read back;
2. **compact** (:func:`sharded_select_compact`): one launch a device
   compacts the tables of its shards into at most ``cap`` runs each
   (:func:`run_gather_cap`), the runs are gathered and aggregated again
   by K1's runs mode, and K2 picks; exact unless a shard had more than
   ``cap`` runs;
3. **full** (:func:`sharded_select_full`): every shard's rows are
   gathered and K1 and K2 run over them.

WordPiece's symbol weights are K4, one launch a device over its block
of shards (their sum), then the mesh's sum over the devices
(:func:`sharded_sym_freq`). The merge is K3p, one launch a device over
its block with the host's ids as arguments (:func:`sharded_apply_merge`).
The port scores each shard's whole table,
so the JAX package's candidate cap (``c_ovf``) never vetoes a
certificate here: the tier counts may differ from the JAX package's for
WordPiece, the merges do not.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ops.merge import apply_merge
from ..ops.pairstats import (TablePair, clean_table, pair_rows,
                             pair_stats_runs)
from ..ops.shard_select import (TableSet, compact_tables, lookup_reduce,
                                nominate_tables)
from ..ops.train_loop import PaddedState, select_host_ids, select_scratch
from .mesh import DataMesh

# Candidates nominated per shard per step, as in the JAX package.
TOPK = 256

FLAG = 5  # the record column of a tier's flag: proven / exact / 1


def run_gather_cap(n_local_pairs: int) -> int:
    """Distinct-run cap of the compact tier: a quarter of the local pair
    slots, at least 1,024, rounded up to 256 and at most the slots (the
    JAX package's ``run_gather_cap``)."""
    cap = max(n_local_pairs // 4, 1024)
    return min(-(-cap // 256) * 256, max(n_local_pairs, 1))


class ShardBlock:
    """One device's consecutive shards of the mesh (a group of
    ``mesh.groups``) as one block of rows: ``state`` is their PaddedState
    [D * rows, L] and ``shards`` its views, one a shard. K1 counts every
    shard's pairs into the shard's own table in one launch (:meth:`pairs`),
    K4 the block's symbol weights in one launch (``state.count_symbols``,
    its two outputs alternating as the tables do) and K3p merges the
    whole block in one launch.

    On CUDA each shard has two tables, used on alternate steps: the launch
    that fills one set empties the other, whose readers (the tiers'
    nomination, lookup and compaction) ran before it in stream order.
    A step thus issues one K1 stream operation a device and no memset.
    ``sets`` are the two sets' TableSets, built once with the shards'
    position bases, and ``filled`` the one the last :meth:`pairs` filled
    (None on the CPU, whose plain versions need no descriptor)."""

    def __init__(self, sym: np.ndarray, freq: np.ndarray, device,
                 n_shards: int, bases: List[int]) -> None:
        self.state = PaddedState(sym, freq, device)
        n, L = self.state.sym.shape
        self.rows = n // n_shards
        self.wgt = self.state.wgt
        self.shards = [self.state.rows(i * self.rows, (i + 1) * self.rows)
                       for i in range(n_shards)]
        self.sets: List[TableSet] = []
        if self.state.device.type == "cuda":
            self.sets = [TableSet([clean_table(self.rows * L,
                                               self.state.device)
                                   for _ in range(n_shards)], bases)
                         for _ in range(2)]
        self.filled: Optional[TableSet] = None
        self._parity = 0

    def pairs(self) -> list:
        """K1 over the block: each shard's table, this step's set."""
        if not self.sets:
            return pair_rows(self.state.sym, self.wgt, self.rows)
        p, self._parity = self._parity, 1 - self._parity
        self.filled = self.sets[p]
        return pair_rows(self.state.sym, self.wgt, self.rows, self.filled,
                         clear=self.sets[1 - p])

    def table_set(self, tables) -> Optional[TableSet]:
        """``filled`` when ``tables`` are its tables (this step's K1), for
        the tiers' grouped kernels; else None, and the wrappers build a
        set for the call."""
        ts = self.filled
        if ts is not None and len(ts.tables) == len(tables) and all(
                t is u for t, u in zip(ts.tables, tables)):
            return ts
        return None

    def merge(self, a: int, b: int, new_id: int) -> None:
        """K3p over the block, the ids as the kernel's arguments."""
        apply_merge(self.state.sym, merge=(a, b, new_id))


class ShardedCorpus:
    """The padded training state of this process's shards of ``mesh``:
    ``blocks[g]`` holds the shards of group ``g`` of the mesh (one
    :class:`ShardBlock` a device), ``shards[i]`` (a view of its block, on
    ``mesh.devices[i]``) holds rows ``(mesh.first + i) * rows`` on, and
    its positions start at ``bases[i]``. ``n_real`` is the number of rows
    before padding."""

    def __init__(self, mesh: DataMesh, sym: np.ndarray,
                 freq: np.ndarray) -> None:
        D = mesh.size
        sym = np.asarray(sym, dtype=np.int32)
        freq = np.asarray(freq, dtype=np.int64)
        self.n_real, L = sym.shape
        pad = (-self.n_real) % D
        L = max(L, 2)  # K1 needs two slots; PAD changes nothing
        if (self.n_real + pad) * L >= 2 ** 31:
            raise ValueError("shard_corpus: positions must stay below 2**31")
        full = np.full((self.n_real + pad, L), -1, dtype=np.int32)
        full[:self.n_real, :sym.shape[1]] = sym
        self.freq = np.concatenate([freq, np.zeros(pad, dtype=np.int64)])
        self.mesh = mesh
        self.L = L
        self.rows = full.shape[0] // D
        self.bases: List[int] = [(mesh.first + i) * self.rows * L
                                 for i in range(len(mesh.devices))]
        self.blocks: List[ShardBlock] = []
        for dev, start, stop in mesh.groups:
            lo, hi = ((mesh.first + i) * self.rows for i in (start, stop))
            self.blocks.append(ShardBlock(full[lo:hi], self.freq[lo:hi], dev,
                                          stop - start,
                                          self.bases[start:stop]))
        self.shards: List[PaddedState] = [
            s for blk in self.blocks for s in blk.shards]
        self._full: Optional[PaddedState] = None
        self._runs_tables: Optional[TablePair] = None
        self._buffers = {}
        # K2's partials and ticket on mesh.home, for every tier's selection
        self.k2_scratch = select_scratch(mesh.home)

    def pairs(self) -> list:
        """K1 over every shard, one launch a device: the shards' tables in
        shard order."""
        return [t for blk in self.blocks for t in blk.pairs()]

    @property
    def n_local_pairs(self) -> int:
        """Pair slots of one shard, as the JAX package counts them."""
        return self.rows * (self.L - 1)

    def full_state(self, sym: torch.Tensor) -> PaddedState:
        """A PaddedState over every row of the mesh, holding ``sym``
        (the gathered rows, on ``mesh.home``)."""
        if self._full is None:
            self._full = PaddedState(
                np.full((self.freq.shape[0], self.L), -1, dtype=np.int32),
                self.freq, self.mesh.home)
        self._full.sym = sym
        return self._full

    def runs_claims(self):
        """The table the last :meth:`aggregate_runs` filled, for K2's
        claims mode (None on the CPU)."""
        return None if self._runs_tables is None else \
            self._runs_tables.claims()

    def aggregate_runs(self, rk, rc, rp):
        """K1's runs mode over the M runs the compact tier gathers (always
        as many) on ``mesh.home``: on CUDA into one of two tables, the
        launch emptying the other."""
        if self._runs_tables is None and self.mesh.home.type == "cuda":
            self._runs_tables = TablePair(rk.shape[0] + 1, self.mesh.home)
        if self._runs_tables is None:
            return pair_stats_runs(rk, rc, rp)
        return self._runs_tables.runs(rk, rc, rp)

    def _outputs(self, group: int, key, sizes):
        """Output tensors of a grouped kernel for group ``group`` of the
        mesh, one for each (entries, dtype) of ``sizes``, allocated once
        under ``key`` and written every step (on CUDA; None on the CPU,
        whose plain versions allocate)."""
        dev = self.mesh.groups[group][0]
        if dev.type != "cuda":
            return None
        out = self._buffers.get((group, key))
        if out is None:
            out = self._buffers[(group, key)] = tuple(
                torch.empty(n, dtype=dt, device=dev) for n, dt in sizes)
        return out

    def nominate_buffers(self, group: int, k: int):
        """The nomination's outputs (cand, kth) for group ``group`` of the
        mesh at ``k`` a shard."""
        _, start, stop = self.mesh.groups[group]
        n = stop - start
        return self._outputs(group, ("nominate", k),
                             ((n * k, torch.int64), (3 * n, torch.int64)))

    def run_buffers(self, group: int, cap: int):
        """The compaction's outputs for group ``group`` of the mesh at
        ``cap`` runs a shard."""
        _, start, stop = self.mesh.groups[group]
        n = (stop - start) * cap
        return self._outputs(group, ("runs", cap),
                             ((n, torch.int64), (n, torch.int64),
                              (n, torch.int32), (1, torch.int32)))

    def host(self) -> np.ndarray:
        """Every shard's rows on the host, without the padding rows (the
        JAX package's ``fetch_global``)."""
        from .distributed import fetch_global
        return fetch_global([blk.state.sym for blk in self.blocks],
                            self.mesh)[:self.n_real]


def shard_corpus(mesh: DataMesh, sym: np.ndarray,
                 freq: np.ndarray) -> ShardedCorpus:
    """Pad the rows to a multiple of the mesh size (all-PAD, weight 0, at
    the end: no pairs, and the real rows keep their positions) and place
    this process's blocks on their devices."""
    return ShardedCorpus(mesh, sym, freq)


def sharded_sym_freq(corpus: ShardedCorpus, sym_cap: int) -> torch.Tensor:
    """WordPiece's symbol weights over the whole mesh (the JAX package's
    ``_local_sym_freq`` with its psum): K4 once a device over its block,
    the sum of its shards, then the mesh's sum of those partials. Valid
    until the next call."""
    return corpus.mesh.sum([blk.state.count_symbols(sym_cap)
                            for blk in corpus.blocks])


def sharded_select_topk(corpus: ShardedCorpus, tables, rec,
                        sym_freq=None, wide_score: bool = False,
                        topk: int = TOPK) -> None:
    """The top-K tier: ``rec`` gets K2's winner over the gathered
    candidates (a, b, active) and, in ``rec[5]``, the certificate's
    proven flag, both from one K2 launch. ``tables`` are the shards' K1
    tables; ``sym_freq`` (on ``mesh.home``) selects WordPiece. Replaces
    the JAX package's ``sharded_bpe_select_topk`` and
    ``sharded_wp_select_topk``."""
    mesh = corpus.mesh
    k = min(topk, corpus.n_local_pairs)
    picks = [nominate_tables(tables[a:b], k,
                             None if sym_freq is None else sym_freq.to(dev),
                             corpus.blocks[g].table_set(tables[a:b]),
                             corpus.nominate_buffers(g, k))
             for g, (dev, a, b) in enumerate(mesh.groups)]
    cand = mesh.gather([c for c, _ in picks])
    kth = mesh.gather([t for _, t in picks])
    looked = [lookup_reduce(cand.to(dev), tables[a:b], corpus.bases[a:b],
                            corpus.blocks[g].table_set(tables[a:b]))
              for g, (dev, a, b) in enumerate(mesh.groups)]
    g_cnt = mesh.sum([c for c, _ in looked])
    g_pos = mesh.amin([p for _, p in looked])
    select_host_ids(cand, g_cnt, g_pos, rec, sym_freq,
                    scratch=corpus.k2_scratch, kth=kth, wide_score=wide_score)


def sharded_select_compact(corpus: ShardedCorpus, tables, rec, cap: int,
                           sym_freq=None) -> None:
    """The compact tier: ``rec`` gets K2's winner over the aggregated
    runs of every shard and, in ``rec[5]``, 1 when no shard had more than
    ``cap`` runs (the answer is then exact). Replaces the JAX package's
    ``sharded_bpe_select_compact`` and ``sharded_wp_select_compact``."""
    mesh = corpus.mesh
    cap = min(cap, corpus.n_local_pairs)
    runs = [compact_tables(tables[a:b], corpus.bases[a:b], cap,
                           out=corpus.run_buffers(g, cap),
                           tset=corpus.blocks[g].table_set(tables[a:b]))
            for g, (_, a, b) in enumerate(mesh.groups)]
    gk, gc, gp = (mesh.gather([r[j] for r in runs]) for j in range(3))
    agg = corpus.aggregate_runs(gk, gc, gp)
    select_host_ids(*agg, rec, sym_freq, claims=corpus.runs_claims(),
                    scratch=corpus.k2_scratch)
    rec[FLAG:].copy_(1 - mesh.amax([r[3] for r in runs]))


def sharded_select_full(corpus: ShardedCorpus, rec, sym_freq=None) -> None:
    """The full tier: every shard's rows gathered, then K1 and K2 over
    them. ``rec[5]`` = 1. Replaces the JAX package's
    ``sharded_bpe_select`` and ``sharded_wp_select``."""
    mesh = corpus.mesh
    state = corpus.full_state(mesh.gather([blk.state.sym
                                           for blk in corpus.blocks]))
    select_host_ids(*state.pairs(), rec, sym_freq, claims=state.claims(),
                    scratch=corpus.k2_scratch)
    rec[FLAG] = 1


def sharded_apply_merge(corpus: ShardedCorpus, a: int, b: int,
                        new_id: int) -> None:
    """Merge (a, b) into ``new_id`` on every shard: K3p, row-local, one
    launch a device over its block, the ids as the kernel's arguments (no
    record and no copy to the device)."""
    for blk in corpus.blocks:
        blk.merge(a, b, new_id)


class ShardedTrainer:
    """The per-step loop of training under a mesh, for the models: a
    tiered selection and the merge on every shard, counting which tier
    settled each step in ``sel_stats`` and the steps the certificate did
    not settle in ``topk_fallbacks``. ``force_tier`` ('compact' or
    'full') pins the selection to that exact tier."""

    def __init__(self, mesh: DataMesh, sym: np.ndarray, freq: np.ndarray,
                 sym_cap: Optional[int] = None, wide_score: bool = False,
                 force_tier: Optional[str] = None) -> None:
        if force_tier not in (None, "compact", "full"):
            raise ValueError(f"_force_tier must be 'compact' or 'full', "
                             f"got {force_tier!r}")
        self.corpus = shard_corpus(mesh, sym, freq)
        # The JAX package's estimate of the local pair slots, padding
        # included.
        n_dev = mesh.size
        n_pos = (sym.shape[0] + n_dev) * max(sym.shape[1] - 1, 1)
        self.run_cap = run_gather_cap(n_pos // n_dev)
        self.sym_cap = sym_cap  # WordPiece: the size of K4's table
        self.wide_score = wide_score
        self.force_tier = force_tier
        self.sel_stats = {"proven": 0, "compact": 0, "full": 0}
        self.topk_fallbacks = 0
        self.rec = torch.zeros(6, dtype=torch.int32, device=mesh.home)

    def select(self) -> Optional[Tuple[int, int]]:
        """The next merge's (a, b), or None when no pair is left."""
        corpus, rec = self.corpus, self.rec
        tables = corpus.pairs() if self.force_tier != "full" else None
        sym_freq = None if self.sym_cap is None else \
            sharded_sym_freq(corpus, self.sym_cap)
        if self.force_tier is None:
            sharded_select_topk(corpus, tables, rec, sym_freq,
                                self.wide_score)
            a, b, _, _, active, proven = rec.tolist()
            if proven:
                self.sel_stats["proven"] += 1
                return (a, b) if active else None
            self.topk_fallbacks += 1
        if self.force_tier != "full":
            sharded_select_compact(corpus, tables, rec, self.run_cap,
                                   sym_freq)
            a, b, _, _, active, exact = rec.tolist()
            if exact:
                self.sel_stats["compact"] += 1
                return (a, b) if active else None
        self.sel_stats["full"] += 1
        sharded_select_full(corpus, rec, sym_freq)
        a, b, _, _, active, _ = rec.tolist()
        return (a, b) if active else None

    def merge(self, a: int, b: int, new_id: int) -> None:
        sharded_apply_merge(self.corpus, a, b, new_id)

    def host(self) -> np.ndarray:
        return self.corpus.host()
