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

Each gather writes into an output the corpus makes once
(:meth:`ShardedCorpus.gather_out`), and each reduction of one partial a
process is in place (parallel/mesh.py), so no tier allocates after a
run's first step and each can be captured in a CUDA graph
(:class:`ShardedTrainer`), its collectives included.

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

from ..benchmarks import profiling
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

RUN_GATHERS = ("keys", "counts", "pos")  # the compact tier's gathers


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

    Each shard has two tables, used on alternate steps: the launch that
    fills one set empties the other, whose readers (the tiers'
    nomination, lookup and compaction) ran before it in stream order.
    A step thus issues one K1 stream operation a device and no memset.
    ``sets`` are the two sets' TableSets, built once with the shards'
    position bases, ``filled`` the one the last :meth:`pairs` filled and
    ``_parity`` the one the next fills. On the CPU the plain version
    writes into them (ops/pairstats.pair_rows), so the tiers take the
    same sets as on the card."""

    def __init__(self, sym: np.ndarray, freq: np.ndarray, device,
                 n_shards: int, bases: List[int]) -> None:
        self.state = PaddedState(sym, freq, device)
        n, L = self.state.sym.shape
        self.rows = n // n_shards
        self.wgt = self.state.wgt
        self.shards = [self.state.rows(i * self.rows, (i + 1) * self.rows)
                       for i in range(n_shards)]
        self.sets = [TableSet([clean_table(self.rows * L, self.state.device)
                               for _ in range(n_shards)], bases)
                     for _ in range(2)]
        self.filled: Optional[TableSet] = None
        self._parity = 0

    def pairs(self) -> list:
        """K1 over the block: each shard's table, this step's set."""
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

    def full_state(self) -> PaddedState:
        """The full tier's PaddedState over every row of the mesh on
        ``mesh.home``, made once with K1's two tables (on CUDA): its
        ``sym`` is where the tier gathers the rows (:meth:`gather`; on one
        device with no process group, the block's own rows)."""
        if self._full is None:
            full = PaddedState(
                np.full((self.freq.shape[0], self.L), -1, dtype=np.int32),
                self.freq, self.mesh.home)
            parts = [blk.state.sym for blk in self.blocks]
            out = self.gather_out("sym", parts)
            full.sym = parts[0] if out is None else out
            if full.device.type == "cuda":
                full._tables = TablePair(full.sym.numel(), full.device)
            self._full = full
        return self._full

    def gather_out(self, name: str, parts) -> Optional[torch.Tensor]:
        """The output of the tiers' gather ``name`` of ``parts``
        (``mesh.gathered_shape``), made by the first call; None where the
        gather copies nothing (one part, no process group)."""
        mesh = self.mesh
        if not mesh.group and len(parts) == 1:
            return None
        shape = mesh.gathered_shape(parts)
        out = self._buffers.get(("gather", name))
        if out is None or tuple(out.shape) != shape:
            out = self._buffers[("gather", name)] = torch.empty(
                shape, dtype=parts[0].dtype, device=mesh.home)
        return out

    def gather(self, name: str, parts) -> torch.Tensor:
        """``mesh.gather`` of ``parts`` into :meth:`gather_out`."""
        return self.mesh.gather(parts, out=self.gather_out(name, parts))

    def runs_claims(self):
        """The table the last :meth:`aggregate_runs` filled, for K2's
        claims mode (None on the CPU)."""
        return None if self._runs_tables is None else \
            self._runs_tables.claims()

    def runs_tables(self, M: int) -> Optional[TablePair]:
        """K1's two tables for the M runs of the compact tier on
        ``mesh.home``, made once (None on the CPU, whose plain version
        needs none)."""
        if self._runs_tables is None and self.mesh.home.type == "cuda":
            self._runs_tables = TablePair(M + 1, self.mesh.home)
        return self._runs_tables

    def aggregate_runs(self, rk, rc, rp):
        """K1's runs mode over the M runs the compact tier gathers (always
        as many) on ``mesh.home``: on CUDA into one of two tables, the
        launch emptying the other."""
        pair = self.runs_tables(rk.shape[0])
        if pair is None:
            return pair_stats_runs(rk, rc, rp)
        return pair.runs(rk, rc, rp)

    def _outputs(self, group: int, key, sizes):
        """Output tensors of a grouped kernel for group ``group`` of the
        mesh, one for each (entries, dtype) of ``sizes``, allocated once
        under ``key`` and written every step (the plain versions copy
        into them)."""
        dev = self.mesh.groups[group][0]
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

    def lookup_buffers(self, group: int, m: int):
        """The lookup's outputs (count, position) for group ``group`` of
        the mesh over ``m`` gathered candidates."""
        return self._outputs(group, ("lookup", m),
                             ((m, torch.int64), (m, self._pos_dtype(group))))

    def _pos_dtype(self, group: int) -> torch.dtype:
        """Positions as the kernels write them (int32), or as the plain
        versions do on the CPU (int64)."""
        return torch.int32 if self.mesh.groups[group][0].type == "cuda" \
            else torch.int64

    def run_buffers(self, group: int, cap: int):
        """The compaction's outputs for group ``group`` of the mesh at
        ``cap`` runs a shard."""
        _, start, stop = self.mesh.groups[group]
        n = (stop - start) * cap
        return self._outputs(group, ("runs", cap),
                             ((n, torch.int64), (n, torch.int64),
                              (n, self._pos_dtype(group)),
                              (1, torch.int32)))

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
    cand = corpus.gather("cand", [c for c, _ in picks])
    kth = corpus.gather("kth", [t for _, t in picks])
    looked = [lookup_reduce(cand.to(dev), tables[a:b], corpus.bases[a:b],
                            corpus.blocks[g].table_set(tables[a:b]),
                            corpus.lookup_buffers(g, cand.shape[0]))
              for g, (dev, a, b) in enumerate(mesh.groups)]
    g_cnt = mesh.sum([c for c, _ in looked])
    g_pos = mesh.amin([p for _, p in looked])
    select_host_ids(cand, g_cnt, g_pos, rec, sym_freq,
                    scratch=corpus.k2_scratch, kth=kth, wide_score=wide_score)


def sharded_select_compact(corpus: ShardedCorpus, tables, rec, cap: int,
                           sym_freq=None) -> None:
    """The compact tier: ``rec`` gets K2's winner over the aggregated
    runs of every shard and, in ``rec[5]``, 1 when no shard had more than
    ``cap`` runs (the answer is then exact), written in place. Replaces
    the JAX package's ``sharded_bpe_select_compact`` and
    ``sharded_wp_select_compact``."""
    mesh = corpus.mesh
    cap = min(cap, corpus.n_local_pairs)
    runs = [compact_tables(tables[a:b], corpus.bases[a:b], cap,
                           out=corpus.run_buffers(g, cap),
                           tset=corpus.blocks[g].table_set(tables[a:b]))
            for g, (_, a, b) in enumerate(mesh.groups)]
    gk, gc, gp = (corpus.gather(name, [r[j] for r in runs])
                  for j, name in enumerate(RUN_GATHERS))
    agg = corpus.aggregate_runs(gk, gc, gp)
    select_host_ids(*agg, rec, sym_freq, claims=corpus.runs_claims(),
                    scratch=corpus.k2_scratch)
    rec[FLAG:].fill_(1).sub_(mesh.amax([r[3] for r in runs]))


def sharded_select_full(corpus: ShardedCorpus, rec, sym_freq=None) -> None:
    """The full tier: every shard's rows gathered, then K1 and K2 over
    them. ``rec[5]`` = 1. Replaces the JAX package's
    ``sharded_bpe_select`` and ``sharded_wp_select``."""
    state = corpus.full_state()
    state.sym = corpus.gather("sym", [blk.state.sym for blk in corpus.blocks])
    select_host_ids(*state.pairs(), rec, sym_freq, claims=state.claims(),
                    scratch=corpus.k2_scratch)
    rec[FLAG:].fill_(1)


def sharded_apply_merge(corpus: ShardedCorpus, a: int, b: int,
                        new_id: int) -> None:
    """Merge (a, b) into ``new_id`` on every shard: K3p, row-local, one
    launch a device over its block, the ids as the kernel's arguments (no
    record and no copy to the device)."""
    for blk in corpus.blocks:
        blk.merge(a, b, new_id)


class _TierGraph:
    """A captured tier of a step: its CUDA graph, the host values the
    capture moved (``moved``: (object, attribute, value after); ``fills``:
    (PairTable, fills added)), the launches it holds by ``launch.*``
    counter, the compactions it holds by TableSet (their epochs) and the
    mesh's collectives it holds by kind."""

    def __init__(self, graph, moved, fills, launches, compactions,
                 collectives) -> None:
        self.graph = graph
        self.moved = moved
        self.fills = fills
        self.launches = launches
        self.compactions = compactions
        self.collectives = collectives


class ShardedTrainer:
    """The per-step loop of training under a mesh, for the models: a
    tiered selection and the merge on every shard, counting which tier
    settled each step in ``sel_stats`` and the steps the certificate did
    not settle in ``topk_fallbacks``. ``force_tier`` ('compact' or
    'full') pins the selection to that exact tier.

    As in the JAX package, each tier a step tries is one dispatch and one
    read-back (its record's flag decides whether the next tier runs), and
    the merge is one more dispatch with the host's ids. The first tier
    holds the step's K4 (WordPiece) and K1 too. Where this process's
    shards all lie on one CUDA device, on a mesh with no process group or
    on one under NCCL (``graphed``), the run's first step is queued step
    by step (it builds the buffers and the NCCL communicator, checks the
    tables and warms every launcher); every later tier, top-K, compact or
    full, is one replay of a ``torch.cuda.CUDAGraph`` of its launches, its
    collectives and the copy of its record into a pinned host buffer,
    captured once for each key (:meth:`_key`: the tier, whether it holds
    K1, and the host values its launches read: the block's table set,
    K4's output, and the runs tables' or the full state's table
    parities), and the host reads the record after an event. Every step
    of the other meshes (gloo, several devices a process) and of the CPU,
    which runs the plain versions, is queued step by step.

    Under a process group the ranks need not capture together: a key
    holds host values of this process (table parities, an address), so
    one rank may capture a tier while another replays its graph of it. A
    capture runs no collective, and each capture is replayed at once, so
    every rank runs the same collectives in the same order as long as
    every rank replays or queues the same tiers in the same order: the
    globally reduced record decides the tiers, so they do. Nothing may
    issue a collective between tiers outside the graphs unless every
    rank issues it. (A card checks one rank; two gloo processes check
    the route's logic step by step.)

    After a replay the host values move as the capture moved them, every
    ``launch.*`` counter of the profiler (benchmarks/profiling.py) gains
    the launches the graph holds (so each stays the true number of
    kernels run), the mesh's ``collectives`` the collectives it holds,
    and each TableSet counts the graph's compactions (their epochs are
    device words). A capture that
    allocates, or fails, raises; nothing falls back to queuing the tier.
    :meth:`close` releases the graphs. ``graph_stats`` counts the run's
    ``captures``, ``replays`` and ``eager_steps`` (steps queued step by
    step), its ``graphs`` by tier, its ``tiers`` (the tiers run) and
    ``eager_tiers`` (those of them queued step by step); the captures'
    time is the ``train.capture`` span's."""

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
        self.dev = mesh.home
        cuda = self.dev.type == "cuda"
        self.rec = torch.zeros(6, dtype=torch.int32, device=self.dev)
        self.host_rec = torch.zeros(6, dtype=torch.int32, pin_memory=cuda)
        self.event = torch.cuda.Event() if cuda else None
        self.graphed = cuda and len(mesh.groups) == 1 and (
            not mesh.group or mesh.backend == "nccl")
        self.graphs = {}  # key -> _TierGraph
        self.graph_stats = {"captures": 0, "replays": 0, "eager_steps": 0,
                            "graphs": {}, "tiers": 0, "eager_tiers": 0}
        self.steps = 0
        self._tables = None  # this step's K1 tables
        self._sym_freq = None  # this step's symbol weights (WordPiece)
        self._stream = None

    def select(self) -> Optional[Tuple[int, int]]:
        """The next merge's (a, b), or None when no pair is left."""
        eager = not self.graphed or self.steps == 0
        self.steps += 1
        head = True
        tiers = () if self.force_tier == "full" else \
            ("compact",) if self.force_tier == "compact" else \
            ("topk", "compact")
        for tier in tiers:
            a, b, _, _, active, flag = self._tier(tier, head, eager)
            head = False
            if flag:
                self.sel_stats["proven" if tier == "topk" else tier] += 1
                return (a, b) if active else None
            if tier == "topk":
                self.topk_fallbacks += 1
        self.sel_stats["full"] += 1
        a, b, _, _, active, _ = self._tier("full", head, eager)
        return (a, b) if active else None

    def _queue(self, tier: str, head: bool) -> None:
        """A tier's launches: with ``head`` the step's K4 and K1 first;
        then the tier's, which write its record; then the record's copy
        into the host buffer."""
        corpus, rec = self.corpus, self.rec
        if head:
            self._sym_freq = None if self.sym_cap is None else \
                sharded_sym_freq(corpus, self.sym_cap)
            self._tables = corpus.pairs() if tier != "full" else None
        if tier == "topk":
            sharded_select_topk(corpus, self._tables, rec, self._sym_freq,
                                self.wide_score)
        elif tier == "compact":
            sharded_select_compact(corpus, self._tables, rec, self.run_cap,
                                   self._sym_freq)
        else:
            sharded_select_full(corpus, rec, self._sym_freq)
        self.host_rec.copy_(rec, non_blocking=self.event is not None)

    def _tier(self, tier: str, head: bool, eager: bool):
        """Run one tier: queued step by step, or replayed; its record."""
        self.graph_stats["tiers"] += 1
        if eager:
            self.graph_stats["eager_tiers"] += 1
            self.graph_stats["eager_steps"] += int(head)
            with profiling.phase("train.device_step", self.dev):
                self._queue(tier, head)
        else:
            self._replay(tier, head)
        return self._fetch()

    def _fetch(self) -> list:
        """The last tier's record, once its copy is on the host (an event
        after the work queued so far, waited for)."""
        with profiling.phase("train.fetch_records"):
            if self.event is not None:
                self.event.record()
                self.event.synchronize()
            return self.host_rec.tolist()

    def _key(self, tier: str, head: bool) -> tuple:
        """The host values a tier's launches read: the table set K1 fills
        (``head``) or filled, K4's output (its address), and for the
        compact tier the runs tables' next table, last fill and parities
        (ops/pairstats.TablePair.host_key), for the full tier the full
        state's (ops/train_loop.PaddedState.host_key)."""
        blk = self.corpus.blocks[0]
        freqs = blk.state._freqs
        runs = self.corpus._runs_tables if tier == "compact" else None
        full = self.corpus._full if tier == "full" else None
        return (tier, head, blk._parity,
                None if freqs is None else freqs[0].data_ptr(),
                None if runs is None else runs.host_key(),
                None if full is None else full.host_key())

    def _host_values(self):
        """(object, attribute) of every host value a tier may move, and
        the PairTables whose fill counts it may advance."""
        blk = self.corpus.blocks[0]
        slots = [(self, "_tables"), (self, "_sym_freq"), (blk, "_parity"),
                 (blk, "filled"), (blk.state, "_freqs"),
                 (blk.state, "sym_freq")]
        full = self.corpus._full
        tables = []
        for pair in (self.corpus._runs_tables,
                     None if full is None else full._tables):
            if pair is not None:
                slots += [(pair, "_next"), (pair, "filled")]
                slots += [(t, "dirty") for t in pair.tables]
                tables += pair.tables
        return slots, tables

    def _prepare(self, tier: str) -> None:
        """Make, before a tier's key is read, what its wrappers would make
        on their first call (nothing may allocate inside a capture): the
        compact tier's output buffers, gathers' outputs and runs tables,
        and the full tier's state and gather's output."""
        corpus = self.corpus
        if tier == "compact":
            cap = min(self.run_cap, corpus.n_local_pairs)
            runs = [corpus.run_buffers(g, cap)
                    for g in range(len(corpus.blocks))]
            for j, name in enumerate(RUN_GATHERS):
                corpus.gather_out(name, [r[j] for r in runs])
            corpus.runs_tables(
                corpus.mesh.gathered_shape([r[0] for r in runs])[0])
        elif tier == "full":
            corpus.full_state()

    def _replay(self, tier: str, head: bool) -> None:
        self._prepare(tier)
        key = self._key(tier, head)
        g = self.graphs.get(key)
        with torch.cuda.device(self.dev):
            if g is None:
                g = self._capture(key, tier, head)
            else:
                for tset, n in g.compactions:
                    tset.advance(n)
            with profiling.phase("train.step_replay", self.dev):
                g.graph.replay()
        for obj, attr, value in g.moved:
            setattr(obj, attr, value)
        for table, n in g.fills:
            table.fills += n
        for name, n in g.launches.items():
            profiling.count(name, n)
        for kind, n in g.collectives:
            self.corpus.mesh.collectives[kind] += n
        self.graph_stats["replays"] += 1

    def _capture(self, key, tier: str, head: bool) -> _TierGraph:
        """Capture the tier's launches on a side stream. The capture
        queues nothing to run, but the wrappers it calls count their
        launches and move the host values as the tier moves them: noted,
        then put back, for the replay that follows to move them (the
        TableSets keep the compactions counted, which that replay runs)."""
        with profiling.phase("train.capture"):
            slots, tables = self._host_values()
            before = [getattr(o, a) for o, a in slots]
            fills = [t.fills for t in tables]
            launched = profiling.counters("launch.")
            issued = dict(self.corpus.mesh.collectives)
            sets = self.corpus.blocks[0].sets
            for tset in sets:  # no restart of the epochs inside
                tset.room(1)
            calls = [tset.calls for tset in sets]
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.dev)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.stream(self._stream):
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    allocated = _allocations(self.dev)
                    self._queue(tier, head)
                    allocated = _allocations(self.dev) - allocated
                finally:
                    graph.capture_end()
            if allocated:
                raise RuntimeError(f"ShardedTrainer: the capture of the "
                                   f"{tier} tier allocated device memory "
                                   f"{allocated} times")
            moved = [(o, a, getattr(o, a)) for (o, a), v in
                     zip(slots, before) if _changed(getattr(o, a), v)]
            launches = profiling.counted_since(launched, "launch.")
            g = _TierGraph(
                graph, moved,
                [(t, t.fills - n) for t, n in zip(tables, fills)
                 if t.fills != n],
                launches,
                [(tset, tset.calls - n) for tset, n in zip(sets, calls)
                 if tset.calls != n],
                [(kind, self.corpus.mesh.collectives[kind] - n)
                 for kind, n in issued.items()
                 if self.corpus.mesh.collectives[kind] != n])
            # put back what the capture moved and counted: the replay
            # moves and counts it
            for (o, a), v in zip(slots, before):
                setattr(o, a, v)
            for t, n in zip(tables, fills):
                t.fills = n
            for name, n in launches.items():
                profiling.count(name, -n)
            self.corpus.mesh.collectives.update(issued)
            self.graphs[key] = g
        self.graph_stats["captures"] += 1
        by_tier = self.graph_stats["graphs"]
        by_tier[tier] = by_tier.get(tier, 0) + 1
        return g

    def close(self) -> None:
        """Release the graphs (after the steps that replay them)."""
        if self.graphs:
            torch.cuda.current_stream(self.dev).synchronize()
            for g in self.graphs.values():
                g.graph.reset()
            self.graphs.clear()

    def merge(self, a: int, b: int, new_id: int) -> None:
        sharded_apply_merge(self.corpus, a, b, new_id)

    def host(self) -> np.ndarray:
        return self.corpus.host()


def _changed(now, was) -> bool:
    """Whether a host value moved: by value for a number, else by
    identity (a list of tables, a tensor, an object)."""
    if isinstance(now, int) and isinstance(was, int):
        return now != was
    return now is not was


def _allocations(dev) -> int:
    """Device allocations made so far on ``dev`` (the caching
    allocator's count)."""
    return torch.cuda.memory_stats(dev).get("allocation.all.allocated", 0)
