#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Drives FastWP batched encode (``subword_tokenizers_tpu_torch``) on the
card at the size of ``data/train-85k.json`` with the 8,043-token
WordPiece vocab ``tests/golden/port_t85k_fastwp_vocab.json``:

0. the card's name and power limit (nvidia-smi) and the versions;
1. builds the native front end (g++) and the CUDA kernels (nvcc,
   sm_90a) from the sources in the checkout;
2. holds each kernel against its plain PyTorch version on the same
   tensors on the card, exactly (every output is an integer): seeded
   random tries and rows that raise every flag, the general-pops route,
   and the 27,482 unique chunks of the corpus; times both;
3. encodes the whole corpus three times through ``FastWP(device="cuda")
   .tokenize_batch``; the output's sha256 must equal the one the JAX
   package gave (``tests/golden/port_t85k_fastwp_expect.json``) and both
   kernels must have been launched; then ``tokenize_stream`` and small
   batches against the host ``tokenize``;
4. an input on which the reference would hang raises on the card;
5. holds the three BPE training kernels (pair counts, selection with
   hash unification, merge with compaction) against their plain
   versions, exactly, on seeded random flat states, on the corpus's
   initial state (187,885 slots) and on its state after 1,000 merges;
   times both at the initial state;
6. trains ``NaiveBPE(device="cuda")`` on the whole corpus to an
   8,000-symbol vocab: every merge must equal the JAX package's
   (``tests/golden/port_t85k_v8000_bpe_merges.json``, whose first 500
   are the reference trainer's ``t85k_v578_merges.json``) and every
   kernel must have been launched; cold and warm times, the phase split
   and the device's idle share under ``torch.profiler``;
6b. the other training routes: a checkpoint at 1,400 resumed to 8,000,
   the exact per-step path to 578, and a forced hash collision;
7. holds the WordPiece training kernels against their plain versions,
   exactly: the exact scorer on about 10^6 seeded cases up to d = 2^104,
   symbol weights (K4), selection by score with "##"-stripping
   unification (K2's WordPiece mode) and the merge carrying the weights
   (K3), on the corpus's initial WordPiece state, after 1,000 merges,
   with weights scaled into the wide score domain, and on a near tie of
   relative gap 2^-51; times each at the initial state;
8. trains ``NaiveWP(device="cuda")`` on the whole corpus to an
   8,000-token vocab: every merge and the vocab must equal the JAX
   package's (``tests/golden/port_t85k_v8000_wp_vocab.json``), the
   carried weights a recount, and every kernel must have been launched;
   cold and warm times, the phase split, and (8c) the idle share;
8b. the other WordPiece routes: a checkpoint at 1,400 merges resumed to
   8,000, the per-step path to 1,000, a forced hash collision, and
   ``FastWP.train`` then ``tokenize_batch`` against the golden vocab.

Each phase prints one line; any failure raises. The line before the last
is the kernels' JSON record, the last ``{"ok": true, "device": ...}``.
Without CUDA, or without the rest of the repo, it exits non-zero.
"""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
DEVICE = "cuda:0"


def digest(token_lists) -> str:
    return hashlib.sha256(json.dumps(token_lists, ensure_ascii=False)
                          .encode("utf-8")).hexdigest()


def cuda_ms(fn, reps: int, queue_ahead: bool = False) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up,
    by CUDA events. ``queue_ahead`` holds the stream in a spin of 1e8
    cycles (about 50 ms) while the host queues the calls, so that a
    kernel shorter than its wrapper's host overhead is timed back to
    back (only for ``fn`` that never waits for the device)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queue_ahead:
        torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_err(got, want) -> int:
    """Largest absolute difference of two integer outputs; 0 if equal."""
    import torch
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if got.numel() == 0:
        return 0
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def emitted(ids, head, out_n, cap):
    """The stream entries that rows wrote (the kernel leaves the rest
    unset)."""
    import torch
    R = out_n.shape[0]
    n = out_n.to(torch.int64).clamp(max=cap)
    cols = torch.arange(cap, device=ids.device)[None, :]
    dest = head[:R].to(torch.int64)[:, None] + cols
    keep = (cols < n[:, None]) & (dest < R * cap)
    return ids[dest[keep]]


def device_trace(fn, path):
    """Run ``fn`` once under torch.profiler; return (host wall ms, device
    busy ms, {kernel or copy name: [count, device ms]}) read from the
    Chrome trace, which is kept at ``path``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path, encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    spans, by_name = [], {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy",
                                                   "gpu_memset"):
            spans.append((e["ts"], e["ts"] + e["dur"]))
            rec = by_name.setdefault(e["name"][:60], [0, 0.0])
            rec[0] += 1
            rec[1] += e["dur"] / 1e3
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return wall * 1e3, busy / 1e3, by_name


def random_case(rng, S, W, n_nodes, A, max_pops, hang_sharp):
    """Random trie tables and char words that reach every mode and flag:
    failure chains with cycles (stuck rows), wide pops (overflow), rows
    whose last char is not punctuation (crash)."""
    import numpy as np
    goto = rng.integers(-1, n_nodes, size=(n_nodes, A + 1))
    goto[rng.random(goto.shape) < 0.5] = -1
    goto[:, A] = -1
    fail = np.array([rng.integers(-1, max(n, 1)) for n in range(n_nodes)])
    cyc = rng.random(n_nodes) < 0.05
    fail[cyc] = rng.integers(0, n_nodes, size=int(cyc.sum()))
    # root_sharp (node 2): a dead end reached from the root, so that bare
    # "##" segments (the sharp sequence) occur.
    goto[0, :4] = 2
    goto[2] = -1
    fail[2] = -1
    cnt = rng.integers(0, max_pops + 1, size=n_nodes)
    pops_off = np.concatenate([[0], np.cumsum(cnt)])
    pops_flat = rng.integers(0, 1000, size=int(pops_off[-1]))
    sharp = [-2] if hang_sharp else list(rng.integers(0, 1000, size=2))
    aid = rng.integers(0, A + 1, size=(S, W))
    bits = (rng.random((3, S, W)) < 0.25).astype(np.int64)
    words = aid | (bits[0] << 22) | (bits[1] << 23) | (bits[2] << 24)
    slen = rng.integers(0, W, size=S)
    tables = [np.asarray(a, dtype=np.int32) for a in
              (goto, fail, pops_off, pops_flat, sharp)]
    return (np.asarray(words, dtype=np.int32),
            np.asarray(slen, dtype=np.int32), tables,
            dict(root_p=n_nodes - 1, root_sharp=2, unk_id=1000))


def bpe_random_state(rng, n_words, max_len, n_sym, wscale, unit, holes):
    """A seeded flat BPE state (numpy fs, wid, wgt) with word boundaries,
    tail padding, runs of equal symbols, and optionally equal weights
    (ties decided by first position) or dead slots inside."""
    import numpy as np
    from subword_tokenizers_tpu_torch.ops.flat import WID_PAD, build_flat
    sym = np.full((n_words, max_len), -1, dtype=np.int32)
    for w in range(n_words):
        n = int(rng.integers(1, max_len + 1))
        s = int(rng.integers(0, n_sym))
        for j in range(n):
            if rng.random() > 0.45:
                s = int(rng.integers(0, n_sym))
            sym[w, j] = s
    freq = (np.ones(n_words, np.int64) if unit
            else rng.integers(1, 50, size=n_words)) * wscale
    fs, wid, wgt = build_flat(sym, freq, pad_to=64)
    if holes:
        dead = (rng.random(fs.shape[0]) < 0.08) & (fs >= 0)
        fs[dead], wid[dead], wgt[dead] = -1, WID_PAD, 0
    return fs, wid, wgt


def main() -> int:
    import numpy as np
    import torch

    # ---- phase 0: the card
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    kind = torch.cuda.get_device_name(0)
    print(f"phase 0: {kind}; python {sys.version.split()[0]}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")

    sys.path.insert(0, ROOT)
    from subword_tokenizers_tpu_torch import FastWP
    from subword_tokenizers_tpu_torch._native import binding
    from subword_tokenizers_tpu_torch.benchmarks import profiling
    from subword_tokenizers_tpu_torch.frontend.charclass import PUNC_PY, WS_PY
    from subword_tokenizers_tpu_torch.ops import _cuda
    from subword_tokenizers_tpu_torch.ops.fetch import (compact_ids,
                                                        compact_ids_ref)
    from subword_tokenizers_tpu_torch.ops.wp_encode import pack_words
    from subword_tokenizers_tpu_torch.ops.wp_encode_e2e import (
        route_params, wp_e2e_scan, wp_e2e_scan_ref)
    dev = torch.device(DEVICE)

    # ---- phase 1: builds
    t0 = time.perf_counter()
    binding.load()
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    _cuda.lib()
    t_cuda = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in _cuda.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"phase 1: native front end {t_native:.2f} s, CUDA kernels "
          f"{t_cuda:.2f} s (sm_90a); ptxas: {' | '.join(ptxas)}")

    # ---- phase 2: each kernel against its plain version, on the card
    errs = {"wp_e2e_scan": 0, "compact_ids": 0}
    n_cases = 0
    flag_rows = np.zeros(4, dtype=np.int64)

    def check(chars, slen, tables, roots, cap, max_steps, unk_ovf):
        nonlocal n_cases
        goto, fail, pops_off, pops_flat, sharp = tables
        args = (chars, slen, goto, fail, pops_off, pops_flat,
                roots["root_p"], roots["root_sharp"], roots["unk_id"],
                sharp)
        got = wp_e2e_scan(*args, cap=cap, max_steps=max_steps,
                          unk_ovf=unk_ovf)
        want = wp_e2e_scan_ref(*args, cap, max_steps, unk_ovf)
        for g, w in zip(got, want):
            errs["wp_e2e_scan"] = max(errs["wp_e2e_scan"], max_err(g, w))
        ids, head = compact_ids(*got)
        ids_r, head_r = compact_ids_ref(*want)
        errs["compact_ids"] = max(
            errs["compact_ids"], max_err(head, head_r),
            max_err(emitted(ids, head, got[1], cap),
                    emitted(ids_r, head_r, want[1], cap)))
        flags = head_r[chars.shape[0] + 1:].cpu().numpy()
        for b in range(4):
            flag_rows[b] += int((flags >> b & 1).sum())
        n_cases += 1
        return got, want, ids, head

    rng = np.random.default_rng(SEED)
    for k in range(6):
        words, slen, tables, roots = random_case(
            rng, S=2048, W=24, n_nodes=96, A=40,
            max_pops=11 if k < 2 else 3, hang_sharp=k % 2 == 1)
        tables = [torch.from_numpy(t).to(dev) for t in tables]
        slen_d = torch.from_numpy(slen).to(dev)
        u16 = ((words & 0x1FFF) | ((words >> 9) & 0xE000)).astype(np.uint16)
        for chars in (torch.from_numpy(words).to(dev),
                      torch.from_numpy(u16.view(np.int16)).to(dev)):
            for general in (False, True):
                check(chars, slen_d, tables, roots,
                      *route_params(chars.shape[1], general))
    if not all(flag_rows):
        raise AssertionError(f"random cases left a flag unset: {flag_rows}")

    # the general-pops route on a real trie: max_pops = 11
    gen = FastWP(device=dev)
    gen.vocab = {"a", "##a", "a" * 12 + "z", "!"}
    gen._build_e2e()
    st = gen._device_state()
    assert st.max_pops == 11, st.max_pops
    alphabet = np.array([ord(c) for c in "aaaaz! "], dtype=np.uint32)
    cps = alphabet[rng.integers(0, alphabet.size, size=(512, 40))]
    cps[:, -1] = 32
    slen = rng.integers(1, 40, size=512).astype(np.int32)
    chars = pack_words(*(torch.from_numpy(a).to(dev) for a in
                         (st.alpha[cps], WS_PY[cps], PUNC_PY[cps])))
    check(chars, torch.from_numpy(slen).to(dev),
          [st.goto, st.fail, st.pops_off, st.pops_flat, st.sharp],
          dict(root_p=st.root_p, root_sharp=st.root_sharp,
               unk_id=st.unk_id), *route_params(40, general=True))

    # the main path's shapes: the corpus's unique chunks
    with open(os.path.join(ROOT, "data", "train-85k.json"),
              encoding="utf-8") as f:
        corpus = json.load(f)
    with open(os.path.join(ROOT, "tests", "golden",
                           "port_t85k_fastwp_vocab.json"),
              encoding="utf-8") as f:
        vocab = json.load(f)
    with open(os.path.join(ROOT, "tests", "golden",
                           "port_t85k_fastwp_expect.json"),
              encoding="utf-8") as f:
        expect = json.load(f)
    tok = FastWP(device=dev)
    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "vocab.json"), "w", encoding="utf-8") as f:
            json.dump(vocab, f, ensure_ascii=False)
        tok.load_resources(d, strict=True)
    st = tok._device_state()
    _, _, uniq_buf, uniq_off, uniq_len = binding.encode_prep(corpus)
    Lc = -(-(int(uniq_len.max()) + 2) // 8) * 8
    mat16 = binding.pack_u16_rows(uniq_buf, uniq_off, uniq_len, Lc, st.alpha)
    assert mat16.shape == (expect["unique_chunks"], 32), mat16.shape
    chars = torch.from_numpy(mat16.view(np.int16)).to(dev)
    slen_d = torch.from_numpy((uniq_len + 1).astype(np.int32)).to(dev)
    tables = [st.goto, st.fail, st.pops_off, st.pops_flat, st.sharp]
    roots = dict(root_p=st.root_p, root_sharp=st.root_sharp,
                 unk_id=st.unk_id)
    params = route_params(Lc, general=False)
    got, want, ids, head = check(chars, slen_d, tables, roots, *params)
    R = mat16.shape[0]
    total = int(head[R])
    assert total == int(want[1].sum()) and total > 0, total
    assert not bool(head[R + 1:].any()), "real chunks raised a flag"
    assert errs["wp_e2e_scan"] == 0 and errs["compact_ids"] == 0, errs
    scan_args = (chars, slen_d, st.goto, st.fail, st.pops_off,
                 st.pops_flat, st.root_p, st.root_sharp, st.unk_id, st.sharp)
    timing = {
        "wp_e2e_scan": (
            cuda_ms(lambda: wp_e2e_scan(*scan_args, *params), 50, True),
            cuda_ms(lambda: wp_e2e_scan_ref(*scan_args, *params), 3)),
        "compact_ids": (
            cuda_ms(lambda: compact_ids(*got), 200, True),
            cuda_ms(lambda: compact_ids_ref(*got), 20)),
    }
    torch.cuda.synchronize()
    print(f"phase 2: kernels equal their plain versions exactly on "
          f"{n_cases} cases (rows flagged ovf/stuck/crash/##: "
          f"{flag_rows.tolist()}); at {R} x {Lc}: scan "
          f"{timing['wp_e2e_scan'][0]:.3f} ms (plain "
          f"{timing['wp_e2e_scan'][1]:.3f} ms), compact "
          f"{timing['compact_ids'][0]:.3f} ms (plain "
          f"{timing['compact_ids'][1]:.3f} ms); {smi}")

    # ---- phase 3: the main path
    n_bytes = sum(len(s.encode("utf-8")) for s in corpus)
    wp_e2e_scan.launches = 0
    compact_ids.launches = 0
    # run 0 is cold, runs 1-3 warm, run 4 warm with the phase profiler on
    # (it synchronises after each device phase)
    walls = []
    for run in range(5):
        profiling.enable(run == 4)
        profiling.reset()
        out = None
        t0 = time.perf_counter()
        out = tok.tokenize_batch(corpus)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if digest(out) != expect["full_sha256"]:
            raise AssertionError(f"run {run}: output differs from the JAX "
                                 "package's")
    phase_ms = {name: round(v["total_s"] * 1e3, 3)
                for name, v in profiling.report().items()}
    profiling.enable(False)
    warm = sorted(walls[1:4])[1]
    launches = {"wp_e2e_scan": wp_e2e_scan.launches,
                "compact_ids": compact_ids.launches}
    if not all(launches.values()):
        raise AssertionError(f"a kernel was not launched: {launches}")
    n_tokens = sum(map(len, out))
    assert n_tokens == expect["full_tokens"], n_tokens
    print(f"phase 3: tokenize_batch of {len(corpus)} sentences "
          f"({n_bytes} bytes, {n_tokens} tokens) equals the JAX sha256; "
          f"launches {launches}; cold {walls[0]*1e3:.3f} ms, warm "
          f"{[round(w * 1e3, 3) for w in walls[1:4]]} ms, median "
          f"{warm*1e3:.3f} ms = {n_bytes/warm/1e6:.3f} MB/s; "
          f"profiled {walls[4]*1e3:.3f} ms, phases (ms) "
          f"{json.dumps(phase_ms)}; {smi}")

    streamed = list(tok.tokenize_stream(iter(corpus), batch_sentences=8192))
    assert streamed == out, "tokenize_stream differs from one batch"
    small = rng.integers(0, len(corpus), size=64)
    for n in (1, 7, 64):
        batch = [corpus[i] for i in small[:n]]
        assert tok.tokenize_batch(batch) == [tok.tokenize(s) for s in batch]
    print("phase 3b: tokenize_stream (11 blocks of <= 8192) equals the "
          "batch; batches of 1, 7 and 64 equal the host tokenize")

    out = None
    wall, busy, by_name = device_trace(
        lambda: tok.tokenize_batch(corpus),
        os.path.join(ROOT, "chiprun_out", "chip_smoke_trace.json"))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    dev_line = ("not measured (the trace holds no device events)"
                if not by_name else
                f"device busy {busy:.3f} ms of {wall:.1f} ms "
                f"(idle share {1 - busy / wall:.4f}); "
                + "; ".join(f"{n} x{c} {ms:.3f} ms" for n, (c, ms) in top))
    print(f"phase 3c: one warm tokenize_batch under torch.profiler: "
          f"{dev_line}; {smi}")

    # ---- phase 4: an input on which the reference hangs
    hang = FastWP(device=dev)
    hang.vocab = {"a"}
    hang._build_e2e()
    try:
        hang.tokenize_batch(["a ¤ a"])
    except RuntimeError as e:
        assert "makes no progress" in str(e), e
        print(f"phase 4: the hang input raised on the card: {e}")
    else:
        raise AssertionError("the hang input did not raise")

    # ---- phase 5: the BPE training kernels against their plain versions
    from subword_tokenizers_tpu_torch import NaiveBPE
    from subword_tokenizers_tpu_torch.core.corpus import (build_bpe_corpus,
                                                          unique_words)
    from subword_tokenizers_tpu_torch.core.symbols import SymbolTable
    from subword_tokenizers_tpu_torch.frontend.pretokenize import \
        pretokenize_batch
    from subword_tokenizers_tpu_torch.ops import train_loop
    from subword_tokenizers_tpu_torch.ops.flat import (build_flat,
                                                       merge_apply,
                                                       merge_apply_ref)
    from subword_tokenizers_tpu_torch.ops.pairstats import (alloc_table,
                                                            canonical,
                                                            pair_stats,
                                                            pair_stats_ref)
    from subword_tokenizers_tpu_torch.ops.train_loop import (
        init_tables, select_unify, select_unify_ref, str_hashes)
    bpe_kernels = ("pair_stats", "select_unify", "merge_apply")
    errs.update({k: 0 for k in bpe_kernels})

    def err_all(got, want):
        return max(max_err(g, w) for g, w in zip(got, want))

    def hash_tables(strings, sym_cap, max_len):
        """(h1, h2, slen, pw1, pw2) on the card for a list of symbol
        strings (repeats allowed: several ids with one hash)."""
        h = np.zeros((3, sym_cap), dtype=np.int64)
        for i, s in enumerate(strings):
            h[0, i], h[1, i] = str_hashes(s)
            h[2, i] = len(s)
        pw = train_loop.pow_tables(max_len + 4)
        return [torch.from_numpy(x).to(dev) for x in (*h, *pw)]

    def check_bpe(fs, wid, wgt, strings, max_vocab, max_len):
        """K1, K2 (both modes) and K3 (the winner, a self-merge, an
        inactive step) against their plain versions on one state."""
        tab = pair_stats(fs, wid, wgt)
        errs["pair_stats"] = max(errs["pair_stats"], err_all(
            canonical(*tab), pair_stats_ref(fs, wid, wgt)))
        n = len(strings)
        h1, h2, sl, pw1, pw2 = hash_tables(strings, max_vocab + 8, max_len)
        recs = []
        for host_ids in (False, True):
            st = [h1.clone(), h2.clone(), sl.clone(),
                  torch.tensor([n, n, 1], dtype=torch.int32, device=dev)]
            st_r = [x.clone() for x in st]
            rec = torch.zeros(6, dtype=torch.int32, device=dev)
            rec_r = rec.clone()
            select_unify(*tab, *st, pw1, pw2, max_vocab, rec, host_ids)
            select_unify_ref(*tab, *st_r, pw1, pw2, max_vocab, rec_r,
                             host_ids)
            errs["select_unify"] = max(errs["select_unify"],
                                       err_all([*st, rec], [*st_r, rec_r]))
            recs.append(rec)
        a, b = recs[0].tolist()[:2]
        self_pair = int(fs[(fs >= 0)].mode().values)
        for row in (recs[0].tolist(), [self_pair, self_pair, n, 0, 1, 0],
                    [a, b, n, 0, 0, 0]):
            rec = torch.tensor(row, dtype=torch.int32, device=dev)
            rec_r = rec.clone()
            got = merge_apply(fs, wid, wgt, rec)
            want = merge_apply_ref(fs, wid, wgt, rec_r)
            errs["merge_apply"] = max(errs["merge_apply"],
                                      err_all([*got, rec], [*want, rec_r]))
        return recs[0]

    n_bpe_cases = 0
    for k, (unit, holes, wscale, n_sym) in enumerate(
            [(False, False, 1, 6), (True, False, 1, 6),
             (False, True, 1, 6), (False, False, (1 << 28) + 9871, 6),
             (False, False, 1, 2), (True, False, 1 << 42, 3)]):
        fs, wid, wgt = (torch.from_numpy(x).to(dev) for x in
                        bpe_random_state(rng, 4000, 12, n_sym, wscale,
                                         unit, holes))
        strings = [chr(ord("a") + i) for i in range(n_sym)]
        rec = check_bpe(fs, wid, wgt, strings, 100, 12)
        # forced hits: the winner's string present at two ids
        a, b = rec.tolist()[:2]
        merged = strings[a] + strings[b]
        check_bpe(fs, wid, wgt, strings + [merged, "zz", merged], 100, 12)
        n_bpe_cases += 2

    words, freq, _ = unique_words(pretokenize_batch(corpus))
    table = SymbolTable()
    arrays = build_bpe_corpus(words, freq, table)
    max_len = arrays.sym.shape[1]
    flat0 = build_flat(arrays.sym, arrays.freq)
    F0 = flat0[0].shape[0]
    n_slots = int((flat0[0] >= 0).sum())
    fs, wid, wgt = (torch.from_numpy(x).to(dev) for x in flat0)
    check_bpe(fs, wid, wgt, table.strings(), 8000, max_len)
    # the state after 1,000 merges, from the kernel path
    state = train_loop.FlatState(*flat0, dev)
    t1000 = SymbolTable(table.strings())
    train_loop.run_fused(state, t1000, len(table) + 1000, max_len,
                         lambda *m: None)
    assert len(t1000) == len(table) + 1000, len(t1000)
    check_bpe(*state.arrays(), t1000.strings(), 8000, max_len)
    n_bpe_cases += 2
    if any(errs[k] for k in bpe_kernels):
        raise AssertionError(f"a BPE kernel differs: {errs}")

    # times at the initial state
    tab = alloc_table(F0, dev)
    h1, h2, sl, ctrl, pw1, pw2, _ = init_tables(table, 8000, max_len, dev)
    rec = torch.zeros(6, dtype=torch.int32, device=dev)
    pair_stats(fs, wid, wgt, tab)
    tab_ref = pair_stats_ref(fs, wid, wgt)
    select_unify(*tab, h1, h2, sl, ctrl, pw1, pw2, 8000, rec)
    out = tuple(torch.empty_like(x) for x in (fs, wid, wgt))
    timing["pair_stats"] = (
        cuda_ms(lambda: pair_stats(fs, wid, wgt, tab), 200, True),
        cuda_ms(lambda: pair_stats_ref(fs, wid, wgt), 10))
    timing["select_unify"] = (
        cuda_ms(lambda: select_unify(*tab, h1, h2, sl, ctrl, pw1, pw2,
                                     8000, rec), 200, True),
        cuda_ms(lambda: select_unify_ref(*tab_ref, h1, h2, sl, ctrl, pw1,
                                         pw2, 8000, rec), 10))
    timing["merge_apply"] = (
        cuda_ms(lambda: merge_apply(fs, wid, wgt, rec, out=out), 200, True),
        cuda_ms(lambda: merge_apply_ref(fs, wid, wgt, rec), 10))
    torch.cuda.synchronize()
    print(f"phase 5: BPE kernels equal their plain versions exactly on "
          f"{n_bpe_cases} states (6 random x 2 symbol tables, the 85k "
          f"initial state, after 1,000 merges); at {n_slots} slots "
          f"(F = {F0}): " + ", ".join(
              f"{k} {timing[k][0]:.3f} ms (plain {timing[k][1]:.3f} ms)"
              for k in bpe_kernels) + f"; {smi}")

    # ---- phase 6: the BPE training path, the whole corpus to 8,000
    golden_dir = os.path.join(ROOT, "tests", "golden")
    with open(os.path.join(golden_dir, "port_t85k_v8000_bpe_merges.json"),
              encoding="utf-8") as f:
        golden = [tuple(p) for p in json.load(f)]
    with open(os.path.join(golden_dir, "t85k_v578_merges.json"),
              encoding="utf-8") as f:
        anchor = [tuple(p) for p in json.load(f)]
    assert golden[:len(anchor)] == anchor

    def check_train(tok, what):
        if tok.merges_list != golden or len(tok.vocab) != 8000:
            bad = next((i for i, (g, w) in enumerate(
                zip(tok.merges_list, golden)) if g != w),
                min(len(tok.merges_list), len(golden)))
            raise AssertionError(
                f"{what}: {len(tok.merges_list)} merges, first difference "
                f"from the JAX golden at merge {bad}")
        rebuilt = ["".join(syms) for syms, _ in tok.corpus_as_symbols]
        if rebuilt != words or [f for _, f in tok.corpus_as_symbols] != \
                freq.tolist():
            raise AssertionError(f"{what}: corpus_as_symbols is wrong")

    pair_stats.launches = select_unify.launches = merge_apply.launches = 0
    # run 0 is cold (the process's first training), runs 1-2 warm, run 3
    # warm with the phase profiler on (it synchronises after each device
    # phase)
    train_walls = []
    for run in range(4):
        profiling.enable(run == 3)
        profiling.reset()
        tok = NaiveBPE(device=dev)
        t0 = time.perf_counter()
        tok.train(corpus, 8000)
        torch.cuda.synchronize()
        train_walls.append(time.perf_counter() - t0)
        check_train(tok, f"run {run}")
    train_phase_ms = {name: round(v["total_s"] * 1e3, 3)
                      for name, v in profiling.report().items()}
    profiling.enable(False)
    launches.update(pair_stats=pair_stats.launches,
                    select_unify=select_unify.launches,
                    merge_apply=merge_apply.launches)
    if not all(launches[k] for k in bpe_kernels):
        raise AssertionError(f"a BPE kernel was not launched: {launches}")
    print(f"phase 6: NaiveBPE(device='cuda').train of all {len(corpus)} "
          f"sentences ({len(words)} word types, {n_slots} slots) to 8000: "
          f"{len(golden)} merges equal the JAX golden (first "
          f"{len(anchor)} = the reference anchor); launches "
          f"{ {k: launches[k] for k in bpe_kernels} }; cold "
          f"{train_walls[0]:.3f} s, warm {train_walls[1]:.3f} / "
          f"{train_walls[2]:.3f} s; profiled {train_walls[3]:.3f} s, phases "
          f"(ms) {json.dumps(train_phase_ms)}; {smi}")

    with tempfile.TemporaryDirectory() as d:
        wall, busy, by_name = device_trace(
            lambda: NaiveBPE(device=dev).train(corpus, 8000),
            os.path.join(d, "train_trace.json"))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    dev_line = ("not measured (the trace holds no device events)"
                if not by_name else
                f"device busy {busy:.3f} ms of {wall:.1f} ms "
                f"(idle share {1 - busy / wall:.4f}); "
                + "; ".join(f"{n} x{c} {ms:.3f} ms" for n, (c, ms) in top))
    print(f"phase 6c: one warm train under torch.profiler: {dev_line}; "
          f"{smi}")

    # ---- phase 6b: the other training routes
    with tempfile.TemporaryDirectory() as d:
        part = NaiveBPE(device=dev)
        part.train(corpus, 1400, checkpoint_dir=d, checkpoint_every=500)
        assert part.merges_list == golden[:len(part.merges_list)]
        resumed = NaiveBPE(device=dev)
        resumed.train(corpus, 8000, checkpoint_dir=d, resume=True)
        check_train(resumed, "resumed run")
    per_step = NaiveBPE(device=dev)
    per_step._force_per_step = True
    per_step.train(corpus, 578)
    assert per_step.merges_list == anchor, "per-step path left the anchor"
    small = corpus[:500]
    plain = NaiveBPE(device=dev)
    plain.train(small, 300)
    real_hashes, real_run = train_loop.str_hashes, train_loop.run_fused
    raised = []

    def spy(*args, **kwargs):
        try:
            return real_run(*args, **kwargs)
        except train_loop.HashCollision as e:
            raised.append(e)
            raise

    try:
        train_loop.str_hashes = lambda s: (0, 0)
        train_loop.run_fused = spy
        forced = NaiveBPE(device=dev)
        forced.train(small, 300)
    finally:
        train_loop.str_hashes, train_loop.run_fused = real_hashes, real_run
    assert len(raised) == 1, "the forced collision did not fall back"
    assert (forced.merges_list, forced.corpus_as_symbols) == \
        (plain.merges_list, plain.corpus_as_symbols)
    print(f"phase 6b: a checkpoint at {len(part.merges_list)} merges "
          f"resumed to 8000 equals the golden; the per-step path to 578 "
          f"equals the reference anchor; a forced hash collision on 500 "
          f"sentences fell back and equals the fused run "
          f"({len(plain.merges_list)} merges)")

    # ---- phase 7: the WordPiece training kernels against their plain
    # versions
    from subword_tokenizers_tpu_torch import NaiveWP
    from subword_tokenizers_tpu_torch.core.corpus import build_wp_corpus
    from subword_tokenizers_tpu_torch.ops.bitmath import (score_bits,
                                                          score_bits_ref)
    from subword_tokenizers_tpu_torch.ops.pairstats import (
        EMPTY_KEY, symbol_freqs, symbol_freqs_ref)
    wp_kernels = ("symbol_freqs", "wp_score", "select_unify_wp",
                  "merge_apply_wp")
    errs.update({k: 0 for k in wp_kernels})

    # the scorer: weights of every bit length up to 52 (d up to 2^104),
    # counts up to the smaller weight, and the edge families
    n = 1 << 20
    fa = rng.integers(1, 1 << 52, size=n) >> rng.integers(0, 52, size=n)
    fb = rng.integers(1, 1 << 52, size=n) >> rng.integers(0, 52, size=n)
    cs = np.minimum(rng.integers(1, 1 << 53, size=n)
                    >> rng.integers(0, 53, size=n), np.minimum(fa, fb))
    top = (1 << 52) - 1
    edge = [(c, 1 << i, 1 << j) for i in range(52) for j in range(0, 52, 5)
            for c in (1, 3, (1 << 33) - 1)]
    edge += [(c, c * (1 << k) + dl, 1 << j) for k in range(2, 40)
             for c in (3, 5, 101, 2049) for dl in (-1, 0, 1)
             for j in (0, 13, 51) if c * (1 << k) + dl < (1 << 52)]
    edge += [((1 << 53) - 1 - i, top - i, top - 2 * i) for i in range(64)]
    edge += [(0, 0, 0), (1, top, top), (top, 1, 1)]
    cs, fa, fb = (np.concatenate([x, np.array(e, dtype=np.int64)])
                  for x, e in zip((cs, fa, fb), zip(*edge)))
    n_wide = int(sum(int(a) * int(b) >= (1 << 53) for a, b in
                     zip(fa.tolist(), fb.tolist())))
    c_d, fa_d, fb_d = (torch.from_numpy(x).to(dev) for x in (cs, fa, fb))
    errs["wp_score"] = max_err(score_bits(c_d, fa_d, fb_d),
                               score_bits_ref(c_d, fa_d, fb_d))
    n_score = int(cs.shape[0])

    def check_wp(fs, wid, wgt, strings, max_len, sf=None):
        """K4, K1 + K2's WordPiece mode (both modes) and K3 with the
        weights (the winner, a self-merge, an inactive step) against
        their plain versions on one state. ``sf``: the weights the run
        carried, which must equal K4's recount."""
        cap = 8008 if sf is None else sf.shape[0] - 1
        sf_k4 = symbol_freqs(fs, wgt, cap)
        errs["symbol_freqs"] = max(errs["symbol_freqs"], max_err(
            sf_k4, symbol_freqs_ref(fs, wgt, cap)))
        if sf is not None:
            errs["merge_apply_wp"] = max(errs["merge_apply_wp"],
                                         max_err(sf, sf_k4))
        tab = pair_stats(fs, wid, wgt)
        n = len(strings)
        h1, h2, sl, pw1, pw2 = hash_tables(strings, cap, max_len)
        sharp = str_hashes("##")
        recs = []
        for host_ids in (False, True):
            st = [h1.clone(), h2.clone(), sl.clone(),
                  torch.tensor([n, n, 1], dtype=torch.int32, device=dev)]
            st_r = [x.clone() for x in st]
            rec = torch.zeros(6, dtype=torch.int32, device=dev)
            rec_r = rec.clone()
            select_unify(*tab, *st, pw1, pw2, 8000, rec, host_ids, True,
                         sf_k4, sharp)
            select_unify_ref(*tab, *st_r, pw1, pw2, 8000, rec_r, host_ids,
                             True, sf_k4, sharp)
            errs["select_unify_wp"] = max(errs["select_unify_wp"], err_all(
                [*st, rec], [*st_r, rec_r]))
            recs.append(rec)
        a, b = recs[0].tolist()[:2]
        self_pair = int(fs[(fs >= 0)].mode().values)
        for row in (recs[0].tolist(), [self_pair, self_pair, n, 0, 1, 0],
                    [a, b, n, 0, 0, 0]):
            rec = torch.tensor(row, dtype=torch.int32, device=dev)
            rec_r = rec.clone()
            s_k, s_r = sf_k4.clone(), sf_k4.clone()
            got = merge_apply(fs, wid, wgt, rec, sym_freq=s_k)
            want = merge_apply_ref(fs, wid, wgt, rec_r, sym_freq=s_r)
            errs["merge_apply_wp"] = max(
                errs["merge_apply_wp"],
                err_all([*got, rec, s_k], [*want, rec_r, s_r]),
                max_err(s_k, symbol_freqs_ref(got[0], got[2], cap)))
        return recs[0]

    table_wp = SymbolTable()
    arrays_wp = build_wp_corpus(words, freq, table_wp)
    flat_wp = build_flat(arrays_wp.sym, arrays_wp.freq)
    assert flat_wp[0].shape[0] == F0
    fs, wid, wgt = (torch.from_numpy(x).to(dev) for x in flat_wp)
    check_wp(fs, wid, wgt, table_wp.strings(), max_len)
    # weights scaled into the wide score domain (6,006,645 occurrences
    # times 2^28 + 9871 is about 2^50.5; fa * fb passes 2^53)
    wide_scale = (1 << 28) + 9871
    check_wp(fs, wid, wgt * wide_scale, table_wp.strings(), max_len)
    sf_wide = symbol_freqs(fs, wgt * wide_scale, 8008)
    assert int(sf_wide.max()) ** 2 >= 1 << 53
    # the state after 1,000 merges, from the kernel path, with the
    # weights it carried
    state = train_loop.FlatState(*flat_wp, dev)
    t1000 = SymbolTable(table_wp.strings())
    train_loop.run_fused(state, t1000, len(table_wp) + 1000, max_len,
                         lambda *m: None, wordpiece=True)
    assert len(t1000) == len(table_wp) + 1000, len(t1000)
    check_wp(*state.arrays(), t1000.strings(), max_len, state.sym_freq)
    n_wp_cases = 3
    # a near tie: c1/(A q) and c2/(A p) with c1 p - c2 q = 1, a relative
    # gap of about 2^-51; the larger double wins, and on a tie the first
    # position
    q, p = (1 << 26) - 1, (1 << 26) - 3
    c1 = (1 << 25) - 1
    c2 = (c1 * p - 1) // q
    A = (1 << 20) + 7
    sf_b = torch.tensor([1, A, p, q, 1], dtype=torch.int64, device=dev)
    s1, s2 = c1 / (A * q), c2 / (A * p)
    assert s1 != s2
    for pos1, pos2 in ((5, 9), (9, 5)):
        tab = (torch.tensor([(1 << 32) | 3, EMPTY_KEY, (1 << 32) | 2,
                             EMPTY_KEY], dtype=torch.int64, device=dev),
               torch.tensor([c1, 0, c2, 0], dtype=torch.int64, device=dev),
               torch.tensor([pos1, 0, pos2, 0], dtype=torch.int32,
                            device=dev))
        z = torch.zeros(1, dtype=torch.int64, device=dev)
        rec = torch.zeros(6, dtype=torch.int32, device=dev)
        rec_r = rec.clone()
        args = (z, z, z, torch.zeros(3, dtype=torch.int32, device=dev), z,
                z, 0)
        select_unify(*tab, *args, rec, True, True, sf_b)
        select_unify_ref(*tab, *args, rec_r, True, True, sf_b)
        errs["select_unify_wp"] = max(errs["select_unify_wp"],
                                      max_err(rec, rec_r))
        want_b = 3 if (s1 > s2 or (s1 == s2 and pos1 < pos2)) else 2
        assert rec.tolist()[:2] == [1, want_b], rec.tolist()
        n_wp_cases += 1
    if any(errs[k] for k in wp_kernels):
        raise AssertionError(f"a WordPiece kernel differs: {errs}")

    # times at the initial state
    cap = 8008
    sf0 = symbol_freqs(fs, wgt, cap)
    tab = pair_stats(fs, wid, wgt, alloc_table(F0, dev))
    tab_ref = pair_stats_ref(fs, wid, wgt)
    h1, h2, sl, ctrl, pw1, pw2, sharp = init_tables(table_wp, 8000, max_len,
                                                    dev)
    rec = torch.zeros(6, dtype=torch.int32, device=dev)
    select_unify(*tab, h1, h2, sl, ctrl, pw1, pw2, 8000, rec, False, True,
                 sf0, sharp)
    out = tuple(torch.empty_like(x) for x in (fs, wid, wgt))
    sf_t = sf0.clone()
    sc = tuple(x[:F0].clone() for x in (c_d, fa_d, fb_d))
    sc_narrow = tuple(torch.from_numpy(x).to(dev) for x in (
        rng.integers(1, 1 << 20, size=F0), rng.integers(1, 1 << 26, size=F0),
        rng.integers(1, 1 << 26, size=F0)))
    timing["symbol_freqs"] = (
        cuda_ms(lambda: symbol_freqs(fs, wgt, cap), 200, True),
        cuda_ms(lambda: symbol_freqs_ref(fs, wgt, cap), 10))
    timing["wp_score"] = (
        cuda_ms(lambda: score_bits(*sc_narrow), 200, True),
        cuda_ms(lambda: score_bits_ref(*sc_narrow), 10))
    timing["wp_score_mixed"] = (
        cuda_ms(lambda: score_bits(*sc), 200, True),
        cuda_ms(lambda: score_bits_ref(*sc), 1))
    timing["select_unify_wp"] = (
        cuda_ms(lambda: select_unify(*tab, h1, h2, sl, ctrl, pw1, pw2, 8000,
                                     rec, False, True, sf0, sharp), 200,
                True),
        cuda_ms(lambda: select_unify_ref(*tab_ref, h1, h2, sl, ctrl, pw1,
                                         pw2, 8000, rec, False, True, sf0,
                                         sharp), 10))
    timing["merge_apply_wp"] = (
        cuda_ms(lambda: merge_apply(fs, wid, wgt, rec, out=out,
                                    sym_freq=sf_t), 200, True),
        cuda_ms(lambda: merge_apply_ref(fs, wid, wgt, rec, sym_freq=sf_t),
                10))
    torch.cuda.synchronize()
    print(f"phase 7: WordPiece kernels equal their plain versions exactly: "
          f"the scorer on {n_score} cases ({n_wide} wide, d up to 2^104), "
          f"K4, K2's WordPiece mode and K3 with the weights on {n_wp_cases} "
          f"states (the 85k initial state, its weights times 2^28 + 9871, "
          f"after 1,000 merges, a near tie of gap 2^-51 in both orders); at "
          f"{n_slots} slots (F = {F0}): " + ", ".join(
              f"{k} {timing[k][0]:.3f} ms (plain {timing[k][1]:.3f} ms)"
              for k in ("symbol_freqs", "select_unify_wp",
                        "merge_apply_wp"))
          + f"; scorer on {F0} narrow cases {timing['wp_score'][0]:.3f} ms "
          f"(plain {timing['wp_score'][1]:.3f} ms), on {F0} of the mixed "
          f"cases {timing['wp_score_mixed'][0]:.3f} ms (plain "
          f"{timing['wp_score_mixed'][1]:.3f} ms); {smi}")

    # ---- phase 8: the WordPiece training path, the whole corpus to 8,000
    with open(os.path.join(golden_dir, "port_t85k_v8000_wp_vocab.json"),
              encoding="utf-8") as f:
        golden_wp = json.load(f)
    wp_merges = [tuple(m) for m in golden_wp["merges"]]
    wp_vocab = golden_wp["vocab"]
    n_alpha = len(wp_vocab) - len(wp_merges)
    assert n_alpha == len(table_wp), (n_alpha, len(table_wp))

    def check_wp_train(tok, what, n_merges=None):
        want = wp_merges[:n_merges]
        if tok._merge_log != want or (n_merges is None and sorted(
                tok.vocab) != wp_vocab):
            bad = next((i for i, (g, w) in enumerate(
                zip(tok._merge_log, want)) if g != w),
                min(len(tok._merge_log), len(want)))
            raise AssertionError(
                f"{what}: {len(tok._merge_log)} merges, first difference "
                f"from the JAX golden at merge {bad}")
        rebuilt = [syms[0] + "".join(s[2:] for s in syms[1:])
                   for syms, _ in tok.corpus_as_symbols]
        if rebuilt != words or [f for _, f in tok.corpus_as_symbols] != \
                freq.tolist():
            raise AssertionError(f"{what}: corpus_as_symbols is wrong")

    states = []
    real_state = train_loop.FlatState

    class KeptState(real_state):
        """FlatState that keeps each instance, to read the carried
        weights after a run."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            states.append(self)

    pair_stats.launches = select_unify.launches = merge_apply.launches = 0
    select_unify.wp_launches = merge_apply.wp_launches = 0
    symbol_freqs.launches = 0
    # run 0 is cold (the process's first WordPiece training), runs 1-2
    # warm, run 3 warm with the phase profiler on
    wp_walls = []
    try:
        train_loop.FlatState = KeptState
        for run in range(4):
            profiling.enable(run == 3)
            profiling.reset()
            tok = NaiveWP(device=dev)
            t0 = time.perf_counter()
            tok.train(corpus, 8000)
            torch.cuda.synchronize()
            wp_walls.append(time.perf_counter() - t0)
            check_wp_train(tok, f"WordPiece run {run}")
    finally:
        train_loop.FlatState = real_state
    wp_phase_ms = {name: round(v["total_s"] * 1e3, 3)
                   for name, v in profiling.report().items()}
    profiling.enable(False)
    wp_launches = {"pair_stats": pair_stats.launches,
                   "select_unify": select_unify.wp_launches,
                   "merge_apply": merge_apply.wp_launches,
                   "symbol_freqs": symbol_freqs.launches}
    if not all(wp_launches.values()) or \
            select_unify.launches != select_unify.wp_launches:
        raise AssertionError(f"a WordPiece kernel was not launched: "
                             f"{wp_launches}")
    st = states[-1]
    fs_end, _, wgt_end = st.arrays()
    cap = st.sym_freq.shape[0] - 1
    recount = symbol_freqs(fs_end, wgt_end, cap)
    errs["merge_apply_wp"] = max(errs["merge_apply_wp"], max_err(
        st.sym_freq, recount), max_err(st.sym_freq, symbol_freqs_ref(
            fs_end, wgt_end, cap)))
    if errs["merge_apply_wp"]:
        raise AssertionError("the carried weights differ from a recount")
    print(f"phase 8: NaiveWP(device='cuda').train of all {len(corpus)} "
          f"sentences ({len(words)} word types, {n_slots} slots, "
          f"{len(table_wp)} initial symbols) to 8000: {len(wp_merges)} "
          f"merges and the vocab equal the JAX golden, corpus_as_symbols "
          f"rebuilds the words, the carried weights equal a recount; "
          f"launches {wp_launches}; cold {wp_walls[0]:.3f} s, warm "
          f"{wp_walls[1]:.3f} / {wp_walls[2]:.3f} s; profiled "
          f"{wp_walls[3]:.3f} s, phases (ms) {json.dumps(wp_phase_ms)}; "
          f"{smi}")

    with tempfile.TemporaryDirectory() as d:
        wall, busy, by_name = device_trace(
            lambda: NaiveWP(device=dev).train(corpus, 8000),
            os.path.join(d, "wp_train_trace.json"))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    dev_line = ("not measured (the trace holds no device events)"
                if not by_name else
                f"device busy {busy:.3f} ms of {wall:.1f} ms "
                f"(idle share {1 - busy / wall:.4f}); "
                + "; ".join(f"{n} x{c} {ms:.3f} ms" for n, (c, ms) in top))
    print(f"phase 8c: one warm WordPiece train under torch.profiler: "
          f"{dev_line}; {smi}")

    # ---- phase 8b: the other WordPiece routes
    with tempfile.TemporaryDirectory() as d:
        part = NaiveWP(device=dev)
        part.train(corpus, n_alpha + 1400, checkpoint_dir=d,
                   checkpoint_every=500)
        check_wp_train(part, "checkpointed run", 1400)
        resumed = NaiveWP(device=dev)
        resumed.train(corpus, 8000, checkpoint_dir=d, resume=True)
        check_wp_train(resumed, "resumed run")
    per_step = NaiveWP(device=dev)
    per_step._force_per_step = True
    per_step.train(corpus, n_alpha + 1000)
    check_wp_train(per_step, "per-step run", 1000)
    small = corpus[:500]
    plain = NaiveWP(device=dev)
    plain.train(small, 300)
    real_hashes, real_run = train_loop.str_hashes, train_loop.run_fused
    raised = []

    def spy(*args, **kwargs):
        try:
            return real_run(*args, **kwargs)
        except train_loop.HashCollision as e:
            raised.append(e)
            raise

    try:
        train_loop.str_hashes = lambda s: (0, 0)
        train_loop.run_fused = spy
        forced = NaiveWP(device=dev)
        forced.train(small, 300)
    finally:
        train_loop.str_hashes, train_loop.run_fused = real_hashes, real_run
    assert len(raised) == 1, "the forced collision did not fall back"
    assert (forced._merge_log, forced.vocab, forced.corpus_as_symbols) == \
        (plain._merge_log, plain.vocab, plain.corpus_as_symbols)
    fast = FastWP(device=dev)
    fast.train(corpus, 8000)
    check_wp_train(fast, "FastWP run")
    loaded = FastWP(device=dev)
    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "vocab.json"), "w", encoding="utf-8") as f:
            json.dump(wp_vocab, f, ensure_ascii=False)
        loaded.load_resources(d, strict=True)
    encoded = fast.tokenize_batch(corpus)
    if digest(encoded) != digest(loaded.tokenize_batch(corpus)):
        raise AssertionError("FastWP after train encodes differently from "
                             "the golden vocab")
    print(f"phase 8b: a checkpoint at 1400 merges resumed to 8000 equals "
          f"the golden; the per-step path to 1000 merges equals its "
          f"prefix; a forced hash collision on 500 sentences fell back and "
          f"equals the fused run ({len(plain._merge_log)} merges); "
          f"FastWP.train then tokenize_batch ({sum(map(len, encoded))} "
          f"tokens) equals a FastWP loading the golden vocab")

    record = {"kernels": [
        {"name": "wp_e2e_scan", "route": "cuda",
         "source": "subword_tokenizers_tpu_torch/csrc/wp_e2e_scan.cu",
         "replaces": "subword_tokenizers_tpu/ops/wp_encode_e2e.py:109",
         "launches": launches["wp_e2e_scan"],
         "max_abs_err": errs["wp_e2e_scan"],
         "ms": timing["wp_e2e_scan"][0],
         "plain_ms": timing["wp_e2e_scan"][1]},
        {"name": "compact_ids", "route": "cuda",
         "source": "subword_tokenizers_tpu_torch/csrc/compact.cu",
         "replaces": "subword_tokenizers_tpu/ops/fetch.py:31",
         "launches": launches["compact_ids"],
         "max_abs_err": errs["compact_ids"],
         "ms": timing["compact_ids"][0],
         "plain_ms": timing["compact_ids"][1]},
    ] + [
        {"name": k, "route": "cuda",
         "source": f"subword_tokenizers_tpu_torch/csrc/{k}.cu",
         "replaces": replaces, "launches": launches[k],
         "max_abs_err": errs[k], "ms": timing[k][0],
         "plain_ms": timing[k][1]}
        for k, replaces in (
            ("pair_stats", "subword_tokenizers_tpu/ops/flat.py:65"),
            ("select_unify", "subword_tokenizers_tpu/ops/train_loop.py:68"),
            ("merge_apply", "subword_tokenizers_tpu/ops/flat.py:204"))]}
    # the WordPiece path (phase 8) through K1-K3, and its two new kernels
    by_name = {k["name"]: k for k in record["kernels"]}
    by_name["pair_stats"]["wp_launches"] = wp_launches["pair_stats"]
    for k, replaces in (
            ("select_unify", "subword_tokenizers_tpu/ops/pairstats.py:240"),
            ("merge_apply", "subword_tokenizers_tpu/ops/train_loop.py:264")):
        by_name[k].update(
            wp_mode=f"WordPiece mode, replaces {replaces}",
            wp_launches=wp_launches[k], wp_max_abs_err=errs[f"{k}_wp"],
            wp_ms=timing[f"{k}_wp"][0], wp_plain_ms=timing[f"{k}_wp"][1])
    record["kernels"] += [
        {"name": "symbol_freqs", "route": "cuda",
         "source": "subword_tokenizers_tpu_torch/csrc/symbol_freqs.cu",
         "replaces": "subword_tokenizers_tpu/ops/pairstats.py:201",
         "launches": wp_launches["symbol_freqs"],
         "max_abs_err": errs["symbol_freqs"],
         "ms": timing["symbol_freqs"][0],
         "plain_ms": timing["symbol_freqs"][1]},
        {"name": "wp_score", "route": "cuda",
         "source": "subword_tokenizers_tpu_torch/csrc/select_unify.cu",
         "replaces": "subword_tokenizers_tpu/ops/pairstats.py:211",
         "launches": wp_launches["select_unify"],
         "note": "a __device__ scorer run inside each WordPiece-mode "
                 "select_unify launch (those are its launches); its own "
                 "launcher swt_score_bits serves the checks and the times",
         "max_abs_err": errs["wp_score"], "ms": timing["wp_score"][0],
         "plain_ms": timing["wp_score"][1]}]
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
