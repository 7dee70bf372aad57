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
4. an input on which the reference would hang raises on the card.

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
    ]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
