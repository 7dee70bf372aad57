"""Gather-latency probe of the H100, the port of the JAX package's TPU
probe ``tools/pallas_probe.py``:

    python3 -m subword_tokenizers_tpu_torch.tools.gather_probe [--seed N]

Two probes at the TPU probe's shapes, each a hand-written CUDA kernel in
``csrc/gather_probe.cu`` with a plain PyTorch version beside it:

- :func:`gather_take2d`: ``out[i] = tab[idx[i], col[i]]`` over an
  int32[4096, 128] table (2 MiB) and 1,024 indices;
- :func:`gather_loop`: 128 dependent gathers per lane, ``v = (tab[(v +
  c) % N] + v) % N`` for c in 0..127, over an int32[50,000] table
  (200,000 bytes) and 2,048 lanes, with the table read through the
  caches (``shared=False``) or first copied into each block's shared
  memory (``shared=True``, the card's counterpart of the TPU's VMEM).

``main`` checks each kernel against its plain version and prints its
time per call and per dependent iteration: the time per iteration of the
shared and the global mode is the latency of one step of a dependent
gather chain, such as kernel 1's trie walk (``csrc/wp_e2e_scan.cu``).
Inputs come from an explicit seed. On CUDA tensors each wrapper launches
its kernel (and counts the launch); on CPU tensors it runs the plain
version.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..ops import check_tensor

TAKE_SHAPE = (4096, 128)    # the TPU probe's N_TAB x 128 table
TAKE_N = 1024               # its N indices
LOOP_N_TAB = 50_000         # probe_loop_gather's N_TAB
LOOP_N = 2048               # its lanes
LOOP_ITERS = 128            # its ITERS
SHARED_MAX_BYTES = 232_448  # dynamic shared memory a block may have
SEED = 20261016


def take_inputs(seed: int = SEED):
    """(tab int32[4096, 128] in [0, 100), idx int32[1024] in [0, 4096),
    col int32[1024] in [0, 128)) as numpy, from ``seed``."""
    rng = np.random.default_rng(seed)
    tab = rng.integers(0, 100, size=TAKE_SHAPE, dtype=np.int32)
    idx = rng.integers(0, TAKE_SHAPE[0], size=TAKE_N, dtype=np.int32)
    col = rng.integers(0, TAKE_SHAPE[1], size=TAKE_N, dtype=np.int32)
    return tab, idx, col


def loop_inputs(seed: int = SEED):
    """(tab int32[50,000], idx int32[2048]), both in [0, 50,000), as
    numpy, from ``seed``."""
    rng = np.random.default_rng(seed + 1)
    tab = rng.integers(0, LOOP_N_TAB, size=LOOP_N_TAB, dtype=np.int32)
    idx = rng.integers(0, LOOP_N_TAB, size=LOOP_N, dtype=np.int32)
    return tab, idx


def gather_take2d_ref(tab, idx, col):
    """Plain PyTorch version of :func:`gather_take2d`."""
    R, C = tab.shape
    ok = (idx >= 0) & (idx < R) & (col >= 0) & (col < C)
    got = tab[idx.clamp(0, R - 1).long(), col.clamp(0, C - 1).long()]
    return torch.where(ok, got, -1)


def gather_take2d(tab, idx, col):
    """``out[i] = tab[idx[i], col[i]]`` (tab int32[R, C], idx and col
    int32[n]) as int32[n]; an index outside the table gives -1.

    Launches ``swt_gather_take2d`` for CUDA tensors, runs the plain
    version for CPU tensors, and raises for any other device."""
    dev = tab.device
    check_tensor("tab", tab, (torch.int32,), 2, dev)
    check_tensor("idx", idx, (torch.int32,), 1, dev)
    check_tensor("col", col, (torch.int32,), 1, dev)
    n = idx.shape[0]
    if col.shape[0] != n or not 1 <= n < 2 ** 31:
        raise ValueError(f"gather_take2d: {n} indices and {col.shape[0]} "
                         "columns, or none")
    if dev.type == "cpu":
        return gather_take2d_ref(tab, idx, col)
    if dev.type != "cuda":
        raise ValueError(f"gather_take2d: no kernel for device {dev}")
    out = torch.empty(n, dtype=torch.int32, device=dev)
    from ..ops import _cuda
    with torch.cuda.device(dev):
        _cuda.launch("swt_gather_take2d", tab.data_ptr(), tab.shape[0],
                     tab.shape[1], idx.data_ptr(), col.data_ptr(), n,
                     out.data_ptr())
    gather_take2d.launches += 1
    return out


gather_take2d.launches = 0


def gather_loop_ref(tab, idx, iters: int = LOOP_ITERS):
    """Plain PyTorch version of :func:`gather_loop` (either mode)."""
    N = tab.shape[0]
    v = idx.clone()
    for c in range(iters):
        v = (tab[((v + c) % N).long()] + v) % N
    return v


def gather_loop(tab, idx, iters: int = LOOP_ITERS, shared: bool = False):
    """``iters`` dependent gathers per lane, ``v = (tab[(v + c) % N] + v)
    % N`` for c in 0..iters-1 from ``v = idx`` (tab int32[N], idx
    int32[n]; int32 adds that wrap and floor remainders, as PyTorch's
    ``%``): int32[n]. ``shared`` runs the chain in shared memory (N * 4
    bytes, at most 232,448).

    Launches ``swt_gather_loop`` for CUDA tensors (counted in
    ``launches`` or ``shared_launches``), runs the plain version for CPU
    tensors, and raises for any other device."""
    dev = tab.device
    check_tensor("tab", tab, (torch.int32,), 1, dev)
    check_tensor("idx", idx, (torch.int32,), 1, dev)
    N, n = tab.shape[0], idx.shape[0]
    if not 1 <= N < 2 ** 31 or not 1 <= n < 2 ** 31 or \
            not 0 <= iters < 2 ** 31:
        raise ValueError(f"gather_loop: table {N}, lanes {n} or iters "
                         f"{iters} out of range")
    if shared and N * 4 > SHARED_MAX_BYTES:
        raise ValueError(f"gather_loop: a table of {N * 4} bytes does not "
                         f"fit in {SHARED_MAX_BYTES} bytes of shared memory")
    if dev.type == "cpu":
        return gather_loop_ref(tab, idx, iters)
    if dev.type != "cuda":
        raise ValueError(f"gather_loop: no kernel for device {dev}")
    out = torch.empty(n, dtype=torch.int32, device=dev)
    from ..ops import _cuda
    with torch.cuda.device(dev):
        _cuda.launch("swt_gather_loop", tab.data_ptr(), N, idx.data_ptr(), n,
                     int(iters), int(bool(shared)), out.data_ptr())
    if shared:
        gather_loop.shared_launches += 1
    else:
        gather_loop.launches += 1
    return out


gather_loop.launches = 0         # global mode
gather_loop.shared_launches = 0  # shared mode


def call_ms(fn, reps: int, device: torch.device) -> float:
    """Mean ms of ``fn`` over ``reps`` calls after one warm-up. On the
    card, by CUDA events over back-to-back launches queued behind a
    spin of about 50 ms (so that the host's cost of each call is hidden);
    on the CPU, by the host clock."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


def main(argv: Optional[list] = None, *, device="cuda") -> Dict[str, dict]:
    """Run both probes on ``device`` and print, for each, whether the
    output equals the plain version on the CPU, its time per call and,
    for the loop, per dependent iteration: the call's over 128, and the
    marginal one (the slope between 128 and 1,152 iterations, which
    leaves out the launch and the table copy). Returns the numbers."""
    parser = argparse.ArgumentParser(
        prog="gather_probe",
        description="Gather-latency probe (the port of the TPU probe "
                    "tools/pallas_probe.py)")
    parser.add_argument("--seed", type=int, default=SEED)
    parser.add_argument("--reps", type=int, default=100)
    args = parser.parse_args(argv)
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("gather_probe(device='cuda'): CUDA is not "
                               "available")
        where = f"{torch.cuda.get_device_name(dev)}, CUDA events"
    else:
        where = "CPU, plain versions, host clock"
    res: Dict[str, dict] = {"device": {"name": where}}

    tab_np, idx_np, col_np = take_inputs(args.seed)
    tab, idx, col = (torch.from_numpy(a).to(dev)
                     for a in (tab_np, idx_np, col_np))
    want = gather_take2d_ref(*(torch.from_numpy(a)
                               for a in (tab_np, idx_np, col_np)))
    ok = torch.equal(gather_take2d(tab, idx, col).cpu(), want)
    ms = call_ms(lambda: gather_take2d(tab, idx, col), args.reps, dev)
    res["take2d"] = {"correct": ok, "us_per_call": ms * 1e3}
    print(f"take-2d: correct = {ok}, {ms * 1e3:.3f} us/call over "
          f"{TAKE_N} indices of a {TAKE_SHAPE[0]} x {TAKE_SHAPE[1]} table "
          f"({where})", flush=True)

    tab_np, idx_np = loop_inputs(args.seed)
    tab, idx = (torch.from_numpy(a).to(dev) for a in (tab_np, idx_np))
    want = gather_loop_ref(torch.from_numpy(tab_np), torch.from_numpy(idx_np))
    long_iters = 9 * LOOP_ITERS
    for shared in (False, True):
        mode = "shared" if shared else "global"
        ok = torch.equal(gather_loop(tab, idx, shared=shared).cpu(), want)
        ms = call_ms(lambda: gather_loop(tab, idx, shared=shared), args.reps,
                     dev)
        ms_long = call_ms(lambda: gather_loop(tab, idx, long_iters, shared),
                          max(args.reps // 5, 1), dev)
        marginal = (ms_long - ms) / (long_iters - LOOP_ITERS) * 1e3
        res[f"loop_{mode}"] = {
            "correct": ok, "us_per_call": ms * 1e3,
            "us_per_iter": ms / LOOP_ITERS * 1e3,
            "marginal_us_per_iter": marginal}
        print(f"loop-gather ({mode}): correct = {ok}, {ms * 1e3:.3f} "
              f"us/call, {ms / LOOP_ITERS * 1e3:.4f} us/iter for {LOOP_N} "
              f"lanes ({LOOP_ITERS} iterations), marginal {marginal:.4f} "
              f"us/iter ({where})", flush=True)
    return res


if __name__ == "__main__":
    main()
