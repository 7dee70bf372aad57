"""Flags byte and dense token stream of a batch of scanned rows (kernel 2).

Same semantics as the JAX package's ``ops/fetch.py`` (``compact_ids``)
and the tail of ``ops/wp_encode_e2e.py`` (``wp_e2e_scan_u16_stacked``):
each row's emitted prefix ``out[r, :min(out_n[r], cap)]`` goes to the
stream at the exclusive prefix sum of ``out_n``, and each row gets the
flags byte ``ovf | stuck<<1 | crash<<2 | sawneg2<<3``.

The stream is i32 in the caller's row order: the JAX package's u16
stream, row sort and static prefix served its TPU's remote link. The
host stitches by (offset, count), which gives the same token lists.

The kernel (``csrc/compact.cu``) is one launch over tiles of rows, each
tile placed in the stream by a look-back over a per-device
:class:`StreamScratch`, which FastWP's fused scan
(ops/wp_encode_e2e.wp_e2e_scan_compact) shares.
"""
from __future__ import annotations

import torch

from ..benchmarks import profiling
from . import check_tensor

TILE_ROWS = 256  # rows of a tile of kernel 2 (csrc/compact.cu)
EPOCH_MAX = (1 << 30) - 1


class StreamScratch:
    """The look-back words of the stream kernels on one device: ``words``
    int64[2 + 2 n_tiles] holds the tile ticket (0 between calls) and a
    16-byte status word a tile, each carrying its call's epoch, so a word
    of an earlier call is never read as this call's. Grown, never shrunk;
    zeroed when it grows and when the epochs wrap."""

    def __init__(self, device) -> None:
        self.device = torch.device(device)
        self.words = torch.zeros(2, dtype=torch.int64, device=self.device)
        self.epoch = 0

    def take(self, n_tiles: int):
        """(words, epoch) for a call over ``n_tiles`` tiles."""
        need = 2 + 2 * n_tiles
        if self.words.shape[0] < need:
            self.words = torch.zeros(max(need, 2 * self.words.shape[0]),
                                     dtype=torch.int64, device=self.device)
            self.epoch = 0
        self.epoch += 1
        if self.epoch > EPOCH_MAX:
            self.words.zero_()
            self.epoch = 1
        return self.words, self.epoch


_SCRATCH = {}  # device -> StreamScratch


def stream_scratch(dev) -> StreamScratch:
    """The :class:`StreamScratch` of ``dev``, made on first use. Calls on
    one device share it, so they must run on one stream."""
    s = _SCRATCH.get(dev)
    if s is None:
        s = _SCRATCH[dev] = StreamScratch(dev)
    return s


def compact_ids_ref(out2d, out_n, ovf=None, stuck=None, crash=None):
    """Plain PyTorch version of the kernel (same outputs; stream
    positions no row writes are 0 here and unset in the kernel's)."""
    dev = out2d.device
    R, cap = out2d.shape
    offs = torch.zeros(R + 1, dtype=torch.int64, device=dev)
    torch.cumsum(out_n.to(torch.int64), 0, out=offs[1:])
    cols = torch.arange(cap, device=dev)[None, :]
    emitted = cols < out_n[:, None]
    dest = offs[:R, None] + cols
    keep = emitted & (dest < R * cap)
    ids = torch.zeros(R * cap, dtype=torch.int32, device=dev)
    ids[dest[keep]] = out2d[keep]
    neg2 = (emitted & (out2d == -2)).any(dim=1)
    flags = neg2.to(torch.int32) << 3
    for bit, f in enumerate((ovf, stuck, crash)):
        if f is not None:
            flags |= f.to(torch.int32) << bit
    return ids, torch.cat([offs.to(torch.int32), flags])


def compact_ids(out2d, out_n, ovf=None, stuck=None, crash=None):
    """Dense token stream and per-row flags of scanned rows.

    out2d: int32[R, cap]; out_n: int32[R]; ovf, stuck, crash: bool[R]
    or None, false on every row (the outputs of
    ops/wp_encode_e2e.wp_e2e_scan).

    Returns (ids int32[R*cap], head int32[2R+1]): ``head[:R]`` are the
    rows' offsets in ``ids``, ``head[R]`` is the total, and
    ``head[R+1:]`` are the flags bytes, so one copy brings all three to
    the host. Launches the CUDA kernel for CUDA tensors, runs the
    PyTorch version for CPU tensors, and raises for any other device.
    """
    dev = out2d.device
    check_tensor("out2d", out2d, (torch.int32,), 2, dev)
    check_tensor("out_n", out_n, (torch.int32,), 1, dev)
    flags = (("ovf", ovf), ("stuck", stuck), ("crash", crash))
    for name, t in flags:
        if t is not None:
            check_tensor(name, t, (torch.bool,), 1, dev)
    R, cap = out2d.shape
    if any(t is not None and t.shape[0] != R for t in (out_n, ovf, stuck,
                                                       crash)):
        raise ValueError("compact_ids: inconsistent shapes")
    if R * cap >= 2 ** 31:
        raise ValueError("compact_ids: stream would pass 2**31 entries")
    if dev.type == "cpu":
        return compact_ids_ref(out2d, out_n, ovf, stuck, crash)
    if dev.type != "cuda":
        raise ValueError(f"compact_ids: no kernel for device {dev}")
    ids = torch.empty(R * cap, dtype=torch.int32, device=dev)
    if R == 0:
        return ids, torch.zeros(1, dtype=torch.int32, device=dev)
    head = torch.empty(2 * R + 1, dtype=torch.int32, device=dev)
    words, epoch = stream_scratch(dev).take(-(-R // TILE_ROWS))
    from . import _cuda
    with torch.cuda.device(dev):
        _cuda.launch("swt_compact", out2d.data_ptr(), R, cap,
                     out_n.data_ptr(),
                     *(0 if t is None else t.data_ptr() for _, t in flags),
                     ids.data_ptr(), head.data_ptr(), words.data_ptr(),
                     epoch)
    profiling.count("launch.compact_ids")
    return ids, head
