"""The data mesh of the port: a 1-D row sharding of the corpus.

The JAX package's mesh (its ``parallel/mesh.py``) is a ``jax.sharding.Mesh``
over a ``data`` axis: word types (training) or unique rows (encode) shard
across it, model state is replicated, and the only coupling is the
per-step reduction of pair statistics. Here a mesh is a small object with
the same role, and its collectives come in two routes behind one
interface, so ``parallel/train.py`` is written once:

- **one process, D shards** (no process group): ``devices`` holds one
  ``torch.device`` per shard and may repeat one device
  (``make_data_mesh(8, devices=["cuda:0"] * 8)`` is eight shards on one
  card, ``["cpu"] * 8`` the CPU tests'). The collectives are tensor ops
  (``torch.cat``, a stacked sum, a stacked amin) whose result lies on the
  first shard's device;
- **a process group** (after ``distributed.initialize()``): each process
  holds its own contiguous block of shards, ``devices`` lists that
  process's shards and ``size`` counts the shards of every process. The
  collectives are ``torch.distributed`` ``all_gather_into_tensor`` and
  ``all_reduce`` (SUM, MIN, MAX) over buffers of one size on every
  process, and their result lies on the process's own device.

In both routes ``home`` is the device of the reduced results, where the
replicated selection runs. A kernel that takes every shard of a device
in one launch (ops/shard_select.py) gives one partial result for each
of ``groups``, the runs of the process's consecutive shards on one
device; the collectives take those partials in place of the shards'
tensors and finish the reduction across devices and processes.

A gather writes into the caller's ``out`` when it is given, and a
process that holds one partial reduces it in place, so the collectives
of a step allocate nothing and can be captured in a CUDA graph
(parallel/train.ShardedTrainer). ``collectives`` counts the
``torch.distributed`` calls made, by kind.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch


def _device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"make_data_mesh: unsupported device {dev}")
    return dev


class DataMesh:
    """A 1-D data mesh of ``size`` shards; this process holds shards
    ``first`` to ``first + len(devices) - 1``, shard ``first + i`` on
    ``devices[i]``."""

    def __init__(self, devices: Sequence, group: bool = False) -> None:
        if not devices:
            raise ValueError("make_data_mesh: no devices")
        self.devices: List[torch.device] = [_device(d) for d in devices]
        if len({d.type for d in self.devices}) != 1:
            raise ValueError("make_data_mesh: the shards' devices must all "
                             "be CUDA or all be the CPU")
        self.group = group
        world, rank, self.backend = 1, 0, None
        if group:
            import torch.distributed as dist
            world, rank = dist.get_world_size(), dist.get_rank()
            self.backend = dist.get_backend()
        self.world = world
        self.collectives = {"all_gather": 0, "all_reduce": 0}
        self.size = len(self.devices) * world
        self.first = rank * len(self.devices)
        self.home = self.devices[0]
        # (device, start, stop): runs of consecutive shards on one device
        self.groups: List[Tuple[torch.device, int, int]] = []
        for i, d in enumerate(self.devices):
            if self.groups and self.groups[-1][0] == d:
                self.groups[-1] = (d, self.groups[-1][1], i + 1)
            else:
                self.groups.append((d, i, i + 1))

    @property
    def type(self) -> str:
        """"cuda" or "cpu"."""
        return self.home.type

    def _local(self, parts) -> List[torch.Tensor]:
        if len(parts) not in (len(self.devices), len(self.groups)):
            raise ValueError(f"expected {len(self.devices)} shard tensors or "
                             f"{len(self.groups)} group partials, got "
                             f"{len(parts)}")
        return [p.to(self.home) for p in parts]

    def gather(self, parts, out: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
        """The shards' tensors (one per shard of this process, each of the
        same shape; or one per group, each its shards' concatenation)
        concatenated along dim 0 in shard order, over every shard of the
        mesh, on ``home``: into ``out`` when it is given (of
        :meth:`gathered_shape`). A single part on one process is returned
        as it is."""
        local = self._local(parts)
        if not self.group:
            if len(local) == 1:
                return local[0]
            return torch.cat(local) if out is None else \
                torch.cat(local, out=out)
        import torch.distributed as dist
        local = local[0] if len(local) == 1 else torch.cat(local)
        if out is None:
            out = torch.empty(self.gathered_shape(parts), dtype=local.dtype,
                              device=local.device)
        dist.all_gather_into_tensor(out, local)
        self.collectives["all_gather"] += 1
        return out

    def gathered_shape(self, parts) -> tuple:
        """The shape :meth:`gather` gives ``parts``."""
        rows = sum(p.shape[0] for p in parts)
        return (self.world * rows,) + tuple(parts[0].shape[1:])

    def _reduce(self, parts, op: str) -> torch.Tensor:
        local = self._local(parts)
        if len(local) == 1:
            local = local[0]  # one partial: reduced in place
        else:
            stacked = torch.stack(local)
            local = stacked.sum(0) if op == "sum" else \
                stacked.amin(0) if op == "min" else stacked.amax(0)
        if self.group:
            import torch.distributed as dist
            dist.all_reduce(local, {"sum": dist.ReduceOp.SUM,
                                    "min": dist.ReduceOp.MIN,
                                    "max": dist.ReduceOp.MAX}[op])
            self.collectives["all_reduce"] += 1
        return local

    def sum(self, parts) -> torch.Tensor:
        """Elementwise sum of the shards' tensors (or of the groups'
        partial sums) over the mesh. A single part is the result: under a
        process group it is reduced in place (as are :meth:`amin`'s and
        :meth:`amax`'s)."""
        return self._reduce(parts, "sum")

    def amin(self, parts) -> torch.Tensor:
        """Elementwise minimum of the shards' tensors (or of the groups'
        partial minima) over the mesh."""
        return self._reduce(parts, "min")

    def amax(self, parts) -> torch.Tensor:
        """Elementwise maximum of the shards' tensors (or of the groups'
        partial maxima) over the mesh."""
        return self._reduce(parts, "max")


def make_data_mesh(n_devices: Optional[int] = None,
                   devices: Optional[Sequence] = None) -> DataMesh:
    """A mesh over the first ``n_devices`` of ``devices``.

    Without a process group, ``devices`` defaults to every CUDA device
    (none is an error: pass ``devices=["cpu"] * n`` for the CPU). After
    ``distributed.initialize()``, ``devices`` are this process's shards
    (default: one shard on its CUDA device, or on the CPU under gloo) and
    the mesh spans every process; ``n_devices``, if given, is then the
    mesh's total size and must equal ``len(devices)`` times the number of
    processes.
    """
    from . import distributed
    group = distributed.is_initialized()
    if devices is None:
        if group:
            devices = [distributed.local_device()]
        elif torch.cuda.is_available():
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        else:
            raise RuntimeError("make_data_mesh: CUDA is not available; pass "
                               "devices=['cpu'] * n for a CPU mesh")
    devices = list(devices)
    if group:
        mesh = DataMesh(devices, group=True)
        if n_devices is not None and n_devices != mesh.size:
            raise ValueError(f"make_data_mesh: {n_devices} shards asked, but "
                             f"{len(devices)} per process over {mesh.world} "
                             f"processes make {mesh.size}")
        return mesh
    if n_devices is not None:
        devices = devices[:n_devices]
    return DataMesh(devices)
