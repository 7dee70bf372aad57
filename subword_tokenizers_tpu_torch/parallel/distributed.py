"""Several processes, one program: process setup and the host view.

As in the JAX package (its ``parallel/distributed.py``), a job over
several processes runs the same program in each:

    from subword_tokenizers_tpu_torch.parallel import distributed, mesh
    distributed.initialize("localhost:29500", num_processes=2,
                           process_id=rank)          # NCCL, or gloo on CPU
    m = mesh.make_data_mesh()                        # every process's shards
    tok = NaiveBPE(mesh=m)
    tok.train(corpus, max_vocab)                     # the same on each
    if distributed.is_coordinator():
        tok.save_resources(path)                     # process 0 writes

Every reduction of parallel/train.py is order-free (integer sums, minima
of globally defined positions), so every process computes the same merges
with no coordination beyond the collectives.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               device: str = "cuda") -> None:
    """Join the process group: NCCL for ``device="cuda"`` (this process
    then works on CUDA device ``process_id`` modulo the devices it sees),
    gloo for ``"cpu"``. ``coordinator_address`` is ``host:port`` of process
    0's store (or a ``tcp://`` or ``file://`` URL). A second call is a
    no-op, and so is a call with no address and no process count (one
    process), as in the JAX package."""
    import torch.distributed as dist
    if dist.is_initialized():
        return
    if coordinator_address is None and num_processes is None:
        return
    if num_processes is None or process_id is None:
        raise ValueError("initialize: give num_processes and process_id")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize(device='cuda'): CUDA is not "
                               "available")
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"initialize: unsupported device {dev}")
    url = coordinator_address or "localhost:29500"
    if "://" not in url:
        url = f"tcp://{url}"
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id)


def is_initialized() -> bool:
    """Whether this process is in a process group."""
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def local_device() -> torch.device:
    """This process's device: its CUDA device under NCCL (set by
    :func:`initialize`), else the CPU."""
    import torch.distributed as dist
    if is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def is_coordinator() -> bool:
    """Process 0 (the one that writes resources)."""
    import torch.distributed as dist
    return not is_initialized() or dist.get_rank() == 0


def process_count() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if is_initialized() else 1


def fetch_global(parts, mesh) -> np.ndarray:
    """The rows of every shard of ``mesh`` on the host, in shard order:
    ``parts`` holds this process's shards (one tensor each); under a
    process group they are all-gathered first, so every process gets the
    whole array."""
    return mesh.gather(parts).cpu().numpy()
