"""Multi-process execution (counterpart of opv_tpu/parallel/multihost.py).

One controller per process, as in JAX: every process runs the same
program on the identical input and computes the mesh entries it owns.
torch.distributed's gloo backend carries what crosses processes on the
host: per-shard counts, gathered per-channel results (host-bound already:
JAX fetches them with process_allgather) and the halo of a time seam that
spans two processes.  NCCL is not used: it refuses two ranks on one GPU,
and the traffic is kilobytes a block.

global_mesh places each process's devices contiguously along 'time', so a
halo stays inside a process and 'ch' spans processes, as the JAX package
orders its devices.
"""

from __future__ import annotations

import numpy as np
import torch

from opv_tpu_torch.parallel.mesh import Mesh


def initialize_multihost(coordinator: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None) -> None:
    """Join the gloo process group at tcp://coordinator (host:port); with
    no coordinator, nothing (a single process)."""
    if coordinator is None:
        return
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


def all_gather(obj) -> list:
    """Every process's `obj`, in rank order (gloo on the host; [obj] in a
    single process).  Every process must call it at the same point."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def global_mesh(ch: int | None = None, time: int | None = None,
                devices=None) -> Mesh:
    """A (ch, time) mesh over every process's devices.  devices: this
    process's own (default: its visible CUDA devices); the lists are
    exchanged, so every process builds the same mesh.  Each process's
    devices lie contiguously along 'time'."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("global_mesh: no CUDA device visible; pass "
                               "devices=")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    local = [str(torch.device(d)) for d in devices]
    lists = all_gather(local)
    flat = [d for lst in lists for d in lst]
    ranks = [r for r, lst in enumerate(lists) for _ in lst]
    n = len(flat)
    nproc = len(lists)
    if ch is None and time is None:
        ch = nproc if nproc > 1 else 1
        time = n // max(ch, 1)
    elif ch is None:
        ch = n // time
    elif time is None:
        time = n // ch
    if ch * time != n:
        raise ValueError(f"mesh {ch}x{time} != {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = flat
    return Mesh(arr.reshape(ch, time), ("ch", "time"),
                ranks=np.asarray(ranks).reshape(ch, time))
