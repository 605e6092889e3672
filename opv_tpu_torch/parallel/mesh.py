"""Device meshes (counterpart of opv_tpu/parallel/mesh.py).

A mesh is a named-axis grid of torch devices, as jax.sharding.Mesh is of
JAX devices.  The workload's parallel axes (SURVEY.md section 2):

* ``ch``   channel parallelism: independent RF channels split like a batch
           axis (the reference's analog: one process per radio);
* ``time`` time parallelism: contiguous IQ blocks of one long capture, each
           with an overlap-save halo from its right neighbour.

There is one controller per process, as in JAX: a sharded program loops
over the mesh entries this process owns and runs each entry's piece of
work on that entry's device, launching every piece before it waits on any.
A halo is a ``.to()`` of the neighbour's head; a sum over shards is a sum
of per-shard counts; across processes (and only there) torch.distributed's
gloo backend carries halos, counts and results on the host
(parallel/multihost.py).

A device may appear more than once in a mesh: ``make_mesh({"ch": 8},
devices=["cuda:0"] * 8)`` runs eight shards, each with its own tensors, on
one card, and ``devices=["cpu"] * 8`` is the counterpart of the JAX tests'
eight virtual CPU devices (tests/conftest.py).
"""

from __future__ import annotations

import numpy as np
import torch


def process_rank() -> int:
    """This process's rank in the torch.distributed group (0 when there is
    none)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


class Mesh:
    """devices: an object array of torch.device, one axis per name; ranks:
    the process owning each entry (default: this process, for all)."""

    def __init__(self, devices, axis_names, ranks=None):
        devs = np.asarray(devices, dtype=object)
        self.devices = np.empty(devs.shape, dtype=object)
        for idx in np.ndindex(devs.shape):
            self.devices[idx] = torch.device(devs[idx])
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(f"{len(self.axis_names)} axis names for a "
                             f"{self.devices.ndim}-d device array")
        self.ranks = (np.full(devs.shape, process_rank()) if ranks is None
                      else np.asarray(ranks, dtype=np.int64).reshape(
                          devs.shape))

    @property
    def shape(self) -> dict:
        """{axis name: size}, in axis order (Mesh.shape in JAX)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def multiprocess(self) -> bool:
        return len(np.unique(self.ranks)) > 1

    def grid(self, axes):
        """(devices, ranks), each an array over `axes` in that order (an
        axis the mesh lacks has size 1): the first entry along every other
        axis, which holds the work a program replicates over them."""
        idx = tuple(slice(None) if a in axes else 0 for a in self.axis_names)
        devs, ranks = self.devices[idx], self.ranks[idx]
        kept = [a for a in self.axis_names if a in axes]
        order = [kept.index(a) for a in axes if a in kept]
        devs, ranks = devs.transpose(order), ranks.transpose(order)
        shape = tuple(self.shape.get(a, 1) for a in axes)
        return devs.reshape(shape), ranks.reshape(shape)

    def home(self) -> torch.device:
        """The first device of this process in the mesh: where a sharded
        program's gathered results are put."""
        mine = np.flatnonzero(self.ranks.reshape(-1) == process_rank())
        if not mine.size:
            raise ValueError("no device of this mesh belongs to this process")
        return self.devices.reshape(-1)[mine[0]]


def make_mesh(axes: dict, devices=None) -> Mesh:
    """A mesh with named axes over the first prod(axes) devices.  devices
    defaults to every visible CUDA device (cuda:0 .. cuda:n-1); there is no
    CPU default, so without a card pass devices= (a device may repeat)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device visible; pass "
                               "devices= (e.g. ['cpu'] * 8) to run the "
                               "plain twins")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    shape = tuple(axes.values())
    n = int(np.prod(shape))
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    arr = np.empty(n, dtype=object)
    arr[:] = [torch.device(d) for d in devices[:n]]
    return Mesh(arr.reshape(shape), tuple(axes.keys()))


def channel_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A ('ch'=n) mesh; n defaults to the number of devices given, or of
    visible CUDA devices."""
    if n_devices is None:
        n_devices = (len(devices) if devices is not None
                     else torch.cuda.device_count())
    return make_mesh({"ch": n_devices}, devices)


def channel_shards(mesh: Mesh, channels: int) -> list:
    """The 'ch' shards of a (C, ...) per-channel value: [(lo, hi, device,
    rank)] in channel order, each on the first device of its 'ch' row.
    Raises ValueError (as the JAX engine does) for a mesh without a 'ch'
    axis or channels not divisible by its size."""
    if "ch" not in mesh.shape:
        raise ValueError("mesh must carry a 'ch' axis")
    nch = mesh.shape["ch"]
    if channels % nch:
        raise ValueError(f"{channels} channels not divisible by ch-axis size "
                         f"{nch}")
    devs, ranks = mesh.grid(("ch",))
    lc = channels // nch
    return [(i * lc, (i + 1) * lc, devs[i], int(ranks[i]))
            for i in range(nch)]
