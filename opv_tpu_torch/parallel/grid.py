"""The combined (channel x time) sharded receiver step (counterpart of
opv_tpu/parallel/grid.py): channels split over 'ch' like a batch axis,
long captures split into time blocks with the halo exchange, the decode
count summed over the whole mesh.

The seam logic (halo exchange and ownership) is parallel/sharded.py's
halo_grid, shared with rx_time_sharded: one implementation.
"""

from __future__ import annotations

from opv_tpu_torch.parallel.mesh import Mesh
from opv_tpu_torch.parallel.sharded import (check_time_shard_geometry,
                                            halo_grid, shard_blocks)


def rx_grid_sharded(mesh: Mesh, samples, max_frames_per_shard: int = 8,
                    **kw) -> dict:
    """The sharded receiver step over mesh axes ('ch', 'time').

    samples: (C, T) (numpy or tensor), C split over 'ch' and T over
    'time'; or the blocks already placed, {(i, j): tensor on its device}
    (parallel/sharded.py::shard_blocks), this process's only.  Returns
    dict(frames (C, ntime*F, 134), owned, starts (global sync sample
    positions), metrics, sync_q, n the global decoded count)."""
    ntime = mesh.shape["time"]
    if isinstance(samples, dict):
        blocks = samples
        total = ntime * next(iter(blocks.values())).shape[1]
    else:
        blocks, total = None, samples.shape[1]
    check_time_shard_geometry(total, ntime)
    if blocks is None:
        blocks = shard_blocks(mesh, samples, ("ch", "time"))
    return halo_grid(mesh, blocks, total // ntime, ("ch", "time"),
                     max_frames_per_shard, **kw)
