"""Sharded feed-forward receivers over 'ch' and 'time' mesh axes
(counterpart of opv_tpu/parallel/sharded.py).

Channel parallelism splits independent channels like a batch axis; the
global decode count is the sum of the shards' counts.  Time parallelism
splits one long capture into contiguous blocks, each extended by an
overlap-save halo from its right neighbour: the halo covers one full frame
(sync + payload + slack), so every frame whose sync starts in a shard's own
block decodes there, and a frame belongs to the shard where its sync
starts, which makes the seam dedup exact (SURVEY.md section 5).

Each shard's rx_fast runs on the shard's device; every shard is launched
before any result is gathered.  The results come back as tensors of the
JAX package's global shapes and axis order, on the first device of this
process in the mesh (parallel/mesh.py).
"""

from __future__ import annotations

import numpy as np
import torch

from opv_tpu_torch.config import CONFIG
from opv_tpu_torch.parallel.mesh import Mesh, process_rank
from opv_tpu_torch.parallel.multihost import all_gather
from opv_tpu_torch.rx.fast import rx_fast

# halo: one frame of symbols (a payload may start up to a sync word before
# the seam and run a full payload past it) plus timing-phase slack
HALO_SYMBOLS = CONFIG.frame_symbols + CONFIG.sync_bits
HALO_SAMPLES = HALO_SYMBOLS * CONFIG.samples_per_symbol

#: the per-frame outputs of a halo-extended shard, in halo_demod's order
GRID_KEYS = ("frames", "owned", "starts", "metrics", "sync_q")


def check_time_shard_geometry(total_samples: int, ntime: int) -> None:
    """A time shard smaller than the halo cannot lend its neighbour a full
    frame of lookahead: seam-spanning frames would silently vanish."""
    block = total_samples // ntime
    if ntime > 1 and block < HALO_SAMPLES:
        raise ValueError(
            f"time shard of {block} samples is smaller than the "
            f"{HALO_SAMPLES}-sample overlap halo; use <= "
            f"{total_samples // HALO_SAMPLES} time shards for this capture")


def layout(mesh: Mesh, split) -> tuple:
    """(devices, ranks), each (nch, ntime): the mesh's ('ch', 'time') grid
    with an axis not in `split` cut to its first entry (the work replicates
    over it)."""
    devs, ranks = mesh.grid(("ch", "time"))
    if "ch" not in split:
        devs, ranks = devs[:1], ranks[:1]
    if "time" not in split:
        devs, ranks = devs[:, :1], ranks[:, :1]
    return devs, ranks


def shard_blocks(mesh: Mesh, samples, split=("ch", "time")) -> dict:
    """(C, T) samples (numpy or tensor) -> {(i, j): block of 'ch' shard i
    and 'time' shard j on its device}, this process's blocks only."""
    devs, ranks = layout(mesh, split)
    nch, ntime = devs.shape
    x = (samples if isinstance(samples, torch.Tensor)
         else torch.from_numpy(np.asarray(samples)))
    c, t = x.shape
    if c % nch or t % ntime:
        raise ValueError(f"({c}, {t}) samples do not split over a "
                         f"{nch} x {ntime} shard grid")
    lc, lt = c // nch, t // ntime
    me = process_rank()
    return {(i, j): x[i * lc:(i + 1) * lc, j * lt:(j + 1) * lt].to(devs[i, j])
            for i in range(nch) for j in range(ntime) if ranks[i, j] == me}


def halos(mesh: Mesh, blocks: dict, split) -> dict:
    """{(i, j): the first HALO_SAMPLES of block (i, j+1), on (i, j)'s
    device}; the last time shard gets zeros, not the wrapped head.  A head
    whose left neighbour belongs to another process goes over gloo (every
    process joins that gather, so none skips it)."""
    _, ranks = layout(mesh, split)
    nch, ntime = ranks.shape
    crossing = [(i, j) for i in range(nch) for j in range(1, ntime)
                if ranks[i, j] != ranks[i, j - 1]]
    remote = {}
    if crossing:
        mine = {k: blocks[k][:, :HALO_SAMPLES].cpu()
                for k in crossing if k in blocks}
        for part in all_gather(mine):
            remote.update(part)
    out = {}
    for (i, j), b in blocks.items():
        if j == ntime - 1:
            out[(i, j)] = torch.zeros_like(b[:, :HALO_SAMPLES])
        else:
            src = blocks.get((i, j + 1), remote.get((i, j + 1)))
            out[(i, j)] = src[:, :HALO_SAMPLES].to(b.device)
    return out


def halo_demod(block: torch.Tensor, halo, base: int,
               max_frames_per_shard: int, **kw):
    """One shard's body: rx_fast over the block with its right neighbour's
    halo appended (halo None: a single time shard, no halo), and sync-start
    ownership.  Returns (frames, owned, sync_starts, metrics, sync_q) for
    the block; sync_starts are global sample positions (base + the position
    within the block), so streaming receivers can apply cross-batch ownership
    and report absolute stream indices."""
    ext = block if halo is None else torch.cat([block, halo], dim=1)
    out = rx_fast(ext, max_frames=max_frames_per_shard, **kw)
    # ownership: the frame's sync (payload start minus the 24-symbol sync
    # word) falls inside the local block, not the halo
    sync_start = out["starts"] - CONFIG.sync_bits * CONFIG.samples_per_symbol
    owned = out["frame_valid"] & (sync_start < block.shape[1])
    return (out["frames"], owned, base + sync_start, out["metrics"],
            out["sync_q"])


def gather(mesh: Mesh, outs: dict, shape: tuple) -> dict:
    """Per-shard results {(i, j): {key: tensor}} -> {key: the shards
    concatenated, time shards along axis 1 and 'ch' shards along axis 0},
    on this process's first mesh device; a key "n" (per-shard counts) is
    summed.  Across processes every shard's results are gathered over gloo
    first."""
    if mesh.multiprocess:
        merged = {}
        for part in all_gather({k: {n: t.cpu() for n, t in o.items()}
                                for k, o in outs.items()}):
            merged.update(part)
        outs = merged
    home = mesh.home()
    nch, ntime = shape
    keys = next(iter(outs.values())).keys()
    res = {}
    for key in keys:
        parts = [[outs[(i, j)][key].to(home) for j in range(ntime)]
                 for i in range(nch)]
        if key == "n":
            res[key] = torch.stack([p for row in parts for p in row]).sum()
        else:
            res[key] = torch.cat([torch.cat(row, dim=1) for row in parts])
    return res


def halo_grid(mesh: Mesh, blocks: dict, width: int, split,
              max_frames_per_shard: int, **kw) -> dict:
    """The (ch x time) program shared by rx_time_sharded and
    rx_grid_sharded over blocks of `width` samples: halos, every local
    shard's halo_demod launched, then the results gathered; n is the global
    count of owned frames."""
    devs, _ = layout(mesh, split)
    nch, ntime = devs.shape
    halo = halos(mesh, blocks, split) if ntime > 1 else {}
    outs = {}
    for (i, j), b in blocks.items():
        res = dict(zip(GRID_KEYS, halo_demod(b, halo.get((i, j)), j * width,
                                             max_frames_per_shard, **kw)))
        res["n"] = res["owned"].sum()
        outs[(i, j)] = res
    return gather(mesh, outs, (nch, ntime))


def rx_fast_sharded(mesh: Mesh, samples, max_frames_per_shard: int = 8,
                    **kw):
    """Channel-parallel rx_fast: (C, N) split over mesh axis 'ch'.  Each
    shard demodulates its channels on its device; returns (frames (C, F,
    134), the global decode count)."""
    devs, _ = layout(mesh, ("ch",))
    blocks = shard_blocks(mesh, samples, ("ch",))
    outs = {}
    for k, b in blocks.items():
        out = rx_fast(b, max_frames=max_frames_per_shard, **kw)
        outs[k] = dict(frames=out["frames"], n=out["n_decoded"])
    res = gather(mesh, outs, devs.shape)
    return res["frames"], res["n"]


def rx_time_sharded(mesh: Mesh, samples, max_frames_per_shard: int = 8,
                    **kw) -> dict:
    """Time-parallel rx_fast over one (or a few) very long channels:
    (C, T) with T split over mesh axis 'time'.  Returns dict(frames (C,
    ntime*F, 134), owned, starts (global sync positions), metrics, sync_q,
    n the global count of owned frames)."""
    ntime = mesh.shape["time"]
    check_time_shard_geometry(samples.shape[1], ntime)
    blocks = shard_blocks(mesh, samples, ("time",))
    return halo_grid(mesh, blocks, samples.shape[1] // ntime, ("time",),
                     max_frames_per_shard, **kw)
