"""Checkpoint/resume of the streaming engine's state.

The state is a dict of leaves (LockedStreamDemodulator.state_tree), of
leaves and such dicts (WidebandReceiver.state_tree nests the engine's
under "demod"), or of leaves and NamedTuples of leaves
(StreamingDemodulator.state_tree's LoopState and SyncTrackerState).  Its
leaves are stored in the JAX package's layout (opv_tpu/stream/state.py):
one .npz holding `n_leaves` and `leaf_{i}`, the leaves in the order
jax.tree.flatten gives, a dict by sorted key and a NamedTuple by field,
depth first.  A checkpoint written by either package therefore loads
in the other.

Tensors are stored as numpy arrays; bfloat16 tensors widened to float32
(exact), since numpy has no bfloat16.  Both engines cast a float32 buffer
to their own buffer dtype on load.
"""

from __future__ import annotations

import numpy as np
import torch


def _norm(path: str) -> str:
    # np.savez appends .npz on write; normalize so load finds the same file
    return path if path.endswith(".npz") else path + ".npz"


def _is_record(x) -> bool:
    """A NamedTuple (a tuple with fields), which jax.tree.flatten walks
    in field order."""
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _paths(tree, prefix=()) -> list:
    """The key path of every leaf, in jax.tree.flatten's order."""
    if not isinstance(tree, dict):
        raise TypeError(f"state must be a dict, got {type(tree).__name__}")
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += _paths(v, prefix + (k,))
        elif _is_record(v):
            out += [prefix + (k, i) for i in range(len(v))]
        elif isinstance(v, (list, tuple)):
            raise TypeError(f"state entry {prefix + (k,)} is a "
                            f"{type(v).__name__}; only dicts and NamedTuples "
                            f"nest")
        else:
            out.append(prefix + (k,))
    return out


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def to_host(x) -> np.ndarray:
    """A host numpy copy of a tensor, bfloat16 widened to float32 (exact);
    a numpy value passes through.  A CPU tensor is copied too, so the
    array never aliases a tensor the caller keeps."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.to(torch.float32)
        return x.cpu().numpy() if x.is_cuda else x.numpy().copy()
    return np.asarray(x)


def to_device(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """x on `device`.  A host tensor goes to the card through a pinned
    staging copy, non-blocking: a copy from pageable memory would
    synchronize the stream and so wait for every block in flight.  The
    caching host allocator keeps the staging memory until its copy has
    run."""
    if device.type != "cuda" or x.is_cuda:
        return x.to(device)
    staged = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    return staged.copy_(x).to(device, non_blocking=True)


def save_state(path: str, tree: dict) -> None:
    leaves = [to_host(_get(tree, p)) for p in _paths(tree)]
    np.savez(_norm(path), n_leaves=np.int64(len(leaves)),
             **{f"leaf_{i}": x for i, x in enumerate(leaves)})


def _rebuild(like, leaves):
    """`like`'s structure with its leaves taken in order from `leaves`."""
    if isinstance(like, dict):
        return {k: _rebuild(like[k], leaves) for k in sorted(like)}
    if _is_record(like):
        return type(like)(*(next(leaves) for _ in like))
    return next(leaves)


def load_state(path: str, like: dict) -> dict:
    """Restore a state saved with save_state (by either package), using
    `like` (a state of the same layout) for its structure: dicts of numpy
    leaves, NamedTuples rebuilt with numpy fields."""
    paths = _paths(like)
    with np.load(_norm(path)) as data:
        if int(data["n_leaves"]) != len(paths):
            raise ValueError(
                f"checkpoint has {int(data['n_leaves'])} leaves but the "
                f"target structure has {len(paths)} — wrong `like` template?")
        leaves = iter([data[f"leaf_{i}"] for i in range(len(paths))])
        return _rebuild(like, leaves)
