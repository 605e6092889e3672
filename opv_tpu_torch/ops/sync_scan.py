"""The sync state machine: the hand-written CUDA kernel (csrc/sync_scan.cu)
and its plain twins, two contracts.  sync_scan:

    raw, norm (C, S) float64, valid (C, S) bool,
    ints (C, 6) int32 [state, sss, misses, collecting, total, frames],
    sync_q (C,) float64 ->
        ints (C, 6), sync_q (C,), ready (C, S) bool, q (C, S) float64,
        events (C, S) int32, ev_misses (C, S) int32, ev_frames (C, S) int32

the lax.scan of opv_tpu/rx/sync.py::sync_scan (`:166`, not a Pallas
kernel): HUNTING -> VERIFYING on a sync hit past the 24-symbol warm-up,
VERIFYING -> LOCKED (frame ready) 2144 symbols after it, LOCKED re-checks
sync every 2168 symbols (OK, a flywheel miss, or lost lock at the 5th) and
emits a frame 2144 symbols after each check while collecting.
sync_correlate_scan takes the soft stream soft_ext (C, 23 + S) in place of
raw and norm, computes them as rx/sync.py::sync_correlate does, and
returns them after the other outputs.  The kernel is one template over its
input: GivenSync (raw, norm given) and SoftSync (the correlation as its
input stage), each counted on its own.  Every output is an integer, a copy
of an input, or the twin's float64 adds and division in the twin's order,
so the kernel and the twins agree bit for bit.  The twin walks each
channel's symbols over Python ints and floats.

Both contracts hold in float32 too (raw, norm, soft_ext, sync_q and q
float32, the JAX package's dtype="float32" mode): the thresholds are then
rounded to float32 once, as a Python float is against a float32 array in
JAX, and the kernel is its float32 instantiation, counted on its own.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from opv_tpu_torch.config import CONFIG
from opv_tpu_torch.ops import build
from opv_tpu_torch.rx.sync import sync_correlate

HUNT, VERIFY, LOCKED = 0, 1, 2
#: transition codes per symbol (opv_tpu/rx/sync.py EV_*)
EV_NONE, EV_HUNT_VERIFY, EV_VERIFY_LOCK, EV_SYNC_OK, EV_SYNC_MISS, \
    EV_LOSE_LOCK = range(6)
INT_WIDTH = 6
_TOTAL_CAP = 1 << 30


_REALS = (torch.float64, torch.float32)


def _thresholds(dtype=torch.float64):
    """(hunt norm, locked norm, hunt raw), rounded to float32 for a
    float32 machine (0.7 becomes 0.699999988...)."""
    thr = (CONFIG.sync_hunt_norm_thresh, CONFIG.sync_locked_norm_thresh,
           CONFIG.sync_hunt_raw_thresh)
    if dtype == torch.float32:
        return tuple(float(np.float32(t)) for t in thr)
    return thr


def _counts():
    return (CONFIG.sync_bits, CONFIG.encoded_bits, CONFIG.frame_symbols,
            CONFIG.sync_miss_limit)


def _i32(x: int) -> int:
    """x wrapped to int32, as the JAX carry wraps."""
    return (x + (1 << 31)) % (1 << 32) - (1 << 31)


def _check(raw, norm, valid, ints, sync_q):
    c, s = raw.shape
    if raw.dtype not in _REALS or norm.dtype != raw.dtype \
            or norm.shape != (c, s) or valid.shape != (c, s):
        raise ValueError(f"raw/norm must be (C, S) float64 or float32 alike "
                         f"and valid (C, S), got {tuple(raw.shape)} "
                         f"{raw.dtype}, {tuple(norm.shape)} {norm.dtype}, "
                         f"{tuple(valid.shape)}")
    _check_carry(ints, sync_q, c, raw.dtype)


def _check_carry(ints, sync_q, c, dtype):
    if ints.shape != (c, INT_WIDTH) or sync_q.shape != (c,) \
            or sync_q.dtype != dtype:
        raise ValueError(f"ints must be ({c}, {INT_WIDTH}) and sync_q ({c},) "
                         f"{dtype}, got {tuple(ints.shape)}, "
                         f"{tuple(sync_q.shape)} {sync_q.dtype}")


def sync_scan_reference(raw: torch.Tensor, norm: torch.Tensor,
                        valid: torch.Tensor, ints: torch.Tensor,
                        sync_q: torch.Tensor):
    """The plain twin (CPU): each channel's symbols in order, over Python
    ints and floats."""
    _check(raw, norm, valid, ints, sync_q)
    hunt_norm, locked_norm, hunt_raw = _thresholds(raw.dtype)
    sync_bits, eb, fs, miss_limit = _counts()
    c, s = raw.shape
    out_ready, out_q, out_ev, out_m, out_f = [], [], [], [], []
    st_out, q_out = [], []
    for (state, sss, misses, coll, total, frames), sq, rr, nn, vv in zip(
            ints.tolist(), sync_q.tolist(), raw.tolist(), norm.tolist(),
            valid.tolist()):
        collecting = bool(coll)
        ready, qs, evs, ms, fr = [False] * s, [0.0] * s, [0] * s, [0] * s, [0] * s
        for t in range(s):
            if vv[t]:
                r, nrm = rr[t], nn[t]
                total = min(_i32(total + 1), _TOTAL_CAP)
                sss1 = _i32(sss + 1)
                hunt_hit = (state == HUNT and total >= sync_bits
                            and r >= hunt_raw and nrm >= hunt_norm)
                ver_done = state == VERIFY and sss1 >= eb
                lock_chk = state == LOCKED and sss1 == fs
                lock_ok = lock_chk and nrm >= locked_norm
                lock_miss = lock_chk and not lock_ok
                m = 0 if lock_ok else (_i32(misses + 1) if lock_miss else misses)
                lose_lock = lock_miss and m >= miss_limit
                flywheel = lock_miss and not lose_lock
                lock_emit = state == LOCKED and collecting and sss1 == eb
                synced = hunt_hit or lock_ok or flywheel
                state = (VERIFY if hunt_hit else LOCKED if ver_done
                         else HUNT if lose_lock else state)
                collecting = (True if synced else False
                              if (ver_done or lose_lock or lock_emit)
                              else collecting)
                sss = 0 if (hunt_hit or lock_chk) else sss1
                sq = nrm if synced else sq
                misses = 0 if ver_done else m
                rdy = ver_done or lock_emit
                frames = _i32(frames + rdy)
                ready[t] = rdy
                evs[t] = (EV_HUNT_VERIFY if hunt_hit else EV_VERIFY_LOCK
                          if ver_done else EV_SYNC_OK if lock_ok
                          else EV_LOSE_LOCK if lose_lock
                          else EV_SYNC_MISS if flywheel else EV_NONE)
            qs[t], ms[t], fr[t] = sq, misses, frames
        out_ready.append(ready)
        out_q.append(qs)
        out_ev.append(evs)
        out_m.append(ms)
        out_f.append(fr)
        st_out.append([state, sss, misses, int(collecting), total, frames])
        q_out.append(sq)
    dev = raw.device
    i32 = dict(dtype=torch.int32, device=dev)
    real = dict(dtype=raw.dtype, device=dev)
    return (torch.tensor(st_out, **i32).reshape(c, INT_WIDTH),
            torch.tensor(q_out, **real).reshape(c),
            torch.tensor(out_ready, dtype=torch.bool, device=dev).reshape(c, s),
            torch.tensor(out_q, **real).reshape(c, s),
            torch.tensor(out_ev, **i32).reshape(c, s),
            torch.tensor(out_m, **i32).reshape(c, s),
            torch.tensor(out_f, **i32).reshape(c, s))


def _check_soft(soft_ext, valid, ints, sync_q):
    if soft_ext.dim() != 2 or soft_ext.dtype not in _REALS \
            or soft_ext.shape[1] < CONFIG.sync_bits - 1:
        raise ValueError(f"soft_ext must be (C, 23 + S) float64 or float32, "
                         f"got {tuple(soft_ext.shape)} {soft_ext.dtype}")
    c, s = soft_ext.shape[0], soft_ext.shape[1] - (CONFIG.sync_bits - 1)
    if valid.shape != (c, s):
        raise ValueError(f"valid must be ({c}, {s}), got {tuple(valid.shape)}")
    _check_carry(ints, sync_q, c, soft_ext.dtype)


def sync_correlate_scan_reference(soft_ext: torch.Tensor, valid: torch.Tensor,
                                  ints: torch.Tensor, sync_q: torch.Tensor):
    """The plain twin (CPU): rx/sync.py::sync_correlate, then
    sync_scan_reference; the machine's outputs, then raw and norm."""
    _check_soft(soft_ext, valid, ints, sync_q)
    raw, norm = sync_correlate(soft_ext)
    return (*sync_scan_reference(raw, norm, valid, ints, sync_q), raw, norm)


def _state_outputs(ints, sync_q, shape):
    """The carry in, the carry out and the machine's five (C, S) outputs,
    allocated on ints' device."""
    dev = ints.device
    ints = ints.to(dtype=torch.int32).contiguous()
    sync_q = sync_q.to(device=dev).contiguous()
    outs = (torch.empty_like(ints), torch.empty_like(sync_q),
            torch.empty(shape, dtype=torch.bool, device=dev),
            torch.empty(shape, dtype=sync_q.dtype, device=dev),
            *(torch.empty(shape, dtype=torch.int32, device=dev)
              for _ in range(3)))
    return ints, sync_q, outs


def launch(lib, raw, norm, valid, ints, sync_q):
    """One GivenSync launch of `lib`'s opv_sync_scan on raw's stream
    (checked tensors; no count; nothing to launch for no channels).  `lib`
    is the port's library or another build exporting the same C entry
    point.  Returns sync_scan's seven outputs."""
    c, s = raw.shape
    dev = raw.device
    raw, norm = raw.contiguous(), norm.contiguous()
    valid = valid.to(device=dev, dtype=torch.bool).contiguous()
    ints, sync_q, outs = _state_outputs(ints.to(dev), sync_q, (c, s))
    if c:
        thr = (ctypes.c_double * 3)(*_thresholds())
        cnt = (ctypes.c_int * 4)(*_counts())
        fn = lib.opv_sync_scan_f32 if raw.dtype == torch.float32 \
            else lib.opv_sync_scan
        err = fn(
            raw.data_ptr(), norm.data_ptr(), valid.data_ptr(), c, s, thr, cnt,
            ints.data_ptr(), sync_q.data_ptr(), *(t.data_ptr() for t in outs),
            build.stream_ptr(raw))
        build.check(lib, err, "sync_scan")
    return outs


def launch_soft(lib, soft_ext, valid, ints, sync_q):
    """One SoftSync launch of `lib`'s opv_sync_correlate_scan on soft_ext's
    stream (checked tensors; no count; nothing to launch for no channels):
    soft_ext's rows are read in place at their stride.  Returns
    sync_correlate_scan's nine outputs."""
    c, n = soft_ext.shape
    s = n - (CONFIG.sync_bits - 1)
    dev = soft_ext.device
    if soft_ext.stride(1) != 1 or (c > 1 and soft_ext.stride(0) < n):
        soft_ext = soft_ext.contiguous()
    ld = soft_ext.stride(0) if c > 1 else n
    valid = valid.to(device=dev, dtype=torch.bool).contiguous()
    ints, sync_q, outs = _state_outputs(ints.to(dev), sync_q, (c, s))
    raw, norm = (torch.empty((c, s), dtype=soft_ext.dtype, device=dev)
                 for _ in range(2))
    if c:
        thr = (ctypes.c_double * 4)(*_thresholds(), CONFIG.sync_min_energy)
        cnt = (ctypes.c_int * 4)(*_counts())
        fn = lib.opv_sync_correlate_scan_f32 \
            if soft_ext.dtype == torch.float32 else lib.opv_sync_correlate_scan
        err = fn(
            soft_ext.data_ptr(), ld, valid.data_ptr(), c, s, thr, cnt,
            CONFIG.sync_word, ints.data_ptr(), sync_q.data_ptr(),
            *(t.data_ptr() for t in outs), raw.data_ptr(), norm.data_ptr(),
            build.stream_ptr(soft_ext))
        build.check(lib, err, "sync_correlate_scan")
    return (*outs, raw, norm)


def sync_scan_cuda(raw: torch.Tensor, norm: torch.Tensor, valid: torch.Tensor,
                   ints: torch.Tensor, sync_q: torch.Tensor):
    """The kernel on given raw/norm (GivenSync): a warp per channel, on
    raw's stream."""
    if not raw.is_cuda:
        raise ValueError("the CUDA sync_scan kernel needs a CUDA tensor")
    _check(raw, norm, valid, ints, sync_q)
    out = launch(build.library(), raw, norm, valid, ints, sync_q)
    if raw.shape[0]:
        sync_scan_cuda.launches[_key("GivenSync", raw.dtype)] += 1
    return out


def sync_correlate_scan_cuda(soft_ext: torch.Tensor, valid: torch.Tensor,
                             ints: torch.Tensor, sync_q: torch.Tensor):
    """The kernel with the correlation as its input stage (SoftSync): a
    warp per channel, on soft_ext's stream."""
    if not soft_ext.is_cuda:
        raise ValueError("the CUDA sync_scan kernel needs a CUDA tensor")
    _check_soft(soft_ext, valid, ints, sync_q)
    out = launch_soft(build.library(), soft_ext, valid, ints, sync_q)
    if soft_ext.shape[0]:
        sync_scan_cuda.launches[_key("SoftSync", soft_ext.dtype)] += 1
    return out


def _key(src: str, dtype) -> str:
    """The launch counter of an instantiation: the input, and float32."""
    return f"{src},float32" if dtype == torch.float32 else src


#: launches per input and precision (one kernel template, four
#: instantiations)
sync_scan_cuda.launches = {"GivenSync": 0, "SoftSync": 0,
                           "GivenSync,float32": 0, "SoftSync,float32": 0}
