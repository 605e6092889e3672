"""Soft-decision Viterbi (K=7, 64 states) as batched (B, 64) torch loops.

These are the plain twins of the CUDA Viterbi kernel (ops/viterbi.py):
the CPU path, and the kernel's oracle on the card.  Decision rules, bit
for bit: branch metric bm = (expected ? 7 - s : s); the INT_MAX guard
keeps unreachable states unreachable; ties go to parent p0 (radix 2) or
to the lower grandparent, then the lower parent (radix 4); the end state
is the lowest-index state with the minimum metric; full traceback.  The
twins apply the guard at every step; the kernel only in the first 8 (every
state is reachable after 6), which decides identically.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from opv_tpu_torch.config import CONFIG

_NS = CONFIG.num_states
_FB = CONFIG.frame_bits
_INF = 0x7FFFFFFF
_GUARD = 0x7FFFFFF0
_SOFT_MAX = CONFIG.soft_max


@functools.lru_cache(maxsize=None)
def _tables():
    """Per-state parents (p0 = s>>1, p1 = p0+32) and the expected
    (g1, g2) bits of the transition from each parent."""
    s = np.arange(_NS)
    p0 = s >> 1
    p1 = p0 + _NS // 2
    inb = s & 1
    f0 = (inb << 6) | p0
    f1 = (inb << 6) | p1

    def parity(x):
        return np.bitwise_count(x.astype(np.uint8)) & 1

    return (p0.astype(np.int32), p1.astype(np.int32),
            parity(f0 & CONFIG.g1_mask).astype(np.int32),
            parity(f0 & CONFIG.g2_mask).astype(np.int32),
            parity(f1 & CONFIG.g1_mask).astype(np.int32),
            parity(f1 & CONFIG.g2_mask).astype(np.int32))


def _on(a, dev, dtype=torch.int32):
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)


def _bm(e, sg):
    """Branch metric of soft value(s) sg (B, 1) against expected bits e."""
    return torch.where(e == 1, _SOFT_MAX - sg, sg)


def _guard_add(m, bm):
    return torch.where(m < _GUARD, m + bm, torch.full_like(m, _INF))


def _metrics0(b, dev):
    m = torch.full((b, _NS), _INF, dtype=torch.int32, device=dev)
    m[:, 0] = 0
    return m


def _best(metrics):
    best = torch.argmin(metrics, dim=1)          # first minimum
    return best, metrics.gather(1, best[:, None])[:, 0]


def viterbi_decode(soft: torch.Tensor):
    """Decode one frame: (2144,) int soft symbols -> (bits (1072,) uint8,
    path metric 0-d int32), a batch of one through
    ops/registry.py::viterbi_batch (the Viterbi kernel on a CUDA tensor,
    its twin on a CPU tensor)."""
    from opv_tpu_torch.ops import registry   # ops/ imports this module
    soft = torch.as_tensor(soft)
    bits, metric = registry.viterbi_batch(soft.reshape(1, -1))
    return bits[0], metric[0]


def viterbi_decode_batch(soft: torch.Tensor):
    """Radix-2 oracle: (B, 2144) int soft symbols (deinterleaved, (g1, g2)
    per trellis step) -> (bits (B, 1072) uint8, metrics (B,) int32)."""
    dev = soft.device
    b = soft.shape[0]
    p0, p1, e1_0, e2_0, e1_1, e2_1 = (_on(t, dev) for t in _tables())
    p0, p1 = p0.long(), p1.long()
    sg = soft.to(torch.int32).reshape(b, _FB, 2)
    metrics = _metrics0(b, dev)
    decs = torch.empty((_FB, b, _NS), dtype=torch.bool, device=dev)
    for t in range(_FB):
        sg1, sg2 = sg[:, t, 0:1], sg[:, t, 1:2]
        bm0 = _bm(e1_0, sg1) + _bm(e2_0, sg2)
        bm1 = _bm(e1_1, sg1) + _bm(e2_1, sg2)
        m0 = _guard_add(metrics[:, p0], bm0)
        m1 = _guard_add(metrics[:, p1], bm1)
        dec = m1 < m0                             # ties -> p0
        decs[t] = dec
        metrics = torch.where(dec, m1, m0)
    best, metric = _best(metrics)
    bits = torch.empty((b, _FB), dtype=torch.uint8, device=dev)
    s = best
    for t in range(_FB - 1, -1, -1):
        bits[:, t] = s & 1
        took = decs[t].gather(1, s[:, None])[:, 0].long()
        s = (s >> 1) + took * (_NS // 2)
    return bits, metric.to(torch.int32)


@functools.lru_cache(maxsize=None)
def _tables_r4():
    """Radix-4 tables indexed by the FINAL state s of a fused double step:
    expected bits of the second step (via p0 = s>>1) and of the first step
    into p = s>>1 (bp=0) or s>>1 + 32 (bp=1), plus the grandparents
    g = (s>>2) + 16*bp + 32*bg in (bp, bg) order 00, 01, 10, 11."""
    _, _, e1_0, e2_0, _, _ = _tables()
    s = np.arange(_NS)
    pa, pb = s >> 1, (s >> 1) + _NS // 2
    g = {(bp, bg): (s >> 2) + 16 * bp + 32 * bg for bp in (0, 1) for bg in (0, 1)}
    return (e1_0, e2_0, e1_0[pa], e2_0[pa], e1_0[pb], e2_0[pb],
            tuple(g[k].astype(np.int32) for k in ((0, 0), (0, 1), (1, 0), (1, 1))))


def viterbi_decode_r4_batch(soft: torch.Tensor):
    """Radix-4 twin: two trellis steps fused per iteration (536 instead of
    1072), decision-identical to viterbi_decode_batch.  Candidate priority
    (bg within bp, then bp, ties toward 0) reproduces the sequential tie
    rules.  Same contract as viterbi_decode_batch."""
    dev = soft.device
    b = soft.shape[0]
    tabs = _tables_r4()
    E1b, E2b, E1a0, E2a0, E1a1, E2a1 = (_on(t, dev) for t in tabs[:6])
    g00, g01, g10, g11 = (_on(g, dev, torch.long) for g in tabs[6])
    sg = soft.to(torch.int32).reshape(b, _FB // 2, 4)
    metrics = _metrics0(b, dev)
    n2 = _FB // 2
    bps = torch.empty((n2, b, _NS), dtype=torch.int64, device=dev)
    bgs = torch.empty((n2, b, _NS), dtype=torch.int64, device=dev)
    for d in range(n2):
        sg1a, sg2a = sg[:, d, 0:1], sg[:, d, 1:2]
        sg1b, sg2b = sg[:, d, 2:3], sg[:, d, 3:4]
        a2, b2 = _bm(E1b, sg1b), _bm(E2b, sg2b)
        bmB0 = a2 + b2
        bmB1 = a2 - b2 + _SOFT_MAX
        a10, b10 = _bm(E1a0, sg1a), _bm(E2a0, sg2a)
        a11, b11 = _bm(E1a1, sg1a), _bm(E2a1, sg2a)
        c00 = _guard_add(metrics[:, g00], bmB0 + a10 + b10)
        c01 = _guard_add(metrics[:, g01], bmB0 + a10 - b10 + _SOFT_MAX)
        c10 = _guard_add(metrics[:, g10], bmB1 + a11 + b11)
        c11 = _guard_add(metrics[:, g11], bmB1 + a11 - b11 + _SOFT_MAX)
        dga = c01 < c00                           # bg within bp=0
        va = torch.minimum(c00, c01)
        dgb = c11 < c10                           # bg within bp=1
        vb = torch.minimum(c10, c11)
        bp = vb < va                              # ties -> bp=0
        bps[d] = bp
        bgs[d] = torch.where(bp, dgb, dga)
        metrics = torch.minimum(va, vb)
    best, metric = _best(metrics)
    bits = torch.empty((b, _FB), dtype=torch.uint8, device=dev)
    s = best
    for d in range(n2 - 1, -1, -1):
        bits[:, 2 * d + 1] = s & 1
        bp = bps[d].gather(1, s[:, None])[:, 0]
        p = (s >> 1) + bp * (_NS // 2)
        bits[:, 2 * d] = p & 1
        bg = bgs[d].gather(1, s[:, None])[:, 0]
        s = (p >> 1) + bg * (_NS // 2)
    return bits, metric.to(torch.int32)
