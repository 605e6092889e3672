"""The reference-exact modulator's NCO phase recurrence: the hand-written
CUDA kernel (csrc/phase_track.cu), its plain twin and a model of the
kernel's walk, one contract:

    (T,) float64 start phases ph0, T increments, n ->
        (phases (T, n) float64, final (T,) float64)
    phases[t, 0] = ph0[t], phases[t, i+1] = wrap(phases[t, i] + inc[t]),
    final[t] = wrap(phases[t, n-1] + inc[t])

wrap(p): p - 2pi if p > pi, then p + 2pi if p < -pi (opv-mod.cpp:274-279).
Replaces opv_tpu/tx/modulator.py::_phase_track (a lax.scan).

The recurrence is serial, but it is arithmetic between binade edges and
wraps.  While a phase x and x + inc lie in one binade [2^e, 2^(e+1)), x is
an integer m times u = 2^(e-52) and the float64 add moves m by
d = inc / u rounded to nearest, ties to even: the same d at every sample
of the binade, once the first step has made m even where inc / u ends in
exactly 1/2 (a tie binade).  The kernel therefore walks segments: at a
segment's start x it takes the real add p = x + inc (which settles the
tie), counts in closed form the further steps of d that keep the phase
inside the binade, and takes the one real step (add and wraps) across
the edge.  One frame takes ~8,130 segments a tone against 86,720 serial
steps; every phase is still the recurrence's, bit for bit.

phase_track_reference is the twin: a loop over Python floats, the oracle
and the CPU route.  phase_segments_reference is the walk over Python
ints, step for step as the kernel takes it, for the tests.
"""

from __future__ import annotations

import math
import struct

import torch

from opv_tpu_torch.ops import build

_PI = math.pi
_TWO_PI = 2.0 * math.pi
#: a binade's significands, in units of its u = 2^(e-52): [_LO, _HI)
_LO, _HI = 1 << 52, 1 << 53
#: math.pi in units of the binade [2, 4): the top of the walk's last binade
_PI_UNITS = 0x1921FB54442D18
#: the lowest binade walked; below it 1 / (d u) leaves float64's range and
#: the kernel takes every step as a real one
E_MIN = -970
#: samples a launch pair walks and fills at most; a longer call runs
#: several, each from the last one's final phase (the segment table holds
#: one record per sample at worst)
CHUNK = 1 << 20


def _wrap(p: float) -> float:
    if p > _PI:
        p -= _TWO_PI
    if p < -_PI:
        p += _TWO_PI
    return p


def phase_track_reference(ph0: torch.Tensor, incs, n: int):
    """The plain twin: the recurrence over Python floats, on the host;
    results on ph0's device."""
    rows, finals = [], []
    for p0, inc in zip(ph0.tolist(), incs):
        ph, row = p0, []
        append = row.append
        for _ in range(n):
            append(ph)
            p = ph + inc
            if p > _PI:
                p -= _TWO_PI
            if p < -_PI:
                p += _TWO_PI
            ph = p
        rows.append(row)
        finals.append(ph)
    f64 = dict(dtype=torch.float64, device=ph0.device)
    return (torch.tensor(rows, **f64).reshape(len(incs), n),
            torch.tensor(finals, **f64))


def _bits(x: float) -> int:
    return struct.unpack("<Q", struct.pack("<d", x))[0]


def _decode(x: float):
    """(negative, e, m) of a normal double x = +-m 2^(e-52), m in
    [2^52, 2^53); e is None for zero, subnormals and non-finite x."""
    b = _bits(x)
    eb = (b >> 52) & 0x7FF
    if eb == 0 or eb == 0x7FF:
        return b >> 63, None, 0
    return b >> 63, eb - 1023, (b & (_LO - 1)) | _LO


def binade_steps(inc: float) -> dict[int, tuple[int, bool]]:
    """{e: (d, tie)} for each binade e in [E_MIN, 1] that the walk can
    take at increment inc: d is inc / 2^(e-52) rounded to nearest, ties to
    even, from inc's bits with integer shifts; tie says that the quotient
    ends in exactly 1/2 (the first step from an odd significand then
    differs from d by one).  Binades where |d| >= 2^52 (no step can stay
    inside) are left out."""
    b = _bits(inc)
    eb = (b >> 52) & 0x7FF
    mag = (b & (_LO - 1)) | (_LO if eb else 0)
    big = (-mag if b >> 63 else mag)
    ex = (eb if eb else 1) - 1023  # inc = big * 2^(ex - 52)
    out = {}
    for e in range(E_MIN, 2):
        shift = ex - e
        if shift >= 0:
            d, tie = big << shift, False
        else:
            q = big >> -shift  # floor
            r = big - (q << -shift)
            half = 1 << (-shift - 1)
            tie = r == half
            d = q + (r > half or (tie and q & 1))
        if abs(d) < _LO:
            out[e] = (d, tie)
    return out


def _walk(x: float, inc: float, n: int, margin: int):
    """One tone: (phases written one by one before the walk, segments
    [(start, x0, x1, d)], final).  A segment's samples are x0 at start,
    then x1 + j d for j = 0 .. len - 2, len = next start - start; d is the
    step of x0's binade (0 where the walk takes none)."""
    prefix, segs = [], []
    if not (math.isfinite(inc) and abs(inc) < _PI):
        while len(prefix) < n:  # the serial recurrence
            prefix.append(x)
            x = _wrap(x + inc)
        return prefix, segs, x
    while len(prefix) < n and not abs(x) <= _PI:
        prefix.append(x)
        x = _wrap(x + inc)
    steps = binade_steps(inc)
    up = not _bits(inc) >> 63
    i, final = len(prefix), x
    while i < n:
        p = x + inc  # the real first step: it takes a tie by parity
        neg, e, _ = _decode(x)
        rest = n - 1 - i
        k, d = 0, 0
        if e in steps:
            d, tie = steps[e]
            pneg, pe, mp = _decode(p)
            if pneg == neg and pe == e:
                room = ((_PI_UNITS if e == 1 else _HI - 1) - mp
                        if up != neg else mp - (_LO + margin))
                if room >= 0:
                    assert not tie or mp % 2 == 0, "a tie step left m odd"
                    k = rest + 1 if d == 0 else 1 + room // abs(d)
        dx = math.ldexp(d, e - 52) if e in steps else 0.0
        segs.append((i, x, p, dx))
        if k:
            mp = -mp if neg else mp
            if k > rest:
                final = math.ldexp(mp + rest * d, e - 52)
                break
            x_end = math.ldexp(mp + (k - 1) * d, e - 52)
        else:
            x_end = x
        if k == rest:
            final = _wrap(x_end + inc)
            break
        x = _wrap(x_end + inc)
        i += k + 1
    return prefix, segs, final


def _fill(prefix, segs, n: int) -> list:
    """The fill: each segment's samples from its record (x1 + j d is exact:
    j |d| < 2^52 units and every sum stays in x1's binade)."""
    row = list(prefix)
    bounds = [s[0] for s in segs[1:]] + [n]
    for (start, x0, x1, dx), end in zip(segs, bounds):
        row.append(x0)
        row.extend(x1 + j * dx for j in range(end - start - 1))
    return row


def phase_segments_reference(ph0: torch.Tensor, incs, n: int,
                             margin: int = 1):
    """The kernel's walk over Python ints: (phases (T, n), final (T,),
    segments), segments[t] the tone's table [(start, x0, x1, d)] as the
    kernel writes it.  A step of d is taken only while the result stays
    `margin` units above the binade's lower edge (and at most at its top,
    or at pi): below 2^e the float grid is twice as fine, so an exact sum
    just under the edge rounds there and not to the edge.  margin=0 shows
    the fault that the kernel's margin of one avoids."""
    rows, finals, tables = [], [], []
    for p0, inc in zip(ph0.tolist(), incs):
        prefix, segs, final = _walk(p0, float(inc), n, margin)
        rows.append(_fill(prefix, segs, n))
        finals.append(final)
        tables.append(segs)
    f64 = dict(dtype=torch.float64, device=ph0.device)
    return (torch.tensor(rows, **f64).reshape(len(incs), n),
            torch.tensor(finals, **f64), tables)


def launch(lib, ph0: torch.Tensor, incs, n: int, chunk: int = CHUNK):
    """`lib`'s opv_phase_track on ph0's stream (a checked CUDA tensor; no
    count): (phases, final, segs, counts), segs (T, chunk + 1, 4) float64
    records (start as int64 bits, x0, x1, d) and counts (T,) int64 of the
    last chunk.  `lib` is the port's library or another build exporting
    the same C entry point."""
    t = len(incs)
    chunk = min(max(n, 1), chunk)
    dev = ph0.device
    phases = torch.empty((t, n), dtype=torch.float64, device=dev)
    final = torch.empty((t,), dtype=torch.float64, device=dev)
    segs = torch.empty((t, chunk + 1, 4), dtype=torch.float64, device=dev)
    counts = torch.empty((t,), dtype=torch.int64, device=dev)
    err = lib.opv_phase_track(ph0.data_ptr(), float(incs[0]),
                              float(incs[-1]), t, n, phases.data_ptr(),
                              final.data_ptr(), segs.data_ptr(),
                              counts.data_ptr(), chunk, build.stream_ptr(ph0))
    build.check(build.library(), err, "phase_track")
    return phases, final, segs, counts


def segment_tables(segs: torch.Tensor, counts: torch.Tensor) -> list:
    """launch's records as each tone's [(start, x0, x1, d)], read back."""
    tables = []
    for row, c in zip(segs.cpu(), counts.tolist()):
        starts = row[:c, 0].contiguous().view(torch.int64).tolist()
        tables.append([(s, *r) for s, r in zip(starts, row[:c, 1:].tolist())])
    return tables


def phase_track_cuda(ph0: torch.Tensor, incs, n: int):
    """The kernel: per chunk of CHUNK samples, a walk launch (one block a
    tone; its first thread walks the segments) and a fill launch (the grid
    writes the segments' samples), counted once."""
    if not ph0.is_cuda:
        raise ValueError("the CUDA phase_track kernel needs a CUDA tensor")
    t = len(incs)
    if ph0.dtype != torch.float64 or ph0.shape != (t,) or t not in (1, 2):
        raise ValueError(f"ph0 must be (T,) float64 with T = len(incs) in "
                         f"(1, 2), got {tuple(ph0.shape)} {ph0.dtype}, "
                         f"{t} increments")
    phases, final, _, _ = launch(build.library(), ph0.contiguous(), incs, n)
    phase_track_cuda.launches += 1
    return phases, final


phase_track_cuda.launches = 0
