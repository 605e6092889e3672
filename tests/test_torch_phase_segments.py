"""The exact TX's phase_track kernel walks binade segments
(opv_tpu_torch/csrc/phase_track.cu).  Its model over Python ints,
ops/phase_track.py::phase_segments_reference, follows the kernel's walk
and segment table step for step; here it is held bit for bit against the
serial twin and JAX's opv_tpu.tx.modulator._phase_track (x64, CPU), and
its per-binade steps against an exact fractions derivation."""

from __future__ import annotations

import math
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opv_tpu.tx.modulator import _phase_track as jax_phase_track
from opv_tpu_torch.config import CONFIG
from opv_tpu_torch.ops import phase_track as pt
from opv_tpu_torch.tx.modulator import _INC1, _INC2

N = 20_000
TIE_INC = 2.0 ** -5 + 2.0 ** -57
INCS = {"f1": _INC1, "f2": _INC2, "+0.05": 0.05, "-0.05": -0.05,
        "+tie": TIE_INC, "-tie": -TIE_INC}
STARTS = {"0": 0.0, "-0": -0.0, "+pi": math.pi, "-pi": -math.pi,
          "pi-": math.nextafter(math.pi, 0), "-pi+": math.nextafter(-math.pi, 0),
          "+0.5": 0.5, "-0.5": -0.5, "0.5-": math.nextafter(0.5, 0),
          "1e-300": 1e-300, "5e-324": 5e-324, "7": 7.0, "-100": -100.0}


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit, the sign of a zero included."""
    return a.shape == b.shape and torch.equal(a.view(torch.int64),
                                              b.view(torch.int64))


def _check(ph0: float, inc: float, n: int, margin: int = 1):
    """The model's phases, final phase and table against the twin's."""
    x = torch.tensor([ph0], dtype=torch.float64)
    want, want_f = pt.phase_track_reference(x, [inc], n)
    got, got_f, tables = pt.phase_segments_reference(x, [inc], n, margin)
    return _same(got, want) and _same(got_f, want_f), tables[0], want, want_f


@pytest.mark.parametrize("start", STARTS)
@pytest.mark.parametrize("inc", INCS)
def test_segment_walk_equals_twin(inc, start):
    """Every phase and the final phase of the walk are the serial
    recurrence's, from starts on both wraps, at the binade edges 0.5 and
    its predecessor, tiny and subnormal phases and phases beyond pi."""
    ok, table, _, _ = _check(STARTS[start], INCS[inc], N)
    assert ok
    assert table, "no segment walked"


def test_first_step_tie_case_from_minus_half():
    """2^-5 + 2^-57 from -0.5: at sample 14 the exact sum lies half a unit
    (of 2^-56) under 2^-4, a tie on [2^-4, 2^-3)'s grid, and below 2^-4 the
    float grid is twice as fine.  A walk that decides a segment's first
    step by integer rounding, with no one-unit margin, takes 2^-4 there
    and leaves the twin at sample 14.  This walk takes each first step as
    the real add, so it matches with or without the margin."""
    ph13 = float(pt.phase_track_reference(
        torch.tensor([-0.5], dtype=torch.float64), [TIE_INC], 14)[0][0, 13])
    gap = Fraction(ph13) + Fraction(TIE_INC) + Fraction(1, 16)
    assert gap == Fraction(1, 2) * Fraction(2) ** -56
    for margin in (0, 1):
        assert _check(-0.5, TIE_INC, N, margin)[0]


def test_margin_keeps_a_step_of_d_off_the_lower_edge():
    """Where a step of d lands on 2^e from an exact sum 3/8 of a unit
    under it, the float add rounds to the finer grid below the edge
    (2^e - u/2).  Without the one-unit margin the walk takes 2^e and
    leaves the twin at sample 3; with it the segment stops one step
    early and the real add crosses the edge."""
    inc = -(2.0 ** -13 + 3 * 2.0 ** -56)  # d = -2^40 units of [0.5, 1)
    x0 = 0.5 + 3 * 2.0 ** -13
    ok0, _, want, _ = _check(x0, inc, 50, margin=0)
    assert not ok0
    ok1, table, _, _ = _check(x0, inc, 50, margin=1)
    assert ok1
    assert float(want[0, 3]) == 0.5 - 2.0 ** -54
    assert table[1][0] == 3  # the real step from sample 2 starts sample 3


@pytest.mark.parametrize("inc, start", [
    (_INC1, 0.0), (_INC2, 0.123456789), (0.05, -100.0), (-TIE_INC, math.pi),
    (TIE_INC, -0.5)])
def test_segment_walk_equals_jax(inc, start):
    """The walk, the twin and JAX's lax.scan give the same phases."""
    run = jax.jit(jax_phase_track, static_argnums=2)
    phases, final = run(jnp.float64(start), jnp.float64(inc), N)
    x = torch.tensor([start], dtype=torch.float64)
    got, got_f, _ = pt.phase_segments_reference(x, [inc], N)
    assert _same(got[0], torch.from_numpy(np.array(phases)))
    assert _same(got_f[0], torch.tensor(float(final), dtype=torch.float64))


@pytest.mark.parametrize("n", [0, 1, 2])
@pytest.mark.parametrize("start", ["0", "+pi", "-100", "5e-324"])
def test_short_calls(n, start):
    """n = 0 returns ph0 as the final phase; n = 1 its one step."""
    ph0 = torch.tensor([STARTS[start], -0.25], dtype=torch.float64)
    want, want_f = pt.phase_track_reference(ph0, [_INC1, _INC2], n)
    got, got_f, tables = pt.phase_segments_reference(ph0, [_INC1, _INC2], n)
    assert _same(got, want) and _same(got_f, want_f)
    if n == 0:
        assert _same(got_f, ph0) and tables == [[], []]


@pytest.mark.parametrize("inc, start", [
    (0.0, 0.3), (-0.0, -0.3), (1e-20, 1.0), (2.0 ** -53, 1.0),
    (2.0 ** -53, 1.0 + 2.0 ** -52), (-(2.0 ** -53), -1.0 - 2.0 ** -52),
    (3 * 2.0 ** -60, 0.001), (5e-324, 1e-310), (3.5, 0.1), (-7.0, 1.0),
    (math.nextafter(math.pi, 0), math.pi), (1e-300, 2.0 ** -960)])
def test_edge_increments(inc, start):
    """Steps of zero (absorbed increments, a tie at d = 1/2 from an odd
    significand), steps of a few units, subnormal increments, binades
    below the walk's lowest, and |inc| >= pi (the serial path)."""
    assert _check(start, inc, 3000)[0]


def test_one_frame_from_reset_takes_about_8130_segments():
    """From reset, one 40 ms frame (86,720 samples) takes 8,000-8,300
    segments a tone: ~10.7 samples a segment against 86,720 serial steps."""
    ph0 = torch.zeros(2, dtype=torch.float64)
    n = CONFIG.samples_per_frame
    want, want_f = pt.phase_track_reference(ph0, [_INC1, _INC2], n)
    got, got_f, tables = pt.phase_segments_reference(ph0, [_INC1, _INC2], n)
    assert _same(got, want) and _same(got_f, want_f)
    for table in tables:
        assert 8_000 <= len(table) <= 8_300
        assert table[0][0] == 0
        starts = [s[0] for s in table]
        assert starts == sorted(set(starts))


@pytest.mark.parametrize("inc", [*INCS.values(), 3 * 2.0 ** -60, 5e-324,
                                 1e-300, 0.0, -0.0, 2.0 ** -53])
def test_binade_steps_equal_exact_fractions(inc):
    """d = inc / 2^(e-52) rounded half to even, and the tie flag, for
    every binade the walk takes, equal an exact derivation; binades left
    out are exactly those where |d| >= 2^52."""
    table = pt.binade_steps(inc)
    for e in range(pt.E_MIN, 2):
        q = Fraction(inc) / Fraction(2) ** (e - 52)
        d = round(q)  # half to even
        if abs(d) >= 2 ** 52:
            assert e not in table
            continue
        assert table[e] == (d, q.denominator == 2), e


def test_tie_binades_of_the_cases():
    """The config's increment ties on [2, 4), which every 160-sample cycle
    crosses on both sides; 2^-5 + 2^-57 on [1/16, 1/8); 0.05 on [1/8, 1/4)."""
    ties = {name: sorted(e for e, (_, tie) in pt.binade_steps(inc).items()
                         if tie)
            for name, inc in (("f", _INC1), ("tie", TIE_INC), ("0.05", 0.05))}
    assert 1 in ties["f"]
    assert -4 in ties["tie"]
    assert -3 in ties["0.05"]


def test_cuda_wrapper_refuses_a_cpu_tensor():
    """On a CPU tensor the kernel's wrapper raises; the registry sends CPU
    tensors to the twin."""
    with pytest.raises(ValueError, match="CUDA tensor"):
        pt.phase_track_cuda(torch.zeros(2, dtype=torch.float64),
                            (_INC1, _INC2), 10)
