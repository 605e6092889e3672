"""TX modulator of the PyTorch port (fast and reference-exact paths),
bit-exact against JAX and the reference binary's capture."""

import pathlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from opv_tpu.core import build_bert_frame, encode_frame
from opv_tpu.tx.modulator import modulate_bits_fast as mod_fast_j
from opv_tpu.tx.modulator import modulate_bits_wire as mod_wire_j
from opv_tpu.tx.modulator import mod_reset as mod_reset_j
from opv_tpu.tx.modulator import modulate_bits_exact as mod_exact_j
from opv_tpu.tx.modulator import modulate_frames as mod_frames_j
from opv_tpu.tx.modulator import symbol_signs as signs_j
from opv_tpu_torch.ops import phase_track as pt
from opv_tpu_torch.tx import modulator as m

GOLDEN = pathlib.Path(__file__).parent / "golden"


@pytest.mark.parametrize("t0,bn0", [(0, 1), (1, 0), (-1, 1), (1, 1)])
def test_symbol_signs_match(t0, bn0):
    rng = np.random.default_rng(3)
    for n in (1, 2, 7, 500):
        bits = rng.integers(0, 2, n)
        got = m.symbol_signs(torch.from_numpy(bits), t0, bn0)
        want = signs_j(jnp.asarray(bits), jnp.int32(t0), jnp.int32(bn0))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n160", [0, 7, 40, 123])
def test_wire_words_match(n160):
    """Packed int32 wire words identical for any carried 160-sample phase
    and gating state, and for an S not divisible by 4."""
    rng = np.random.default_rng(n160)
    bits = rng.integers(0, 2, 999)
    st = m.ModulatorState(t_xor=-1, b_n=0, phase_f1=0.0, phase_f2=0.0,
                          n160=n160)
    stj = mod_reset_j()._replace(t_xor=jnp.int32(-1), b_n=jnp.int32(0),
                                 n160=jnp.int32(n160))
    w, ns = m.modulate_bits_wire(torch.from_numpy(bits), st)
    wj, nsj = mod_wire_j(jnp.asarray(bits), stj)
    np.testing.assert_array_equal(w.numpy(), np.asarray(wj))
    assert (int(ns.t_xor), int(ns.b_n), int(ns.n160)) == \
        (int(nsj.t_xor), int(nsj.b_n), int(nsj.n160))
    iq, _ = m.modulate_bits_fast(torch.from_numpy(bits), st)
    iqj, _ = mod_fast_j(jnp.asarray(bits), stj)
    np.testing.assert_array_equal(iq.numpy(), np.asarray(iqj))


def test_modulate_frames_matches():
    frames = build_bert_frame("KI5ZDF", frame_num=np.arange(3))
    enc = np.array(encode_frame(jnp.asarray(frames)))
    iq, st = m.modulate_frames(torch.from_numpy(enc))
    iqj, stj = mod_frames_j(jnp.asarray(enc), exact=False)
    np.testing.assert_array_equal(iq.numpy(), np.asarray(iqj))
    assert int(st.n160) == int(stj.n160)
    # a continued stream equals one long stream
    iq_a, st_a = m.modulate_frames(torch.from_numpy(enc[:1]))
    iq_b, _ = m.modulate_frames(torch.from_numpy(enc[1:]), st_a)
    np.testing.assert_array_equal(torch.cat([iq_a, iq_b]).numpy(), iq.numpy())
    assert m.tx_flush_zeros().shape == (4000, 2)


def _state_j(st):
    return mod_reset_j()._replace(
        t_xor=jnp.int32(st.t_xor), b_n=jnp.int32(st.b_n),
        phase_f1=jnp.float64(st.phase_f1), phase_f2=jnp.float64(st.phase_f2),
        n160=jnp.int32(st.n160))


def _same_state(st, stj):
    assert (int(st.t_xor), int(st.b_n), int(st.n160)) == \
        (int(stj.t_xor), int(stj.b_n), int(stj.n160))
    # float64 phases bit for bit
    assert float(st.phase_f1) == float(stj.phase_f1)
    assert float(st.phase_f2) == float(stj.phase_f2)


@pytest.mark.parametrize("t0,bn0,ph1,ph2,n160", [
    (0, 1, 0.0, 0.0, 0), (-1, 0, 1.234, -3.1, 37), (1, 1, 3.14159, -3.14159, 159)])
def test_exact_bits_match(t0, bn0, ph1, ph2, n160):
    """modulate_bits_exact from a non-reset state: int16 I/Q and the final
    float64 phases bit-identical to the JAX package's (x64 on)."""
    rng = np.random.default_rng(n160)
    bits = rng.integers(0, 2, 301)
    st = m.ModulatorState(t0, bn0, ph1, ph2, n160)
    iq, ns = m.modulate_bits_exact(torch.from_numpy(bits), st)
    iqj, nsj = mod_exact_j(jnp.asarray(bits), _state_j(st))
    assert iq.dtype == torch.int16 and iq.shape == (301 * 40, 2)
    np.testing.assert_array_equal(iq.numpy(), np.asarray(iqj))
    _same_state(ns, nsj)


def test_phase_track_twin_is_the_recurrence():
    """The twin's phases: ph0 first, then wrap(ph + inc) per sample, the
    final phase one step past the last; n = 0 returns ph0."""
    ph0 = torch.tensor([3.1, -3.1], dtype=torch.float64)
    incs = (0.05, -0.05)
    phases, final = pt.phase_track_reference(ph0, incs, 5)
    assert phases.shape == (2, 5) and phases.dtype == torch.float64
    assert phases[:, 0].tolist() == ph0.tolist()
    for t, inc in enumerate(incs):
        p = phases[t].tolist() + [float(final[t])]
        for a, b in zip(p, p[1:]):
            q = a + inc
            q = q - pt._TWO_PI if q > pt._PI else q
            q = q + pt._TWO_PI if q < -pt._PI else q
            assert b == q
    assert abs(float(phases[0, 1])) < 3.2 and float(phases[0, 1]) < 0
    empty, same = pt.phase_track_reference(ph0, incs, 0)
    assert empty.shape == (2, 0) and torch.equal(same, ph0)


def test_exact_frames_equal_the_reference_capture():
    """modulate_frames(exact=True) of bert3's frames plus the zero flush is
    tests/golden/bert3.iq (the reference binary's output) byte for byte."""
    frames = build_bert_frame("W5NYV", frame_num=np.arange(3))
    enc = torch.from_numpy(np.array(encode_frame(jnp.asarray(frames))))
    iq, _ = m.modulate_frames(enc, exact=True)
    wire = torch.cat([iq, m.tx_flush_zeros()]).numpy().astype("<i2").tobytes()
    assert wire == (GOLDEN / "bert3.iq").read_bytes()


def test_exact_fast_exact_interop_matches():
    """A stream switching exact -> fast -> exact carries the same state as
    the JAX package's: the fast path rewrites the phases from n160."""
    frames = build_bert_frame("KI5ZDF", frame_num=np.arange(3))
    enc = np.array(encode_frame(jnp.asarray(frames)))
    st, stj = m.mod_reset(), mod_reset_j()
    for k, exact in enumerate((True, False, True)):
        iq, st = m.modulate_frames(torch.from_numpy(enc[k:k + 1]), st,
                                   exact=exact)
        iqj, stj = mod_frames_j(jnp.asarray(enc[k:k + 1]), stj, exact=exact)
        np.testing.assert_array_equal(iq.numpy(), np.asarray(iqj))
        _same_state(st, stj)
