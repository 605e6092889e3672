"""The port's coherent Costas-loop demodulator (opv_tpu_torch/rx/coherent.py
and rx_batch(coherent=True)) on the CPU.

The reference pin (tests/test_coherent.py): on bert3 the reference's
coherent mode estimates 1430.0 Hz, rails its AFC at +2000 Hz, never leaves
HUNTING and decodes nothing; the port's rx_batch must give exactly that.

The loop against opv_tpu/rx/coherent.py on SYMBOLS symbols of a seeded
capture: soft within RTOL of max|soft| and every state field within RTOL
(relative, at least 1).  The loop is chaotic: float64 rounding of the two
packages' 40-term sums and sincos grows by orders of magnitude over
thousands of symbols (ROADMAP queue 3), so the comparison is held over a
few hundred symbols, where it sits near 1e-12.  A branch (a wrap, a clip,
the dominant tone) that flips between the two is named by its symbol.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from opv_tpu.config import CONFIG
from opv_tpu.core import build_bert_frame, encode_frame
from opv_tpu.io.iq import iq_bytes_to_complex
from opv_tpu.rx import coherent as cj
from opv_tpu.tx import modulate_frames
from opv_tpu_torch.rx import coherent as ct
from opv_tpu_torch.rx.pipeline import rx_batch

RTOL = 1e-9
SYMBOLS = 320


def test_coherent_mode_matches_reference_failure(golden_dir):
    s = iq_bytes_to_complex((golden_dir / "bert3.iq").read_bytes())
    out = rx_batch(s, coherent=True, device="cpu")
    assert float(out["est_offset"]) == 1430.0
    assert out["decoded"] == 0
    assert float(out["freq_offset"]) == CONFIG.afc_clamp_hz == 2000.0
    assert int(out["tracker_state"]) == 0
    assert int(out["n_symbols"]) == len(s) // 40 == 6604
    assert int(out["samples_used"]) == len(s)
    assert out["frames"].shape == (0, 134)


@pytest.fixture(scope="module")
def seeded():
    """Two BERT frames of the fast TX at a numpy-drawn CFO in AWGN
    (numpy seed 21), complex128."""
    rng = np.random.default_rng(21)
    frames = build_bert_frame("W5NYV", frame_num=np.arange(2))
    iq, _ = modulate_frames(encode_frame(jnp.asarray(frames)), exact=False)
    iq = np.asarray(iq, np.float64)
    s = iq[:, 0] + 1j * iq[:, 1]
    cfo = rng.uniform(-600, 600)
    s = s * np.exp(2j * np.pi * cfo * np.arange(len(s)) / CONFIG.sample_rate)
    s += 800 * (rng.standard_normal(len(s)) + 1j * rng.standard_normal(len(s)))
    return s[: SYMBOLS * 40 + 17], cfo


@pytest.mark.parametrize("pll_bw", [50.0, 200.0])
def test_loop_matches_jax(seeded, pll_bw):
    s, cfo = seeded
    a, b = ct.pll_gains(pll_bw)
    assert (a, b) == cj.pll_gains(pll_bw)
    init = cfo + 120.0
    soft_j, st_j = cj.demodulate_coherent(
        jnp.asarray(s), cj.coherent_state_init(init), CONFIG.afc_alpha, a, b)
    soft_t, st_t = ct.demodulate_coherent(
        torch.from_numpy(s), ct.coherent_state_init(init), CONFIG.afc_alpha,
        a, b)
    soft_j, soft_t = np.asarray(soft_j), soft_t.numpy()
    assert soft_t.shape == soft_j.shape == (SYMBOLS,)
    err = np.abs(soft_t - soft_j) / np.abs(soft_j).max()
    bad = np.nonzero(err > RTOL)[0]
    assert not bad.size, f"soft differs from symbol {bad[0]} (max {err.max():.3g})"
    for name, vj, vt in zip(ct.CoherentState._fields, st_j, st_t):
        vj, vt = np.asarray(vj), vt.numpy()
        assert vt.dtype == vj.dtype, name
        assert abs(vt - vj) <= RTOL * max(1.0, abs(vj)), (name, vt, vj)


def _both(s, st_j, st_t, pll_bw):
    """The two packages' loops over s from the given states."""
    a, b = ct.pll_gains(pll_bw)
    soft_j, st_j = cj.demodulate_coherent(jnp.asarray(s), st_j,
                                          CONFIG.afc_alpha, a, b)
    soft_t, st_t = ct.demodulate_coherent(torch.from_numpy(s), st_t,
                                          CONFIG.afc_alpha, a, b)
    soft_j, soft_t = np.asarray(soft_j), soft_t.numpy()
    np.testing.assert_allclose(soft_t, soft_j, rtol=0,
                               atol=RTOL * np.abs(soft_j).max())
    for name, vj, vt in zip(ct.CoherentState._fields, st_j, st_t):
        vj, vt = np.asarray(vj), vt.numpy()
        assert abs(vt - vj) <= RTOL * max(1.0, abs(vj)), (name, vt, vj)
    return st_j, st_t


def test_loop_across_calls_and_at_its_clamp(seeded):
    """A state carried into a second call (its prev_dom nonzero, so the AFC
    hold of the call's first symbol matters), and a loop frequency started
    next to its +-0.1 clamp: both packages step for step."""
    s, cfo = seeded
    k = 160 * 40 + 7
    st_j, st_t = _both(s[:k], cj.coherent_state_init(cfo),
                       ct.coherent_state_init(cfo), 200.0)
    assert abs(complex(st_t.prev_dom)) > 0
    _both(s[k:], st_j, st_t, 200.0)
    for lf in (0.0999, -0.0999):
        _both(s[: 40 * 40], cj.coherent_state_init(cfo)._replace(
                  loop_freq=jnp.asarray(lf)),
              ct.coherent_state_init(cfo)._replace(
                  loop_freq=torch.tensor(lf, dtype=torch.float64)), 200.0)


def test_state_init_and_dtypes():
    st = ct.coherent_state_init(torch.tensor(1430.0, dtype=torch.float64))
    assert st.freq_offset.shape == () and float(st.freq_offset) == 1430.0
    assert st.prev_dom.dtype == torch.complex128
    assert ct.coherent_state_init(5.0, dtype=torch.float32).prev_dom.dtype \
        == torch.complex64
    soft, st2 = ct.demodulate_coherent(torch.zeros(79, dtype=torch.complex128),
                                       st, 0.001, *ct.pll_gains(50.0))
    assert soft.shape == (1,) and float(soft[0]) == 0.0
    # the first symbol of a call holds the AFC; silence gives no phase error
    assert float(st2.freq_offset) == 1430.0 and float(st2.loop_freq) == 0.0
