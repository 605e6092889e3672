"""TX modulator fast path of the PyTorch port, bit-exact against JAX."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from opv_tpu.core import build_bert_frame, encode_frame
from opv_tpu.tx.modulator import modulate_bits_fast as mod_fast_j
from opv_tpu.tx.modulator import modulate_bits_wire as mod_wire_j
from opv_tpu.tx.modulator import mod_reset as mod_reset_j
from opv_tpu.tx.modulator import modulate_frames as mod_frames_j
from opv_tpu.tx.modulator import symbol_signs as signs_j
from opv_tpu_torch.tx import modulator as m


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
    st = m.ModulatorState(t_xor=-1, b_n=0, n160=n160)
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
    with pytest.raises(NotImplementedError):
        m.modulate_frames(torch.from_numpy(enc), exact=True)
