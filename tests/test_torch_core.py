"""Codec core of the PyTorch port, bit-exact against the JAX package."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from opv_tpu.config import CONFIG
from opv_tpu.core import base40 as base40_j
from opv_tpu.core import framing as framing_j
from opv_tpu.core.convcode import conv_encode_bits as conv_j
from opv_tpu.core.interleave import deinterleave_gather as deint_j
from opv_tpu.core.interleave import interleave_perm as perm_j
from opv_tpu.core.lfsr import randomizer_mask as mask_j
from opv_tpu_torch.core import base40, framing
from opv_tpu_torch.core.convcode import conv_encode_bits
from opv_tpu_torch.core.interleave import deinterleave_gather, interleave_perm
from opv_tpu_torch.core.lfsr import randomizer_mask


@pytest.mark.parametrize("call", ["W5NYV", "KI5ZDF", "ab-1/.", "", "??X"])
def test_base40_matches(call):
    enc = base40.base40_encode(call)
    assert enc == base40_j.base40_encode(call)
    assert base40.base40_decode(enc) == base40_j.base40_decode(enc)


def test_tables_match():
    np.testing.assert_array_equal(randomizer_mask(), mask_j())
    np.testing.assert_array_equal(interleave_perm(), perm_j())
    np.testing.assert_array_equal(deinterleave_gather(), deint_j())
    # interleave then deinterleave is the identity
    x = np.arange(CONFIG.encoded_bits)
    np.testing.assert_array_equal(x[interleave_perm()][deinterleave_gather()], x)


def test_conv_encode_matches():
    u = np.random.default_rng(0).integers(0, 2, (4, 1072)).astype(np.uint8)
    got = conv_encode_bits(torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(got, np.asarray(conv_j(jnp.asarray(u))))


def test_framing_round_trips_and_matches():
    rng = np.random.default_rng(1)
    fr = framing.build_bert_frame("W5NYV", frame_num=np.arange(4))
    np.testing.assert_array_equal(
        fr, framing_j.build_bert_frame("W5NYV", frame_num=np.arange(4)))
    assert framing.build_bert_frame("W5NYV").shape == (CONFIG.frame_bytes,)
    payload = rng.integers(0, 256, (3, CONFIG.frame_bytes)).astype(np.uint8)
    t = torch.from_numpy(payload)
    bits = framing.bytes_to_bits_msb(t)
    np.testing.assert_array_equal(
        bits.numpy(), np.asarray(framing_j.bytes_to_bits_msb(jnp.asarray(payload))))
    np.testing.assert_array_equal(framing.bits_to_bytes_msb(bits).numpy(), payload)
    np.testing.assert_array_equal(framing.derandomize(framing.randomize(t)).numpy(),
                                  payload)
    enc = framing.encode_frame(t)
    np.testing.assert_array_equal(
        enc.numpy(), np.asarray(framing_j.encode_frame(jnp.asarray(payload))))
    sym = framing.frame_to_symbol_bits(enc)
    np.testing.assert_array_equal(
        sym.numpy(), np.asarray(framing_j.frame_to_symbol_bits(jnp.asarray(enc.numpy()))))
    vbits = rng.integers(0, 2, (3, CONFIG.frame_bits)).astype(np.uint8)
    np.testing.assert_array_equal(
        framing.pack_frame_bits(torch.from_numpy(vbits)).numpy(),
        np.asarray(framing_j.pack_frame_bits(jnp.asarray(vbits))))


def test_golden_frames_decode_chain_inverse(golden_dir):
    """encode -> (clean decode) recovers the golden frames: the Viterbi
    twin on a noiseless deinterleaved stream, then pack + derandomize."""
    from opv_tpu_torch.rx.frame_decoder import decode_payloads
    golden = np.frombuffer((golden_dir / "bert3.frames").read_bytes(),
                           dtype=np.uint8).reshape(-1, CONFIG.frame_bytes)
    enc = framing.encode_frame(torch.from_numpy(golden.copy()))
    soft = torch.where(enc == 1, -1.0, 1.0)       # bit 1 -> F1 (negative soft)
    frames, metrics, ok = decode_payloads(soft)
    np.testing.assert_array_equal(frames.numpy(), golden)
    assert int(metrics.abs().sum()) == 0 and bool(ok.all())


def test_config_matches_jax_package():
    """The port's numerology is the JAX package's, field for field."""
    import dataclasses
    from opv_tpu.config import CONFIG as CONFIG_J
    from opv_tpu_torch.config import CONFIG as CONFIG_T
    assert dataclasses.asdict(CONFIG_T) == dataclasses.asdict(CONFIG_J)
    for name in ("frame_bits", "encoded_bits", "frame_symbols",
                 "samples_per_frame", "phase_inc_f1", "phase_inc_f2"):
        assert getattr(CONFIG_T, name) == getattr(CONFIG_J, name), name
    assert CONFIG_T.sync_pattern_bits() == CONFIG_J.sync_pattern_bits()
