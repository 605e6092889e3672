"""The plain reference against the program on the CPU at a tiny size (the
test may load the program; the reference itself does not)."""

import numpy as np
import torch

from opv_tpu_torch.core.framing import encode_frame, frame_to_symbol_bits
from opv_tpu_torch.core.interleave import deinterleave_gather
from opv_tpu_torch.rx.channelizer import channelize
from opv_tpu_torch.rx.viterbi import viterbi_decode_batch
from opv_tpu_torch.tx.modulator import symbol_signs
from portbench import generator, reference as ref
from portbench.tests.small import cut, run


def test_transmit_tables_match_the_program():
    rng = np.random.default_rng(1)
    p = torch.from_numpy(rng.integers(0, 256, (3, 2, 134), dtype=np.uint8))
    got = ref.encode_symbols(p)
    assert torch.equal(got, frame_to_symbol_bits(encode_frame(p)))
    bits = got.reshape(3, -1)
    a, b = ref.msk_amplitudes(bits)
    for c in range(3):
        d1, d2, _, _ = symbol_signs(bits[c], 1, 1)
        assert torch.equal(a[c], (d2 - d1).float())
        assert torch.equal(b[c], (d2 + d1).float())


def test_viterbi_metric_matches_the_program():
    q = torch.from_numpy(np.random.default_rng(2).integers(0, 8, (5, 2144)))
    gather = torch.from_numpy(deinterleave_gather().astype(np.int64))
    _, want = viterbi_decode_batch(q[:, gather].to(torch.int32))
    assert ref.viterbi_metric(q).tolist() == want.tolist()


def test_channelizer_matches_the_program():
    config, traffic, _ = cut("wideband64-steady", 4)
    tr = generator.generate(config, traffic, 3, "cpu")
    x = torch.cat(tr.feeds)
    hist = tr.k * tr.taps - 1
    quantum = tr.feeds[0].shape[0]
    # the receiver's first window: one quantum and the next filter history
    got = channelize(x[:quantum + hist], tr.k, tr.taps)
    want = generator.channel_samples(tr, "cpu")[:, :quantum // tr.k]
    assert got.shape == want.shape
    err = (got.to(torch.complex128).abs() - want.abs()).abs().max()
    assert err < 1e-5 * want.abs().max()
    ratio = got[:, 100:200].to(torch.complex128) / want[:, 100:200]
    assert (ratio / ratio[:, :1] - 1).abs().max() < 1e-5


def test_program_agrees_with_the_reference():
    out = run("locked64-ptt", 2, 3.0, seed=12345)
    chk = out["check"]
    assert chk["compared"] > 0
    assert chk["numbers"]["metric_gap"][0] == 0.0
    assert chk["sync_q_gap"] < 1e-5
