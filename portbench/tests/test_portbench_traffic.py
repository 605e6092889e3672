"""The traffic generator at a tiny size: one seed, one stream; another seed,
other payloads, phases and noise in the same structure; every channel's
cycle closes its modulator state."""

import numpy as np
import pytest
import torch

from portbench import generator, reference as ref
from portbench.tests.small import cut


@pytest.mark.parametrize("workload", ["wideband64-steady", "locked64-ptt"])
def test_same_seed_same_stream(workload):
    config, traffic, _ = cut(workload, 2)
    a = generator.generate(config, traffic, 2**31 + 7, "cpu")
    b = generator.generate(config, traffic, 2**31 + 7, "cpu")
    c = generator.generate(config, traffic, 2**31 + 8, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.feeds, b.feeds))
    assert np.array_equal(a.payloads, b.payloads)
    assert not np.array_equal(a.payloads, c.payloads)
    assert not torch.equal(a.feeds[0], c.feeds[0])
    for f in ("gate", "offsets", "sync_at"):
        assert np.array_equal(getattr(a, f), getattr(c, f))
    assert len(a.feeds) == len(c.feeds)


def test_every_cycle_has_even_parity():
    config, traffic, _ = cut("locked64-ptt", 3)
    tr = generator.generate(config, traffic, 99, "cpu")
    bits = ref.encode_symbols(torch.from_numpy(tr.payloads))
    assert (bits.to(torch.int64).sum((1, 2)) % 2 == 0).all()


def test_bursts_follow_the_mix():
    config, traffic, _ = cut("locked64-ptt", 3)
    tr = generator.generate(config, traffic, 5, "cpu")
    per = traffic["period_frames"]
    assert tr.gate.shape[1] % per == 0
    for c in range(3):
        on = np.flatnonzero(tr.gate[c, :per])
        assert len(on) == traffic["burst_frames"]
        assert tr.gate[c, c * traffic["burst_stagger"] % per]


def test_frames_sit_where_the_generator_says():
    config, traffic, _ = cut("locked64-ptt", 2)
    tr = generator.generate(config, traffic, 5, "cpu")
    for c in range(2):
        s0 = int(round(tr.sync_at[c]))
        assert tr.frame_at(c, s0 + 3 * ref.SPF + 7) == 3
        assert tr.frame_at(c, s0 + 3 * ref.SPF - 20) == 3
        assert tr.frame_at(c, s0 + 3 * ref.SPF + 21) is None


def test_wideband_bursts_on_some_carriers_with_offsets():
    """A sparse wideband band from a mix alone: every other carrier in
    spurts, a carrier offset, the rest noise; seen through the reference's
    own channelizer."""
    config, _, _ = cut("wideband64-steady", 4)
    mix = {"period_frames": 12, "offset_stride": 487, "ebn0_db": 60.0,
           "burst_frames": 6, "burst_stagger": 1, "active_stride": 2,
           "cfo_hz": [3000.0]}
    tr = generator.make(config, mix, 11, "cpu")
    assert not tr.gate[1].any() and not tr.gate[3].any()
    assert tr.gate[0].sum() == tr.gate[0].size // 2
    assert np.allclose(tr.cfo_hz, 3000.0)
    ys = generator.channel_samples(tr, "cpu")
    s0 = int(round(tr.sync_at[0]))
    on = next(j for j in range(tr.cycle_frames) if tr.gate[0, j])
    off = next(j for j in range(tr.cycle_frames) if not tr.gate[0, j])

    def frame(c, j):
        a = (s0 + j * ref.SPF + 1000) % ys.shape[1]
        return ys[c, a:a + 60_000]

    p_on = frame(0, on).abs().pow(2).mean()
    assert frame(0, off).abs().pow(2).mean() < 1e-3 * p_on
    assert frame(1, on).abs().pow(2).mean() < 1e-3 * p_on
    # the mean instantaneous frequency of a spurt: the offset (the two
    # tones' +-13.55 kHz average out over random bits)
    x = frame(0, on)
    f = (x[1:] * x[:-1].conj()).angle().mean() * ref.SAMPLE_RATE / (2 * np.pi)
    assert abs(float(f) - 3000.0) < 600.0


def test_a_mix_names_its_generator_by_file():
    config, traffic, _ = cut("locked64-ptt", 2)
    with pytest.raises(SystemExit, match="no_such_mix"):
        generator.make(config, dict(traffic, generator="no_such_mix"), 1,
                       "cpu")
