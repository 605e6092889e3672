"""The port's I/O and operator output (opv_tpu_torch/io, opv_tpu_torch/utils)
against the JAX package's on the same inputs, made from seeds with numpy."""

import io
import json
import socket

import numpy as np
import pytest

from opv_tpu.io import iq as iq_j
from opv_tpu.stream import LockedStreamDemodulator as EngineJ
from opv_tpu.utils import display as disp_j
from opv_tpu.utils import metrics as met_j
from opv_tpu_torch.config import CONFIG
from opv_tpu_torch.io import iq as iq_p
from opv_tpu_torch.io.udp import UDPFrameBridge
from opv_tpu_torch.stream import LockedStreamDemodulator as EngineP
from opv_tpu_torch.utils import display as disp_p
from opv_tpu_torch.utils import metrics as met_p
from cli_support import free_port
from stream_scenarios import signal

FB = CONFIG.frame_bytes


def _wire(n_bytes, seed):
    return np.random.default_rng(seed).integers(
        0, 256, n_bytes, dtype=np.uint8).tobytes()


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("n_bytes", [0, 4, 4003, 65536])
def test_iq_bytes_to_complex_matches(dtype, n_bytes):
    """A trailing partial sample (4003 bytes) is dropped in both."""
    buf = _wire(n_bytes, n_bytes)
    got = iq_p.iq_bytes_to_complex(buf, dtype=dtype)
    want = iq_j.iq_bytes_to_complex(buf, dtype=dtype)
    assert got.dtype == want.dtype == dtype
    np.testing.assert_array_equal(got, want)
    pairs = np.frombuffer(buf[:len(buf) // 4 * 4], "<i2").reshape(-1, 2)
    np.testing.assert_array_equal(iq_p.int16_pairs_to_complex(pairs, dtype),
                                  iq_j.int16_pairs_to_complex(pairs, dtype))


@pytest.mark.parametrize("channels", [1, 2, 64])
def test_iq_bytes_to_i16_pairs_matches(channels):
    """(C, n, 2) int16 from channel-interleaved wire bytes, equal as floats
    to the JAX package's float32 pairs; a partial sample instant at the
    end is dropped, and the view does not share the caller's bytes."""
    buf = bytearray(_wire(4 * channels * 1000 + 4 * channels - 2, channels))
    got = iq_p.iq_bytes_to_i16_pairs(buf, channels=channels)
    want = iq_j.iq_bytes_to_f32_pairs(bytes(buf), channels=channels)
    assert got.shape == want.shape == (channels, 1000, 2)
    assert got.dtype == np.int16 and got.flags.writeable
    np.testing.assert_array_equal(got.astype(np.float32), want)
    buf[:4 * channels] = bytes(4 * channels)
    np.testing.assert_array_equal(got.astype(np.float32), want)


def test_udp_bridge_round_trip_and_malformed_drop():
    a, b = UDPFrameBridge(port=free_port()), UDPFrameBridge()
    try:
        frame = _wire(FB, 1)
        assert b.send(frame) is False               # no sender yet
        with pytest.raises(ValueError):
            b.send(frame[:10], dest=("127.0.0.1", a.port))
        raw = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        raw.sendto(b"short", ("127.0.0.1", a.port))  # malformed: dropped
        raw.close()
        assert b.send(frame, dest=("127.0.0.1", a.port))
        got = [f for _ in range(20) for f in a.poll(timeout=0.1)][:1]
        assert got == [frame]
        assert a.last_sender[1] == b.port
        reply = _wire(FB, 2)
        assert a.send(reply)                        # back to the sender
        back = [f for _ in range(20) for f in b.poll(timeout=0.1)][:1]
        assert back == [reply]
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("metric,q", [(0, 0.987654), (1234, 0.5)])
def test_display_is_string_identical(metric, q):
    frame = _wire(FB, metric)
    frame = frame[:6] + (CONFIG.default_token if metric == 0 else 0x123456
                         ).to_bytes(3, "big") + frame[9:]
    outs = []
    for d in (disp_j, disp_p):
        out = io.StringIO()
        d.banner("OPV MSK Demodulator with AFC v1.0 (streaming)", out=out)
        d.print_frame(7, frame, metric, q, out=out)
        d.summary(9, 8, 1.2345, 5678, "-", 0.0, out=out)
        outs.append(out.getvalue())
    assert outs[0] == outs[1]


def test_metrics_match_on_engines_fed_the_same_feed():
    """locked_metrics has the JAX package's keys, and the same counts, on
    engines fed the same 2-channel feed; emit_json writes one JSON line."""
    s, _ = signal(6)
    x = np.stack([s, np.roll(s, 777)])
    sd_j = EngineJ(2, timing=True)
    sd_p = EngineP(2, timing=True, device="cpu")
    n = x.shape[1]
    for sd in (sd_j, sd_p):
        sd.feed(x)
        sd.flush()
    m_j = met_j.locked_metrics(sd_j, 2, 2 * n)
    m_p = met_p.locked_metrics(sd_p, 2, 2 * n)
    assert set(m_p) == set(m_j)
    assert set(m_p["last_block"]) == set(m_j["last_block"])
    for k in ("engine", "channels", "samples_per_chan", "seconds", "decoded",
              "perfect", "reacquisitions", "refreshes", "blocks",
              "blocks_by_program", "locked_channels"):
        assert m_p[k] == m_j[k], k
    out = io.StringIO()
    met_p.emit_json(m_p, out=out)
    line = out.getvalue()
    assert line.count("\n") == 1 and json.loads(line)["decoded"] == m_j["decoded"]
