"""The port's TX multiplexer (opv_tpu_torch.tx.multiplexer): the TestCOBS
and TestPriorities cases of tests/test_multiplexer.py run against the port
(the JAX package's test bodies, with that module's multiplexer names bound
to the port's for each case), and one scripted traffic sequence through
both packages with every tick() output and state equal."""

import numpy as np
import pytest

import test_multiplexer as ref
from opv_tpu.tx import multiplexer as mux_j
from opv_tpu_torch.tx import multiplexer as mux_t

_PORTED = ("DATA_BYTES", "TxMultiplexer", "TxState", "cobs_decode",
           "cobs_encode")


@pytest.fixture(autouse=True)
def _port_names(monkeypatch):
    """The reference test bodies look these names up in their module."""
    for name in _PORTED:
        monkeypatch.setattr(ref, name, getattr(mux_t, name))


class TestCOBSPort(ref.TestCOBS):
    pass


class TestPrioritiesPort(ref.TestPriorities):
    pass


def test_names_are_the_port_s():
    assert ref.TxMultiplexer is mux_t.TxMultiplexer
    assert ref.mux().__class__.__module__ == "opv_tpu_torch.tx.multiplexer"


def _script(pkg):
    """A scripted traffic sequence on one package: every tick's (state
    name, frame) and the multiplexer's state after it."""
    m = pkg.TxMultiplexer("KE9V", token=0x123456, hang_frames=3)
    rng = np.random.default_rng(7)
    big = bytes(rng.integers(0, 256, 1400, dtype=np.uint8))
    events = {
        0: lambda: m.push_chat(b"hello"),
        2: lambda: m.push_background(big),
        4: lambda: (m.set_ptt(True), m.push_voice(b"v" * 80)),
        5: lambda: m.push_voice(b"w" * 200),
        6: lambda: m.push_aaaaa(b"auth-token"),
        7: lambda: m.push_voice(b"x"),
        8: lambda: m.set_ptt(False),
        10: lambda: m.push_chat(bytes(range(256)) * 2, urgent=True),
        12: lambda: (m.set_ptt(True), m.push_voice(b"y" * 3)),
        13: lambda: m.push_chat(b"urgent", urgent=True),
        15: lambda: m.set_ptt(False),
        30: lambda: m.push_background(b"\x00" * 300),
    }
    out = []
    for t in range(60):
        if t in events:
            events[t]()
        st, frame = m.tick()
        out.append((st.name, frame, m.state.name, m.ptt, m.frames_sent,
                    m._data_sent, m._abort_pending, m._hang_count,
                    len(m._chat), len(m._background), len(m._aaaaa),
                    None if m._data_in_flight is None
                    else bytes(m._data_in_flight)))
    return out


def test_scripted_traffic_matches_jax():
    got, want = _script(mux_t), _script(mux_j)
    assert got == want
    assert sum(f is not None for _, f, *_ in got) >= 30
    assert {s for s, *_ in got} >= {"PREAMBLE", "SENDVOICE", "INTERRUPTUS",
                                    "SENDDATA", "HANGTIME", "SENDEOT", "IDLE"}
