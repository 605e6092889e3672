"""The readers of the engine's block records (portbench/blocks.py) on a
fake context: each new per-layer metric's value from hand-made records,
None where the engine keeps no records (a program without them) or the
window's blocks hold nothing the metric reads, and the readers on a real
CPU engine's records."""

import types

import numpy as np
import pytest
import torch

from portbench.run import reader


def _rec(launch, programs, host, device=None):
    return dict(launch=launch, programs=programs, retime=False,
                rehunt=False, host_ms=host, device_ms=device or {})


#: two traced blocks (ignored), then three
RECORDS = [_rec("exact", 9, {"launch": 99.0}, {"steady": [99.0]})] * 2 + [
    _rec("kept", 1, {"append": 0.5, "launch": 2.0, "resolve": 1.0,
                     "resolve/resolve.wait": 0.25, "slide": 0.5,
                     "wideband.append": 0.125, "wideband.channelize": 1.0,
                     "wideband.slide": 0.375},
         {"steady": [1.5], "operands": [0.25], "channelize": [10.5]}),
    _rec("relaunched", 3, {"launch": 5.0, "launch/sync_wait": 2.0,
                           "launch/retime": 0.5, "resolve": 3.0,
                           "resolve/agc/sync_wait": 1.0},
         {"reacquire": [4.0, 6.0], "retime": [0.5]}),
    _rec("kept", 2, {"launch": 1.0, "resolve": 2.0,
                     "resolve/resolve.rehunt": 1.5},
         {"steady": [2.5], "operands": [0.75], "reacquire": [8.0]}),
]

WANT = {
    "overlap_share": 100.0 * 2 / 3,
    "programs_per_block": 2.0,
    # (2.0 + 0.5 + 0.5 + 0.125 + 1.0 + 0.375) + (5.0 - 2.0) + 1.0
    "launch_host_ms": (4.5 + 3.0 + 1.0) / 3,
    "sync_wait_ms": (0.0 + 3.0 + 0.0) / 3,
    "steady_device_ms": 2.0,
    "operands_device_ms": 0.5,
    "reacquire_device_ms": 6.0,
    "channelize_window_ms": 10.5,
}


def _ctx(engine, traced=2):
    return types.SimpleNamespace(engine=engine,
                                 window=types.SimpleNamespace(
                                     traced_blocks=traced))


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_on_records(name):
    got = reader(name).read(_ctx(types.SimpleNamespace(block_trace=RECORDS)))
    assert got == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_without_records_reads_none(name):
    r = reader(name)
    # a program that keeps no block records (the parent of this reader)
    assert r.read(_ctx(types.SimpleNamespace(block_stats=[]))) is None
    # timing off, and a window with no block after the traced seconds
    assert r.read(_ctx(types.SimpleNamespace(block_trace=[]))) is None
    assert r.read(_ctx(types.SimpleNamespace(block_trace=RECORDS),
                       traced=len(RECORDS))) is None


def test_device_readers_read_none_without_their_span():
    ctx = _ctx(types.SimpleNamespace(block_trace=RECORDS[:2] + [
        _rec("kept", 1, {"launch": 1.0})]))
    for name in ("steady_device_ms", "operands_device_ms",
                 "reacquire_device_ms", "channelize_window_ms"):
        assert reader(name).read(ctx) is None


def test_readers_on_a_cpu_engine():
    """A timing engine on the CPU: the counters read from its records, no
    device span (none is recorded on the CPU)."""
    from opv_tpu_torch.config import CONFIG
    from opv_tpu_torch.core.framing import build_bert_frame, encode_frame
    from opv_tpu_torch.stream import LockedStreamDemodulator
    from opv_tpu_torch.tx.modulator import (iq_int16_to_complex,
                                            modulate_frames, tx_flush_zeros)
    spf = CONFIG.samples_per_frame
    f = torch.from_numpy(build_bert_frame("W5NYV", frame_num=np.arange(6)))
    iq, _ = modulate_frames(encode_frame(f))
    s = iq_int16_to_complex(torch.cat([iq, tx_flush_zeros()]))
    x = torch.zeros((1, 8 * spf), dtype=torch.complex64)
    x[0, 333:333 + len(s)] = s[:8 * spf - 333]
    sd = LockedStreamDemodulator(1, block_frames=2, pipeline=True,
                                 timing=True, device="cpu")
    for off in range(0, x.shape[1], 2 * spf):
        sd.feed(x[:, off:off + 2 * spf])
    sd.flush()
    ctx = _ctx(sd, traced=0)
    rows = sd.block_trace
    assert reader("overlap_share").read(ctx) == pytest.approx(
        100.0 * sum(r["launch"] == "kept" for r in rows) / len(rows))
    assert reader("programs_per_block").read(ctx) == pytest.approx(
        sum(r["programs"] for r in rows) / len(rows))
    assert reader("launch_host_ms").read(ctx) > 0
    assert reader("sync_wait_ms").read(ctx) >= 0
    assert reader("steady_device_ms").read(ctx) is None
