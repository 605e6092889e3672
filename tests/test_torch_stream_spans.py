"""The locked engine's timing records (opv_tpu_torch/utils/spans.py) on
the CPU: nothing recorded with timing off; each block's launch counters
(how its program was launched, the programs launched for it, retime,
re-hunt) on hand-derived lock histories, in the synchronous and the
pipelined engine; block_stats computed from the spans; the top-level
spans' cover of feed(); the spans as function-scope profiler ranges.

Blocks of 2 frames: a block advances 173,440 samples and its window holds
3 frames and 1,040 samples, so the first window completes on the second
feed and each later feed completes one more."""

import time

import numpy as np
import pytest
import torch

from opv_tpu_torch.config import CONFIG
from opv_tpu_torch.core.framing import build_bert_frame, encode_frame
from opv_tpu_torch.stream import LockedStreamDemodulator
from opv_tpu_torch.tx.modulator import (iq_int16_to_complex, modulate_frames,
                                        tx_flush_zeros)
from opv_tpu_torch.utils.spans import Recorder, leaf_ms, top_level_ms

SPF = CONFIG.samples_per_frame
BF = 2

#: every span path a block record of these runs may hold
PATHS = {"append", "launch", "launch/retime", "launch/sync_wait", "resolve",
         "resolve/resolve.wait", "resolve/resolve.emit", "resolve/resolve.rehunt",
         "resolve/resolve.rehunt/resolve.wait",
         "resolve/resolve.rehunt/resolve.emit", "resolve/resolve.lifecycle",
         "slide", "record"}


def _signal(n_frames, start=0):
    f = torch.from_numpy(build_bert_frame("W5NYV",
                                          frame_num=start + np.arange(n_frames)))
    iq, _ = modulate_frames(encode_frame(f))
    return iq_int16_to_complex(torch.cat([iq, tx_flush_zeros()])).numpy()


def _handover():
    """Channel 0: 4 frames from sample 333, then silence (its lock drops
    at block 4's second slot, the sixth miss, and it is re-hunted there);
    channel 1: silence, then 4 frames from 9 frames + 1,777 samples (it
    locks in block 4).  16 frames, 8 feeds, 8 blocks (the last one the
    flushed tail)."""
    x = np.zeros((2, 16 * SPF), np.complex64)
    a, b = _signal(4), _signal(4, start=100)
    x[0, 333:333 + len(a)] = a
    x[1, 9 * SPF + 1777:9 * SPF + 1777 + len(b)] = b
    return x


def _retiming():
    """One channel, clean frames from sample 333 on: it locks in block 0
    and, warming (its Viterbi metric EMA above _WARM_METRIC_MIN, set to
    -1 here), asks for a retime at every resolve after.  10 frames, 5
    feeds, 5 blocks."""
    x = np.zeros((1, 10 * SPF), np.complex64)
    x[0, 333:] = _signal(10)[:10 * SPF - 333]
    return x


#: (launch, programs, retime, rehunt) of each block record
EXPECTED = {
    # every block runs re-acquisition (a channel is always hunting), one
    # program a block; block 4's resolve re-hunts channel 0 (two programs)
    ("handover", False): [("exact", 1, False, False)] * 4
    + [("exact", 2, False, True)] + [("exact", 1, False, False)] * 3,
    # block 0 launches at once; block 1's prediction (both hunting) is
    # discarded when block 0's resolve locks channel 0; blocks 2-4 keep
    # theirs, block 4 re-hunting channel 0; block 5's prediction is
    # discarded when block 4's resolve swaps the locks; block 6 keeps its
    # prediction (drained by flush), block 7 is the flushed tail
    ("handover", True): [("exact", 1, False, False),
                         ("relaunched", 2, False, False),
                         ("kept", 1, False, False),
                         ("kept", 1, False, False),
                         ("kept", 2, False, True),
                         ("relaunched", 2, False, False),
                         ("kept", 1, False, False),
                         ("exact", 1, False, False)],
    # block 0 acquires (re-acquire); every later block retimes, then runs
    # the steady program
    ("retiming", False): [("exact", 1, False, False)]
    + [("exact", 2, True, False)] * 4,
    # the retime comes due at each resolve, after the next block's
    # prediction was launched: each is discarded for a retime and the
    # steady program (three programs); the flushed tail is exact
    ("retiming", True): [("exact", 1, False, False)]
    + [("relaunched", 3, True, False)] * 3 + [("exact", 2, True, False)],
}

SCENES = {"handover": _handover, "retiming": _retiming}


def _run(x, pipeline, timing=True, tweak=None):
    """x fed a block advance at a time, then flushed: (engine, tuples,
    seconds of every feed() and of the flush())."""
    sd = LockedStreamDemodulator(x.shape[0], block_frames=BF,
                                 pipeline=pipeline, timing=timing,
                                 device="cpu")
    if tweak is not None:
        tweak(sd)
    out, walls = [], []
    for off in range(0, x.shape[1], BF * SPF):
        t0 = time.perf_counter()
        out += sd.feed(x[:, off:off + BF * SPF])
        walls.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    out += sd.flush()
    walls.append(time.perf_counter() - t0)
    return sd, out, walls


def _warm(sd):
    sd._WARM_METRIC_MIN = -1.0


@pytest.fixture(scope="module")
def runs():
    got = {}
    for scene, make in SCENES.items():
        x = make()
        for pipeline in (False, True):
            got[scene, pipeline] = _run(
                x, pipeline, tweak=_warm if scene == "retiming" else None)
    return got


def test_timing_off_records_nothing(monkeypatch):
    """No record, and no profiler range opened."""
    opened = []
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        lambda name: opened.append(name))
    sd, out, _ = _run(_retiming()[:, :4 * SPF], pipeline=True, timing=False)
    assert out and sd._rec is None and opened == []
    assert sd.block_stats == [] and sd.block_trace == []


@pytest.mark.parametrize("scene,pipeline", sorted(EXPECTED))
def test_launch_counters_follow_the_lock_history(runs, scene, pipeline):
    sd, out, _ = runs[scene, pipeline]
    got = [(r["launch"], r["programs"], r["retime"], r["rehunt"])
           for r in sd.block_trace]
    assert got == EXPECTED[scene, pipeline]
    assert len(sd.block_stats) == len(sd.block_trace)
    # the tuples are the synchronous engine's
    assert out == runs[scene, False][1]


@pytest.mark.parametrize("scene,pipeline", sorted(EXPECTED))
def test_block_stats_come_from_the_spans(runs, scene, pipeline):
    sd, _, _ = runs[scene, pipeline]
    for st, r in zip(sd.block_stats, sd.block_trace):
        assert set(st) == {"tag", "device_wait_ms", "host_ms"}
        assert set(r["host_ms"]) <= PATHS
        assert r["device_ms"] == {}                   # no device on the CPU
        wait = leaf_ms(r, "resolve.wait", under="resolve")
        assert st["device_wait_ms"] == round(wait, 3)
        assert st["host_ms"] == round(r["host_ms"]["resolve"] - wait, 3)
        assert r["retime"] == ("launch/retime" in r["host_ms"]
                               and "launch/sync_wait" in r["host_ms"])
        assert r["rehunt"] == ("resolve/resolve.rehunt" in r["host_ms"])


@pytest.mark.parametrize("scene,pipeline", sorted(EXPECTED))
def test_top_level_spans_cover_the_feeds(runs, scene, pipeline):
    """Over the run, the records' top-level spans sum to no more than the
    wall time of the feed() and flush() calls and to at least 90% of it
    (every span of a call is recorded by the end of the flush)."""
    sd, _, walls = runs[scene, pipeline]
    spans = sum(top_level_ms(r) for r in sd.block_trace) * 1e-3
    assert 0.9 * sum(walls) <= spans <= sum(walls)


def test_spans_are_function_scope_profiler_ranges(runs):
    """The spans reach a profiler trace as CPU ranges named opv.<span>,
    not in record_function's user scope (which a CUDA trace mirrors onto
    the device timeline); a span's time is kept under its path."""
    from torch.profiler import ProfilerActivity, profile
    names = {p.rsplit("/", 1)[-1] for sd, _, _ in runs.values()
             for r in sd.block_trace for p in r["host_ms"]}
    assert names == {p.rsplit("/", 1)[-1] for p in PATHS}
    rec = Recorder()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("probe"):
            pass
        with rec.span("launch"):
            with rec.span("sync_wait"):
                torch.ones(4).sum()
    events = prof.events()
    user = next(e.scope for e in events if e.name == "probe")
    ours = {e.name: e for e in events if e.name.startswith("opv.")}
    assert set(ours) == {"opv.launch", "opv.sync_wait"}
    assert all(e.scope != user for e in ours.values())
    r = rec.block("exact", 1, False, False)
    assert set(r["host_ms"]) == {"launch", "launch/sync_wait"}
    assert 0 < r["host_ms"]["launch/sync_wait"] <= r["host_ms"]["launch"]
    assert top_level_ms(r) == r["host_ms"]["launch"]
    assert rec.block("exact", 1, False, False)["host_ms"] == {}
