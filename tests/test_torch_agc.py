"""int8 AGC of the port's streaming engine (CPU tensors, the twins) against
the JAX package's engine: the scenarios of tests/test_locked_stream.py's
TestInt8Agc (low SNR, a weak signal, a mid-stream level step), the step
update itself on fixed statistics, the re-quantization's rounding, an AGC
engine's per-channel step across checkpoints of both packages, and the
pipelined AGC engine.

Tolerances: identical tuple streams (channel, frame bytes, Viterbi metric
and absolute position equal, sync quality within 1e-4).  The adopted step
within 1e-6 relative of the JAX engine's from the same feed (the level
statistics are float32 sums taken in another order), and bit-equal given
the same host statistics (the update is the JAX engine's numpy)."""

import pathlib
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import opv_tpu.stream as sj
import opv_tpu_torch.stream as st
from opv_tpu.config import CONFIG
from stream_scenarios import SPF, assert_same_stream, gap_burst, run, signal

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
from chip_smoke import impaired_feed  # noqa: E402

STEP_RTOL = 1e-6


def _port(channels, **kw):
    return st.LockedStreamDemodulator(channels, device="cpu", **kw)


def _both(x, chunk=None, agc_blocks=None, **kw):
    """The JAX engine and the port's on x: (port tuples, port engine, JAX
    engine), the tuple streams held equal and the steps within
    STEP_RTOL."""
    engines = [sj.LockedStreamDemodulator(x.shape[0], **kw),
               _port(x.shape[0], **kw)]
    outs = []
    for sd in engines:
        if agc_blocks is not None:
            sd._AGC_BLOCKS = agc_blocks
        outs.append(run(sd, x, chunk))
    assert_same_stream(outs[1], outs[0])
    np.testing.assert_allclose(engines[1]._scale_np, engines[0]._scale_np,
                               rtol=STEP_RTOL)
    for k in ("decoded", "perfect", "reacquisitions"):
        assert getattr(engines[1], k) == getattr(engines[0], k), k
    return outs[1], engines[1], engines[0]


def _bit_errors(out, frames):
    """Bit errors against the BERT frames, aligned by the counter byte
    (a missing frame counts as all wrong)."""
    want = np.unpackbits(frames, axis=1)
    got = np.zeros_like(frames)
    for r in out:
        slot = r[1][12]
        if slot < len(frames):
            got[slot] = np.frombuffer(r[1], np.uint8)
    return int((np.unpackbits(got, axis=1) != want).sum())


def test_low_snr_agc_removes_clipping_penalty():
    """Eb/N0 8 dB: noise at ~1.8x wire full scale per component clips at
    the fixed step but sits at 3.5 sigma under AGC; the AGC engine tracks
    the float engine's errors, the fixed-step one is clearly worse."""
    s, frames = signal(10)
    rng = np.random.default_rng(11)
    sig_pow = float(np.mean(np.abs(s[:10 * SPF]) ** 2))
    noise_pow = sig_pow / (10 ** 0.8 / CONFIG.samples_per_symbol)
    x = (s + (rng.standard_normal(len(s)) + 1j * rng.standard_normal(len(s)))
         * np.sqrt(noise_pow / 2)).astype(np.complex64)[None, :]
    out_agc, sd, _ = _both(x, block_frames=2, dtype="int8")
    e_agc = _bit_errors(out_agc, frames)
    e_float = _bit_errors(run(_port(1, block_frames=2, dtype="float32"), x),
                          frames)
    e_fixed = _bit_errors(run(_port(1, block_frames=2, dtype="int8",
                                    agc=False), x), frames)
    total = frames.size * 8
    assert e_agc <= e_float + 0.01 * total, (e_agc, e_float)
    assert e_fixed > 2 * e_agc + 0.005 * total, (e_fixed, e_agc)
    assert sd._scale_np[0] > 129.0          # noise above full scale


def test_weak_signal_keeps_resolution():
    """Amplitude 64 (half an LSB at the fixed step): the fixed step rounds
    the whole stream to zero; AGC adopts a ~128x finer step on the first
    feed and decodes every frame perfectly."""
    s, frames = signal(6)
    weak = (s / 256.0).astype(np.complex64)[None, :]
    out, sd, _ = _both(weak, block_frames=2, dtype="int8")
    assert [r[1] for r in out] == [bytes(f) for f in frames]
    assert all(r[2] == 0 for r in out)
    assert sd._scale_np[0] < 1.0
    assert run(_port(1, block_frames=2, dtype="int8", agc=False), weak) == []


def test_level_step_midstream_requants_and_recovers():
    """A 256x level drop mid-stream: lock drops, the next AGC update
    re-quantizes the window, the engine re-hunts and decodes the quiet
    tail perfectly (fed frame-sized chunks, _AGC_BLOCKS = 2)."""
    s1, _ = signal(8)
    s2, f2 = signal(12, start=100)
    x = np.concatenate([s1, (s2 / 256.0).astype(np.complex64)])[None, :]
    out, sd, _ = _both(x, chunk=SPF, agc_blocks=2, block_frames=2,
                       dtype="int8")
    loud = [r for r in out if r[1][12] < 100]
    quiet = [r for r in out if r[1][12] >= 100]
    assert len(loud) == 8 and len(quiet) >= 4
    assert [r[1] for r in quiet] == [bytes(f) for f in f2[-len(quiet):]]
    assert all(r[2] == 0 for r in quiet)
    assert sd._scale_np[0] < 1.0


@pytest.mark.parametrize("force", [False, True])
@pytest.mark.parametrize("count", [0, 2 * 4160])
def test_agc_update_is_the_jax_formula(force, count):
    """Given the same host statistics, step and buffered window, the
    update adopts bit-identical steps and re-quantizes the window to the
    same int8 rows: clean (the peak decides), noisy (3.5 rms decides),
    inside and outside the hysteresis band, silence."""
    rng = np.random.default_rng(3)
    ss = np.array([2.1e12, 5.0e9, 7.7e11, 0.0, 3.3e13, 1.0e10], np.float32)
    mx = np.array([16383.0, 2100.5, 8000.0, 0.0, 40000.0, 180.0], np.float32)
    cnt = 2_000_000
    scale = np.array([129.0, 12.0, 50.0, 129.0, 129.0, 1.5], np.float32)
    rows = rng.integers(-127, 128, (6, 5 * SPF // 40 + 26, 80), np.int8)
    sd_j = sj.LockedStreamDemodulator(6, block_frames=4, dtype="int8")
    sd_t = _port(6, block_frames=4, dtype="int8")
    for sd, put in ((sd_j, jnp.asarray), (sd_t, torch.from_numpy)):
        sd._stat_ss, sd._stat_max = put(ss.copy()), put(mx.copy())
        sd._stat_cnt = cnt
        sd._scale_np = scale.copy()
        sd._scale = put(scale.copy())
        sd._buf = put(rows.copy())
        sd._count = count
        sd._agc_update(force=force)
    np.testing.assert_array_equal(sd_t._scale_np, sd_j._scale_np)
    assert sd_t._scale_np.dtype == sd_j._scale_np.dtype == np.float32
    np.testing.assert_array_equal(sd_t._buf.numpy(), np.asarray(sd_j._buf))
    assert (sd_t._scale_np != scale).any() and sd_t._stat_cnt == 0
    if count:
        assert not np.array_equal(sd_t._buf.numpy(), rows)


def test_requant_rounds_half_to_even():
    buf = torch.tensor([[1, 3, 5, -1, -3, -5, 127, -127, 7]],
                       dtype=torch.int8)[:, None, :]
    half = torch.tensor([0.5])
    got = st.LockedStreamDemodulator._requant(buf, half)
    assert got.flatten().tolist() == [0, 2, 2, 0, -2, -2, 64, -64, 4]
    assert got.dtype == torch.int8
    assert st.LockedStreamDemodulator._requant(
        buf, torch.tensor([3.0])).flatten().tolist()[6:8] == [127, -127]
    sd_j = sj.LockedStreamDemodulator(1, block_frames=1, dtype="int8")
    np.testing.assert_array_equal(
        np.asarray(sd_j._requant(jnp.asarray(buf.numpy()),
                                 jnp.asarray(half.numpy()))), got.numpy())


@pytest.fixture(scope="module")
def two_levels():
    """Ten frames on two channels, channel 1 at 1/256 of full scale, and
    the JAX AGC engine's uninterrupted tuples (a checkpoint at a cut
    continues them)."""
    s, _ = signal(10)
    x = np.stack([s, (s / 256.0).astype(np.complex64)])
    return x, run(sj.LockedStreamDemodulator(2, block_frames=4,
                                             dtype="int8"), x)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_agc_checkpoint_crosses_packages(tmp_path, two_levels, direction):
    """An AGC engine's per-channel step crosses a checkpoint both ways: the
    loading engine adopts it (no re-priming) and continues the stream."""
    x, ref = two_levels
    cut = 6 * SPF + 1013
    mk_j = lambda: sj.LockedStreamDemodulator(2, block_frames=4,  # noqa: E731
                                              dtype="int8")
    mk_t = lambda: _port(2, block_frames=4, dtype="int8")  # noqa: E731
    first, second = ((mk_j(), mk_t()) if direction == "jax_to_port"
                     else (mk_t(), mk_j()))
    save = sj.save_state if direction == "jax_to_port" else st.save_state
    load = st.load_state if direction == "jax_to_port" else sj.load_state
    out = list(first.feed(x[:, :cut]))
    assert first._scale_np[1] < 1.0 < first._scale_np[0]
    save(str(tmp_path / "ck"), first.state_tree())
    second.load_state_tree(load(str(tmp_path / "ck"), second.state_tree()))
    np.testing.assert_array_equal(second._scale_np, first._scale_np)
    out += second.feed(x[:, cut:]) + second.flush()
    assert_same_stream(out, ref)
    assert second.decoded == 20


@pytest.mark.parametrize("chunk", [70_001, 4 * SPF])
def test_pipelined_agc_matches_jax(chunk):
    """The pipelined int8 AGC engine emits the JAX pipelined engine's
    tuples on the lock-loss stream.  Fed advance-sized chunks it also
    emits the synchronous engine's.  Fed 70,001-sample chunks it does not,
    in either package: the pipeline resolves block N-1 after block N's
    window is appended, so the update at that resolve reads one more feed
    of statistics and re-quantizes a whole window.  Here the synchronous
    engine re-hunts burst 2 on a window still quantized at the gap's step
    and decodes its first three frames 2 samples late with metrics of
    ~800, which the pipelined engine decodes with metric 0 (ROADMAP
    queue 3)."""
    x = gap_burst()[0][None, :]
    got, _, _ = _both(x, chunk=chunk, block_frames=4, dtype="int8",
                      pipeline=True)
    sync = run(_port(1, block_frames=4, dtype="int8"), x, chunk)
    if chunk == 4 * SPF:
        assert got == sync
        return
    diff = [i for i, (a, b) in enumerate(zip(got, sync)) if a != b]
    assert len(got) == len(sync) and len(diff) == 3
    assert all(got[i][2] == 0 < sync[i][2] and
               abs(got[i][4] - sync[i][4]) <= 2 for i in diff)


def test_pipelined_agc_silent_tail_matches_jax():
    """chip_smoke.impaired_feed (20 frames on 4 channels, the last one a
    gap burst) fed in advance-sized chunks: the pipelined AGC engine
    drains its last block at flush(), where a lock transition triggers an
    update that reads only the stream's silent tail; channel 0 adopts the
    1e-6 floor, and its last four frames, decoded from the re-quantized
    window, come out with sync quality 0 (flywheel frames, bytes right,
    metric 0), in both packages; channel 1 (AWGN) adopts another step and
    decodes its last four frames with metrics 0 instead of 2-4.  The
    synchronous engine updated before that tail (ROADMAP queue 3)."""
    s, _ = signal(20)
    delays = (0, 488, 976)
    x = np.zeros((3, len(s) + max(delays) + 24), np.complex64)
    for c, d in enumerate(delays):
        x[c, d:d + len(s)] = s
    feed = impaired_feed(torch.from_numpy(x), torch.device("cpu"))[0].numpy()
    got, sd, _ = _both(feed, chunk=4 * SPF, block_frames=4, dtype="int8",
                       pipeline=True)
    sync = run(_port(4, block_frames=4, dtype="int8"), feed, 4 * SPF)
    assert sd._scale_np[0] == np.float32(1e-6)
    assert [(r[0], r[1], r[4]) for r in got] == \
        [(r[0], r[1], r[4]) for r in sync]
    tail = [a for a, b in zip(got, sync) if a != b and a[0] == 0]
    assert len(tail) == 4 and all(r[2] == 0 and r[3] == 0.0 for r in tail)


def test_silent_first_feed_matches_jax():
    """opv-demod -s --fast --buf int8 at 64 channels reads 4,096 samples
    per channel at a time, so a channel whose signal starts later is
    silent on the first feed, where AGC primes.  Both packages floor its
    step at 1e-6; the signal that follows saturates, and the next adoption
    re-quantizes that window to zeros, so channel 1 loses frames the same
    way in both, while channel 0 decodes every frame (ROADMAP queue 3)."""
    s, frames = signal(12)
    delays = (0, 5000)
    x = np.zeros((2, len(s) + max(delays) + 24), np.complex64)
    for c, d in enumerate(delays):
        x[c, d:d + len(s)] = s
    got, _, _ = _both(x, chunk=4096, block_frames=4, dtype="int8",
                      pipeline=True)
    assert [r[1] for r in got if r[0] == 0] == [bytes(f) for f in frames]
    # the first nine frames of the late channel are lost
    assert [r[1] for r in got if r[0] == 1] == [bytes(f) for f in frames[9:]]
