"""The port's BER tools (opv_tpu_torch/tools/) on the CPU twins against the
JAX package and the reference binary's committed waterfall captures.

The captures are the JAX tools' byte for byte; seq_stats/tail_stats equal
tools/ber_headtohead.py's; ber_curve writes tools/ber_curve.py's rows on
every path; the locked receiver meets tests/test_ber.py's
waterfall envelope and is no worse than the reference's frames on
awgn7/awgn8; with the CFO pinned to JAX's estimate, rx_locked decodes the
7 dB capture to JAX's frames exactly."""

import json
import pathlib

import numpy as np
import pytest
import torch

from opv_tpu_torch.cli._device import DeviceError
from opv_tpu_torch.config import CONFIG
from opv_tpu_torch.rx.locked import rx_locked
from opv_tpu_torch.tools import (ber_curve, ber_headtohead, capture,
                                 gen_timing_template, timing_pin_probe)

REPO = pathlib.Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


def _jax_exact(n_frames: int):
    """tools/ber_headtohead.py's transmission over JAX's exact TX."""
    import jax.numpy as jnp
    from opv_tpu.core import build_bert_frame, encode_frame
    from opv_tpu.tx import modulate_frames, tx_flush_zeros
    frames = build_bert_frame("W5NYV", frame_num=np.arange(n_frames) % 256)
    iq, _ = modulate_frames(encode_frame(jnp.asarray(frames)), exact=True)
    iq = np.concatenate([np.asarray(iq), tx_flush_zeros()])
    return np.asarray(frames), iq


def _jax_headtohead_wire(iq, n_frames, seed, db, lead):
    """tools/ber_headtohead.py:145-165, verbatim."""
    s = iq[:, 0].astype(np.float64) + 1j * iq[:, 1].astype(np.float64)
    sig_pow = float(np.mean(np.abs(s[: n_frames * CONFIG.samples_per_frame])
                            ** 2))
    rng = np.random.default_rng([seed, int(round(db * 10))])
    npow = sig_pow / (10 ** (db / 10) / CONFIG.samples_per_symbol)
    noisy = s + (rng.standard_normal(len(s))
                 + 1j * rng.standard_normal(len(s))) * np.sqrt(npow / 2)
    noisy = np.concatenate([
        (rng.standard_normal(lead) + 1j * rng.standard_normal(lead))
        * np.sqrt(npow / 2), noisy])
    wire = np.empty((len(noisy), 2), dtype="<i2")
    wire[:, 0] = np.clip(np.trunc(noisy.real), -32768, 32767)
    wire[:, 1] = np.clip(np.trunc(noisy.imag), -32768, 32767)
    return wire


@pytest.fixture(scope="module")
def exact3():
    return capture.exact_signal(3, CPU), _jax_exact(3)


@pytest.mark.parametrize("seed,db", [(42, 7.0), (45, 5.0)])
def test_headtohead_capture_is_the_jax_tools(exact3, seed, db):
    (truth, s, sig_pow), (jframes, jiq) = exact3
    np.testing.assert_array_equal(truth, jframes)
    wire = capture.headtohead_wire(s, sig_pow, seed, db, lead=2000)
    want = _jax_headtohead_wire(jiq, 3, seed, db, 2000)
    assert wire.dtype == want.dtype and wire.tobytes() == want.tobytes()


def test_curve_capture_is_the_jax_tools():
    """tools/ber_curve.py's fast TX and one generator across the points."""
    import jax.numpy as jnp
    from opv_tpu.core import build_bert_frame, encode_frame
    from opv_tpu.tx import modulate_frames, tx_flush_zeros
    frames, s, sig_pow = capture.fast_signal(3, CPU)
    jf = build_bert_frame("W5NYV", frame_num=np.arange(3))
    iq, _ = modulate_frames(encode_frame(jnp.asarray(jf)), exact=False)
    iq = np.concatenate([np.asarray(iq), tx_flush_zeros()])
    js = (iq[:, 0] + 1j * iq[:, 1]).astype(np.complex64)
    jpow = float(np.mean(np.abs(js[: 3 * CONFIG.samples_per_frame]) ** 2))
    np.testing.assert_array_equal(frames, np.asarray(jf))
    assert s.tobytes() == js.tobytes() and sig_pow == jpow
    ours, theirs = np.random.default_rng(42), np.random.default_rng(42)
    for db in (7.0, 10.0):
        npow = jpow / (10 ** (db / 10) / CONFIG.samples_per_symbol)
        want = js + (theirs.standard_normal(len(js))
                     + 1j * theirs.standard_normal(len(js))) \
            * np.sqrt(npow / 2)
        assert capture.awgn(s, sig_pow, ours, db).tobytes() == want.tobytes()


def _sequences(seed: int):
    """A truth block and decoded sequences of it: shifted, short, with
    flipped bits, longer than the truth, empty."""
    rng = np.random.default_rng(seed)
    truth = rng.integers(0, 256, (12, CONFIG.frame_bytes), dtype=np.uint8)
    noisy = truth.copy()
    flips = rng.random(noisy.shape) < 0.02
    noisy[flips] ^= rng.integers(1, 256, int(flips.sum()), dtype=np.uint8)
    return truth, [noisy, noisy[3:], noisy[1:9], noisy[:0],
                   np.concatenate([noisy, noisy[:4]]),
                   rng.integers(0, 256, (5, CONFIG.frame_bytes),
                                dtype=np.uint8)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seq_and_tail_stats_are_the_jax_tools(seed):
    from tools.ber_headtohead import seq_stats, tail_stats
    truth, seqs = _sequences(seed)
    for seq in seqs:
        assert ber_headtohead.seq_stats(seq, truth) == seq_stats(seq, truth)
        for skip in (0, 4, 6):
            assert ber_headtohead.tail_stats(seq, truth, skip) == \
                tail_stats(seq, truth, skip)


@pytest.fixture(scope="module")
def awgn_setup():
    """tests/test_ber.py's 20-frame fast-TX capture."""
    return capture.fast_signal(20, CPU)


def _ber(got, frames):
    a = np.unpackbits(got, axis=1)
    b = np.unpackbits(frames, axis=1)
    return float((a != b).sum()) / a.size


class TestAwgnWaterfall:
    """tests/test_ber.py::TestAwgnWaterfall on the port's locked path."""

    @pytest.mark.parametrize("db,seed,limit", [(7.0, 42, 0.03),
                                               (10.0, 43, 1e-3)])
    def test_locked_within_reference_envelope(self, awgn_setup, db, seed,
                                              limit):
        frames, s, sig_pow = awgn_setup
        noisy = capture.awgn(s, sig_pow, np.random.default_rng(seed), db)
        got, _ = ber_curve.decode(noisy, frames, "locked", CPU)
        ber = _ber(got, frames)
        assert ber <= limit, f"{db} dB BER {ber:.3e} exceeds {limit}"


def _golden(golden_dir, db):
    raw = np.fromfile(golden_dir / f"awgn{db}.iq", dtype="<i2").reshape(-1, 2)
    ref = np.frombuffer((golden_dir / f"awgn{db}.frames").read_bytes(),
                        dtype=np.uint8).reshape(-1, CONFIG.frame_bytes)
    return capture.wire_to_complex(raw).astype(np.complex64), ref


class TestWaterfallHeadToHead:
    """tests/test_ber.py::TestWaterfallHeadToHead on the port: the locked
    path's BER on the reference binary's committed waterfall captures is
    no worse than the reference's own frames."""

    @pytest.mark.parametrize("db", [7, 8])
    def test_locked_ber_at_most_reference(self, golden_dir, db):
        truth = capture.bert_frames(12)
        x, ref_seq = _golden(golden_dir, db)
        out = rx_locked(torch.from_numpy(x)[None], n_frames=12)
        ours = out["frames"][0].numpy()[out["frame_valid"][0].numpy()]
        be, _ = ber_headtohead.seq_stats(ours, truth)
        ref_be, _ = ber_headtohead.seq_stats(ref_seq, truth)
        assert be <= ref_be, (f"{db} dB: locked {be} bit errors, the "
                              f"reference {ref_be}, on the same capture")


def test_locked_on_the_7db_capture_is_jax_given_its_cfo(awgn_setup):
    """rx_locked on the 7 dB capture of TestAwgnWaterfall: with the CFO
    pinned to the JAX receiver's estimate (the grid argmax differs between
    the packages by tens of Hz on flat curves), the port decodes JAX's
    frames, metrics and validity exactly, on JAX's grid."""
    import jax.numpy as jnp
    from opv_tpu.rx.locked import rx_locked as rx_locked_j
    frames, s, sig_pow = awgn_setup
    x = capture.awgn(s, sig_pow, np.random.default_rng(42), 7.0
                     ).astype(np.complex64)
    want = {k: np.asarray(v) for k, v in
            rx_locked_j(jnp.asarray(x)[None], n_frames=20).items()}
    got = rx_locked(torch.from_numpy(x)[None], n_frames=20,
                    freq_offset=torch.tensor(want["freq_offset"]))
    for k in ("frames", "metrics", "frame_valid", "p0"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    np.testing.assert_allclose(got["frac"].numpy(), want["frac"], atol=1e-3)
    assert 0 < _ber(got["frames"][0].numpy(), frames) <= 0.03


def test_headtohead_tool_on_a_short_capture(tmp_path):
    """The tool's main on one 3-frame capture at 10 dB, held to BER_r05.json:
    every row of the JAX tool with its keys, the reference row copied in,
    a compare entry per row with the port's figure first, and the tracking
    counters of the capture; 3 frames cannot equal a 200-frame artifact,
    so the holds fail and main returns 1."""
    path = tmp_path / "ber.json"
    rc = ber_headtohead.main(["--device", "cpu", "--frames", "3", "--ebn0",
                              "10", "--seeds", "42", "--against",
                              str(REPO / "BER_r05.json"), "--json",
                              str(path)])
    out = json.loads(path.read_text())
    assert rc == 1 and out["holds"] is False and out["device"] == "cpu"
    assert out["card"] is None and out["frames_per_capture"] == 3
    row, = out["rows"]
    file_row = json.loads((REPO / "BER_r05.json").read_text())["rows"][-1]
    assert row["reference"] == file_row["reference"]
    assert set(row) == set(file_row)
    for key in ber_headtohead.LOCKED_ROWS:
        assert set(row[key]) == set(file_row[key]), key
        assert row[key]["decoded"] == 3 and row[key]["ber"] == 0.0, key
    trk = row["tracking"]
    assert set(file_row["tracking"]) - {"backend"} <= set(trk)
    assert trk["device"] == "cpu" and trk["decoded"] == 3
    assert (trk["locks"], trk["lock_drops"]) == (1, 0)
    cmp, = out["compare"]
    assert cmp["tracking"]["against"] == "reference"
    assert cmp["tracking"]["locks"] == [1, file_row["reference"]["locks"]]
    assert cmp["locked"]["ber"] == [0.0, file_row["locked"]["ber"]]


def _compare_of(against: dict) -> dict:
    """An output whose rows are the file's own (tracking = reference)."""
    rows = [{**r, "tracking": r["reference"]} for r in against["rows"]]
    return {"compare": ber_headtohead.compare(rows, against)}


def test_holds_of_the_file_against_itself():
    against = json.loads((REPO / "BER_r05.json").read_text())
    assert ber_headtohead.check(_compare_of(against)) == []


@pytest.mark.parametrize("what", ["tracking seed", "tracking misses",
                                  "locked 6%", "locked 10 dB", "decoded"])
def test_holds_name_each_departure(what):
    against = json.loads((REPO / "BER_r05.json").read_text())
    rows = [json.loads(json.dumps({**r, "tracking": r["reference"]}))
            for r in against["rows"]]
    r7, r10 = rows[2], rows[4]
    if what == "tracking seed":
        r7["tracking"]["ber_per_seed"][3] += 1e-6
    elif what == "tracking misses":
        r7["tracking"]["sync_misses"] += 1
    elif what == "locked 6%":
        r7["locked_int8_agc"]["ber"] *= 1.06
    elif what == "locked 10 dB":
        # 2e-5 over at 10 dB is allowed, 3e-5 is not
        r10["locked"]["ber"] += 2e-5
        assert ber_headtohead.check(
            {"compare": ber_headtohead.compare(rows, against)}) == []
        r10["locked"]["ber"] += 1e-5
    else:
        r7["locked_streaming_bf4"]["decoded"] -= 6
    bad = ber_headtohead.check(
        {"compare": ber_headtohead.compare(rows, against)})
    assert len(bad) == 1, bad


@pytest.mark.parametrize("tool", [ber_headtohead, ber_curve, timing_pin_probe,
                                  gen_timing_template])
def test_tools_default_to_the_card(tool):
    """--device defaults to cuda, and on a host without a card that is an
    error, never a run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(DeviceError):
        tool.main([])


def _jax_curve(monkeypatch, tmp_path, argv) -> list:
    """tools/ber_curve.py's rows for `argv` (it reads sys.argv)."""
    import sys
    from tools import ber_curve as jax_curve
    out = tmp_path / "jax.json"
    monkeypatch.setattr(sys, "argv", ["ber_curve.py", *argv, "--json",
                                      str(out)])
    assert jax_curve.main() == 0
    return json.loads(out.read_text())


@pytest.mark.parametrize("path", ber_curve.PATHS)
def test_curve_tool_rows_are_the_jax_tools(monkeypatch, tmp_path, path):
    """ber_curve's main on 3 frames at 8 and 10 dB (one generator across
    the points) writes the JAX tool's rows, value for value, on every
    path."""
    argv = ["--frames", "3", "--ebn0", "8", "10", "--path", path]
    out = tmp_path / "port.json"
    assert ber_curve.main(argv + ["--device", "cpu", "--json",
                                  str(out)]) == 0
    got = json.loads(out.read_text())
    assert got == _jax_curve(monkeypatch, tmp_path, argv)
    assert got[0]["bit_errors"] > 0         # the 8 dB point has errors
