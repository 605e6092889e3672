"""The port's opv-demod (opv_tpu_torch.cli.opv_demod) on the CPU: -s --fast
round trips, the golden captures decoded exactly as the JAX package's
pipelined engine decodes them when fed the CLI's 1 MiB reads, metrics,
profile, --wideband; batch mode (the tracking receiver, --fast the dense
receiver, -c the coherent loop) and -s (the tracking receiver) against
the reference binary's golden frames and stderr lines."""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from opv_tpu.io.iq import iq_bytes_to_f32_pairs
from opv_tpu.stream import LockedStreamDemodulator as EngineJ
from opv_tpu_torch.cli import opv_demod, opv_mod
from cli_support import run_main

ROOT = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "golden"

FB = 134
CPU = ["--device", "cpu"]


def _frames(n, seed):
    return np.random.default_rng(seed).integers(0, 256, n * FB,
                                                dtype=np.uint8).tobytes()


def _fast_iq(data):
    rc, iq, _ = run_main(opv_mod.main, ["-R", "--fast"] + CPU, data)
    assert rc == 0
    return iq


def _demod(argv, iq):
    return run_main(opv_demod.main, ["-s", "--fast"] + argv + CPU, iq)


def _split(raw):
    return [raw[i:i + FB] for i in range(0, len(raw), FB)]


@pytest.fixture(scope="module")
def four():
    data = _frames(4, 9)
    return data, _fast_iq(data)


@pytest.mark.parametrize("argv", [["-r", "-q"], ["-r", "-q", "--block", "2"],
                                  ["-r", "-q", "--buf", "int8"]],
                         ids=["default", "block2", "int8"])
def test_round_trip(four, argv):
    """mod --fast | demod -s --fast -r == input, at the default block, at
    --block 2 and on int8 window rows."""
    data, iq = four
    rc, out, _ = _demod(argv, iq)
    assert rc == 0 and out == data


def test_single_frame_burst():
    """An isolated 1-frame burst is emitted by burst salvage."""
    data = _frames(1, 17)
    rc, out, _ = _demod(["-r", "-q"], _fast_iq(data))
    assert rc == 0 and out == data


def test_two_channels_tagged():
    """--channels 2: sample-interleaved streams; each channel's frames come
    out byte-exact, tagged [ch N] on stderr with the frame dump."""
    d0, d1 = _frames(4, 11), _frames(4, 12)
    a = np.frombuffer(_fast_iq(d0), "<i2").reshape(-1, 2)
    b = np.frombuffer(_fast_iq(d1), "<i2").reshape(-1, 2)
    inter = np.stack([a, b], axis=1).astype("<i2").tobytes()
    rc, out, err = _demod(["-r", "--channels", "2"], inter)
    assert rc == 0
    assert sorted(_split(out)) == sorted(_split(d0) + _split(d1))
    assert err.count("[ch 0]") == 4 and err.count("[ch 1]") == 4
    assert "Summary: 8 frames (8 perfect, 0 errors)" in err


def _jax_pipelined(iq: bytes) -> bytes:
    """The JAX package's pipelined engine fed as opv-demod -s --fast feeds
    it: 1 MiB reads, whole sample instants, wire-form float32 pairs."""
    sd = EngineJ(channels=1, pipeline=True, block_frames=4)
    out = []
    for off in range(0, len(iq), opv_demod.READ_BYTES):
        out += sd.feed(iq_bytes_to_f32_pairs(iq[off:off + opv_demod.READ_BYTES]))
    out += sd.flush()
    return b"".join(fb for _c, fb, *_ in out)


@pytest.mark.parametrize("name", ["cfo500", "awgn8"])
def test_golden_capture_matches_jax_engine(name):
    iq = (GOLDEN / f"{name}.iq").read_bytes()
    rc, out, _ = _demod(["-r", "-q"], iq)
    want = _jax_pipelined(iq)
    assert rc == 0 and len(out) >= FB and out == want


def test_metrics_lines(four, tmp_path):
    """--metrics FILE: one JSON line per block-completing feed and a final
    one, counting the frames written."""
    data, iq = four
    path = tmp_path / "m.jsonl"
    rc, out, _ = _demod(["-r", "-q", "--metrics", str(path)], iq)
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    assert rc == 0 and out == data and lines[-1]["final"] is True
    last = lines[-1]
    assert last["decoded"] == 4 and last["channels"] == 1
    assert last["engine"] == "locked" and last["locked_channels"] == 1
    assert {"tag", "device_wait_ms", "host_ms"} <= set(last["last_block"])


def test_profile_writes_a_chrome_trace(four, tmp_path):
    data, iq = four
    rc, out, _ = _demod(["-r", "-q", "--profile", str(tmp_path / "prof")], iq)
    trace = json.loads((tmp_path / "prof" / "opv_demod_trace.json").read_text())
    assert rc == 0 and out == data and trace["traceEvents"]


@pytest.mark.parametrize("feed", ["channels", "wideband"])
def test_profile_carries_the_engine_spans(four, wideband4, tmp_path, feed):
    """--profile turns the engine's timing records on: the Chrome trace
    holds its host spans (and the wideband receiver's) as CPU ranges, and
    the frames are those of the run without it."""
    if feed == "channels":
        argv, iq = ["--block", "1"], four[1]
        want = {"opv.append", "opv.launch", "opv.resolve",
                "opv.resolve.wait", "opv.resolve.emit", "opv.slide"}
    else:
        argv, iq = ["--wideband", str(wideband4[0])], wideband4[1]
        want = {"opv.wideband.append", "opv.wideband.channelize",
                "opv.wideband.slide", "opv.launch", "opv.resolve"}
    rc, out, _ = _demod(["-r", "-q"] + argv
                        + ["--profile", str(tmp_path / "prof")], iq)
    rc0, out0, _ = _demod(["-r", "-q"] + argv, iq)
    trace = json.loads((tmp_path / "prof" / "opv_demod_trace.json").read_text())
    spans = [e for e in trace["traceEvents"]
             if str(e.get("name", "")).startswith("opv.")]
    assert rc == rc0 == 0 and out == out0
    assert want <= {e["name"] for e in spans}
    assert {e.get("cat") for e in spans} == {"cpu_op"}


def test_help_and_empty_input():
    rc, out, err = run_main(opv_demod.main, ["-h"])
    assert rc == 0 and "--channels" in err and out == b""
    rc, out, err = _demod(["-q"], b"")
    assert rc == 1 and out == b""


@pytest.mark.parametrize("name,gold", [("bert3", "bert3.frames"),
                                       ("raw3", "raw3.bin")])
def test_batch_fast_gives_the_golden_frames(name, gold):
    """Batch --fast: rx_fast over all of stdin, the reference's frames on
    stdout in the order of their starts; the summary's state is "-"."""
    rc, out, err = run_main(opv_demod.main, ["--fast", "-r"] + CPU,
                            (GOLDEN / f"{name}.iq").read_bytes())
    assert rc == 0 and out == (GOLDEN / gold).read_bytes()
    assert "Loaded 264160 samples (0.122 sec)" in err
    assert "Summary: 3 frames (" in err
    assert "Final state: -, AFC:" in err


def test_batch_fast_short_capture():
    """Shorter than one frame and its sync word: nothing to decode, rc 1."""
    iq = (GOLDEN / "bert3.iq").read_bytes()[: 4 * (86_720 + 959)]
    rc, out, err = run_main(opv_demod.main, ["--fast"] + CPU, iq)
    assert rc == 1 and out == b""
    assert "Capture shorter than one frame; nothing to decode" in err


def test_batch_coherent_matches_the_reference():
    """-c on bert3: the reference binary's report (tests/test_coherent.py's
    docstring), the experimental-mode note, no frame, rc 1."""
    rc, out, err = run_main(opv_demod.main, ["-c", "-r"] + CPU,
                            (GOLDEN / "bert3.iq").read_bytes())
    assert rc == 1 and out == b""
    for line in ("OPV MSK Demodulator with Costas Loop v1.0 (coherent)",
                 "Note: coherent mode is experimental",
                 "Estimated carrier offset: 1430.0 Hz",
                 "Demodulated 6604 symbols, final AFC offset: 2000.0 Hz",
                 "Summary: 0 frames (0 perfect, 0 errors)",
                 "Final state: HUNTING, AFC: 2000.0 Hz"):
        assert line in err, line


def test_streaming_ignores_coherent():
    """-s -c runs -s (the reference ignores -c when streaming), with the
    experimental-mode note on stderr."""
    iq = (GOLDEN / "bert3.iq").read_bytes()
    rc, out, err = run_main(opv_demod.main, ["-s", "-r", "-q"] + CPU, iq)
    rc_c, out_c, err_c = run_main(opv_demod.main, ["-s", "-c", "-r", "-q"]
                                  + CPU, iq)
    assert rc == rc_c == 0 and out == out_c == (GOLDEN / "bert3.frames").read_bytes()
    assert err_c.startswith("Note: coherent mode is experimental")
    assert err_c.split("\n", 1)[1] == err


@pytest.mark.parametrize("name,gold", [("bert3", "bert3.frames"),
                                       ("raw3", "raw3.bin")])
def test_batch_mode_gives_the_golden_frames(name, gold):
    """Batch mode (no -s): rx_batch over all of stdin, the reference's
    frames on stdout; the reference's stderr report around them."""
    rc, out, err = run_main(opv_demod.main, ["-r"] + CPU,
                            (GOLDEN / f"{name}.iq").read_bytes())
    assert rc == 0 and out == (GOLDEN / gold).read_bytes()
    assert "Loaded 264160 samples (0.122 sec)" in err
    assert "Demodulated 6603 symbols, final AFC offset:" in err
    assert "Summary: 3 frames (3 perfect, 0 errors)" in err
    assert "Final state: LOCKED" in err


def test_streaming_transition_lines_and_metrics(tmp_path):
    """-s on bert3.iq: the reference binary's sync transition lines byte
    for byte (tests/test_cli.py::TestSyncDiagnostics), the CFO estimate,
    the summary, and a final metrics line with the Viterbi histogram."""
    path = tmp_path / "m.jsonl"
    rc, out, err = run_main(opv_demod.main, ["-s", "--metrics", str(path)]
                            + CPU, (GOLDEN / "bert3.iq").read_bytes())
    lines = [ln for ln in err.splitlines()
             if "HUNTING" in ln or "VERIFYING" in ln or "LOCKED:" in ln]
    assert rc == 0 and out == b""
    assert lines[:5] == [
        "[23] HUNTING→VERIFYING (corr=1.000, raw=5824282519967)",
        "[2167] VERIFYING→LOCKED (frame 1)",
        "[2191] LOCKED: sync OK (corr=1.000)",
        "[4359] LOCKED: sync OK (corr=1.000)",
        "[6527] LOCKED: sync MISS #1 (corr=0.000)",
    ]
    assert "Estimated carrier offset: 1430.0 Hz" in err
    assert "Summary: 3 frames (3 perfect, 0 errors)" in err
    final = json.loads(path.read_text().splitlines()[-1])
    assert final["frames"] == 3 and final["sync_state"] == "LOCKED"
    assert final["viterbi_metric_hist"]["<=0"] == 3


@pytest.mark.parametrize("argv,gold", [(["-a", "0.01"], "cfo500_a01.frames"),
                                       (["-o", "500"], "cfo500_o500.frames")])
def test_streaming_dsp_tunables(argv, gold):
    """-s -a / -o on the +500 Hz capture: the reference's frames for each
    (tests/test_streaming.py::TestDSPTunableParity)."""
    rc, out, err = run_main(opv_demod.main, ["-s", "-r", "-q"] + argv + CPU,
                            (GOLDEN / "cfo500.iq").read_bytes())
    assert rc == 0 and out == (GOLDEN / gold).read_bytes(), err[-1000:]


@pytest.fixture(scope="module")
def wideband4():
    """tests/test_cli.py's --wideband 4 signal: two carriers (channels 0
    and 2, 4 frames each) scaled by 0.45 to stay inside int16, as wire
    bytes; and the transmitted frames."""
    from test_channelizer import msk_wideband, synthesize_wideband
    from opv_tpu.core import build_bert_frame
    k = 4
    sets = {0: np.asarray(build_bert_frame("W5NYV", frame_num=np.arange(4))),
            2: np.asarray(build_bert_frame("TEST", frame_num=np.arange(4)))}
    lead = np.zeros(2000 * k, np.complex128)
    wb = {c: np.concatenate([lead, msk_wideband(f, k)])
          for c, f in sets.items()}
    n = max(map(len, wb.values()))
    x = synthesize_wideband(wb, k, n) * 0.45
    wire = np.empty((n, 2), dtype="<i2")
    wire[:, 0] = np.clip(np.round(x.real), -32768, 32767)
    wire[:, 1] = np.clip(np.round(x.imag), -32768, 32767)
    return k, wire.tobytes(), [bytes(f) for fs in sets.values() for f in fs]


def test_wideband_decodes_every_frame(wideband4, tmp_path):
    """-s --fast --wideband 4 -r: the frame set is the transmitted frames
    and the port's WidebandReceiver's output on the same reads (pipelined,
    block_frames 2, exact quanta, the tail at the end); frames are tagged
    [ch N]; the final metrics line counts channel samples per channel."""
    from opv_tpu_torch.io.iq import iq_bytes_to_complex
    from opv_tpu_torch.stream import WidebandReceiver
    k, wire, want = wideband4
    path = tmp_path / "m.jsonl"
    rc, out, err = _demod(["-r", "--wideband", str(k), "--metrics",
                           str(path)], wire)
    assert rc == 0, err[-2000:]
    assert sorted(_split(out)) == sorted(want)
    wb = WidebandReceiver(k, block_frames=2, pipeline=True, device="cpu")
    x = iq_bytes_to_complex(wire)
    q = wb.quantum
    assert opv_demod.WIDEBAND_READ_BYTES >= len(wire)     # one read
    ref = []
    for off in range(0, len(x) - q + 1, q):
        ref += wb.feed(x[off:off + q])
    ref += wb.feed(x[len(x) // q * q:]) + wb.flush()
    assert out == b"".join(r[1] for r in ref)
    assert err.count("[ch 0]") == 4 and err.count("[ch 2]") == 4
    assert "Summary: 8 frames (8 perfect, 0 errors)" in err
    final = json.loads(path.read_text().splitlines()[-1])
    assert final["final"] and final["decoded"] == 8 and final["channels"] == k
    assert final["samples_per_chan"] == len(x) // k


@pytest.mark.parametrize("argv", [
    ["-s", "--fast", "--wideband", "4", "--channels", "2"],
    ["-s", "--wideband", "4"],
    ["--fast", "--wideband", "4"],
])
def test_wideband_usage_errors_exit_2(argv):
    rc, out, err = run_main(opv_demod.main, argv + CPU, b"\0" * 4000)
    assert rc == 2 and out == b"" and "--wideband" in err


def test_default_device_needs_a_card(four):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default runs there")
    rc, out, err = run_main(opv_demod.main, ["-s", "--fast", "-r"], four[1])
    assert rc != 0 and out == b"" and "--device cpu" in err


def test_module_entry_point(four):
    data, iq = four
    r = subprocess.run([sys.executable, "-m", "opv_tpu_torch.cli.opv_demod",
                        "-s", "--fast", "-r", "-q"] + CPU, input=iq,
                       capture_output=True, cwd=ROOT, timeout=120)
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    assert r.stdout == data
