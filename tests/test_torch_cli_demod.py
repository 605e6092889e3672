"""The port's opv-demod (opv_tpu_torch.cli.opv_demod) on the CPU: -s --fast
round trips, the golden captures decoded exactly as the JAX package's
pipelined engine decodes them when fed the CLI's 1 MiB reads, metrics,
profile, and the exit codes of the paths not ported yet."""

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


def test_help_and_empty_input():
    rc, out, err = run_main(opv_demod.main, ["-h"])
    assert rc == 0 and "--channels" in err and out == b""
    rc, out, err = _demod(["-q"], b"")
    assert rc == 1 and out == b""


@pytest.mark.parametrize("argv,item", [
    (["-s", "--fast", "--wideband", "4"], "item 9"),
    (["--fast"], "item 10"),
    (["-s"], "item 11"),
    ([], "item 11"),
    (["-s", "--fast", "-c"], "item 11"),
])
def test_unported_paths_exit_2(argv, item):
    rc, out, err = run_main(opv_demod.main, argv + CPU, b"\0" * 4000)
    assert rc == 2 and out == b"" and item in err and "not ported" in err


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
