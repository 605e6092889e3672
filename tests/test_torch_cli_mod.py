"""The port's opv-mod (opv_tpu_torch.cli.opv_mod) on the CPU: the exact path
writes the reference binary's captures byte for byte, --fast writes the
JAX package's fast TX, and the usage errors keep their exit codes."""

import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opv_tpu.core import build_bert_frame, encode_frame
from opv_tpu.tx import modulate_frames, tx_flush_zeros
from opv_tpu_torch.cli import opv_mod
from cli_support import run_main

ROOT = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "golden"


def _jax_tx(frames, exact):
    iq, _ = modulate_frames(encode_frame(jnp.asarray(frames)), exact=exact)
    return np.concatenate([np.asarray(iq), tx_flush_zeros()]
                          ).astype("<i2").tobytes()


def test_bert_exact_equals_reference_capture():
    rc, out, _ = run_main(opv_mod.main, ["-S", "W5NYV", "-B", "3",
                                         "--device", "cpu"])
    assert rc == 0 and out == (GOLDEN / "bert3.iq").read_bytes()


def test_raw_exact_equals_reference_capture():
    rc, out, _ = run_main(opv_mod.main, ["-R", "--device", "cpu"],
                          (GOLDEN / "raw3.bin").read_bytes())
    assert rc == 0 and out == (GOLDEN / "raw3.iq").read_bytes()


def test_fast_raw_equals_jax_fast_tx():
    frames = np.random.default_rng(5).integers(0, 256, (2, 134), dtype=np.uint8)
    rc, out, err = run_main(opv_mod.main, ["-R", "--fast", "-v", "--device",
                                           "cpu"], frames.tobytes() + b"xyz")
    assert rc == 0 and out == _jax_tx(frames, exact=False)
    assert "Warning: EOF after partial frame (3 bytes)" in err
    assert "End of input. Total frames: 2" in err


def test_bert_token_and_verbose():
    """-t sets the token; -v reports each batch and "Done."; the fast BERT
    frames are the JAX package's."""
    rc, out, err = run_main(opv_mod.main, ["-S", "AB1CD", "-B", "2", "-t",
                                           "0x123456", "-v", "--fast",
                                           "--device", "cpu"])
    frames = build_bert_frame("AB1CD", 0x123456, np.arange(2))
    assert rc == 0 and out == _jax_tx(frames, exact=False)
    assert "Sent frame 2/2" in err and err.rstrip().endswith("Done.")


@pytest.mark.parametrize("argv,rc,msg", [
    ([], 1, "Must specify either -R"),
    (["-B", "2"], 1, "CALLSIGN"),
    (["-R", "-B", "2"], 1, "mutually exclusive"),
    (["-h"], 1, "opv-mod"),
])
def test_usage_errors(argv, rc, msg):
    got, out, err = run_main(opv_mod.main, argv + ["--device", "cpu"])
    assert got == rc and msg in err and out == b""


def test_default_device_needs_a_card():
    """Without --device the port runs on the card; with none visible it
    exits non-zero and names --device cpu, writing nothing."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default runs there")
    rc, out, err = run_main(opv_mod.main, ["-S", "W5NYV", "-B", "1"])
    assert rc != 0 and out == b"" and "--device cpu" in err


def test_long_callsign_warns_and_truncates():
    rc, out, err = run_main(opv_mod.main, ["-S", "ABCDEFGHIJK", "-B", "1",
                                           "--fast", "--device", "cpu"])
    frames = build_bert_frame("ABCDEFGHI", frame_num=np.arange(1))
    assert rc == 0 and "truncated to 9 characters" in err
    assert out == _jax_tx(frames, exact=False)


def test_module_entry_point():
    """python -m opv_tpu_torch.cli.opv_mod: the exact BERT capture."""
    r = subprocess.run([sys.executable, "-m", "opv_tpu_torch.cli.opv_mod",
                        "-S", "W5NYV", "-B", "3", "--device", "cpu"],
                       capture_output=True, cwd=ROOT, timeout=120)
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    assert r.stdout == (GOLDEN / "bert3.iq").read_bytes()
