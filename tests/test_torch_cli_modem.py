"""The port's opv-modem (opv_tpu_torch.cli.opv_modem) on the CPU, on
ephemeral UDP ports: -l --fast echo, -t with its -o tee (exact TX by
default), -R --fast delivery, and the exit codes."""

import pathlib
import select
import socket
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opv_tpu.core import encode_frame as encode_j
from opv_tpu.tx import modulate_frames as modulate_j
from opv_tpu_torch.cli import opv_modem
from opv_tpu_torch.core.base40 import base40_encode
from cli_support import free_port, run_main

ROOT = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "golden"

FB = 134
CPU = ["--device", "cpu"]


def _frame(k: int) -> bytes:
    f = bytearray(FB)
    f[:6] = base40_encode("W5NYV")
    f[6:9] = (0xBBAADD).to_bytes(3, "big")
    f[12:] = bytes((k + i) & 0xFF for i in range(FB - 12))
    return bytes(f)


def _serve(argv, **kw):
    """opv-modem as a process on a fresh port, once it listens."""
    port = free_port()
    proc = subprocess.Popen([sys.executable, "-m", "opv_tpu_torch.cli.opv_modem",
                             "-p", str(port)] + argv + CPU, cwd=ROOT,
                            stderr=subprocess.PIPE, **kw)
    deadline = time.time() + 120
    seen = b""
    while b"Listening" not in seen and proc.poll() is None \
            and select.select([proc.stderr], [], [],
                              max(0.0, deadline - time.time()))[0]:
        seen += proc.stderr.readline()
    if b"Listening" not in seen:
        _stop(proc)
        raise AssertionError(f"opv-modem did not listen: {seen[-2000:]!r}")
    return proc, port


def _stop(proc):
    proc.terminate()
    try:
        proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


def test_loopback_fast_echo():
    """-l --fast: frames sent at 40 ms pacing come back byte-equal, in
    order (the eager engine returns each once the next frame's first
    symbol is buffered; the last one comes with the drain)."""
    proc, port = _serve(["-l", "--fast"], stdout=subprocess.DEVNULL)
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    sent = [_frame(k) for k in range(6)]
    try:
        for f in sent:
            s.sendto(f, ("127.0.0.1", port))
            time.sleep(0.04)
        s.settimeout(20)
        got = [s.recvfrom(4096)[0] for _ in range(len(sent) - 1)]
    finally:
        _stop(proc)
        s.close()
    assert got == sent[:-1]


def test_tx_tee_is_the_exact_modulation(tmp_path):
    """-t -o FILE: stdout carries the frame's exact (default) modulation,
    the JAX package's and the reference's float64 path, and the tee holds
    the same bytes plus the zero flush written at exit."""
    tee = tmp_path / "tee.iq"
    proc, port = _serve(["-t", "-o", str(tee)], stdout=subprocess.PIPE)
    frame = _frame(3)
    want = 86_720 * 4
    got = b""
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.sendto(frame, ("127.0.0.1", port))
        s.close()
        deadline = time.time() + 120
        while len(got) < want and time.time() < deadline:
            got += proc.stdout.read1(65536)
    finally:
        _stop(proc)
    iq, _ = modulate_j(encode_j(jnp.asarray(np.frombuffer(frame, np.uint8)[None])),
                       exact=True)
    assert got == np.asarray(iq).astype("<i2").tobytes()
    assert tee.read_bytes() == got + bytes(4000 * 4)


def test_rx_fast_delivers_the_frames():
    """-R --fast -r PORT on bert3.iq: its three frames arrive over UDP, in
    order, byte-equal to the capture's frames; -v names each."""
    listener = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    listener.bind(("127.0.0.1", 0))
    listener.settimeout(5)
    port = listener.getsockname()[1]
    try:
        rc, out, err = run_main(opv_modem.main, ["-R", "--fast", "-v", "-r",
                                                 str(port)] + CPU,
                                (GOLDEN / "bert3.iq").read_bytes())
        got = [listener.recvfrom(4096)[0] for _ in range(3)]
    finally:
        listener.close()
    assert rc == 0 and out == b""
    assert b"".join(got) == (GOLDEN / "bert3.frames").read_bytes()
    assert "RX 3: W5NYV [0xbbaadd]" in err and "RX:  3 frames" in err


@pytest.mark.parametrize("argv,rc,msg", [
    (["-l"], 2, "item 11"),
    (["-R"], 2, "item 11"),
    (["-l", "-t"], 1, "Cannot combine"),
    (["-h"], 1, "opv-modem"),
    (["-t", "-c", "BAD!"], 1, "Invalid callsign"),
])
def test_exit_codes(argv, rc, msg):
    got, out, err = run_main(opv_modem.main, argv + CPU)
    assert got == rc and msg in err and out == b""


def test_error_binding_to_port():
    """A port another socket holds: "Error binding to port", exit 1."""
    holder = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    holder.bind(("", 0))
    port = holder.getsockname()[1]
    try:
        rc, _, err = run_main(opv_modem.main, ["-t", "-q", "-p", str(port)] + CPU)
    finally:
        holder.close()
    assert rc == 1 and f"Error binding to port {port}" in err


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default runs there")
    rc, out, err = run_main(opv_modem.main, ["-t", "-q", "-p", "0"])
    assert rc != 0 and out == b"" and "--device cpu" in err
