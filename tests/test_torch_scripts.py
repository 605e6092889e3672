"""The PlutoSDR deployment scripts over the port's CLIs, on the CPU: the
five cases of tests/test_scripts.py under its stubbed iio_* tools, each
script given the port's command through OPV_DEMOD / OPV_MOD / OPV_MODEM
with --device cpu (the scripts are not edited), and the default --device
cuda failing on a host without a card."""

import pathlib
import socket
import subprocess
import sys
import time

import pytest
import torch

from cli_support import free_port
from test_scripts import iio_stubs  # noqa: F401  (the stubbed radio)

REPO = pathlib.Path(__file__).resolve().parent.parent
SCRIPTS = REPO / "scripts"


def port_cli(name: str, device: str | None = "cpu") -> str:
    """The port's CLI as the scripts expand it (unquoted)."""
    cmd = f"{sys.executable} -m opv_tpu_torch.cli.{name}"
    return cmd + (f" --device {device}" if device else "")


def port_env(env: dict, device: str | None = "cpu") -> dict:
    return {**env, "PYTHONPATH": str(REPO),
            "OPV_DEMOD": port_cli("opv_demod", device),
            "OPV_MOD": port_cli("opv_mod", device),
            "OPV_MODEM": port_cli("opv_modem", device)}


def run_script(name: str, env: dict, *args, timeout: int = 600):
    return subprocess.run(["bash", str(SCRIPTS / name), *args], env=env,
                          capture_output=True, text=True, timeout=timeout,
                          cwd=REPO)


class TestPlutoRx:
    def test_rx_script_decodes_golden(self, iio_stubs):
        env, tmp = iio_stubs
        r = run_script("opv-pluto-rx.sh", port_env(env))
        assert r.returncode == 0, r.stderr[-500:]
        assert "Summary: 3 frames (3 perfect, 0 errors)" in r.stderr
        attrs = (tmp / "attr.log").read_text()
        assert "altvoltage0 frequency 435000000" in attrs
        assert "sampling_frequency 2168000" in attrs

    def test_rx_script_capture_tee(self, iio_stubs, golden_dir):
        env, tmp = iio_stubs
        cap = tmp / "cap.iq"
        r = run_script("opv-pluto-rx.sh", port_env(env), "-q", "-c", str(cap))
        assert r.returncode == 0, r.stderr[-500:]
        assert cap.read_bytes() == (golden_dir / "bert3.iq").read_bytes()

    def test_rx_script_defaults_to_the_card(self, iio_stubs):
        """Without --device the port's demodulator asks for the card; on a
        host without one the pipeline fails with the DeviceError message,
        it never decodes on the CPU."""
        if torch.cuda.is_available():
            pytest.skip("this host has a card")
        env, _ = iio_stubs
        r = run_script("opv-pluto-rx.sh", port_env(env, device=None))
        assert r.returncode != 0
        assert "--device cuda: no such CUDA device" in r.stderr
        assert "Summary:" not in r.stderr


class TestPlutoTx:
    def test_tx_script_transmits_bert(self, iio_stubs):
        env, tmp = iio_stubs
        r = run_script("opv-pluto-tx.sh", port_env(env), "-S", "W5NYV",
                       "-B", "2")
        assert r.returncode == 0, r.stderr[-500:]
        # 2 frames + 100-symbol flush of int16 IQ reached the radio
        n = int((tmp / "tx_bytes").read_text().split()[0])
        assert n == (2 * 86720 + 100 * 40) * 4
        attrs = (tmp / "attr.log").read_text()
        assert "altvoltage1 frequency 435000000" in attrs

    def test_tx_script_requires_callsign(self, iio_stubs):
        env, _ = iio_stubs
        r = run_script("opv-pluto-tx.sh", port_env(env), timeout=120)
        assert r.returncode != 0
        assert "CALLSIGN" in r.stderr + r.stdout


class TestPlutoFullDuplex:
    def test_full_duplex_both_directions(self, iio_stubs, golden_dir):
        """opv-pluto.sh runs the port's modem TX and RX concurrently: golden
        IQ from the stubbed radio reaches Interlocutor as UDP frames while
        a UDP frame pushed the other way reaches the stubbed radio as IQ."""
        from opv_tpu_torch.core.base40 import base40_decode, base40_encode
        env, tmp = iio_stubs
        b = tmp / "bin"
        done = tmp / "done"
        (b / "iio_readdev").write_text(
            "#!/bin/bash\n"
            f'cat "{golden_dir}/bert3.iq"\n'
            f'while [ ! -f "{done}" ]; do sleep 0.5; done\n')
        (b / "iio_writedev").write_text(
            "#!/bin/bash\n"
            f'exec dd of="{tmp}/tx.bin" status=none bs=4096\n')

        tx_port, rx_port = free_port(), free_port()
        listener = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        listener.bind(("127.0.0.1", rx_port))
        listener.settimeout(1.0)
        proc = subprocess.Popen(
            ["bash", str(SCRIPTS / "opv-pluto.sh"),
             "--tx-port", str(tx_port), "--rx-port", str(rx_port)],
            env=port_env(env), stderr=subprocess.PIPE,
            stdout=subprocess.DEVNULL, cwd=REPO)
        tx_sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        frame = bytearray(134)
        frame[:6] = base40_encode("W5NYV")
        frame = bytes(frame)
        rx_frames = []
        tx_bin = tmp / "tx.bin"
        try:
            deadline = time.time() + 480
            while time.time() < deadline:
                if not (tx_bin.exists() and tx_bin.stat().st_size > 0):
                    tx_sock.sendto(frame, ("127.0.0.1", tx_port))
                try:
                    data, _ = listener.recvfrom(4096)
                    rx_frames.append(data)
                except socket.timeout:
                    pass
                # frame 3 sits in the streaming tail until EOF
                if (len(rx_frames) >= 2 and tx_bin.exists()
                        and tx_bin.stat().st_size > 0):
                    break
                if proc.poll() is not None:
                    break
            done.touch()
            drain = time.time() + 120
            while len(rx_frames) < 3 and time.time() < drain:
                try:
                    data, _ = listener.recvfrom(4096)
                    rx_frames.append(data)
                except socket.timeout:
                    pass
            proc.wait(timeout=60)
        finally:
            done.touch()
            if proc.poll() is None:
                proc.terminate()
                proc.wait(timeout=30)
            listener.close()
            tx_sock.close()
        assert len(rx_frames) >= 3, proc.stderr.read().decode()[-500:]
        for g in rx_frames[:3]:
            assert len(g) == 134
            assert base40_decode(g[:6]) == "W5NYV"
        assert tx_bin.stat().st_size >= 4096


def test_scripts_are_the_jax_packages():
    """The scripts take the port through their variables alone: each
    names its CLI variable and defaults it to the JAX package's module."""
    for name, var, mod in (("opv-pluto-rx.sh", "OPV_DEMOD", "opv_demod"),
                           ("opv-pluto-tx.sh", "OPV_MOD", "opv_mod"),
                           ("opv-pluto.sh", "OPV_MODEM", "opv_modem")):
        text = (SCRIPTS / name).read_text()
        assert f'{var}="${{{var}:-python3 -m opv_tpu.cli.{mod}}}"' in text
        assert f"${var} " in text          # expanded unquoted
