"""Helpers for driving the port's CLIs, shared by tests/test_torch_cli_*.py,
tests/test_torch_io.py and chip_smoke.py: a CLI's main(argv) run in this
process with its standard streams swapped, and a free UDP port."""

import io
import socket
import sys


def run_main(main, argv, stdin: bytes = b""):
    """A CLI's main(argv) in this process, reading `stdin` and with its
    standard output and error captured: (exit code, stdout bytes, stderr
    text)."""
    saved = sys.stdin, sys.stdout, sys.stderr
    sys.stdin = io.TextIOWrapper(io.BytesIO(stdin))
    sys.stdout = io.TextIOWrapper(io.BytesIO(), write_through=True)
    sys.stderr = io.StringIO()
    try:
        rc = main(argv)
        return rc, sys.stdout.buffer.getvalue(), sys.stderr.getvalue()
    finally:
        sys.stdin, sys.stdout, sys.stderr = saved


def free_port() -> int:
    """A UDP port of this host that was free a moment ago (bind 0)."""
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
