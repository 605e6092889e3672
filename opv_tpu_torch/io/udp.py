"""UDP frame bridge: 134-byte datagrams to and from Interlocutor over a
non-blocking socket (counterpart of opv_tpu/io/udp.py, the reference's
UDPServer as a library)."""

from __future__ import annotations

import selectors
import socket

from opv_tpu_torch.config import CONFIG


class UDPFrameBridge:
    """Non-blocking UDP endpoint exchanging fixed-size OPV frames."""

    def __init__(self, port: int = 0, host: str = ""):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind((host, port))
        self.sock.setblocking(False)
        self.port = self.sock.getsockname()[1]
        self.last_sender: tuple[str, int] | None = None
        self._sel = selectors.DefaultSelector()
        self._sel.register(self.sock, selectors.EVENT_READ)

    def receive(self) -> bytes | None:
        """One frame if one is queued, else None.  A datagram of the wrong
        size is dropped and draining goes on, so it cannot hide the valid
        frames queued behind it."""
        while True:
            try:
                data, sender = self.sock.recvfrom(4096)
            except BlockingIOError:
                return None
            if len(data) != CONFIG.frame_bytes:
                continue
            self.last_sender = sender
            return data

    def send(self, frame: bytes, dest: tuple[str, int] | None = None,
             response_port: int | None = None) -> bool:
        """Send a frame to dest, or back to the last sender (on another
        port if response_port is given: the reference's -r).  False when
        there is nowhere to send it."""
        if dest is None:
            if self.last_sender is None:
                return False
            dest = self.last_sender
        if response_port:
            dest = (dest[0], response_port)
        if len(frame) != CONFIG.frame_bytes:
            raise ValueError(f"frame must be {CONFIG.frame_bytes} bytes")
        self.sock.sendto(frame, dest)
        return True

    def poll(self, timeout: float = 0.1):
        """Yield the frames that arrive within timeout seconds."""
        if self._sel.select(timeout=timeout):
            while True:
                f = self.receive()
                if f is None:
                    break
                yield f

    def close(self) -> None:
        self._sel.close()
        self.sock.close()
