"""TX frame multiplexer: priority-scheduled traffic -> 40 ms frame stream
(counterpart of opv_tpu/tx/multiplexer.py; pure host Python, no tensors).

The reference only *designed* this subsystem (docs/OPV multiplexing.md —
state machine, priority rules, COBS framing; no code exists).  This is a
working implementation, driven by logical 40 ms frame
ticks so it is testable off-hardware and host-clock-driven in deployment.

Traffic classes (strictly decreasing priority for frame slots):
  AAAAA  — access/auth control messages; may override voice
  VOICE  — one packet per frame while PTT held; overrides chat/background
  CHAT   — interactive text; may override voice per the reference policy
           (user-controlled timing), here: fills PTT-idle frames first and
           only overrides voice when marked urgent
  BACKGROUND — bulk data, up to 1500-byte packets, COBS-framed across
           frames; aborted (and re-queued) when voice needs the channel

State machine: IDLE -> PREAMBLE -> (SENDVOICE | SENDDATA | INTERRUPTUS)* ->
HANGTIME -> SENDEOT -> IDLE, mirroring the reference design's states.

Each tick() produces at most one 134-byte frame payload (station ID + token
header + 122 data bytes) ready for opv_tpu_torch.core.framing.encode_frame.
"""

from __future__ import annotations

import collections
import enum
from dataclasses import dataclass, field

from opv_tpu_torch.config import CONFIG
from opv_tpu_torch.core.base40 import base40_encode

DATA_BYTES = CONFIG.frame_bytes - CONFIG.payload_offset   # 122


# ---------------------------------------------------------------------------
# COBS framing (consistent-overhead byte stuffing) — lets a multi-frame
# background packet be aborted mid-stream and unambiguously restarted.
# ---------------------------------------------------------------------------

def cobs_encode(data: bytes) -> bytes:
    out = bytearray()
    idx = 0
    while True:
        block = data[idx : idx + 254]
        zero = block.find(b"\x00")
        if zero == -1:
            out.append(len(block) + 1)
            out.extend(block)
            idx += len(block)
            if len(block) < 254:
                break
        else:
            out.append(zero + 1)
            out.extend(block[:zero])
            idx += zero + 1
    out.append(0)          # frame delimiter
    return bytes(out)


def cobs_decode(data: bytes) -> bytes:
    out = bytearray()
    idx = 0
    while idx < len(data):
        code = data[idx]
        if code == 0:
            break
        idx += 1
        out.extend(data[idx : idx + code - 1])
        idx += code - 1
        if code < 255 and idx < len(data) and data[idx] != 0:
            out.append(0)
    return bytes(out)


class TxState(enum.Enum):
    IDLE = "IDLE"
    PREAMBLE = "PREAMBLE"
    SENDVOICE = "SENDVOICE"
    INTERRUPTUS = "INTERRUPTUS"   # control/chat overriding a voice frame
    SENDDATA = "SENDDATA"
    HANGTIME = "HANGTIME"
    SENDEOT = "SENDEOT"


@dataclass
class TxMultiplexer:
    callsign: str
    token: int = CONFIG.default_token
    hang_frames: int = 5           # frames of dead air kept after traffic

    state: TxState = TxState.IDLE
    ptt: bool = False
    _voice_buf: bytes | None = None
    _aaaaa: collections.deque = field(default_factory=collections.deque)
    _chat: collections.deque = field(default_factory=collections.deque)
    _background: collections.deque = field(default_factory=collections.deque)
    _data_in_flight: bytearray | None = None
    _data_sent: int = 0
    _data_src: str = ""
    _data_urgent: bool = False
    _abort_pending: bool = False
    _hang_count: int = 0
    frames_sent: int = 0

    def __post_init__(self):
        self._station = base40_encode(self.callsign)
        self._header = bytes(self._station) + bytes(
            [(self.token >> 16) & 0xFF, (self.token >> 8) & 0xFF,
             self.token & 0xFF, 0, 0, 0])

    # -- traffic ingress ----------------------------------------------------

    def set_ptt(self, on: bool) -> None:
        self.ptt = on
        if not on:
            # a vocoder packet that raced the PTT release is dropped — a
            # stale buffer must not keep the transmitter keyed
            self._voice_buf = None

    def push_voice(self, packet: bytes) -> None:
        """One Opus packet per frame time while PTT is held."""
        self._voice_buf = bytes(packet[:DATA_BYTES])

    def push_aaaaa(self, msg: bytes) -> None:
        if len(msg) > DATA_BYTES:
            raise ValueError(
                f"AAAAA messages are single-frame by design (<= {DATA_BYTES} "
                f"bytes); got {len(msg)}")
        self._aaaaa.append(bytes(msg))

    def push_chat(self, msg: bytes, urgent: bool = False) -> None:
        self._chat.append((bytes(msg), urgent))

    def push_background(self, packet: bytes) -> None:
        if len(packet) > 1500:
            raise ValueError("background packets are limited to 1500 bytes")
        self._background.append(bytes(packet))

    # -- internals ----------------------------------------------------------

    def _frame(self, data: bytes) -> bytes:
        body = data[:DATA_BYTES].ljust(DATA_BYTES, b"\x00")
        self.frames_sent += 1
        return self._header + body

    def _have_traffic(self) -> bool:
        return bool(self.ptt or self._voice_buf or self._aaaaa or self._chat
                    or self._background or self._data_in_flight)

    def _next_data_chunk(self) -> bytes | None:
        """Advance the in-flight COBS stream or start a new packet."""
        if self._data_in_flight is None:
            if self._chat:
                msg, urgent = self._chat.popleft()
                self._data_in_flight = bytearray(cobs_encode(msg))
                self._data_src = "chat"
                self._data_urgent = urgent
            elif self._background:
                self._data_in_flight = bytearray(
                    cobs_encode(self._background.popleft()))
                self._data_src = "background"
                self._data_urgent = False
            else:
                return None
            # 3. if a previous COBS stream was aborted mid-packet, lead with
            # a delimiter so the receiver discards the partial bytes instead
            # of concatenating them with this packet
            if self._abort_pending:
                self._data_in_flight[0:0] = b"\x00"
                self._abort_pending = False
            self._data_sent = 0
        chunk = bytes(self._data_in_flight[self._data_sent:
                                           self._data_sent + DATA_BYTES])
        self._data_sent += len(chunk)
        if self._data_sent >= len(self._data_in_flight):
            self._data_in_flight = None
        return chunk

    def _abort_data(self) -> None:
        """Voice preempts a long background packet: re-queue it (reference
        policy: save the aborted packet and retry after the voice ends)."""
        if self._data_in_flight is not None and self._data_src == "background":
            packet = cobs_decode(bytes(self._data_in_flight).lstrip(b"\x00"))
            self._background.appendleft(packet)
            # bytes already on air lack a terminating delimiter; flag the
            # next data stream to lead with one
            if self._data_sent > 0:
                self._abort_pending = True
        self._data_in_flight = None
        self._data_urgent = False

    # -- the 40 ms tick -----------------------------------------------------

    def tick(self):
        """Advance one frame time.  Returns (state, frame_bytes | None)."""
        if self.state == TxState.IDLE:
            if not self._have_traffic():
                return self.state, None
            self.state = TxState.PREAMBLE
            return self.state, None       # preamble slot (sync-only airtime)

        if self.state == TxState.SENDEOT:
            # EOT went out last tick; transmitter off unless new traffic
            self.state = TxState.IDLE
            if self._have_traffic():
                self.state = TxState.PREAMBLE
                return self.state, None
            return TxState.IDLE, None

        # priority resolution for this frame slot
        if self._aaaaa:
            payload = self._aaaaa.popleft()
            self.state = TxState.INTERRUPTUS if self.ptt else TxState.SENDDATA
            self._hang_count = 0
            return self.state, self._frame(payload)

        urgent_chat = bool(
            (self._chat and self._chat[0][1]) or
            (self._data_in_flight is not None and self._data_src == "chat"
             and self._data_urgent))
        if urgent_chat and self._data_in_flight is not None \
                and self._data_src == "background":
            # 2. an urgent chat must not be starved behind bulk data (and
            # bulk data must never preempt voice): abort the background
            # stream so the chat starts this frame
            self._abort_data()
        if self.ptt and self._voice_buf is not None and not urgent_chat:
            if self._data_in_flight is not None and self._data_src == "background":
                self._abort_data()
            payload = self._voice_buf
            self._voice_buf = None
            self.state = TxState.SENDVOICE
            self._hang_count = 0
            return self.state, self._frame(payload)

        chunk = self._next_data_chunk()
        if chunk is not None:
            self.state = TxState.INTERRUPTUS if self.ptt else TxState.SENDDATA
            self._hang_count = 0
            return self.state, self._frame(chunk)

        if self.ptt:
            # PTT held but no voice packet arrived: dead-air filler frame
            self.state = TxState.SENDVOICE
            self._hang_count = 0
            return self.state, self._frame(b"")

        # nothing to send: hang time, then EOT
        self._hang_count += 1
        if self._hang_count >= self.hang_frames:
            self.state = TxState.SENDEOT
            self._hang_count = 0
        else:
            self.state = TxState.HANGTIME
        return self.state, None
