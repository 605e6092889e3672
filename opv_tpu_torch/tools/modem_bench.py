"""Serving latency of the port's modem loopback (counterpart of
tools/modem_bench.py): `python -m opv_tpu_torch.cli.opv_modem -l [--fast]
--device D` started as a process and driven as a black box over a real
UDP socket (frame in -> encode -> modulate -> demodulate -> frame back):

  cold_start   first frame in -> first frame back, after the process
               listens (its start to "Listening" is server_ready_s), with
               frames paced behind it at 40 ms: the engine's first
               compiles and allocations and its one-frame window gate
  cadence      per-frame latency at the real-time 40 ms pace, p50 / p95 /
               p99 (and min, max) over --frames frames
  burst        closed-loop frames/s with 4 frames in flight, --burst frames
               a window, the median of 5 windows with the min and max;
               x real time and the Msamples/s served (fps x 86,720)

Every figure is on the host clock.  At most PACERS unscored frames follow
the scored ones at a time (the JAX tool keeps pacing), so a modem slower
than real time (the CPU) does not drown in them.  Each run takes a UDP port of its own
that was free a moment before (or --port, and --port + 1 for the second
engine of --both).  Every scored frame must come back, and every frame
that comes back must come after the one before it in the order sent: a
lost or reordered frame fails the run.  --device cpu runs the same
protocol and writes no figures.

    python -m opv_tpu_torch.tools.modem_bench [--fast | --both]
        [--frames 50] [--burst 40] [--port P] [--json FILE] [--device cuda]
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import pathlib
import select
import socket
import subprocess
import sys
import threading
import time

FRAME_BYTES = 134
FRAME_SECONDS = 0.040
SAMPLES_PER_FRAME = 86_720
BURST_IN_FLIGHT = 4
#: frames sent after the ones scored (cold start: in flight before the
#: first comes back; cadence: after the last scored one; burst: in flight
#: after the last): enough to move the engine's window gate (one frame
#: for the tracking loop, about two for the locked engine) without
#: queueing work a modem slower than real time would take long to drain
PACERS = 4
START_S = 180
STALL_S = 120
REPO = pathlib.Path(__file__).resolve().parents[2]


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def build_frame(seq: int) -> bytes:
    """A 134-byte frame: W5NYV, token 0xBBAADD, seq at bytes 12-15 (big
    endian) and a counting payload (tools/modem_bench.py:50-61)."""
    from opv_tpu_torch.core.base40 import base40_encode
    frame = bytearray(FRAME_BYTES)
    frame[:6] = base40_encode("W5NYV")
    frame[6:9] = (0xBBAADD).to_bytes(3, "big")
    frame[12:16] = seq.to_bytes(4, "big")
    for i in range(16, FRAME_BYTES):
        frame[i] = (seq + i) & 0xFF
    return bytes(frame)


def seq_of(frame: bytes) -> int:
    return int.from_bytes(frame[12:16], "big")


def free_port() -> int:
    """A UDP port of this host that was free a moment ago (bind 0)."""
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class LoopbackServer:
    """opv_modem -l as a process; its stderr is read by a thread (the
    last lines kept for errors) so the process never blocks on it."""

    def __init__(self, port: int, fast: bool, device: str):
        cmd = [sys.executable, "-m", "opv_tpu_torch.cli.opv_modem", "-l",
               "-p", str(port), "--device", device]
        if fast:
            cmd.append("--fast")
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            filter(None, [str(REPO), os.environ.get("PYTHONPATH")])))
        self.proc = subprocess.Popen(cmd, env=env, cwd=REPO,
                                     stderr=subprocess.PIPE,
                                     stdout=subprocess.DEVNULL)
        self.tail = collections.deque(maxlen=40)
        self._reader = None

    def wait_ready(self, timeout: float = START_S) -> bool:
        deadline = time.time() + timeout
        err = self.proc.stderr
        while self.proc.poll() is None and select.select(
                [err], [], [], max(0.0, deadline - time.time()))[0]:
            line = err.readline()
            self.tail.append(line)
            if b"Listening" in line:
                self._reader = threading.Thread(target=self._drain,
                                                daemon=True)
                self._reader.start()
                return True
        return False

    def _drain(self):
        for line in self.proc.stderr:
            self.tail.append(line)

    def stop(self):
        self.proc.terminate()
        try:
            self.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        if self._reader is not None:
            self._reader.join(timeout=10)
        self.proc.stderr.close()

    def tail_text(self) -> str:
        return b"".join(self.tail).decode(errors="replace")[-2000:]


class Order:
    """Every frame that comes back must follow the one before it."""

    def __init__(self):
        self.last = -1

    def check(self, data: bytes) -> int:
        seq = seq_of(data)
        if seq <= self.last:
            raise RuntimeError(f"frame {seq} came back after frame "
                               f"{self.last}: out of order")
        self.last = seq
        return seq


def percentiles(lat) -> dict:
    lat = sorted(lat)

    def pct(p):
        return lat[min(len(lat) - 1, int(p / 100 * len(lat)))]
    return dict(p50=pct(50), p95=pct(95), p99=pct(99), min=lat[0],
                max=lat[-1], n=len(lat))


def cold_start(sock, dest, order: Order):
    """Frames at the 40 ms pace (at most PACERS after frame 0) until the
    first comes back: (seconds, frames sent)."""
    t0 = time.time()
    pacer = 0
    sock.settimeout(FRAME_SECONDS)
    while True:
        if pacer <= PACERS:
            sock.sendto(build_frame(pacer), dest)
            pacer += 1
        try:
            data, _ = sock.recvfrom(4096)
        except socket.timeout:
            if time.time() - t0 > START_S:
                raise RuntimeError("cold start stalled") from None
            continue
        cold = time.time() - t0
        if order.check(data) != 0:
            raise RuntimeError(f"the first frame back is {seq_of(data)}, "
                               "not 0")
        return cold, pacer


def drain(sock, order: Order, quiet_s: float = 1.0) -> None:
    sock.settimeout(quiet_s)
    try:
        while True:
            order.check(sock.recvfrom(4096)[0])
    except socket.timeout:
        pass


def cadence(sock, dest, order: Order, n: int, base: int) -> list:
    """Latency ms of frames base..base+n-1 sent at the 40 ms pace (PACERS
    frames after them move the window gate and are not scored)."""
    send_t, lat = {}, {}
    next_send = time.time()
    sent = 0
    t_prog = time.time()
    sock.setblocking(False)
    while len(lat) < n:
        now = time.time()
        if now >= next_send and sent < n + PACERS:
            seq = base + sent
            sock.sendto(build_frame(seq), dest)
            send_t[seq] = now
            sent += 1
            next_send += FRAME_SECONDS
        try:
            data, _ = sock.recvfrom(4096)
        except BlockingIOError:
            time.sleep(0.002)
        else:
            seq = order.check(data)
            if base <= seq < base + n:
                lat[seq] = (time.time() - send_t[seq]) * 1e3
                t_prog = time.time()
        if time.time() - t_prog > STALL_S:
            raise RuntimeError(f"cadence run stalled: {len(lat)} of {n} "
                               "frames back")
    sock.setblocking(True)
    return [lat[s] for s in sorted(lat)]


def burst(sock, dest, order: Order, n: int, base: int) -> float:
    """Seconds for frames base..base+n-1 sent closed loop with
    BURST_IN_FLIGHT in flight; once all are sent, unscored frames after
    them (at most PACERS in flight) push the last ones through the window
    gate."""
    t0 = time.time()
    inflight = next_seq = got = pacers = pacers_back = 0
    t_last = time.time()
    while got < n:
        while inflight < BURST_IN_FLIGHT and next_seq < n:
            sock.sendto(build_frame(base + next_seq), dest)
            next_seq += 1
            inflight += 1
        sock.settimeout(0.05 if next_seq == n else 30)
        try:
            data, _ = sock.recvfrom(4096)
        except socket.timeout:
            if next_seq == n and pacers - pacers_back < PACERS:
                sock.sendto(build_frame(base + n + pacers), dest)
                pacers += 1
            if time.time() - t_last > STALL_S:
                raise RuntimeError(f"burst run stalled: {got} of {n} "
                                   "frames back") from None
            continue
        seq = order.check(data)
        if base <= seq < base + n:
            got += 1
            inflight -= 1
            t_last = time.time()
        elif seq >= base + n:
            pacers_back += 1
    return time.time() - t0


def bench(fast: bool, n_cadence: int, n_burst: int, port: int, device: str,
          measured: bool) -> dict:
    from opv_tpu_torch.tools import timing
    engine = "fast" if fast else "exact"
    t_start = time.time()
    srv = LoopbackServer(port, fast, device)
    try:
        if not srv.wait_ready():
            raise RuntimeError(f"opv_modem -l ({engine}) did not listen: "
                               f"{srv.tail_text()}")
        ready = time.time() - t_start
        log(f"server ready in {ready:.1f} s ({engine} engine, port {port})")
        order = Order()
        dest = ("127.0.0.1", port)
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as sock:
            sock.bind(("127.0.0.1", 0))
            cold, pacers = cold_start(sock, dest, order)
            log(f"cold start: {cold:.2f} s ({pacers} frames paced)")
            drain(sock, order)
            base = 500_000
            lat = cadence(sock, dest, order, n_cadence, base)
            cad = percentiles(lat)
            log(f"cadence ({n_cadence} frames at 40 ms): p50 "
                f"{cad['p50']:.1f} ms, p95 {cad['p95']:.1f}, p99 "
                f"{cad['p99']:.1f}")
            secs = []
            for w in range(timing.WINDOWS):
                secs.append(burst(sock, dest, order, n_burst,
                                  base + 100_000 * (w + 1)))
            fps = timing.spread([n_burst / s for s in secs])
            log(f"burst ({timing.WINDOWS} windows of {n_burst} frames, "
                f"{BURST_IN_FLIGHT} in flight): {fps['median']:.1f} "
                f"frames/s")
    except RuntimeError as e:
        raise RuntimeError(f"opv_modem -l ({engine}): {e}; its stderr "
                           f"ends: {srv.tail_text()}") from None
    finally:
        srv.stop()
    run = dict(engine=engine, port=port, clock="host",
               frames_paced_at_cold_start=pacers, cadence_frames=n_cadence,
               burst_frames=n_burst, burst_windows=timing.WINDOWS,
               burst_in_flight=BURST_IN_FLIGHT, pacers=PACERS)
    if not measured:
        for key in ("server_ready_s", "cold_start_s", "cadence_ms",
                    "burst_fps", "burst_x_realtime", "burst_msps"):
            run[key] = timing.NOT_MEASURED
        return run
    return dict(run, server_ready_s=ready, cold_start_s=cold,
                cadence_ms=cad, burst_fps=fps,
                burst_x_realtime={k: v * FRAME_SECONDS
                                  for k, v in fps.items()},
                burst_msps={k: v * SAMPLES_PER_FRAME / 1e6
                            for k, v in fps.items()})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="modem_bench")
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--both", action="store_true")
    ap.add_argument("--frames", type=int, default=50)
    ap.add_argument("--burst", type=int, default=40)
    ap.add_argument("--port", type=int, default=None,
                    help="UDP port (default: one free a moment before)")
    ap.add_argument("--json", default=None)
    ap.add_argument("--commit", default=None,
                    help="the commit to record (default: the checkout's)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from opv_tpu_torch.cli._device import resolve_device
    from opv_tpu_torch.tools.timing import header, measures
    dev = resolve_device(args.device)
    out = header("modem_bench", argv if argv is not None else sys.argv[1:],
                 dev, args.commit)
    engines = [False, True] if args.both else [args.fast]
    out["bench"] = "modem_loopback_serving"
    out["runs"] = [bench(fast, args.frames, args.burst,
                         free_port() if args.port is None
                         else args.port + i, str(dev), measures(dev))
                   for i, fast in enumerate(engines)]
    txt = json.dumps(out)
    if args.json:
        pathlib.Path(args.json).write_text(txt + "\n")
    print(txt)
    return 0


if __name__ == "__main__":
    sys.exit(main())
