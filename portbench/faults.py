"""Faults planted under a run, to show that `correct` comes out false.
Most wrap the receiver's feed() and flush() and change what they return
where the receiver produces it; the estimator faults bias the program's
timing or carrier-offset estimates where they are made.  A fault that
patches the program's modules returns a function that undoes it, which
the run calls once its window has closed."""

from __future__ import annotations

#: the estimator faults' bias: beyond what sound runs' medians read from
#: seed to seed (up to 0.33 samples and 29 Hz at 12 dB, PERF.md section 6)
LATE_SAMPLES = 2.0
HIGH_HZ = 150.0


def _wrap(rx, change):
    feed, flush = rx.feed, rx.flush
    rx.feed = lambda x: change(feed(x))
    rx.flush = lambda: change(flush())


def half_left_out(rx, engine):
    """Half of the bank left out: the frames of every odd channel dropped."""
    _wrap(rx, lambda out: [t for t in out if t[0] % 2 == 0])


def answer_altered(rx, engine):
    """Every frame's first byte altered where the frame is produced."""
    _wrap(rx, lambda out: [(t[0], bytes([t[1][0] ^ 0x5A]) + t[1][1:],
                            *t[2:]) for t in out])


def state_unchanged(rx, engine):
    """The receiver's step returns its input state: every call returns the
    frames of the first call that returned any, again."""
    first = []

    def change(out):
        if out and not first:
            first.append(out)
        return list(first[0]) if first else out
    _wrap(rx, change)


def spurious_frames(rx, engine):
    """A shifted duplicate of every frame, half a frame later: frames
    emitted where nothing was sent."""
    half = 86_720 // 2
    _wrap(rx, lambda out: out + [(*t[:4], t[4] + half) for t in out])


def timing_biased(rx, engine):
    """Every timing estimate of the program LATE_SAMPLES late: the apex
    refinement of a sync fold (the hunt's and the retime's, on the device)
    and its host twin (the retime's deep accumulator).  Returns the undo."""
    import opv_tpu_torch.rx.locked as rxl
    import opv_tpu_torch.stream.locked as stl
    dev, host = rxl._fold_est, stl.fold_est_np
    rxl._fold_est = lambda fold: dev(fold) + LATE_SAMPLES
    stl.fold_est_np = lambda fold: host(fold) + LATE_SAMPLES

    def undo():
        rxl._fold_est, stl.fold_est_np = dev, host
    return undo


def cfo_biased(rx, engine):
    """The hunt's carrier offset HIGH_HZ high on every channel it acquires
    (the engine carries it while the lock holds)."""
    program = engine._reacquire

    def biased(buf, p0, foff, keep, scale, frac):
        out = program(buf, p0, foff, keep, scale, frac)
        out["freq_offset"] = out["freq_offset"] + HIGH_HZ * (~keep).to(
            out["freq_offset"].dtype)
        return out
    engine._reacquire = biased


FAULTS = {"half_left_out": half_left_out, "answer_altered": answer_altered,
          "state_unchanged": state_unchanged,
          "spurious_frames": spurious_frames, "timing_biased": timing_biased,
          "cfo_biased": cfo_biased}
